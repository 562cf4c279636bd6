// K3: wide-window probe by binary search, and K4, its indexed pass.
//
// K3 replaces the TPU kernel merge_probe_gather (hash_join_codes_knl_tpu/
// ops/merge_probe_gather.py: window_probe_call with
// _gather_row_result_factory).  Same contract as the dense probe (K2),
// plus one precondition: the build window is sorted by (key, value).
// The TPU kernel selected two 128-slot chunks by their boundaries,
// gathered them across lanes and counted the run from chunk arithmetic;
// here each thread owns one probe slot and runs a lower-bound and an
// upper-bound binary search over its tile's window [start, start +
// window).  Then count = hi - lo, and because equal-key runs are
// value-ascending the max matched value is val[hi - 1].  Both are exact
// for any M:N run inside the window (runs cut by the window edge give
// exactly what the dense sweep gives for the same window).
//
// K4 replaces window_probe_call_indexed (hash_join_codes_knl_tpu/ops/
// merge_probe_pallas.py, via merge_probe_gather_indexed): the wide pass
// of the two-class window geometry.  It probes only the tiles listed in
// tile_idx, entry j at anchor wrow_c[j], and overwrites their slots of
// the first pass's (mv, mc) in place; every other slot keeps its value.
// The TPU kernel took the list as a scalar-prefetch operand and wrote
// through an aliased, index-mapped output block; here each thread reads
// its own list entry, and skips an entry outside the probe's tiles.  A
// list may repeat a tile: its entries carry the same anchor, so both
// write the same values.
//
// Bound: memory latency, two chains of about log2(window) dependent
// loads.  Design: one thread per probe, 256 threads per block, so a
// block's probes share one tile's window and its loads hit L1/L2.
#include "hjk.cuh"

namespace {

constexpr int kThreads = 256;

// count of build slots equal to probe p in [start, start + window), and
// the max matched value (the build side is (key, value)-sorted)
__device__ __forceinline__ void window_search(
    const int32_t* __restrict__ bhk, const uint32_t* __restrict__ bval,
    int64_t start, int64_t window, int32_t p, int32_t* count,
    uint32_t* value) {
  // lower bound: first slot of the window whose key is >= p
  int64_t a = start, b = start + window;
  while (a < b) {
    const int64_t m = (a + b) >> 1;
    if (__ldg(bhk + m) < p) a = m + 1; else b = m;
  }
  const int64_t lo = a;
  // upper bound: first slot whose key is > p, searched from lo
  b = start + window;
  while (a < b) {
    const int64_t m = (a + b) >> 1;
    if (__ldg(bhk + m) <= p) a = m + 1; else b = m;
  }
  *count = static_cast<int32_t>(a - lo);
  *value = *count > 0 ? __ldg(bval + a - 1) : 0u;
}

__global__ void __launch_bounds__(kThreads)
merge_probe_gather_kernel(const int32_t* __restrict__ probe, int64_t cap,
                          const int32_t* __restrict__ bhk,
                          const uint32_t* __restrict__ bval, int64_t n_build,
                          const int32_t* __restrict__ wrow, int64_t tile,
                          int64_t window, uint32_t* __restrict__ mv,
                          int32_t* __restrict__ mc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= cap) return;
  const int32_t p = probe[i];
  int32_t count = 0;
  uint32_t value = 0u;
  if (p != hjk::kNullKey) {
    window_search(bhk, bval, hjk::window_start(wrow, i / tile, window, n_build),
                  window, p, &count, &value);
  }
  mc[i] = count;
  mv[i] = value;
}

__global__ void __launch_bounds__(kThreads)
merge_probe_gather_indexed_kernel(
    const int32_t* __restrict__ probe, const int32_t* __restrict__ bhk,
    const uint32_t* __restrict__ bval, int64_t n_build,
    const int32_t* __restrict__ wrow_c, const int32_t* __restrict__ tile_idx,
    int64_t total, int64_t n_tiles, int64_t tile, int64_t window,
    uint32_t* __restrict__ mv, int32_t* __restrict__ mc) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const int64_t j = i / tile;  // entry of the compact tile list
  const int64_t t = tile_idx[j];
  if (t < 0 || t >= n_tiles) return;  // an id past the probe: no write
  const int64_t slot = t * tile + i % tile;
  const int32_t p = probe[slot];
  int32_t count = 0;
  uint32_t value = 0u;
  if (p != hjk::kNullKey) {
    window_search(bhk, bval, hjk::window_start(wrow_c, j, window, n_build),
                  window, p, &count, &value);
  }
  mc[slot] = count;
  mv[slot] = value;
}

}  // namespace

HJK_API int hjk_merge_probe_gather(const void* probe, int64_t cap,
                                   const void* bhk, const void* bval,
                                   int64_t n_build, const void* wrow,
                                   int64_t tile, int64_t window, void* mv,
                                   void* mc, void* stream) {
  if (cap <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (cap + kThreads - 1) / kThreads;
  merge_probe_gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probe), cap,
      static_cast<const int32_t*>(bhk), static_cast<const uint32_t*>(bval),
      n_build, static_cast<const int32_t*>(wrow), tile, window,
      static_cast<uint32_t*>(mv), static_cast<int32_t*>(mc));
  return static_cast<int>(cudaGetLastError());
}

// the indexed pass: n_idx list entries of `tile` slots each, written in
// place into mv and mc (the first pass's outputs, cap slots like probe);
// an entry outside [0, cap / tile) is skipped
HJK_API int hjk_merge_probe_gather_indexed(
    const void* probe, int64_t cap, const void* bhk, const void* bval,
    int64_t n_build, const void* wrow_c, const void* tile_idx, int64_t n_idx,
    int64_t tile, int64_t window, void* mv, void* mc, void* stream) {
  const int64_t total = n_idx * tile;
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  merge_probe_gather_indexed_kernel<<<static_cast<unsigned>(blocks), kThreads,
                                      0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probe), static_cast<const int32_t*>(bhk),
      static_cast<const uint32_t*>(bval), n_build,
      static_cast<const int32_t*>(wrow_c),
      static_cast<const int32_t*>(tile_idx), total, cap / tile, tile, window,
      static_cast<uint32_t*>(mv), static_cast<int32_t*>(mc));
  return static_cast<int>(cudaGetLastError());
}
