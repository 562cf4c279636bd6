// K3: the wide-window probe on a window staged in shared memory, and
// K4, its indexed pass by binary search.
//
// K3 replaces the TPU kernel merge_probe_gather (hash_join_codes_knl_tpu/
// ops/merge_probe_gather.py: window_probe_call with
// _gather_row_result_factory).  Same contract as the dense probe (K2),
// plus one precondition: the build window is sorted by (key, value).
// The TPU kernel selected two 128-slot chunks by their boundaries,
// gathered them across lanes and counted the run from chunk arithmetic.
// Here a probe's matches are the run [lo, hi) of its key in the sorted
// window: count = hi - lo, and because equal-key runs are value-ascending
// the max matched value is val[hi - 1].  Both are exact for any M:N run
// inside the window (runs cut by the window edge give exactly what the
// dense sweep gives for the same window).
//
// Bound: bytes (the probes, the union of the windows' keys, one value per
// matched probe, both outputs).  The searches are what stand in the way:
// two chains of about log2(window) dependent loads a probe, which from
// device memory or L2 cost far more than the bytes.  Design: a block
// serves one tile.  It stages the tile's window keys (at most 121 chunks
// = 15,488 keys, 62 KB, at the gather band's ceiling) into shared memory
// with cp.async, 16 bytes a copy where the alignment allows, in pieces of
// `piece` keys when the window is wider; the first probes load while
// the window does.  Each thread then takes kGroup probes blockDim apart
// side by side (so their loads and search levels overlap): a branchless
// lower-bound search in shared memory, level by level (neighbouring
// lanes hold neighbouring sorted probes, so the first levels are
// broadcasts), then a galloping search for the run's end from lo (one or
// two loads for the common run of length 0 or 1).  Only val[hi - 1] of a
// matched probe is read from device memory.  A probe outside [first key,
// last key] of a piece matches nothing there.  With several pieces, the
// first writes the outputs and later ones add their counts and, on a
// hit, take their later (larger) value.  Blocks go
// position by position over the probe's sorted chunks (hjk::block_tiles),
// so the tiles that share a build range stage it from L2.  The probes
// need not be sorted within a tile; sorted ones search faster.
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
// write the same values.  Bound: memory latency, two chains of about
// log2(window) dependent loads a probe from L1/L2 (window_search); one
// thread per probe, 256 threads per block, so a block's probes share one
// tile's window.
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

__device__ __forceinline__ void cp_async16(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(int32_t* dst, const int32_t* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// first index of s_key[lo, len) whose key is > p, where s_key[lo] >= p:
// steps of 1, 2, 4, ... past the run's start, then a binary search in the
// last step
__device__ __forceinline__ int run_end(const int32_t* s_key, int len, int lo,
                                       int32_t p) {
  if (lo >= len || s_key[lo] != p) return lo;
  int a = lo + 1, step = 1;  // s_key[a - 1] == p
  int b = a;                 // candidate: s_key[b] > p or b == len
  while (b < len && s_key[b] == p) {
    a = b + 1;
    step <<= 1;
    b = a + step - 1;
  }
  int e = b < len ? b : len;
  while (a < e) {
    const int m = (a + e) >> 1;
    if (s_key[m] <= p) a = m + 1; else e = m;
  }
  return a;
}

// probes a thread searches side by side: their loads, the levels of
// their searches and their value loads are independent, so up to
// kGroup of each are in flight at once
constexpr int kGroup = 4;

__global__ void __launch_bounds__(1024)
merge_probe_gather_kernel(const int32_t* __restrict__ probe, int64_t n_tiles,
                          int64_t tile, int64_t chunks,
                          const int32_t* __restrict__ bhk,
                          const uint32_t* __restrict__ bval, int64_t n_build,
                          const int32_t* __restrict__ wrow, int64_t window,
                          int piece, uint32_t* __restrict__ mv,
                          int32_t* __restrict__ mc) {
  extern __shared__ int32_t s_key[];
  int64_t t, t_end;
  hjk::block_tiles(blockIdx.x, n_tiles, chunks, 1, &t, &t_end);
  if (t >= t_end) return;
  const int64_t start = hjk::window_start(wrow, t, window, n_build);
  const int64_t base = t * tile;
  const int64_t step = static_cast<int64_t>(kGroup) * blockDim.x;
  // the window starts on a multiple of 4 keys when n_build is one
  const bool vec = n_build % 4 == 0 && hjk::aligned16(bhk);
  int32_t p[kGroup];
  auto load_group = [&](int64_t g) {
#pragma unroll
    for (int k = 0; k < kGroup; ++k) {
      const int64_t i = g + k * blockDim.x + threadIdx.x;
      p[k] = i < tile ? probe[base + i] : hjk::kNullKey;
    }
  };
  for (int64_t w0 = 0; w0 < window; w0 += piece) {
    const int len = static_cast<int>(window - w0 < piece ? window - w0
                                                         : piece);
    const int32_t* src = bhk + start + w0;
    if (w0) __syncthreads();  // the previous piece is fully searched
    if (vec) {  // len is a multiple of 4: window and piece are of 128
      for (int j = 4 * threadIdx.x; j < len; j += 4 * blockDim.x) {
        cp_async16(s_key + j, src + j);
      }
    } else {
      for (int j = threadIdx.x; j < len; j += blockDim.x) {
        cp_async4(s_key + j, src + j);
      }
    }
    load_group(0);  // the first probes arrive while the window does
    cp_async_wait_all();
    __syncthreads();
    const int32_t first_key = s_key[0], last_key = s_key[len - 1];
    for (int64_t g = 0; g < tile; g += step) {
      if (g) load_group(g);
      // lower bounds, level by level: b[k] = first index whose key is
      // >= p[k] (a branchless search of len keys; len >= 128)
      int b[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) b[k] = 0;
      for (int n = len; n > 1;) {
        const int h = n >> 1;
#pragma unroll
        for (int k = 0; k < kGroup; ++k) {
          b[k] = s_key[b[k] + h] < p[k] ? b[k] + h : b[k];
        }
        n -= h;
      }
      int32_t count[kGroup];
      uint32_t value[kGroup];
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const bool live =
            p[k] != hjk::kNullKey && p[k] >= first_key && p[k] <= last_key;
        const int lo = b[k] + (s_key[b[k]] < p[k]);
        count[k] = live ? run_end(s_key, len, lo, p[k]) - lo : 0;
        b[k] = lo + count[k] - 1;  // the run's last slot
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        value[k] = count[k] ? __ldg(bval + start + w0 + b[k]) : 0u;
      }
#pragma unroll
      for (int k = 0; k < kGroup; ++k) {
        const int64_t i = g + k * blockDim.x + threadIdx.x;
        if (i >= tile) break;
        if (w0 == 0) {
          mc[base + i] = count[k];
          mv[base + i] = value[k];
        } else if (count[k]) {
          mc[base + i] += count[k];
          mv[base + i] = value[k];
        }
      }
    }
  }
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

// piece, threads: ops/merge_probe_gather.py's gather_geometry; chunks: the
// probe column's sorted runs of tiles
HJK_API int hjk_merge_probe_gather(const void* probe, int64_t cap,
                                   const void* bhk, const void* bval,
                                   int64_t n_build, const void* wrow,
                                   int64_t tile, int64_t window, void* mv,
                                   void* mc, int64_t chunks, int piece,
                                   int threads, void* stream) {
  const int64_t smem = 4 * static_cast<int64_t>(piece);
  if (piece < 128 || piece % 128 || smem > hjk::kMaxSmem || threads < 32 ||
      threads > 1024 || threads % 32 || tile < 1 || window < 1 ||
      window % 128 || window > n_build || chunks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = cap / tile;
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      merge_probe_gather_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = hjk::block_count(n_tiles, chunks, 1);
  merge_probe_gather_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probe), n_tiles, tile, chunks,
      static_cast<const int32_t*>(bhk), static_cast<const uint32_t*>(bval),
      n_build, static_cast<const int32_t*>(wrow), window, piece,
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
