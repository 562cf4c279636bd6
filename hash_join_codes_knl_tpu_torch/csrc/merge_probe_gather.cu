// K3, the wide-window probe, and K4, its indexed pass: one kernel body
// that searches a window staged in shared memory.
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
// K4 replaces window_probe_call_indexed (hash_join_codes_knl_tpu/ops/
// merge_probe_pallas.py, via merge_probe_gather_indexed): the wide pass
// of the two-class window geometry.  It is the same function over the
// tiles listed in tile_idx, entry j at anchor wrow_c[j], written in place
// over the first pass's (mv, mc); every other slot keeps its value.  The
// TPU kernel took the list as a scalar-prefetch operand and wrote through
// an aliased, index-mapped output block.
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
// hit, take their later (larger) value.  The probes need not be sorted
// within a tile; sorted ones search faster.
//
// The two differ only in which tile a block takes and where its anchor
// comes from.  K3's blocks go position by position over the probe's
// sorted chunks (hjk::block_tiles), so the tiles that share a build range
// stage it from L2.  K4's blocks go position by position over `chunks`
// runs of the list (hjk::block_entry), one block per entry: for the
// engine's ascending lists, the entries of one chunk position run
// together as K3's tiles do.  An entry outside the probe's tiles makes
// the whole block return before it stages anything, and writes
// nothing.  K4's window is one piece (the wrapper refuses a wider one, as
// the JAX wrapper does), so every listed slot takes one plain store of
// its (count, value): an entry that repeats a tile carries the same
// anchor, and its two blocks store the same values.
#include "hjk.cuh"

namespace {

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

// kIndexed = false: K3, block b takes tile t = block_tiles(b) at anchor
// wrow[t]; true: K4, block b takes list entry j = block_entry(b) of the
// n_idx in tile_idx, tile tile_idx[j] at anchor wrow[j]
template <bool kIndexed>
__global__ void __launch_bounds__(1024)
merge_probe_gather_kernel(const int32_t* __restrict__ probe, int64_t n_tiles,
                          int64_t tile, int64_t chunks,
                          const int32_t* __restrict__ tile_idx,
                          int64_t n_idx, const int32_t* __restrict__ bhk,
                          const uint32_t* __restrict__ bval, int64_t n_build,
                          const int32_t* __restrict__ wrow, int64_t window,
                          int piece, uint32_t* __restrict__ mv,
                          int32_t* __restrict__ mc) {
  extern __shared__ int32_t s_key[];
  int64_t t, anchor;
  if constexpr (kIndexed) {
    if (!hjk::block_entry(blockIdx.x, n_idx, chunks, &anchor)) return;
    t = tile_idx[anchor];
    if (t < 0 || t >= n_tiles) return;  // an id past the probe: no write
  } else {
    int64_t t_end;
    hjk::block_tiles(blockIdx.x, n_tiles, chunks, 1, &t, &t_end);
    if (t >= t_end) return;
    anchor = t;
  }
  const int64_t start = hjk::window_start(wrow, anchor, window, n_build);
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

// the checks and the launch of both entry points: n_blocks blocks of
// `threads`, `piece` window keys of shared memory each
template <bool kIndexed>
int launch(const void* probe, int64_t cap, const void* tile_idx,
           int64_t n_idx, int64_t n_blocks, const void* bhk, const void* bval,
           int64_t n_build, const void* wrow, int64_t tile, int64_t window,
           void* mv, void* mc, int64_t chunks, int piece, int threads,
           void* stream) {
  const int64_t smem = 4 * static_cast<int64_t>(piece);
  if (piece < 128 || piece % 128 || smem > hjk::kMaxSmem || threads < 32 ||
      threads > 1024 || threads % 32 || tile < 1 || window < 1 ||
      window % 128 || window > n_build || chunks < 1 ||
      (kIndexed && window > piece)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = cap / tile;
  if (n_tiles <= 0 || n_blocks <= 0) {
    return static_cast<int>(cudaGetLastError());
  }
  cudaError_t err = cudaFuncSetAttribute(
      merge_probe_gather_kernel<kIndexed>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  merge_probe_gather_kernel<kIndexed>
      <<<static_cast<unsigned>(n_blocks), threads, smem,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const int32_t*>(probe), n_tiles, tile, chunks,
          static_cast<const int32_t*>(tile_idx), n_idx,
          static_cast<const int32_t*>(bhk),
          static_cast<const uint32_t*>(bval), n_build,
          static_cast<const int32_t*>(wrow), window, piece,
          static_cast<uint32_t*>(mv), static_cast<int32_t*>(mc));
  return static_cast<int>(cudaGetLastError());
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
  const int64_t blocks =
      chunks < 1 || tile < 1 ? 0 : hjk::block_count(cap / tile, chunks, 1);
  return launch<false>(probe, cap, nullptr, 0, blocks, bhk, bval, n_build,
                       wrow, tile, window, mv, mc, chunks, piece, threads,
                       stream);
}

// the indexed pass: one block for each of the n_idx list entries, in
// block_entry's order over `chunks` runs of the list, written in place
// into mv and mc (the first pass's outputs, cap slots like probe); an
// entry outside [0, cap / tile) is skipped.  The window must be one piece.
HJK_API int hjk_merge_probe_gather_indexed(
    const void* probe, int64_t cap, const void* bhk, const void* bval,
    int64_t n_build, const void* wrow_c, const void* tile_idx, int64_t n_idx,
    int64_t tile, int64_t window, void* mv, void* mc, int64_t chunks,
    int piece, int threads, void* stream) {
  const int64_t blocks =
      chunks < 1 || n_idx < 1 ? 0 : hjk::block_count(n_idx, chunks, 1);
  return launch<true>(probe, cap, tile_idx, n_idx, blocks, bhk, bval,
                      n_build, wrow_c, tile, window, mv, mc, chunks, piece,
                      threads, stream);
}
