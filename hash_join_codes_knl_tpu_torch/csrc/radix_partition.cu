// One radix-partition pass: per-tile histogram, then a stable scatter.
//
// Replaces the TPU kernel radix_partition_pallas (hash_join_codes_knl_tpu/
// ops/radix_partition_pallas.py, body _scatter_kernel).  A pass routes
// each tuple by hash bits [31-skip, 31-skip-bits] (the key rotated left
// by skip, top `bits` bits) into F = 2^bits partition regions; null keys
// (INT32_MIN) are dropped.  The input is cut into tiles; tile i's run of
// partition p goes to the destination row dst[i][p] that the wrapper
// computed from this file's histogram by an exclusive scan over tiles
// (dst < 0: empty run or overflow, not written).  `regions` independent
// inputs of n slots each are partitioned in one launch: tile g belongs
// to region g / n_tiles.
//
// The TPU kernel sorted each tile to group it, staged whole 128-slot rows
// per run in VMEM and wrote them with DMAs, zeros included, relying on
// the grid running in order so that the next run overwrote the zero tail.
// Here blocks run in no order, so the wrapper fills the outputs with the
// null key first and the kernel writes live slots only.  There is no
// sort: within a run, tuples keep their input order (a stable scatter).
//
// Bound: memory traffic (keys read twice and values once, both written
// once to scattered runs).  Design: one block per tile.  Each warp owns
// a contiguous segment of the tile and counts its partitions in a
// private shared-memory histogram (warp __match_any_sync groups equal
// partition ids, and the lowest lane of a group adds its size); an
// exclusive scan over the warps gives each warp its first rank per
// partition; a second sweep ranks each tuple within its warp's group by
// a popcount of the lower lanes of the group and writes it.
#include "hjk.cuh"

namespace {

constexpr int kHistThreads = 256;
constexpr int kMaxFanout = 4096;  // 2^12: the histogram's shared array
constexpr int kMaxWarps = 16;
constexpr int kScatterSmem = 96 * 1024;  // per-warp histograms
constexpr unsigned kFull = 0xffffffffu;

// partition id of a biased key, F for the null key
__device__ __forceinline__ int pid_of(int32_t key, int bits, int skip) {
  if (key == hjk::kNullKey) return 1 << bits;
  const uint32_t u = static_cast<uint32_t>(key) ^ 0x80000000u;
  const uint32_t rot = skip ? (u << skip) | (u >> (32 - skip)) : u;
  return static_cast<int>(rot >> (32 - bits));
}

__global__ void __launch_bounds__(kHistThreads)
radix_histogram_kernel(const int32_t* __restrict__ keys, int64_t n,
                       int64_t tile, int64_t n_tiles, int bits, int skip,
                       int32_t* __restrict__ cnt) {
  __shared__ int s_hist[kMaxFanout];
  const int F = 1 << bits;
  for (int p = threadIdx.x; p < F; p += kHistThreads) s_hist[p] = 0;
  __syncthreads();
  const int64_t g = blockIdx.x;
  const int64_t region0 = (g / n_tiles) * n;
  const int64_t lo = (g % n_tiles) * tile;
  const int64_t hi = lo + tile < n ? lo + tile : n;
  for (int64_t i = lo + threadIdx.x; i < hi; i += kHistThreads) {
    const int p = pid_of(keys[region0 + i], bits, skip);
    if (p < F) atomicAdd(&s_hist[p], 1);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < F; p += kHistThreads) {
    cnt[g * F + p] = s_hist[p];
  }
}

__global__ void radix_scatter_kernel(const int32_t* __restrict__ keys,
                                     const int32_t* __restrict__ vals,
                                     int64_t n, int64_t tile, int64_t n_tiles,
                                     int bits, int skip,
                                     const int32_t* __restrict__ dst,
                                     int32_t* __restrict__ out_k,
                                     int32_t* __restrict__ out_v) {
  extern __shared__ int s_hist[];  // (warps, F): next rank per partition
  const int F = 1 << bits;
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const unsigned lower = (1u << lane) - 1u;
  int* mine = s_hist + w * F;
  for (int p = lane; p < F; p += 32) mine[p] = 0;
  __syncwarp();

  const int64_t g = blockIdx.x;
  const int64_t region0 = (g / n_tiles) * n;
  const int64_t lo = (g % n_tiles) * tile;
  const int64_t hi = lo + tile < n ? lo + tile : n;
  const int64_t seg = ((hi - lo + warps - 1) / warps + 31) & ~int64_t{31};
  const int64_t s0 = lo + w * seg;
  const int64_t s1 = s0 + seg < hi ? s0 + seg : hi;

  for (int64_t b = s0; b < s1; b += 32) {
    const int64_t i = b + lane;
    const int p = i < s1 ? pid_of(keys[region0 + i], bits, skip) : F;
    const unsigned peers = __match_any_sync(kFull, p);
    if (p < F && (peers & lower) == 0) mine[p] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  for (int p = threadIdx.x; p < F; p += blockDim.x) {
    int run = 0;
    for (int v = 0; v < warps; ++v) {
      const int c = s_hist[v * F + p];
      s_hist[v * F + p] = run;
      run += c;
    }
  }
  __syncthreads();

  const int32_t* drow = dst + g * F;
  for (int64_t b = s0; b < s1; b += 32) {
    const int64_t i = b + lane;
    const int32_t key = i < s1 ? keys[region0 + i] : hjk::kNullKey;
    const int p = pid_of(key, bits, skip);
    const unsigned peers = __match_any_sync(kFull, p);
    const int first = p < F ? mine[p] : 0;
    __syncwarp();  // every lane has read its group's base
    if (p < F) {
      if ((peers & lower) == 0) mine[p] = first + __popc(peers);
      const int32_t d = drow[p];
      if (d >= 0) {
        const int64_t slot =
            static_cast<int64_t>(d) * 128 + first + __popc(peers & lower);
        out_k[slot] = key;
        out_v[slot] = vals[region0 + i];
      }
    }
    __syncwarp();
  }
}

}  // namespace

// cnt: (regions * n_tiles, F) int32, every entry written
HJK_API int hjk_radix_histogram(const void* keys, int64_t regions, int64_t n,
                                int64_t tile, int64_t n_tiles, int bits,
                                int skip, void* cnt, void* stream) {
  const int64_t blocks = regions * n_tiles;
  if (bits < 1 || (1 << bits) > kMaxFanout || skip < 0 || skip > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  radix_histogram_kernel<<<static_cast<unsigned>(blocks), kHistThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), n, tile, n_tiles, bits, skip,
      static_cast<int32_t*>(cnt));
  return static_cast<int>(cudaGetLastError());
}

// dst: (regions * n_tiles, F) int32 destination rows; out_k / out_v are
// prefilled with the null key and 0
HJK_API int hjk_radix_scatter(const void* keys, const void* vals,
                              int64_t regions, int64_t n, int64_t tile,
                              int64_t n_tiles, int bits, int skip,
                              const void* dst, void* out_k, void* out_v,
                              void* stream) {
  const int64_t blocks = regions * n_tiles;
  if (bits < 1 || (1 << bits) > kMaxFanout || skip < 0 || skip > 31) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  const int F = 1 << bits;
  int warps = kScatterSmem / (F * static_cast<int>(sizeof(int)));
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  const size_t smem = static_cast<size_t>(warps) * F * sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_scatter_kernel<<<static_cast<unsigned>(blocks), warps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals), n,
      tile, n_tiles, bits, skip, static_cast<const int32_t*>(dst),
      static_cast<int32_t*>(out_k), static_cast<int32_t*>(out_v));
  return static_cast<int>(cudaGetLastError());
}
