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
// once to scattered runs).  The histogram kernel runs at the memory rate
// (0.35 ms for 256M keys, traced on an H100 at 700 W).  The scatter is
// where the time goes: a tuple stored straight to its run is a lone
// 4-byte store, up to 32 different runs per warp-wide store, and wastes
// most of every sector it touches.  Design of the scatter:
// one block per tile, walking it in sub-chunks of 8 * blockDim tuples
// that it regroups in shared memory before writing.  Per sub-chunk each
// warp owns a contiguous segment and ranks its tuples 32 at a time in
// input order (__match_any_sync groups equal partition ids, the group's
// lowest lane bumps the warp's private counter, a popcount of the lower
// lanes of the group gives the rank); a scan over the warps and one over
// the partitions turn (partition, warp, rank) into a position in a
// shared-memory staging area laid out in partition order; the staged
// tuples are then written with neighbouring threads on neighbouring
// slots of a run, so stores fill whole sectors (runs start on 128-slot
// rows, 512-byte aligned).  A per-partition running offset in shared
// memory carries from one sub-chunk to the next; the loop inside the
// block is sequential, so within a run tuples keep their input order.
// The warps' counters are laid out (partition, warp) with a pad column,
// so neither the ranking nor the scan over warps meets a bank conflict.
#include "hjk.cuh"

namespace {

constexpr int kHistThreads = 256;
constexpr int kMaxFanout = 4096;  // 2^12: the histogram's shared array
constexpr int kPerLane = 8;       // tuples per thread and sub-chunk
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

// dynamic shared memory of the scatter, in 32-bit words: the staging
// area (keys, values), the warps' counters with their pad column, and
// four per-partition arrays (sub-chunk count, staging start, running
// offset, destination row)
__host__ __device__ constexpr int64_t scatter_smem_words(int threads, int F) {
  return 2 * static_cast<int64_t>(threads) * kPerLane +
         static_cast<int64_t>(F) * (threads / 32 + 1) + 4 * F;
}

__global__ void __launch_bounds__(1024)
radix_scatter_kernel(const int32_t* __restrict__ keys,
                     const int32_t* __restrict__ vals, int64_t n,
                     int64_t tile, int64_t n_tiles, int bits, int skip,
                     const int32_t* __restrict__ dst,
                     int32_t* __restrict__ out_k,
                     int32_t* __restrict__ out_v) {
  extern __shared__ int32_t smem[];
  __shared__ int s_wtot[32];
  const int F = 1 << bits;
  const int T = blockDim.x;
  const int W = T >> 5;
  const int S = T * kPerLane;  // tuples per sub-chunk
  const int tid = threadIdx.x;
  const int w = tid >> 5;
  const int lane = tid & 31;
  const unsigned lower = (1u << lane) - 1u;
  int32_t* s_k = smem;                // (S,) staged keys
  int32_t* s_v = s_k + S;             // (S,) staged values
  int* s_hist = s_v + S;              // (F, W + 1): counters of the warps
  int* s_cnt = s_hist + F * (W + 1);  // (F,) tuples of this sub-chunk
  int* s_start = s_cnt + F;           // (F,) first staging position
  int* s_off = s_start + F;           // (F,) tuples of earlier sub-chunks
  int* s_dst = s_off + F;             // (F,) destination row
  int* mine = s_hist + w;             // this warp's column, stride W + 1
  const int hs = W + 1;

  const int64_t g = blockIdx.x;
  const int64_t region0 = (g / n_tiles) * n;
  const int64_t lo = (g % n_tiles) * tile;
  const int64_t hi = lo + tile < n ? lo + tile : n;
  for (int p = tid; p < F; p += T) {
    s_cnt[p] = 0;
    s_off[p] = 0;
    s_dst[p] = dst[g * F + p];
  }
  __syncthreads();

  for (int64_t c0 = lo; c0 < hi; c0 += S) {
    // this warp's segment: 32 consecutive tuples per step, in order
    int32_t key[kPerLane], val[kPerLane];
    const int64_t seg0 = c0 + static_cast<int64_t>(w) * 32 * kPerLane + lane;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int64_t i = seg0 + k * 32;
      key[k] = i < hi ? keys[region0 + i] : hjk::kNullKey;
      val[k] = i < hi ? vals[region0 + i] : 0;
    }
    for (int p = lane; p < F; p += 32) mine[p * hs] = 0;
    __syncwarp();
    int rank[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int p = pid_of(key[k], bits, skip);
      const unsigned peers = __match_any_sync(kFull, p);
      const int leader = __ffs(peers) - 1;
      int base = 0;
      if (lane == leader && p < F) {
        base = mine[p * hs];
        mine[p * hs] = base + __popc(peers);
      }
      base = __shfl_sync(kFull, base, leader);
      rank[k] = base + __popc(peers & lower);
      __syncwarp();  // the counters are written before the next step reads
    }
    __syncthreads();

    // per partition, an exclusive scan of the warps' counts (one lane per
    // warp); the running offset takes in the sub-chunk before this one
    for (int idx = tid; idx < F * 32; idx += T) {
      const int p = idx >> 5;
      const int c = lane < W ? s_hist[p * hs + lane] : 0;
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      if (lane < W) s_hist[p * hs + lane] = incl - c;
      if (lane == 31) {
        s_off[p] += s_cnt[p];
        s_cnt[p] = incl;
      }
    }
    __syncthreads();

    // an exclusive scan of the partitions' counts: the staging layout
    int carry = 0;
    for (int base = 0; base < F; base += T) {
      const int p = base + tid;
      const int c = p < F ? s_cnt[p] : 0;
      int incl = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      if (lane == 31) s_wtot[w] = incl;
      __syncthreads();
      int before = 0, total = 0;
      for (int v = 0; v < W; ++v) {
        const int x = s_wtot[v];
        before += v < w ? x : 0;
        total += x;
      }
      if (p < F) s_start[p] = carry + before + incl - c;
      carry += total;
      __syncthreads();
    }
    const int staged = carry;

#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int p = pid_of(key[k], bits, skip);
      if (p < F) {
        const int at = s_start[p] + mine[p * hs] + rank[k];
        s_k[at] = key[k];
        s_v[at] = val[k];
      }
    }
    __syncthreads();

    // neighbouring threads write neighbouring slots of a run
    for (int j = tid; j < staged; j += T) {
      const int32_t k = s_k[j];
      const int p = pid_of(k, bits, skip);
      const int32_t d = s_dst[p];
      if (d >= 0) {
        const int64_t slot =
            static_cast<int64_t>(d) * 128 + s_off[p] + (j - s_start[p]);
        out_k[slot] = k;
        out_v[slot] = s_v[j];
      }
    }
    // the next sub-chunk's barriers come before it touches what this
    // write-out reads
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
// prefilled with the null key and 0.  threads: ops/radix_partition.py's
// scatter_geometry (a multiple of 32 whose shared memory fits)
HJK_API int hjk_radix_scatter(const void* keys, const void* vals,
                              int64_t regions, int64_t n, int64_t tile,
                              int64_t n_tiles, int bits, int skip,
                              const void* dst, void* out_k, void* out_v,
                              int threads, void* stream) {
  const int64_t blocks = regions * n_tiles;
  if (bits < 1 || (1 << bits) > kMaxFanout || skip < 0 || skip > 31 ||
      threads < 32 || threads > 1024 || threads % 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = 4 * scatter_smem_words(threads, 1 << bits);
  if (smem > hjk::kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      radix_scatter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  radix_scatter_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(keys), static_cast<const int32_t*>(vals), n,
      tile, n_tiles, bits, skip, static_cast<const int32_t*>(dst),
      static_cast<int32_t*>(out_k), static_cast<int32_t*>(out_v));
  return static_cast<int>(cudaGetLastError());
}
