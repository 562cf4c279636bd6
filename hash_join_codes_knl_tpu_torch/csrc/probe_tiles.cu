// The tile probe of the padded PHJ.
//
// Replaces the TPU kernel probe_tiles_pallas (hash_join_codes_knl_tpu/
// ops/probe_pallas.py: _probe_call, body _probe_kernel).  Probe tile t
// (slots [t*tile, (t+1)*tile) of the padded layout) is compared with
// every slot of table row tile_pid[t]; each probe gets the count of equal
// slots and the max matched value (unsigned), or 0.  Null keys
// (INT32_MIN) never match: they are dropped from the staged table row,
// and a null probe then finds nothing.  Count and max do not depend on
// slot order, so the row may be compacted in any order.
//
// Bound: compares, (probes) x (live slots of their row).  Design: one
// block sweeps a run of whole tiles (tile_pid is non-decreasing, so the
// run covers one or a few partitions).  For each partition the run
// touches, the row streams through shared memory in stages of kStage
// slots with its null slots compacted away (a warp ballot and one
// shared counter), so pad slots cost no compares.  Every thread keeps
// kPerThread consecutive probes and their accumulators in registers and
// reads each staged key once (a broadcast read); a value is read only on
// a match.  A warp whose probes are all null (the pad tail of a region)
// skips the sweep, and a block with no live probe skips the staging.
#include "hjk.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kGroup = kThreads * kPerThread;  // probes per sweep
constexpr int kStage = 2048;                   // 16 KB of keys + values
constexpr int64_t kBlockProbes = 8192;         // probe slots per block
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
probe_tiles_kernel(const int32_t* __restrict__ probe, int64_t n_tiles,
                   int64_t tile, int64_t tiles_per_block,
                   const int32_t* __restrict__ tk,
                   const uint32_t* __restrict__ tv, int64_t slots,
                   const int32_t* __restrict__ tile_pid,
                   uint32_t* __restrict__ mv, int32_t* __restrict__ mc) {
  __shared__ int32_t s_key[kStage];
  __shared__ uint32_t s_val[kStage];
  __shared__ int s_n;
  const int lane = threadIdx.x & 31;
  int64_t t = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  const int64_t t_end_blk =
      t + tiles_per_block < n_tiles ? t + tiles_per_block : n_tiles;
  while (t < t_end_blk) {
    // the segment: consecutive tiles of one partition
    const int32_t pid = tile_pid[t];
    int64_t seg_end = t + 1;
    while (seg_end < t_end_blk && tile_pid[seg_end] == pid) ++seg_end;
    const int64_t p1 = seg_end * tile;
    const int32_t* row_k = tk + static_cast<int64_t>(pid) * slots;
    const uint32_t* row_v = tv + static_cast<int64_t>(pid) * slots;

    for (int64_t g = t * tile; g < p1; g += kGroup) {
      const int64_t base = g + static_cast<int64_t>(threadIdx.x) * kPerThread;
      int32_t pk[kPerThread];
      int32_t cnt[kPerThread];
      uint32_t mx[kPerThread];
      bool dead = true;
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        pk[k] = base + k < p1 ? probe[base + k] : hjk::kNullKey;
        dead = dead && pk[k] == hjk::kNullKey;
        cnt[k] = 0;
        mx[k] = 0u;
      }
      const bool warp_dead = __all_sync(kFull, dead);
      if (__syncthreads_or(!dead)) {
        for (int64_t w0 = 0; w0 < slots; w0 += kStage) {
          const int len =
              static_cast<int>(slots - w0 < kStage ? slots - w0 : kStage);
          const int len_warps = (len + 31) & ~31;  // whole warps ballot
          if (threadIdx.x == 0) s_n = 0;
          __syncthreads();
          for (int j = threadIdx.x; j < len_warps; j += kThreads) {
            const int32_t key = j < len ? row_k[w0 + j] : hjk::kNullKey;
            const bool live = key != hjk::kNullKey;
            const unsigned ball = __ballot_sync(kFull, live);
            int at = 0;
            if (lane == 0 && ball) at = atomicAdd(&s_n, __popc(ball));
            at = __shfl_sync(kFull, at, 0);
            if (live) {
              const int pos = at + __popc(ball & ((1u << lane) - 1u));
              s_key[pos] = key;
              s_val[pos] = row_v[w0 + j];
            }
          }
          __syncthreads();
          const int n = s_n;
          if (!warp_dead) {
            for (int j = 0; j < n; ++j) {
              const int32_t key = s_key[j];
#pragma unroll
              for (int k = 0; k < kPerThread; ++k) {
                if (pk[k] == key) {
                  ++cnt[k];
                  const uint32_t val = s_val[j];
                  mx[k] = mx[k] > val ? mx[k] : val;
                }
              }
            }
          }
          __syncthreads();  // the stage is consumed before the next one
        }
      }
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        if (base + k < p1) {
          mc[base + k] = cnt[k];
          mv[base + k] = mx[k];
        }
      }
    }
    t = seg_end;
  }
}

}  // namespace

HJK_API int hjk_probe_tiles(const void* probe, int64_t n_tiles, int64_t tile,
                            const void* tk, const void* tv, int64_t slots,
                            const void* tile_pid, void* mv, void* mc,
                            void* stream) {
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  const int64_t tpb = tile < kBlockProbes ? kBlockProbes / tile : 1;
  const int64_t blocks = (n_tiles + tpb - 1) / tpb;
  probe_tiles_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probe), n_tiles, tile, tpb,
      static_cast<const int32_t*>(tk), static_cast<const uint32_t*>(tv),
      slots, static_cast<const int32_t*>(tile_pid),
      static_cast<uint32_t*>(mv), static_cast<int32_t*>(mc));
  return static_cast<int>(cudaGetLastError());
}
