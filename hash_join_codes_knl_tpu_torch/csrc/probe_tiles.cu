// The tile probe of the padded PHJ.
//
// Replaces the TPU kernel probe_tiles_pallas (hash_join_codes_knl_tpu/
// ops/probe_pallas.py: _probe_call, body _probe_kernel).  Probe tile t
// (slots [t*tile, (t+1)*tile) of the padded layout) is held against
// table row tile_pid[t]; each probe gets the count of equal slots and the
// max matched value (unsigned), or 0.  Null keys (INT32_MIN) never
// match, on either side.
//
// The TPU kernel compares every probe with every slot of the row (about
// 10^12 compares at the 4096-way radix plan).  The function needs one
// lookup per probe, so on this card the bound is bytes: probes, tile ids
// and the rows used read once, both outputs written
// once.  Design: a block takes a run of whole tiles (tile_pid is
// non-decreasing, so the run covers one or a few partitions; a segment's
// end is found by bisection).  For each partition the run touches, the
// block builds an open-addressing hash table of the row in dynamic
// shared memory and every probe of the segment looks its key up there
// (smem_table.cuh: the table, its rounds and the key mix, shared with
// K2).  The radix plan's 9216-slot rows hold about 3900 live slots and
// take one round of the 16384-entry table.  ops/probe.py computes stage,
// entries, threads and the block's share of tiles.
#include "smem_table.cuh"

namespace {

__global__ void probe_tiles_kernel(const int32_t* __restrict__ probe,
                                   int64_t n_tiles, int64_t tile,
                                   int64_t tiles_per_block,
                                   const int32_t* __restrict__ tk,
                                   const int32_t* __restrict__ tv,
                                   int64_t slots,
                                   const int32_t* __restrict__ tile_pid,
                                   int32_t* __restrict__ mv,
                                   int32_t* __restrict__ mc, int stage,
                                   int entries) {
  extern __shared__ int32_t smem[];
  const hjk::Table table(smem, entries);
  __shared__ int s_warp[2][32];
  int parity = 0;
  // 16-byte accesses where every row and every thread's four probes
  // start on a 16-byte boundary
  const bool vec_row =
      slots % 4 == 0 && hjk::aligned16(tk) && hjk::aligned16(tv);
  const bool vec_probe = tile % 4 == 0 && hjk::aligned16(probe) &&
                         hjk::aligned16(mv) && hjk::aligned16(mc);

  int64_t t = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  const int64_t t_end_blk =
      t + tiles_per_block < n_tiles ? t + tiles_per_block : n_tiles;
  while (t < t_end_blk) {
    // the segment: consecutive tiles of one partition (its end is the
    // first tile of the block's run with a larger partition id)
    const int32_t pid = tile_pid[t];
    int64_t lo = t + 1, hi = t_end_blk;
    while (lo < hi) {
      const int64_t mid = lo + (hi - lo) / 2;
      if (tile_pid[mid] == pid) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t p0 = t * tile, p1 = lo * tile;
    t = lo;
    hjk::probe_segment(table, entries, stage,
                       tk + static_cast<int64_t>(pid) * slots,
                       tv + static_cast<int64_t>(pid) * slots, slots, vec_row,
                       probe, p0, p1, vec_probe, mv, mc, s_warp, parity);
  }
}

}  // namespace

// stage, entries, threads, tiles_per_block: ops/probe.py's table_geometry
HJK_API int hjk_probe_tiles(const void* probe, int64_t n_tiles, int64_t tile,
                            const void* tk, const void* tv, int64_t slots,
                            const void* tile_pid, void* mv, void* mc,
                            int stage, int entries, int threads,
                            int64_t tiles_per_block, void* stream) {
  const int64_t smem = 12 * static_cast<int64_t>(entries);
  if (!hjk::table_geometry_ok(stage, entries, threads) ||
      tiles_per_block < 1 || tile < 1 || slots < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      probe_tiles_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = (n_tiles + tiles_per_block - 1) / tiles_per_block;
  probe_tiles_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probe), n_tiles, tile, tiles_per_block,
      static_cast<const int32_t*>(tk), static_cast<const int32_t*>(tv), slots,
      static_cast<const int32_t*>(tile_pid), static_cast<int32_t*>(mv),
      static_cast<int32_t*>(mc), stage, entries);
  return static_cast<int>(cudaGetLastError());
}
