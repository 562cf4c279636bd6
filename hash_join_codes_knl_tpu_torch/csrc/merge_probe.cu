// K2: the dense window probe.
//
// Replaces the TPU kernel merge_probe_pallas (hash_join_codes_knl_tpu/
// ops/merge_probe_pallas.py: window_probe_call with
// _dense_row_result_factory).  Each probe of tile t looks at the build
// window [start, start + window), start = window_start(wrow, t); it gets
// the count of equal slots and the max matched value (unsigned), or 0.
// Null keys (INT32_MIN) never match, on either side.  The window need not
// be sorted: NPJ's parked table interleaves empty (null) slots, which are
// simply never inserted.
//
// The TPU kernel compares every probe with every window slot (896 compares
// a probe on NPJ's 16M x 256M table), work that grows with tile x window.
// The function needs one lookup per probe in a table of its window, so on
// this card the bound is bytes: the probes and anchors read once, the
// union of the tiles' windows (keys and values) read once, both outputs
// written once.  Design: the tile probe's shared-memory hash table
// (smem_table.cuh) with the tile's own window as the row.  A block takes
// a run of tiles of one chunk (block_tiles: the chunks' tiles position by
// position, so windows that overlap run together and hit L2); a segment
// is a run of its tiles with the same window start, found by a walk over
// the anchors (they need not be ordered).  For each segment the block
// reads the window once per round, from its 128-row anchor, inserts the
// live slots, and every probe of the segment does one lookup.  Rounds of
// at most `stage` live slots serve every width the engine sends: NPJ's
// 896 slots up to max_window, the narrow merge windows, and the dense
// fallback past 121 chunks.  ops/merge_probe.py's window_table_geometry
// computes stage, entries, threads and tiles per block.
#include "smem_table.cuh"

namespace {

__global__ void merge_probe_dense_kernel(
    const int32_t* __restrict__ probe, int64_t n_tiles, int64_t tile,
    int64_t chunks, int64_t tiles_per_block, const int32_t* __restrict__ bhk,
    const int32_t* __restrict__ bval, int64_t n_build,
    const int32_t* __restrict__ wrow, int64_t window,
    int32_t* __restrict__ mv, int32_t* __restrict__ mc, int stage,
    int entries) {
  extern __shared__ int32_t smem[];
  const hjk::Table table(smem, entries);
  __shared__ int s_warp[2][32];
  int parity = 0;
  // a window starts on a multiple of 4 slots (a 128-row anchor, or the
  // build side's end minus a 128-multiple window) when n_build is one
  const bool vec_row = n_build % 4 == 0 && hjk::aligned16(bhk) &&
                       hjk::aligned16(bval);
  const bool vec_probe = tile % 4 == 0 && hjk::aligned16(probe) &&
                         hjk::aligned16(mv) && hjk::aligned16(mc);
  int64_t t, t_end;
  hjk::block_tiles(blockIdx.x, n_tiles, chunks, tiles_per_block, &t, &t_end);
  while (t < t_end) {
    const int64_t start = hjk::window_start(wrow, t, window, n_build);
    int64_t t1 = t + 1;
    while (t1 < t_end &&
           hjk::window_start(wrow, t1, window, n_build) == start) {
      ++t1;
    }
    hjk::probe_segment(table, entries, stage, bhk + start, bval + start,
                       window, vec_row, probe, t * tile, t1 * tile, vec_probe,
                       mv, mc, s_warp, parity);
    t = t1;
  }
}

}  // namespace

// stage, entries, threads, tiles_per_block: ops/merge_probe.py's
// window_table_geometry; chunks: the probe column's sorted runs of tiles
HJK_API int hjk_merge_probe_dense(const void* probe, int64_t cap,
                                  const void* bhk, const void* bval,
                                  int64_t n_build, const void* wrow,
                                  int64_t tile, int64_t window, void* mv,
                                  void* mc, int64_t chunks, int stage,
                                  int entries, int threads,
                                  int64_t tiles_per_block, void* stream) {
  const int64_t smem = 12 * static_cast<int64_t>(entries);
  if (!hjk::table_geometry_ok(stage, entries, threads) || tile < 1 ||
      window < 1 || window > n_build || chunks < 1 || tiles_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_tiles = cap / tile;
  if (n_tiles <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err = cudaFuncSetAttribute(
      merge_probe_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = hjk::block_count(n_tiles, chunks, tiles_per_block);
  merge_probe_dense_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(probe), n_tiles, tile, chunks,
      tiles_per_block, static_cast<const int32_t*>(bhk),
      static_cast<const int32_t*>(bval), n_build,
      static_cast<const int32_t*>(wrow), window, static_cast<int32_t*>(mv),
      static_cast<int32_t*>(mc), stage, entries);
  return static_cast<int>(cudaGetLastError());
}
