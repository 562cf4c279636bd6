// Shared conventions of the port's CUDA kernels.
//
// Every column is 32-bit: keys are BIASED scrambled keys (hk ^ 0x80000000
// read as int32, so unsigned order is signed order and the null key 0 is
// INT32_MIN); values are the uint32 bits of the relation's payload.
// Entry points have a plain C interface for ctypes: every pointer and the
// stream arrive as void*, every size as int64_t.  They launch on the
// given stream, never synchronise, allocate nothing, and return
// cudaGetLastError() as an int (0 = launched).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define HJK_API extern "C" __attribute__((visibility("default")))

namespace hjk {

constexpr int32_t kNullKey = INT32_MIN;  // biased null key (hk == 0)
// dynamic shared memory one block may ask for on the H100 (227 KB)
constexpr int kMaxSmem = 232448;

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// first window slot of tile t: the row anchor, clamped so that the
// window lies inside the build side (the jnp oracle's dynamic_slice
// clamp; callers already clip anchors to rows_total - window / 128)
__device__ __forceinline__ int64_t window_start(const int32_t* wrow,
                                                int64_t t, int64_t window,
                                                int64_t n_build) {
  int64_t s = static_cast<int64_t>(wrow[t]) * 128;
  s = s < n_build - window ? s : n_build - window;
  return s > 0 ? s : 0;
}

// Tiles [*t0, *t1) of block b of a window probe.  The probe column holds
// `chunks` runs of tiles (each sorted on its own), so tiles at one
// position of every chunk cover about the same build range.  Blocks go
// position by position: block b takes chunk b % chunks, and within it
// the (b / chunks)-th run of `per_block` tiles, so the tiles that share
// a build range run together and their windows are fetched from device
// memory about once, then hit L2.  The grid has chunks * ceil(ceil(
// n_tiles / chunks) / per_block) blocks; a block past a short last chunk
// gets no tiles.  Scheduling only: no result depends on it.
__device__ __forceinline__ void block_tiles(int64_t b, int64_t n_tiles,
                                            int64_t chunks, int64_t per_block,
                                            int64_t* t0, int64_t* t1) {
  const int64_t per_chunk = (n_tiles + chunks - 1) / chunks;
  const int64_t c = b % chunks;
  const int64_t first = c * per_chunk + (b / chunks) * per_block;
  int64_t end = (c + 1) * per_chunk < n_tiles ? (c + 1) * per_chunk : n_tiles;
  end = first + per_block < end ? first + per_block : end;
  *t0 = first;
  *t1 = end > first ? end : first;
}

// grid size of block_tiles' order
inline int64_t block_count(int64_t n_tiles, int64_t chunks,
                           int64_t per_block) {
  const int64_t per_chunk = (n_tiles + chunks - 1) / chunks;
  return chunks * ((per_chunk + per_block - 1) / per_block);
}

}  // namespace hjk
