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

}  // namespace hjk
