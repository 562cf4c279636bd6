// The key scramble as one uint32 pass: out[i] = ((in[i] ^ xor_in) *
// factor) ^ xor_out, the multiply mod 2^32.
//
// Not the counterpart of a TPU kernel: on the TPU the scramble and the
// unscramble were uint32 multiplies that XLA fused into their
// neighbours (hash_join_codes_knl_tpu/utils/hashing.py hashed_key;
// engine/phj.py, `pk * inv` at the end of every PHJ mode).  torch has no
// uint32 multiply, so the port's plain version (ops/scramble.py
// mul_u32_torch) widens to int64 and splits the factor into 16-bit
// halves: about a dozen elementwise passes.  Unsigned wrap-around is
// defined in C++, so here it is one multiply in registers.  With xor_in
// = 0x80000000 the pass unbiases its input first (the unscramble of a
// sorted biased column); with xor_out = 0x80000000 it biases its output.
//
// Bound: memory bandwidth, 4 B read and 4 B written per slot.  Design:
// K1's grid-stride loop (csrc/chunk_layout.cu), 256 threads, at most 16
// blocks an SM; 16-byte loads and stores where both columns are 16-byte
// aligned (the last n % 4 slots one at a time), 4-byte ones otherwise.
#include "hjk.cuh"

namespace {

__device__ __forceinline__ uint32_t scramble(uint32_t x, uint32_t factor,
                                             uint32_t xor_in,
                                             uint32_t xor_out) {
  return ((x ^ xor_in) * factor) ^ xor_out;  // uint32 multiply wraps
}

template <bool kVec>
__global__ void mul_u32_kernel(const uint32_t* __restrict__ in, int64_t n,
                               uint32_t* __restrict__ out, uint32_t factor,
                               uint32_t xor_in, uint32_t xor_out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t scalar_from = 0;
  if (kVec) {
    const uint4* in4 = reinterpret_cast<const uint4*>(in);
    uint4* out4 = reinterpret_cast<uint4*>(out);
    const int64_t n4 = n / 4;
    for (int64_t i = first; i < n4; i += stride) {
      uint4 v = __ldg(in4 + i);
      v.x = scramble(v.x, factor, xor_in, xor_out);
      v.y = scramble(v.y, factor, xor_in, xor_out);
      v.z = scramble(v.z, factor, xor_in, xor_out);
      v.w = scramble(v.w, factor, xor_in, xor_out);
      out4[i] = v;
    }
    scalar_from = n4 * 4;
  }
  for (int64_t i = scalar_from + first; i < n; i += stride) {
    out[i] = scramble(__ldg(in + i), factor, xor_in, xor_out);
  }
}

}  // namespace

HJK_API int hjk_mul_u32(const void* in, int64_t n, void* out,
                        uint32_t factor, uint32_t xor_in, uint32_t xor_out,
                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = ((reinterpret_cast<uintptr_t>(in) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  constexpr int kThreads = 256;
  const int64_t items = vec ? (n + 3) / 4 : n;
  int64_t blocks = (items + kThreads - 1) / kThreads;
  const int64_t max_blocks = 132 * 16;  // 16 resident blocks per H100 SM
  if (blocks > max_blocks) blocks = max_blocks;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint32_t*>(in);
  auto* dst = static_cast<uint32_t*>(out);
  if (vec) {
    mul_u32_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        src, n, dst, factor, xor_in, xor_out);
  } else {
    mul_u32_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        src, n, dst, factor, xor_in, xor_out);
  }
  return static_cast<int>(cudaGetLastError());
}
