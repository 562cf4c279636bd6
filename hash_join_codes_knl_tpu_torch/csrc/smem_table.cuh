// The shared-memory hash table of the tile probe (probe_tiles.cu) and of
// the dense window probe K2 (merge_probe.cu).
//
// A segment is a run of probe slots [p0, p1) that all look up one row of
// build slots (the tile probe: a partition's table row; K2: the tiles'
// common window).  The block builds an open-addressing table of the row
// in dynamic shared memory, entries (key, count, max value): a slot is
// claimed by atomicCAS on the key (empty = the null key, which no live
// key equals), then atomicAdd on the count and atomicMax on the value,
// so duplicate build keys (M:N) collapse into one entry with the exact
// count and max.  Every probe then hashes, walks to its key or to an
// empty entry, and takes the entry's count and max: 16-byte loads of
// four probes a thread, 16-byte stores of both outputs where the
// alignment allows.  Null slots are never inserted, and a null probe
// skips the walk.
//
// A round of the table holds at most `stage` live slots (entries >= 2 *
// stage, so a walk always meets an empty entry).  The row is read in
// chunks of 4 * blockDim slots; a round takes whole chunks while its
// live slots stay within `stage`.  Rows with more live slots take more
// rounds: the first round writes the outputs, a later one re-reads the
// probes and adds its counts and maxes into them on a hit.  Counts add
// and maxes combine across rounds, so one kernel serves rows of any
// width.
//
// The table index is a full-avalanche mix of the key (murmur3's
// finalizer), not its top bits: a partition's keys share their top bits,
// and a window's keys share a key or home-bucket range.  ops/probe.py
// mirrors the mix (table_index).
#pragma once

#include "hjk.cuh"

namespace hjk {

__device__ __forceinline__ uint32_t mix(int32_t key) {
  uint32_t x = static_cast<uint32_t>(key);
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

// four consecutive 32-bit words from p[i..i+4), `fill` past `end`
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ p,
                                      int64_t i, int64_t end, bool vec,
                                      int32_t fill) {
  if (vec && i + 4 <= end) {
    return *reinterpret_cast<const int4*>(p + i);
  }
  int4 r;
  r.x = i < end ? p[i] : fill;
  r.y = i + 1 < end ? p[i + 1] : fill;
  r.z = i + 2 < end ? p[i + 2] : fill;
  r.w = i + 3 < end ? p[i + 3] : fill;
  return r;
}

__device__ __forceinline__ void store4(int32_t* __restrict__ p, int64_t i,
                                       int64_t end, bool vec, int4 v) {
  if (vec && i + 4 <= end) {
    *reinterpret_cast<int4*>(p + i) = v;
    return;
  }
  if (i < end) p[i] = v.x;
  if (i + 1 < end) p[i + 1] = v.y;
  if (i + 2 < end) p[i + 2] = v.z;
  if (i + 3 < end) p[i + 3] = v.w;
}

struct Table {
  int32_t* key;
  int32_t* cnt;
  uint32_t* top;
  uint32_t mask;

  // the table over `entries` (a power of two) entries of 12 bytes at smem
  __device__ __forceinline__ Table(int32_t* smem, int entries)
      : key(smem),
        cnt(smem + entries),
        top(reinterpret_cast<uint32_t*>(smem + 2 * entries)),
        mask(static_cast<uint32_t>(entries - 1)) {}

  __device__ __forceinline__ void insert(int32_t k, uint32_t v) const {
    if (k == kNullKey) return;
    uint32_t i = mix(k) & mask;
    while (true) {
      const int32_t prev = atomicCAS(&key[i], kNullKey, k);
      if (prev == kNullKey || prev == k) break;
      i = (i + 1) & mask;
    }
    atomicAdd(&cnt[i], 1);
    atomicMax(&top[i], v);
  }

  __device__ __forceinline__ void find(int32_t k, int32_t& c,
                                       uint32_t& m) const {
    c = 0;
    m = 0u;
    if (k == kNullKey) return;
    uint32_t i = mix(k) & mask;
    while (true) {
      const int32_t at = key[i];
      if (at == k) {
        c = cnt[i];
        m = top[i];
        return;
      }
      if (at == kNullKey) return;
      i = (i + 1) & mask;
    }
  }
};

// the block's sum of x; `warp_sums` must not be reused before the block's
// next barrier (callers alternate two arrays)
__device__ __forceinline__ int block_sum(int x, int* warp_sums) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xffffffffu, x, d);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    total += warp_sums[w];
  }
  return total;
}

// One segment: the probe slots [p0, p1) against the `slots` build slots
// (row_k, row_v), in as many rounds of the table as the row's live slots
// need; writes mc and mv over [p0, p1).  Every thread of the block calls
// it with the same arguments.  `s_warp` is two arrays of 32 ints that the
// block alternates through `parity`.
__device__ __forceinline__ void probe_segment(
    const Table& table, int entries, int stage,
    const int32_t* __restrict__ row_k, const int32_t* __restrict__ row_v,
    int64_t slots, bool vec_row, const int32_t* __restrict__ probe,
    int64_t p0, int64_t p1, bool vec_probe, int32_t* __restrict__ mv,
    int32_t* __restrict__ mc, int (*s_warp)[32], int& parity) {
  const int tid = threadIdx.x;
  const int64_t chunk = 4 * static_cast<int64_t>(blockDim.x);
  int64_t w0 = 0;
  bool first = true;
  do {
    for (int i = tid; i < entries; i += blockDim.x) {
      table.key[i] = kNullKey;
      table.cnt[i] = 0;
      table.top[i] = 0u;
    }
    __syncthreads();
    // one round: whole chunks while the live slots fit the table.  A
    // chunk holds at most 4 * blockDim <= stage slots, so an empty round
    // always takes one, and a later round starts on a chunk with live
    // slots.  Once the slots left fit the room left, nothing is counted.
    int room = stage;
    while (w0 < slots) {
      const int64_t j = w0 + 4 * static_cast<int64_t>(tid);
      const int4 k = load4(row_k, j, slots, vec_row, kNullKey);
      const int live = (k.x != kNullKey) + (k.y != kNullKey) +
                       (k.z != kNullKey) + (k.w != kNullKey);
      if (slots - w0 > room) {
        const int chunk_live = block_sum(live, s_warp[parity]);
        parity ^= 1;
        if (chunk_live > room) break;  // the same for every thread
        room -= chunk_live;
      }
      if (live) {
        const int4 v = load4(row_v, j, slots, vec_row, 0);
        table.insert(k.x, static_cast<uint32_t>(v.x));
        table.insert(k.y, static_cast<uint32_t>(v.y));
        table.insert(k.z, static_cast<uint32_t>(v.z));
        table.insert(k.w, static_cast<uint32_t>(v.w));
      }
      w0 += chunk;
    }
    __syncthreads();

    // the first round writes the outputs; a later one adds into them
    for (int64_t g = p0 + 4 * static_cast<int64_t>(tid); g < p1; g += chunk) {
      const int4 k = load4(probe, g, p1, vec_probe, kNullKey);
      int4 c;
      uint4 m;
      table.find(k.x, c.x, m.x);
      table.find(k.y, c.y, m.y);
      table.find(k.z, c.z, m.z);
      table.find(k.w, c.w, m.w);
      if (!first) {
        if (!(c.x | c.y | c.z | c.w)) continue;
        const int4 c0 = load4(mc, g, p1, vec_probe, 0);
        const int4 m0 = load4(mv, g, p1, vec_probe, 0);
        c.x += c0.x;
        c.y += c0.y;
        c.z += c0.z;
        c.w += c0.w;
        m.x = max(m.x, static_cast<uint32_t>(m0.x));
        m.y = max(m.y, static_cast<uint32_t>(m0.y));
        m.z = max(m.z, static_cast<uint32_t>(m0.z));
        m.w = max(m.w, static_cast<uint32_t>(m0.w));
      }
      store4(mc, g, p1, vec_probe, c);
      store4(mv, g, p1, vec_probe,
             make_int4(static_cast<int32_t>(m.x), static_cast<int32_t>(m.y),
                       static_cast<int32_t>(m.z), static_cast<int32_t>(m.w)));
    }
    first = false;
    __syncthreads();  // the table is read out before the next clears it
  } while (w0 < slots);
}

// the geometry rules both kernels check before they launch
inline bool table_geometry_ok(int stage, int entries, int threads) {
  return entries >= 2 && (entries & (entries - 1)) == 0 &&
         entries >= 2 * stage && threads >= 32 && threads <= 1024 &&
         threads % 32 == 0 && 4 * threads <= stage &&
         12 * static_cast<int64_t>(entries) <= kMaxSmem;
}

}  // namespace hjk
