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
// shared memory, entries (key, count, max value): a slot is claimed by
// atomicCAS on the key (empty = the null key, which no live key equals),
// then atomicAdd on the count and atomicMax on the value, so duplicate
// build keys (M:N) collapse into one entry with the exact count and max.
// Then every probe of the segment hashes, walks to its key or to an
// empty entry, and takes the entry's count and max: 16-byte loads of
// four probes a thread, 16-byte stores of both outputs.  A null probe
// skips the walk.
//
// A round of the table holds at most `stage` live slots (entries >= 2 *
// stage, so a walk always meets an empty entry).  The row is read in
// chunks of 4 * blockDim slots; a round takes whole chunks while its
// live slots stay within `stage`.  Rows with more live slots take more
// rounds: the first round writes the outputs, a later one re-reads the
// probes and adds its counts and maxes into them on a hit.  Counts add
// and maxes combine across rounds, so one kernel serves rows of any
// width.  The radix plan's 9216-slot rows hold about 3900 live slots and
// take one round of the 16384-entry table.
//
// All keys of a row share their top bits (the partition id), so the
// table index is a full-avalanche mix of the key (murmur3's finalizer),
// not its top bits.  ops/probe.py computes stage, entries, threads and
// the block's share of tiles, and mirrors the mix (table_index).
#include "hjk.cuh"

namespace {

__device__ __forceinline__ uint32_t mix(int32_t key) {
  uint32_t x = static_cast<uint32_t>(key);
  x ^= x >> 16;
  x *= 0x85ebca6bu;
  x ^= x >> 13;
  x *= 0xc2b2ae35u;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
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

  __device__ __forceinline__ void insert(int32_t k, uint32_t v) const {
    if (k == hjk::kNullKey) return;
    uint32_t i = mix(k) & mask;
    while (true) {
      const int32_t prev = atomicCAS(&key[i], hjk::kNullKey, k);
      if (prev == hjk::kNullKey || prev == k) break;
      i = (i + 1) & mask;
    }
    atomicAdd(&cnt[i], 1);
    atomicMax(&top[i], v);
  }

  __device__ __forceinline__ void find(int32_t k, int32_t& c,
                                       uint32_t& m) const {
    c = 0;
    m = 0u;
    if (k == hjk::kNullKey) return;
    uint32_t i = mix(k) & mask;
    while (true) {
      const int32_t at = key[i];
      if (at == k) {
        c = cnt[i];
        m = top[i];
        return;
      }
      if (at == hjk::kNullKey) return;
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
  const Table table{smem, smem + entries,
                    reinterpret_cast<uint32_t*>(smem + 2 * entries),
                    static_cast<uint32_t>(entries - 1)};
  __shared__ int s_warp[2][32];
  int parity = 0;
  const int tid = threadIdx.x;
  const int64_t chunk = 4 * static_cast<int64_t>(blockDim.x);
  // 16-byte accesses where every row and every thread's four probes
  // start on a 16-byte boundary
  const bool vec_row = slots % 4 == 0 && aligned16(tk) && aligned16(tv);
  const bool vec_probe =
      tile % 4 == 0 && aligned16(probe) && aligned16(mv) && aligned16(mc);

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
    const int32_t* row_k = tk + static_cast<int64_t>(pid) * slots;
    const int32_t* row_v = tv + static_cast<int64_t>(pid) * slots;

    int64_t w0 = 0;
    bool first = true;
    do {
      for (int i = tid; i < entries; i += blockDim.x) {
        table.key[i] = hjk::kNullKey;
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
        const int4 k = load4(row_k, j, slots, vec_row, hjk::kNullKey);
        const int live = (k.x != hjk::kNullKey) + (k.y != hjk::kNullKey) +
                         (k.z != hjk::kNullKey) + (k.w != hjk::kNullKey);
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
      for (int64_t g = p0 + 4 * static_cast<int64_t>(tid); g < p1;
           g += chunk) {
        const int4 k = load4(probe, g, p1, vec_probe, hjk::kNullKey);
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
               make_int4(static_cast<int32_t>(m.x),
                         static_cast<int32_t>(m.y),
                         static_cast<int32_t>(m.z),
                         static_cast<int32_t>(m.w)));
      }
      first = false;
      __syncthreads();  // the table is read out before the next clears it
    } while (w0 < slots);
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
  if (entries < 2 || (entries & (entries - 1)) || entries < 2 * stage ||
      threads < 32 || threads > 1024 || threads % 32 ||
      4 * threads > stage || smem > hjk::kMaxSmem || tiles_per_block < 1 ||
      tile < 1 || slots < 1) {
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
