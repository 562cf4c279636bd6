// Native relation generator: C++ twin of relgen/_pygen.py.
//
// Same single-stream MT19937-32 draw order as the reference generator run
// with one thread (write.cpp:1482-1646): unique rejection sampling, inner
// repeat picks, outer walk (ref/uniform/zipf modes), Fisher-Yates shuffles,
// vals = key * factor.  The Python generator is the portable oracle; this
// library exists because the shuffle and the rejection sampler are
// inherently sequential and must run at C speed for multi-hundred-million
// row relations.  Outputs are verified byte-identical to the Python path in
// tests/test_generator.py.
//
// Build: see native/build.py (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

namespace {

// --- MT19937-32 with the reference's seeding (npj.cpp:133-175: no "+i"). ---
struct MT32 {
  uint32_t n[625];
  size_t index;

  explicit MT32(uint32_t seed) {
    n[0] = seed;
    for (size_t i = 0; i != 623; ++i)
      n[i + 1] = 0x6c078965u * (n[i] ^ (n[i] >> 30));
    index = 624;
  }

  uint32_t next() {
    if (index == 624) {
      size_t i = 0;
      uint32_t y;
      do {
        y = (n[i] & 0x80000000u) + (n[i + 1] & 0x7fffffffu);
        n[i] = n[i + 397] ^ (y >> 1);
        n[i] ^= 0x9908b0dfu & (uint32_t)(-(int32_t)(y & 1));
      } while (++i != 227);
      n[624] = n[0];
      do {
        y = (n[i] & 0x80000000u) + (n[i + 1] & 0x7fffffffu);
        n[i] = n[i - 227] ^ (y >> 1);
        n[i] ^= 0x9908b0dfu & (uint32_t)(-(int32_t)(y & 1));
      } while (++i != 624);
      index = 0;
    }
    uint32_t y = n[index++];
    y ^= y >> 11;
    y ^= (y << 7) & 0x9d2c5680u;
    y ^= (y << 15) & 0xefc60000u;
    y ^= y >> 18;
    return y;
  }
};

inline uint64_t mulhi_pick(uint32_t r, uint64_t range) {
  return ((uint64_t)r * range) >> 32;
}

// Distinct nonzero keys by rejection sampling; acceptance is set-membership
// only, realized with a power-of-2 open-addressing table (the table geometry
// does not affect the accepted key sequence).
// Returns false on allocation failure (multi-hundred-million-row tables
// are this library's normal operating point; a NULL deref here would
// crash instead of surfacing rc=2 like the pool malloc does).
bool unique_fill(MT32 &gen, uint32_t *out, uint64_t count) {
  uint64_t buckets = 64;
  while (buckets < count * 2) buckets <<= 1;
  uint32_t *table = (uint32_t *)calloc(buckets, sizeof(uint32_t));
  if (!table) return false;
  uint64_t mask = buckets - 1;
  uint64_t i = 0;
  while (i != count) {
    uint32_t key = gen.next();
    if (key == 0) continue;
    uint64_t h = (key * 0x9e3779b1u) & mask;
    bool dup = false;
    while (table[h] != 0) {
      if (table[h] == key) { dup = true; break; }
      h = (h + 1) & mask;
    }
    if (dup) continue;
    table[h] = key;
    out[i++] = key;
  }
  free(table);
  return true;
}

// write.cpp:1429-1440 semantics, draw-for-draw.
void fisher_yates(uint32_t *data, uint64_t size, MT32 &gen) {
  for (uint64_t i = 0; i != size; ++i) {
    uint64_t j = mulhi_pick(gen.next(), size - i) + i;
    uint32_t t = data[i];
    data[i] = data[j];
    data[j] = t;
  }
}

}  // namespace

extern "C" {

// mode: 0=ref (bit-exact T=1 reference walk; requires outer==min(inner,outer)),
//       1=uniform (intended semantics), 2=zipf (integer-exact rank counts,
//       matching relgen/_pygen.py::zipf_rank_counts).
// meta out: [inner_checksum, outer_checksum, join_distinct].
// Returns 0 on success, nonzero on invalid arguments.
int hjk_generate(uint32_t seed, uint64_t inner_tuples, uint64_t outer_tuples,
                 double selc, double zipf, int mode, uint32_t f_inner,
                 uint32_t f_outer, uint32_t *inner_keys, uint32_t *inner_vals,
                 uint32_t *outer_keys, uint32_t *outer_vals, uint64_t *meta) {
  // validate up front: degenerate counts underflow the output index
  // arithmetic (outer_tuples-1 wraps), selc outside [0,1] walks
  // outer_pool off the heap block, and a negative zipf overflows the
  // 2^40-scaled weights (double->u64 casts past 2^64 are UB).  The
  // Python twin rejects the same inputs; rc=0 must mean a valid pair.
  if (inner_tuples == 0 || outer_tuples == 0) return 1;
  if (!(selc >= 0.0 && selc <= 1.0)) return 1;
  if (mode == 2 && !(zipf >= 0.0)) return 1;
  uint64_t inner_distinct =
      inner_tuples < outer_tuples ? inner_tuples : outer_tuples;
  uint64_t outer_distinct = inner_distinct;
  uint64_t join_distinct = (uint64_t)(inner_distinct * selc);
  uint64_t distinct = inner_distinct + outer_distinct - join_distinct;

  MT32 gen(seed);
  uint32_t *pool = (uint32_t *)malloc(distinct * sizeof(uint32_t));
  if (!pool) return 2;
  if (!unique_fill(gen, pool, distinct)) { free(pool); return 2; }

  // inner keys: distinct slice then uniform repeats
  memcpy(inner_keys, pool, inner_distinct * sizeof(uint32_t));
  for (uint64_t i = inner_distinct; i < inner_tuples; ++i)
    inner_keys[i] = pool[mulhi_pick(gen.next(), inner_distinct)];

  // outer keys
  const uint32_t *outer_pool = pool + (inner_distinct - join_distinct);
  if (mode == 0) {
    if (outer_tuples != outer_distinct) { free(pool); return 1; }
    for (uint64_t o = 0; o + 1 < outer_tuples; ++o)
      outer_keys[o] = outer_pool[o + 1];
    outer_keys[outer_tuples - 1] =
        outer_pool[mulhi_pick(gen.next(), outer_distinct)];
  } else if (mode == 1) {
    memcpy(outer_keys, outer_pool, outer_distinct * sizeof(uint32_t));
    for (uint64_t o = outer_distinct; o < outer_tuples; ++o)
      outer_keys[o] = outer_pool[mulhi_pick(gen.next(), outer_distinct)];
  } else if (mode == 2) {
    const uint64_t rank_cap = 1000000;
    uint64_t nranks = outer_distinct < rank_cap ? outer_distinct : rank_cap;
    uint64_t *w = (uint64_t *)malloc(nranks * sizeof(uint64_t));
    if (!w) { free(pool); return 2; }
    uint64_t base = 0;
    for (uint64_t r = 1; r <= nranks; ++r) {
      w[r - 1] = (uint64_t)(1099511627776.0 /* 2^40 */ *
                            pow((double)r, -zipf));
      base += w[r - 1];
    }
    uint64_t o = 0;
    for (uint64_t r = 0; r < nranks && o < outer_tuples; ++r) {
      unsigned __int128 c128 =
          (unsigned __int128)outer_tuples * w[r] / base;
      uint64_t c = c128 > 1 ? (uint64_t)c128 : 1;
      if (c > outer_tuples - o) c = outer_tuples - o;
      for (uint64_t k = 0; k != c; ++k) outer_keys[o++] = outer_pool[r];
    }
    free(w);
    for (; o < outer_tuples; ++o)
      outer_keys[o] = outer_pool[mulhi_pick(gen.next(), outer_distinct)];
  } else {
    free(pool);
    return 1;
  }
  free(pool);

  uint64_t inner_checksum = 0, outer_checksum = 0;
  for (uint64_t i = 0; i != inner_tuples; ++i) inner_checksum += inner_keys[i];
  for (uint64_t o = 0; o != outer_tuples; ++o) outer_checksum += outer_keys[o];

  fisher_yates(inner_keys, inner_tuples, gen);
  fisher_yates(outer_keys, outer_tuples, gen);

  for (uint64_t i = 0; i != inner_tuples; ++i)
    inner_vals[i] = inner_keys[i] * f_inner;
  for (uint64_t o = 0; o != outer_tuples; ++o)
    outer_vals[o] = outer_keys[o] * f_outer;

  meta[0] = inner_checksum;
  meta[1] = outer_checksum;
  meta[2] = join_distinct;
  return 0;
}

}  // extern "C"
