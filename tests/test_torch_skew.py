"""The port's heavy-hitter functions (parallel/skew.py) against the JAX
package's on the same numpy inputs: nominations, membership, the
small-table probe and the row extraction, slot for slot.  The port
searches a sorted small side where the JAX functions broadcast an
(n, m) comparison; the results must not differ."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hash_join_codes_knl_tpu.parallel import skew as jskew
from hash_join_codes_knl_tpu_torch.parallel import skew as tskew
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    to_numpy_u32,
    u32_to_device,
)


def _t(a):
    return u32_to_device(a, "cpu")


def _zipfish(seed, n, domain, hot=()):
    """Keys from a small domain with a few hot keys, 0s and keys at the
    unsigned extremes (bit 31 set) mixed in."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**32, domain, dtype=np.uint32)
    keys[:3] = [1, 0x80000000, 0xFFFFFFFF]
    out = keys[rng.integers(0, domain, n)]
    for i, (k, frac) in enumerate(hot):
        out[rng.random(n) < frac] = keys[k]
    out[rng.random(n) < 0.02] = 0
    return out.astype(np.uint32)


@pytest.mark.parametrize("sample,k_max,frac", [
    (65536, 8, 1 / 256), (4096, 4, 1 / 64), (100, 16, 0.0), (3, 8, 0.5)])
def test_nominate_heavy_like_jax(sample, k_max, frac):
    keys = _zipfish(1, 20000, 500, hot=((2, 0.2), (7, 0.1), (9, 0.05),
                                        (1, 0.05)))
    want = np.asarray(jskew.nominate_heavy(jnp.asarray(keys), sample, k_max,
                                           frac))
    got = to_numpy_u32(tskew.nominate_heavy(_t(keys), sample, k_max, frac))
    np.testing.assert_array_equal(got, want)


def test_nominate_heavy_ties_and_no_candidates():
    keys = np.array([5, 9, 5, 9, 7, 0, 0, 0], np.uint32)
    for k_max in (1, 2, 8):
        want = np.asarray(jskew.nominate_heavy(jnp.asarray(keys), 8, k_max,
                                               0.1))
        got = to_numpy_u32(tskew.nominate_heavy(_t(keys), 8, k_max, 0.1))
        np.testing.assert_array_equal(got, want)
    none = np.arange(1, 65, dtype=np.uint32)
    assert not to_numpy_u32(tskew.nominate_heavy(_t(none), 64, 8,
                                                 0.5)).any()


def test_is_member_like_jax():
    keys = _zipfish(2, 5000, 300)
    heavy = np.array([keys[10], keys[20], 0, 0xFFFFFFFF, 0x80000000, 12345],
                     np.uint32)
    want = np.asarray(jskew.is_member(jnp.asarray(keys), jnp.asarray(heavy)))
    got = tskew.is_member(_t(keys), _t(heavy)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[keys == 0].any()
    empty = tskew.is_member(_t(keys), _t(np.zeros(0, np.uint32)))
    assert not empty.any()


def test_probe_small_table_like_jax():
    rng = np.random.default_rng(3)
    probe = _zipfish(4, 6000, 200)
    table_k = probe[rng.integers(0, 6000, 64)].copy()
    table_k[:8] = table_k[8]  # a duplicated key: count 9, max value
    table_k[60:] = 0  # the replication buffer's pads
    table_v = rng.integers(0, 2**32, 64, dtype=np.uint32)
    table_v[3] = 0xFFFFFFFF
    want = jskew.probe_small_table(jnp.asarray(probe), jnp.asarray(table_k),
                                   jnp.asarray(table_v))
    mv, mc = tskew.probe_small_table(_t(probe), _t(table_k), _t(table_v))
    np.testing.assert_array_equal(to_numpy_u32(mv), np.asarray(want[0]))
    np.testing.assert_array_equal(mc.numpy(), np.asarray(want[1]))
    assert mc.max() >= 9


@pytest.mark.parametrize("cap", [1, 16, 256])
def test_extract_rows_like_jax(cap):
    rng = np.random.default_rng(5)
    keys = rng.integers(1, 2**32, 3000, dtype=np.uint32)
    vals = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    flags = rng.random(3000) < 0.01
    wk, wv, wc = jskew.extract_rows(jnp.asarray(keys), jnp.asarray(vals),
                                    jnp.asarray(flags), cap)
    gk, gv, gc = tskew.extract_rows(_t(keys), _t(vals),
                                    torch.from_numpy(flags), cap)
    np.testing.assert_array_equal(to_numpy_u32(gk), np.asarray(wk))
    np.testing.assert_array_equal(to_numpy_u32(gv), np.asarray(wv))
    assert int(gc) == int(wc) == int(flags.sum())
