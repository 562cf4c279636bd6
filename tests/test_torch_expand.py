"""The port's M:N expansion, materialize_expanded and the row operators
(compact, filter, sort) against the JAX package's on the CPU, with zero
tolerance: rows slot for slot, or by digest where the JAX side's row
order depends on its unstable probe sort."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hash_join_codes_knl_tpu.engine.phj as jphj
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.ops.compact import compact_rows as jax_compact
from hash_join_codes_knl_tpu.ops.expand import expand_join as jax_expand
from hash_join_codes_knl_tpu.ops.expand import (
    greedy_blocks as jax_greedy_blocks,
)
from hash_join_codes_knl_tpu.ops.filter import filter_relation as jax_filter
from hash_join_codes_knl_tpu.ops.sort import sort_relation as jax_sort
from hash_join_codes_knl_tpu_torch.engine import phj as tphj
from hash_join_codes_knl_tpu_torch.ops.compact import compact_rows
from hash_join_codes_knl_tpu_torch.ops.expand import (
    expand_join,
    greedy_blocks,
)
from hash_join_codes_knl_tpu_torch.ops.filter import filter_relation
from hash_join_codes_knl_tpu_torch.ops.sort import sort_relation
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    to_numpy_u32,
    u32_to_device,
)


def _t(a):
    return u32_to_device(a, "cpu")


def _eq(port_cols, jax_cols):
    for i, (p, j) in enumerate(zip(port_cols, jax_cols)):
        np.testing.assert_array_equal(to_numpy_u32(p), np.asarray(j),
                                      err_msg=str(i))


def _padded_sides(seed=11):
    """Build and probe sides with null rows in the middle of both."""
    rng = np.random.default_rng(seed)
    ik = rng.integers(1, 40, 256, dtype=np.uint32)
    ik[:8] = 0xFFFFFFFF
    iv = rng.integers(0, 2**32, 256, dtype=np.uint32)
    ok = rng.integers(1, 60, 400, dtype=np.uint32)
    ok[-5:] = 0xFFFFFFFF
    ov = rng.integers(0, 2**32, 400, dtype=np.uint32)
    z = lambda n: np.zeros(n, np.uint32)
    ikp = np.concatenate([ik[:100], z(64), ik[100:]])
    ivp = np.concatenate([iv[:100], z(64), iv[100:]])
    okp = np.concatenate([ok[:200], z(32), ok[200:]])
    ovp = np.concatenate([ov[:200], z(32), ov[200:]])
    return (ik, iv, ok, ov), (ikp, ivp, okp, ovp)


@pytest.mark.parametrize("slack", [64, 0, -50],
                         ids=["headroom", "exact", "cut"])
def test_expand_join_padded_sides_slot_for_slot(slack):
    """Null rows on either side stay inert; the rows equal JAX's slot
    for slot, and with a capacity below the count both return the true
    count and the same cut rows."""
    plain, padded = _padded_sides()
    want = join_oracle(*plain)
    cap = len(want[0]) + slack
    got = expand_join(*(_t(c) for c in padded), cap)
    ref = jax_expand(*(jnp.asarray(c) for c in padded), capacity=cap)
    assert int(got[0]) == int(ref[0]) == len(want[0])
    _eq(got[1:], ref[1:])
    n = min(cap, len(want[0]))
    if slack >= 0:
        assert multiset_digest(*(to_numpy_u32(c)[:n] for c in got[1:])) \
            == multiset_digest(*want)
    assert not any(to_numpy_u32(c)[n:].any() for c in got[1:])


def test_expand_join_empty_sides():
    e = np.zeros(0, np.uint32)
    k = np.arange(1, 9, dtype=np.uint32)
    for cols in ((k, k, e, e), (e, e, k, k)):
        got = expand_join(*(_t(c) for c in cols), 16)
        assert int(got[0]) == 0
        assert all(c.shape == (16,) and not c.any() for c in got[1:])


def test_greedy_blocks_like_jax():
    rng = np.random.default_rng(5)
    counts = rng.integers(1, 40, 3000).astype(np.int64)
    counts[100] = 900  # one row past the block size gets its own block
    for block_rows in (1, 37, 512, 100_000):
        got = list(greedy_blocks(counts, block_rows))
        assert got == list(jax_greedy_blocks(counts, block_rows))
        assert sum(b[2] for b in got) == counts.sum()


def _mn_cols(seed=7, ni=4096, no=8192, distinct=1500):
    rng = np.random.default_rng(seed)
    ik = rng.integers(1, 2**32, distinct, dtype=np.uint32)[
        rng.integers(0, distinct, ni)]
    iv = rng.integers(0, 2**32, ni, dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, ni, no - no // 4)],
                         rng.integers(1, 2**32, no // 4, dtype=np.uint32)])
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    return ik, iv, ok, ov


@pytest.fixture(scope="module")
def mn_joined():
    cols = _mn_cols()
    res_t, _ = tphj.join(*cols, device="cpu")
    res_j, _ = jphj.join(*cols)
    assert int(res_t.match_cnts.max()) > 1
    return cols, res_t, res_j


@pytest.mark.parametrize("block_rows", [0, 300, 4096, 10**9])
def test_materialize_expanded_like_jax(mn_joined, block_rows):
    """Rows equal JAX's by digest (its probe values follow an unstable
    sort), keys and build values slot for slot, and the oracle's
    multiset; block_rows 0, small (auto-raised to the largest
    multiplicity), mid and past the total."""
    (ik, iv, ok, ov), res_t, res_j = mn_joined
    got = tphj.materialize_expanded(res_t, ik, iv, block_rows=block_rows)
    ref = jphj.materialize_expanded(res_j, ik, iv, block_rows=block_rows)
    assert all(g.dtype == np.uint32 for g in got)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    assert multiset_digest(*got) == multiset_digest(*ref) \
        == multiset_digest(*join_oracle(ik, iv, ok, ov))


def test_materialize_expanded_takes_tensors_and_blocks_agree(mn_joined):
    (ik, iv, _, _), res_t, _ = mn_joined
    whole = tphj.materialize_expanded(res_t, _t(ik), _t(iv))
    for block_rows in (1, 999):
        blocks = tphj.materialize_expanded(res_t, ik, iv,
                                           block_rows=block_rows)
        for w, b in zip(whole, blocks):
            np.testing.assert_array_equal(w, b)


@pytest.mark.parametrize("block_rows", [0, 64])
def test_materialize_expanded_empty_like_jax(block_rows):
    ik = np.arange(1, 257, dtype=np.uint32)
    ok = np.arange(1000, 1000 + 2048, dtype=np.uint32)
    res_t, _ = tphj.join(ik, ik, ok, ok, device="cpu")
    got = tphj.materialize_expanded(res_t, ik, ik, block_rows=block_rows)
    ref = jphj.materialize_expanded(jphj.join(ik, ik, ok, ok)[0], ik, ik,
                                    block_rows=block_rows)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype == np.uint32 and g.size == r.size == 0


def test_materialize_points_at_materialize_expanded(mn_joined):
    _, res_t, _ = mn_joined
    with pytest.raises(ValueError, match="materialize_expanded"):
        tphj.materialize(res_t)


@pytest.mark.parametrize("n,share", [(4096, 0.3), (777, 0.0), (500, 1.0),
                                     (0, 0.5)])
def test_compact_rows_slot_for_slot(n, share):
    rng = np.random.default_rng(n)
    flags = (rng.random(n) < share).astype(np.uint32)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    got = compact_rows(torch.from_numpy(flags.astype(np.int32)), _t(keys),
                       _t(vals))
    ref = jax_compact(jnp.asarray(flags), jnp.asarray(keys),
                      jnp.asarray(vals))
    assert int(got[0]) == int(ref[0]) == int(flags.sum())
    _eq(got[1:], ref[1:])


def test_filter_relation_slot_for_slot():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    vals = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    got = filter_relation(_t(keys), _t(vals),
                          lambda k, v: (k & 3) == (v & 3))
    ref = jax_filter(jnp.asarray(keys), jnp.asarray(vals),
                     lambda k, v: (k & 3) == (v & 3))
    assert int(got[0]) == int(ref[0])
    _eq(got[1:], ref[1:])


def test_sort_relation_slot_for_slot():
    """Stable, ascending in unsigned order (keys past 2^31 last)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 64, 4000, dtype=np.uint32)
    keys[::7] |= np.uint32(0x80000000)
    keys[::11] = 0xFFFFFFFF
    vals = np.arange(4000, dtype=np.uint32)
    got = sort_relation(_t(keys), _t(vals), _t(vals ^ np.uint32(5)))
    ref = jax_sort(jnp.asarray(keys), jnp.asarray(vals),
                   jnp.asarray(vals ^ np.uint32(5)))
    _eq(got, ref)
