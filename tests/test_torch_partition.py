"""The port's padded layout and dense table (ops/partition.py) against
the JAX package's ops/partition.py, slot for slot, for both of its forms
(argsort and fused sort).  The port's keys are biased; they are compared
after unbiasing, so the port's pad (the biased null key) meets the JAX
pad 0."""

import numpy as np
import pytest

import jax.numpy as jnp

import hash_join_codes_knl_tpu.ops.partition as jpart
from hash_join_codes_knl_tpu.utils.hashing import hashed_key
from hash_join_codes_knl_tpu_torch.engine.config import DEFAULT_FACTOR
from hash_join_codes_knl_tpu_torch.ops import partition as tpart
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    bias,
    to_numpy_u32,
    u32_to_device,
    unbias,
)

_FORMS = {
    "argsort": (jpart.partition_padded_jnp, jpart.build_dense_table_jnp),
    "sort": (jpart.partition_padded_sort_jnp,
             jpart.build_dense_table_sort_jnp),
}


def _hk(n, seed, nulls=0):
    """Scrambled keys (numpy uint32, some null) and values."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**32, n, dtype=np.uint32)
    keys[rng.integers(0, n, nulls)] = 0
    hk = np.array(hashed_key(jnp.asarray(keys), DEFAULT_FACTOR))
    return hk, rng.integers(0, 2**32, n, dtype=np.uint32)


def _port(hk):
    return bias(u32_to_device(hk, "cpu"))


def _u32(t):
    return to_numpy_u32(unbias(t))


@pytest.mark.parametrize("p_bits,skip", [(1, 0), (6, 0), (5, 3), (12, 20),
                                         (4, 28)])
def test_pids_match_jax(p_bits, skip):
    hk, _ = _hk(5000, p_bits, nulls=50)
    P = 1 << p_bits
    want = jpart.pids_from_hk(jnp.asarray(hk), p_bits, skip, null_pid=P)
    got = tpart.pids_from_hk(_port(hk), p_bits, skip, null_pid=P)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    bare = tpart.pids_from_hk(_port(hk), p_bits, skip)
    np.testing.assert_array_equal(
        bare.numpy(), np.asarray(jpart.pids_from_hk(jnp.asarray(hk), p_bits,
                                                     skip)))


def test_pids_refuse_bits_past_the_key():
    with pytest.raises(ValueError):
        tpart.pids_from_hk(_port(np.ones(4, np.uint32)), 8, 25)


@pytest.mark.parametrize("n,P,q", [(0, 4, 128), (1, 16, 256),
                                   (10_000, 32, 256), (65536, 64, 3072)])
def test_padded_capacity(n, P, q):
    assert tpart.padded_capacity(n, P, q) == jpart.padded_capacity(n, P, q)


def _pid_cases():
    """(hk, vals, pids, P): null keys routed to P, out-of-range and
    negative pids, a hot partition, skip_bits > 0."""
    hk, vals = _hk(20_000, 9, nulls=300)
    P = 64
    pids = np.asarray(jpart.pids_from_hk(jnp.asarray(hk), 6, 0,
                                         null_pid=P)).copy()
    pids[::97] = 70  # out of range: dropped
    pids[5::211] = -3
    pids[:2500] = 17  # hot: more tuples than the table has slots
    hk2, vals2 = _hk(6000, 10, nulls=20)
    pids2 = np.asarray(jpart.pids_from_hk(jnp.asarray(hk2), 4, 2,
                                          null_pid=16))
    return [(hk, vals, pids, P), (hk2, vals2, pids2, 16)]


@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("quantum", [128, 384])
def test_partition_padded_matches_jax(form, case, quantum):
    hk, vals, pids, P = _pid_cases()[case]
    want = _FORMS[form][0](jnp.asarray(hk), jnp.asarray(vals),
                           jnp.asarray(pids), P, quantum)
    got = tpart.partition_padded(_port(hk), u32_to_device(vals, "cpu"),
                                 u32_to_device(pids.astype(np.uint32),
                                               "cpu"), P, quantum)
    np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_numpy_u32(got[1]), np.asarray(want[1]))
    for g, w in zip(got[2:], want[2:]):
        assert g.dtype.is_signed and g.dtype.itemsize == 4
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    n_tiles = got[0].shape[0] // quantum
    np.testing.assert_array_equal(
        tpart.tile_pids(got[2], n_tiles, quantum).numpy(),
        np.asarray(jpart.tile_pids(want[2], n_tiles, quantum)))


@pytest.mark.parametrize("form", sorted(_FORMS))
@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("slots", [4, 512, 2048])
def test_build_dense_table_matches_jax(form, case, slots):
    hk, vals, pids, P = _pid_cases()[case]
    want = _FORMS[form][1](jnp.asarray(hk), jnp.asarray(vals),
                           jnp.asarray(pids), P, slots)
    got = tpart.build_dense_table(_port(hk), u32_to_device(vals, "cpu"),
                                  u32_to_device(pids.astype(np.uint32),
                                                "cpu"), P, slots)
    assert got[0].shape == (P, slots) and got[0].is_contiguous()
    np.testing.assert_array_equal(_u32(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(to_numpy_u32(got[1]), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if slots == 512 and case == 0:
        assert int(got[2].max()) > slots  # the hot partition overflows


def test_tile_pids_trailing_tiles_and_empty_partitions():
    offsets = np.array([0, 0, 256, 256, 768], np.int32)  # empty 0 and 2
    want = np.asarray(jpart.tile_pids(jnp.asarray(offsets), 9, 128))
    got = tpart.tile_pids(u32_to_device(offsets.view(np.uint32), "cpu"), 9,
                          128)
    np.testing.assert_array_equal(got.numpy(), want)
