"""The port's key domain (hash_join_codes_knl_tpu_torch/utils/hashing.py)
against the JAX package's hashing, bit for bit."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hash_join_codes_knl_tpu.engine.config import DEFAULT_FACTOR
from hash_join_codes_knl_tpu.utils import hashing as jh
from hash_join_codes_knl_tpu_torch.utils import hashing as th

EDGE_KEYS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF], np.uint32)
FACTORS = [DEFAULT_FACTOR, 1, 3, 0xFFFFFFFF, 0xDEADBEEF | 1, 0x80000001]


def _keys():
    rng = np.random.default_rng(101)
    return np.concatenate(
        [EDGE_KEYS, rng.integers(0, 2**32, 4000, dtype=np.uint32)]
    )


@pytest.mark.parametrize("factor", FACTORS)
def test_hashed_key_bit_exact(factor):
    keys = _keys()
    got = th.to_numpy_u32(th.hashed_key(th.u32_to_device(keys, "cpu"),
                                        factor))
    np.testing.assert_array_equal(got, jh.np_hashed_key(keys, factor))
    np.testing.assert_array_equal(
        got, np.asarray(jh.hashed_key(jnp.asarray(keys), factor))
    )


@pytest.mark.parametrize("factor", FACTORS)
def test_mod_inverse_matches_and_inverts(factor):
    inv = th.mod_inverse_u32(factor)
    assert inv == jh.mod_inverse_u32(factor)
    keys = _keys()
    hk = th.hashed_key(th.u32_to_device(keys, "cpu"), factor)
    np.testing.assert_array_equal(th.to_numpy_u32(th.mul_u32(hk, inv)), keys)


def test_mod_inverse_rejects_even_factor():
    with pytest.raises(ValueError):
        th.mod_inverse_u32(0x9E3779B0)


def test_bias_preserves_unsigned_order():
    keys = _keys()
    t = th.u32_to_device(keys, "cpu")
    b = th.bias(t)
    assert b.dtype == torch.int32
    # signed order of the biased bits == unsigned order of the keys
    np.testing.assert_array_equal(
        np.argsort(b.numpy(), kind="stable"),
        np.argsort(keys, kind="stable"),
    )
    assert int(th.bias(th.u32_to_device(np.zeros(1, np.uint32), "cpu"))) \
        == th.BIAS  # the null key is INT32_MIN
    assert torch.equal(th.unbias(b), t)
    np.testing.assert_array_equal(th.to_numpy_u32(t), keys)


def test_to_numpy_rejects_non_bit_tensors():
    with pytest.raises(TypeError):
        th.to_numpy_u32(torch.zeros(3, dtype=torch.int64))


@pytest.mark.parametrize("partitions,ratio", [(2, 0.5), (8, 0.7), (4, 0.25),
                                              (16, 0.999)])
def test_hash_ratio_like_jax(partitions, ratio):
    """The two-level tier hash, on the device and on the host, equals the
    JAX package's slot for slot."""
    keys = _keys()
    want = np.asarray(jh.hash_ratio(jnp.asarray(keys), DEFAULT_FACTOR,
                                    partitions, ratio))
    got = th.hash_ratio(th.u32_to_device(keys, "cpu"), DEFAULT_FACTOR,
                        partitions, ratio).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        th.np_hash_ratio(keys, DEFAULT_FACTOR, partitions, ratio),
        jh.np_hash_ratio(keys, DEFAULT_FACTOR, partitions, ratio))


def test_hash_ratio_refuses_odd_partitions():
    keys = np.arange(1, 9, dtype=np.uint32)
    with pytest.raises(ValueError, match="even"):
        th.hash_ratio(th.u32_to_device(keys, "cpu"), DEFAULT_FACTOR, 3, 0.5)
    with pytest.raises(ValueError, match="even"):
        th.np_hash_ratio(keys, DEFAULT_FACTOR, 3, 0.5)


@pytest.mark.parametrize("hi_bit,bits", [(32, 6), (26, 6), (32, 1),
                                         (12, 12), (31, 31)])
def test_radix_bits_like_jax(hi_bit, bits):
    hk = th.np_hashed_key(_keys(), DEFAULT_FACTOR)
    np.testing.assert_array_equal(hk, jh.np_hashed_key(_keys(),
                                                       DEFAULT_FACTOR))
    want = np.asarray(jh.radix_bits(jnp.asarray(hk), hi_bit, bits))
    got = th.radix_bits(th.u32_to_device(hk, "cpu"), hi_bit, bits).numpy()
    np.testing.assert_array_equal(got, want)
