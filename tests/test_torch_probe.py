"""The port's tile probe (ops/probe.py) against the JAX package's
probe_tiles_jnp and probe_tiles_pallas (interpret mode), slot for slot.

The layouts come from the JAX package's partition operators; the port
gets the same columns biased.  Both M:N build keys (counts above 1, the
max value) and probe pads are covered, at tiles 128 and 256, and a table
whose partitions hold more tuples than slots."""

import numpy as np
import pytest

import jax.numpy as jnp

import hash_join_codes_knl_tpu.ops.partition as jpart
from hash_join_codes_knl_tpu.ops.probe import probe_tiles_jnp
from hash_join_codes_knl_tpu.ops.probe_pallas import probe_tiles_pallas
from hash_join_codes_knl_tpu.utils.hashing import hashed_key
from hash_join_codes_knl_tpu_torch.engine.config import DEFAULT_FACTOR
from hash_join_codes_knl_tpu_torch.ops import probe as tprobe
from hash_join_codes_knl_tpu_torch.utils.hashing import bias, u32_to_device


def _layout(tile, slots, seed, p_bits=4, distinct=3000, n_build=2000,
            n_probe=8192):
    """JAX padded probe layout and dense table over M:N build keys, with
    null probe keys.  Returns numpy (pk, tk, tv, counts, tpid)."""
    rng = np.random.default_rng(seed)
    P = 1 << p_bits
    keys = rng.integers(1, 2**32, distinct, dtype=np.uint32)
    ik = keys[rng.integers(0, distinct, n_build)]
    iv = rng.integers(0, 2**32, n_build, dtype=np.uint32)
    ok = keys[rng.integers(0, distinct, n_probe)]
    ok[rng.integers(0, n_probe, n_probe // 10)] = 0
    ihk = hashed_key(jnp.asarray(ik), DEFAULT_FACTOR)
    ohk = hashed_key(jnp.asarray(ok), DEFAULT_FACTOR)
    tk, tv, counts = jpart.build_dense_table_jnp(
        ihk, jnp.asarray(iv), jpart.pids_from_hk(ihk, p_bits, null_pid=P),
        P, slots)
    pk, _, offsets, _ = jpart.partition_padded_jnp(
        ohk, jnp.asarray(ok), jpart.pids_from_hk(ohk, p_bits, null_pid=P),
        P, tile)
    tpid = jpart.tile_pids(offsets, pk.shape[0] // tile, tile)
    return tuple(np.array(x) for x in (pk, tk, tv, counts, tpid))


def _port_args(pk, tk, tv, tpid):
    dev = "cpu"
    return (bias(u32_to_device(pk, dev)),
            bias(u32_to_device(tk.reshape(-1), dev)).view(tk.shape),
            u32_to_device(tv.reshape(-1), dev).view(tv.shape),
            u32_to_device(tpid.view(np.uint32), dev))


def _check(got, want_mv, want_mc):
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want_mc))
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32),
                                  np.asarray(want_mv))


@pytest.mark.parametrize("tile,slots", [(128, 256), (256, 128)])
def test_probe_matches_jnp_and_pallas(tile, slots):
    pk, tk, tv, counts, tpid = _layout(tile, slots, seed=tile)
    mv_j, mc_j = probe_tiles_jnp(jnp.asarray(pk), jnp.asarray(tk),
                                 jnp.asarray(tv), jnp.asarray(counts),
                                 jnp.asarray(tpid), tile)
    mv_p, mc_p = probe_tiles_pallas(jnp.asarray(pk), jnp.asarray(tk),
                                    jnp.asarray(tv), jnp.asarray(tpid), tile,
                                    interpret=True)
    np.testing.assert_array_equal(np.asarray(mc_p), np.asarray(mc_j))
    np.testing.assert_array_equal(np.asarray(mv_p), np.asarray(mv_j))
    assert np.asarray(mc_j).max() > 1  # M:N counts
    if slots == 128:
        assert counts.max() > slots  # overflowing partitions
    args = _port_args(pk, tk, tv, tpid)
    counts_t = u32_to_device(counts.view(np.uint32), "cpu")
    # with the count mask (the jnp oracle), without it (the kernel's
    # contract), and through the wrapper (the plain version on the CPU)
    _check(tprobe.probe_tiles_torch(*args, tile, counts_t), mv_j, mc_j)
    _check(tprobe.probe_tiles_torch(*args, tile), mv_j, mc_j)
    before = tprobe.probe_tiles.launches
    _check(tprobe.probe_tiles(*args, tile), mv_j, mc_j)
    assert tprobe.probe_tiles.launches == before  # no kernel on the CPU


def test_count_mask_changes_nothing_past_the_fill():
    """Slots past a row's fill hold the null key, so masking them by the
    counts (also counts above the row width) gives the same result as no
    mask; a count mask BELOW the fill does change it."""
    pk, tk, tv, counts, tpid = _layout(128, 128, seed=3, p_bits=3,
                                       n_build=1000)
    assert counts.max() > 128 and counts.min() < 128
    args = _port_args(pk, tk, tv, tpid)
    plain = tprobe.probe_tiles_torch(*args, 128)
    for c in (counts, np.full_like(counts, 128), counts + 1000):
        got = tprobe.probe_tiles_torch(*args, 128,
                                       u32_to_device(c.view(np.uint32),
                                                     "cpu"))
        for g, w in zip(got, plain):
            assert g.equal(w)
    tight = tprobe.probe_tiles_torch(
        *args, 128, u32_to_device(np.full(len(counts), 8, np.uint32), "cpu"))
    assert int(tight[1].sum()) < int(plain[1].sum())


def test_probe_refuses_bad_shapes():
    pk, tk, tv, _, tpid = _layout(128, 128, seed=4)
    pk, tk, tv, tpid = _port_args(pk, tk, tv, tpid)
    with pytest.raises(ValueError, match="multiple of tile"):
        tprobe.probe_tiles(pk[:-1].contiguous(), tk, tv, tpid, 128)
    with pytest.raises(ValueError, match="one partition per probe tile"):
        tprobe.probe_tiles(pk, tk, tv, tpid[:-1].contiguous(), 128)
    with pytest.raises(ValueError, match="int32"):
        tprobe.probe_tiles(pk.long(), tk, tv, tpid, 128)
