"""The port's tile probe (ops/probe.py) against the JAX package's
probe_tiles_jnp and probe_tiles_pallas (interpret mode), slot for slot.

The layouts come from the JAX package's partition operators; the port
gets the same columns biased.  Both M:N build keys (counts above 1, the
max value) and probe pads are covered, at tiles 128 and 256, and a table
whose partitions hold more tuples than slots."""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("slots", [128, 256, 1024, 9216, 20480, 2**20])
@pytest.mark.parametrize("tile", [128, 3072])
def test_table_geometry_rule(slots, tile):
    """The table is a power of two, at least twice the round, within one
    block's shared memory; a chunk of four slots a thread fits a round;
    the radix rows (9216 slots) and the sort-mode rows (1024) get the
    sizes the kernel's note names."""
    stage, entries, smem, threads, _ = tprobe.table_geometry(slots, tile,
                                                             1000, 16)
    assert entries & (entries - 1) == 0 and entries >= 2 * stage
    assert smem == tprobe.ENTRY_BYTES * entries <= tprobe.SMEM_LIMIT == 232448
    assert stage & (stage - 1) == 0
    assert min(slots, tprobe.MAX_STAGE) <= stage <= tprobe.MAX_STAGE
    assert threads % 32 == 0 and 32 <= threads <= 1024
    assert 4 * threads <= stage
    if slots == 1024:
        assert (stage, entries, smem) == (1024, 2048, 24 * 1024)
    if slots == 9216:
        assert (stage, entries, smem) == (8192, 16384, 192 * 1024)


@pytest.mark.parametrize("tile,n_tiles,partitions,want", [
    (128, 3_289_088, 4096, 803),  # radix 4096-way: a block is a region
    (3072, 148_872, 65536, 3),  # sort mode: 2.27 tiles a partition
    (128, 24, 8, 3),
    (128, 5, 8, 1),  # fewer tiles than partitions
    (128, 0, 8, 1),
    (128, 1_000_000, 2, 1023),  # long regions: equal shares under the cap
    (1 << 18, 40, 4, 1),  # a tile past the cap still gets a block
])
def test_block_share_follows_the_tiles_of_a_partition(tile, n_tiles,
                                                      partitions, want):
    tpb = tprobe.table_geometry(1024, tile, n_tiles, partitions)[4]
    assert tpb == want
    assert tpb == 1 or tpb * tile <= tprobe.MAX_BLOCK_PROBES


def test_table_geometry_refuses_nonsense():
    for bad in [(0, 128, 4, 2), (1024, 0, 4, 2), (1024, 128, -1, 2),
                (1024, 128, 4, 0)]:
        with pytest.raises(ValueError):
            tprobe.table_geometry(*bad)


def _fmix32(x):
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & 0xFFFFFFFF
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & 0xFFFFFFFF
    return x ^ (x >> 16)


def test_table_index_mixes_keys_that_share_their_top_bits():
    """A row's keys share their top p_bits (the partition id).  Indexed
    by their top bits they would all start at one entry; the mix spreads
    them like random keys.  The index equals murmur3's finalizer on the
    biased key's bits."""
    rng = np.random.default_rng(9)
    low = rng.permutation(1 << 20)[:3900].astype(np.uint32)
    hk = (np.uint32(0xABC) << np.uint32(20)) | low  # one 12-bit partition
    keys = bias(u32_to_device(hk, "cpu"))
    entries = 16384
    idx = tprobe.table_index(keys, entries)
    want = [_fmix32(int(k) & 0xFFFFFFFF) % entries for k in keys.tolist()]
    assert idx.tolist() == want
    assert len(set((keys.to(torch.int64) >> 20).tolist())) == 1
    load = np.bincount(idx.numpy(), minlength=entries)
    assert load.max() <= 5 and (load > 0).sum() > 3300
    # sequential raw keys scrambled by the join's factor spread as well
    seq = (np.arange(1, 3901, dtype=np.uint64) * DEFAULT_FACTOR
           % 2**32).astype(np.uint32)
    load = np.bincount(tprobe.table_index(
        bias(u32_to_device(seq, "cpu")), entries).numpy(), minlength=entries)
    assert load.max() <= 5 and (load > 0).sum() > 3300


def _rounds_model(pk, tk, tv, tpid, tile, stage, chunk):
    """The kernel's rounds in plain Python: a row is read in chunks of
    `chunk` slots; a round takes whole chunks while its live slots stay
    within `stage` and holds a dict key -> (count, max value); every
    probe adds the round's count and takes the larger max.  Returns (mv,
    mc, the largest number of rounds a row took)."""
    null = -2**31
    mv = np.zeros(len(pk), np.int64)
    mc = np.zeros(len(pk), np.int64)
    most = 0
    for t, pid in enumerate(tpid):
        row_k, row_v = tk[pid], tv[pid].astype(np.int64) & 0xFFFFFFFF
        w0, rounds = 0, 0
        while True:
            table, room = {}, stage
            while w0 < len(row_k):
                live = [j for j in range(w0, min(w0 + chunk, len(row_k)))
                        if row_k[j] != null]
                if len(live) > room:
                    break
                room -= len(live)
                for j in live:
                    c, m = table.get(row_k[j], (0, 0))
                    table[row_k[j]] = (c + 1, max(m, row_v[j]))
                w0 += chunk
            rounds += 1
            for i in range(t * tile, (t + 1) * tile):
                if pk[i] != null and pk[i] in table:
                    c, m = table[pk[i]]
                    mc[i] += c
                    mv[i] = max(mv[i], m)
            if w0 >= len(row_k):
                break
        most = max(most, rounds)
    return mv, mc, most


@pytest.mark.parametrize("stage,chunk", [(64, 16), (32, 32), (4096, 1024)])
def test_rounds_model_matches_plain(stage, chunk):
    """Counts add and maxes combine across rounds: rows of 256 slots read
    in rounds of at most `stage` live slots, with one key repeated across
    every round boundary, give the plain version's result."""
    rng = np.random.default_rng(stage)
    P, slots, tile = 3, 256, 32
    keys = rng.integers(1, 2**32, 150, dtype=np.uint32)
    tk = keys[rng.integers(0, 150, (P, slots))]
    tk[rng.random((P, slots)) < 0.2] = 0
    tk[0, ::7] = keys[0]  # a duplicate that straddles every boundary
    tk[2, :] = 0
    tk[2, 200:] = keys[5]
    tv = rng.integers(0, 2**32, (P, slots), dtype=np.uint32)
    tpid = np.repeat(np.arange(P), 2).astype(np.int32)
    pk = keys[rng.integers(0, 150, len(tpid) * tile)]
    pk[::4] = keys[0]
    pk[::11] = 0
    args = _port_args(pk, tk, tv, tpid.view(np.uint32))
    want_mv, want_mc = tprobe.probe_tiles_torch(*args, tile)
    mv, mc, rounds = _rounds_model(
        args[0].numpy(), args[1].numpy(), args[2].numpy(), tpid, tile,
        stage, chunk)
    assert rounds == 1 if stage >= slots else rounds > 2
    np.testing.assert_array_equal(mc, want_mc.numpy())
    np.testing.assert_array_equal(
        mv, want_mv.numpy().astype(np.int64) & 0xFFFFFFFF)
    assert mc.max() > 30  # keys[0]'s count, summed over the rounds
