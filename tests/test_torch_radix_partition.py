"""The port's radix pass (ops/radix_partition.py) against the JAX
package's radix_partition_pallas (interpret mode) and its numpy oracle.

The port keeps input order within a run (a stable scatter); the TPU
kernel sorts each tile first.  So against the JAX function the port must
match counts, overflow, output length, the live-slot mask and each run's
(key, value) multiset; against the numpy layout built here (the
reference's destination rule with stable runs) it must match slot for
slot.  The cases mirror tests/test_radix_partition.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hash_join_codes_knl_tpu.ops.radix_partition_pallas import (
    multipass_partition as jax_multipass,
    radix_partition_oracle,
    radix_partition_pallas,
)
from hash_join_codes_knl_tpu.utils.hashing import hashed_key
from hash_join_codes_knl_tpu_torch.ops import radix_partition as trp
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    bias,
    to_numpy_u32,
    u32_to_device,
    unbias,
)


def _rot(hk, skip):
    if not skip:
        return hk
    return (hk << np.uint32(skip)) | (hk >> np.uint32(32 - skip))


def _expected(hk, vals, bits, skip=0, cap=0, tile=32768, regions=1):
    """numpy layout of one pass, runs in input order.  Returns (out_k,
    out_v, run id of every output slot or -1, counts, overflow)."""
    F = 1 << bits
    n = len(hk) // regions
    tile, n_tiles, mrr, cap = trp.geometry(n, bits, cap, tile)
    idx = np.arange(len(hk))
    pid = (_rot(hk, skip) >> np.uint32(32 - bits)).astype(np.int64)
    run = ((idx // n) * n_tiles + (idx % n) // tile) * F + pid
    live = hk != 0
    cnt = np.bincount(run[live], minlength=regions * n_tiles * F)
    cnt3 = cnt.reshape(regions, n_tiles, F)
    rows = -(-cnt3 // 128)
    fill = np.cumsum(rows, 1) - rows
    region = np.arange(regions * F).reshape(regions, 1, F)
    bad = (fill + mrr > cap // 128) | (rows > mrr)
    start = ((fill + region * (cap // 128)) * 128).reshape(-1)
    written = ((cnt3 > 0) & ~bad).reshape(-1)
    keep = live & written[run]
    order = np.argsort(run[keep], kind="stable")
    r_s = run[keep][order]
    first = np.searchsorted(r_s, r_s)  # first index of each run
    slot = start[r_s] + np.arange(len(r_s)) - first
    total = regions * F * cap
    out_k = np.zeros(total, np.uint32)
    out_v = np.zeros(total, np.uint32)
    run_of = np.full(total, -1, np.int64)
    out_k[slot] = hk[keep][order]
    out_v[slot] = vals[keep][order]
    run_of[slot] = r_s
    overflow = int(((cnt3 > 0) & bad).reshape(regions, -1).any(1).sum())
    return out_k, out_v, run_of, cnt3.sum(1).reshape(-1), overflow


def _port(hk, vals, *args, **kw):
    """The port's pass on numpy inputs; numpy (keys, vals, counts,
    overflow) back, keys unbiased (pads become 0)."""
    k, v, c, o = trp.radix_partition(bias(u32_to_device(hk, "cpu")),
                                     u32_to_device(vals, "cpu"), *args, **kw)
    return to_numpy_u32(unbias(k)), to_numpy_u32(v), c.numpy(), int(o)


def _runs(k, v, run_of):
    """(run, key, value) triples of the live slots, sorted."""
    m = run_of >= 0
    t = np.stack([run_of[m], k[m].astype(np.int64), v[m].astype(np.int64)])
    return t[:, np.lexsort(t[::-1])]


def _compare(hk, vals, bits, skip=0, cap=0, tile=4096, want_ovf=0):
    jk, jv, jc, jo = (np.asarray(x) for x in radix_partition_pallas(
        jnp.asarray(hk), jnp.asarray(vals), bits, skip_bits=skip, cap=cap,
        tile=tile, interpret=True))
    pk, pv, pc, po = _port(hk, vals, bits, skip, cap, tile)
    ek, ev, run_of, ec, eo = _expected(hk, vals, bits, skip, cap, tile)
    assert int(jo) == po == eo == want_ovf
    np.testing.assert_array_equal(pc, np.asarray(jc))
    np.testing.assert_array_equal(pc, ec)
    assert pk.shape == jk.shape == ek.shape
    # the port: slot for slot the stable layout
    np.testing.assert_array_equal(pk, ek)
    np.testing.assert_array_equal(pv, ev)
    # the JAX function: same live slots, same multiset in every run
    np.testing.assert_array_equal(jk != 0, ek != 0)
    np.testing.assert_array_equal(_runs(jk, jv, run_of),
                                  _runs(ek, ev, run_of))
    return pk, pv, pc


def _data(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(1, 2**32, n, dtype=np.uint32),
            rng.integers(0, 2**32, n, dtype=np.uint32))


def test_uniform_keys_8way():
    _compare(*_data(20000, 0), bits=3)


def test_16way_with_nulls_and_multiple_tiles():
    hk, vals = _data(30000, 1)
    hk[np.random.default_rng(1).integers(0, 30000, 3000)] = 0
    _, _, counts = _compare(hk, vals, bits=4, tile=4096)
    assert counts.sum() == (hk != 0).sum()


def test_skip_bits_second_pass():
    hk, vals = _data(8192, 2)
    hk = (hk >> np.uint32(3)) | np.uint32(5 << 29)  # shared top 3 bits
    _compare(hk, vals, bits=4, skip=3)


def test_skewed_keys_detect_overflow():
    hk = np.full(8192, 0x9E3779B1, dtype=np.uint32)
    vals = np.arange(8192, dtype=np.uint32)
    _, _, counts = _compare(hk, vals, bits=3, cap=512, tile=4096,
                            want_ovf=1)
    assert counts.sum() == 8192  # counts stay exact


def test_explicit_cap():
    hk, vals = _data(12000, 4)
    pk, _, _ = _compare(hk, vals, bits=3, cap=3000, tile=2048)
    tile, _, mrr, cap = trp.geometry(12000, 3, 3000, 2048)
    assert (tile, cap) == (2048, 3072 + mrr * 128)
    assert len(pk) == 8 * cap


def test_two_pass_composition():
    """Pass 1 on 3 bits, then pass 2 on the next 3 over every pass-1
    region, per region and batched: both equal, and the final regions
    hold the direct 6-bit oracle's multisets."""
    hk, vals = _data(16384, 3)
    k1, v1, _ = _compare(hk, vals, bits=3)
    cap1 = len(k1) // 8
    for p1 in range(8):
        region = slice(p1 * cap1, (p1 + 1) * cap1)
        _compare(k1[region], v1[region], bits=3, skip=3)
    per = [_port(k1[p * cap1:(p + 1) * cap1], v1[p * cap1:(p + 1) * cap1],
                 3, 3) for p in range(8)]
    batched = _port(k1, v1, 3, 3, regions=8)
    np.testing.assert_array_equal(batched[0],
                                  np.concatenate([p[0] for p in per]))
    np.testing.assert_array_equal(batched[1],
                                  np.concatenate([p[1] for p in per]))
    np.testing.assert_array_equal(batched[2],
                                  np.concatenate([p[2] for p in per]))
    assert batched[3] == 0
    want = radix_partition_oracle(hk, vals, 6)
    cap2 = len(batched[0]) // 64
    for p in range(64):
        rk = batched[0][p * cap2:(p + 1) * cap2]
        rv = batched[1][p * cap2:(p + 1) * cap2]
        m = rk != 0
        assert sorted(zip(rk[m], rv[m])) == sorted(zip(*want[p]))


def test_empty_input_clean_overflow():
    k, v, c, o = _port(np.zeros(0, np.uint32), np.zeros(0, np.uint32), 3)
    jk = radix_partition_pallas(jnp.zeros(0, jnp.uint32),
                                jnp.zeros(0, jnp.uint32), 3, interpret=True)
    assert o == 0 and c.sum() == 0 and (k == 0).all() and (v == 0).all()
    assert len(k) == len(jk[0]) and len(k) % (8 * 128) == 0


@pytest.mark.parametrize("bad", [dict(bits=0), dict(bits=13),
                                 dict(bits=3, skip_bits=32),
                                 dict(bits=3, tile=1000),
                                 dict(bits=3, regions=3)])
def test_refuses_what_the_kernel_does_not_take(bad):
    hk = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError):
        trp.radix_partition(hk, hk.clone(), **bad)


def _scrambled(n, seed):
    rng = np.random.default_rng(seed)
    keys = np.unique(rng.integers(1, 2**32, n + 500, dtype=np.uint32))[:n]
    hk = np.array(hashed_key(jnp.asarray(keys), 0x9E3779B1))
    return hk, rng.integers(0, 2**32, n, dtype=np.uint32)


def _multipass(hk, vals, pass_bits):
    k, v, c, o = trp.multipass_partition(bias(u32_to_device(hk, "cpu")),
                                         u32_to_device(vals, "cpu"),
                                         pass_bits)
    return to_numpy_u32(unbias(k)), to_numpy_u32(v), c.numpy(), int(o)


@pytest.mark.parametrize("pass_bits", [(3, 3), (6,)])
def test_multipass_matches_jax(pass_bits):
    """At this size every region is one tile, so per-tile runs are whole
    regions and even the live masks agree across the passes."""
    hk, vals = _scrambled(2048, 5)
    jk, jv, jc, jo = (np.asarray(x) for x in jax_multipass(
        jnp.asarray(hk), jnp.asarray(vals), pass_bits, interpret=True))
    pk, pv, pc, po = _multipass(hk, vals, pass_bits)
    assert po == int(jo) == 0
    np.testing.assert_array_equal(pc, jc)
    assert pk.shape == jk.shape
    np.testing.assert_array_equal(pk != 0, jk != 0)
    cap = len(pk) // len(pc)
    want = radix_partition_oracle(hk, vals, sum(pass_bits))
    for p in range(len(pc)):
        r = slice(p * cap, (p + 1) * cap)
        got = sorted(zip(pk[r][pk[r] != 0], pv[r][pk[r] != 0]))
        assert got == sorted(zip(jk[r][jk[r] != 0], jv[r][jk[r] != 0]))
        assert got == sorted(zip(*want[p]))


def test_multipass_4096way_against_the_oracle():
    """The reference CPRA's 4096-way fanout as two 6-bit passes, held
    against the numpy oracle and a bincount only (the JAX function at this
    fanout is minutes-slow in interpret mode)."""
    hk, vals = _scrambled(8192, 41)
    k, v, counts, ovf = _multipass(hk, vals, (6, 6))
    assert ovf == 0 and counts.shape == (4096,)
    pid = (hk >> np.uint32(20)).astype(np.int64)
    np.testing.assert_array_equal(counts, np.bincount(pid, minlength=4096))
    cap = len(k) // 4096
    want = radix_partition_oracle(hk, vals, 12)
    live = k != 0
    assert live.sum() == 8192
    for p in range(4096):
        r = slice(p * cap, (p + 1) * cap)
        assert sorted(zip(k[r][live[r]], v[r][live[r]])) == \
            sorted(zip(*want[p]))


def test_multipass_keeps_the_reference_unroll_cap():
    hk = torch.zeros(1024, dtype=torch.int32)
    with pytest.raises(ValueError, match="64"):
        trp.multipass_partition(hk, hk.clone(), (7, 3))


@pytest.mark.parametrize("bits", range(1, trp.MAX_BITS + 1))
def test_scatter_geometry_fits_one_block(bits):
    """Staging area, per-warp counters (a padded column per warp) and the
    per-partition arrays fit one block's shared memory at every fanout;
    the main path's 64-way passes get the full block."""
    threads, sub, smem = trp.scatter_geometry(bits)
    F = 1 << bits
    assert threads % 32 == 0 and 32 <= threads <= trp.SCATTER_THREADS
    assert sub == threads * trp.SUBCHUNK_PER_THREAD
    assert smem == 4 * (2 * sub + F * (threads // 32 + 1) + 4 * F)
    assert smem <= trp.SMEM_LIMIT == 232448
    if bits <= 6:
        assert (threads, sub) == (512, 4096)


def _subchunk_model(hk, vals, bits, skip, cap, tile, regions, sub):
    """The kernel's scatter in numpy: a block per tile walks it in
    sub-chunks of `sub` tuples; within a sub-chunk each live tuple's rank
    in its partition is its input order; a running offset per partition
    carries over the sub-chunks.  Destinations and overflow come from the
    port's own histogram rule."""
    F = 1 << bits
    n = len(hk) // regions
    tile, n_tiles, mrr, cap = trp.geometry(n, bits, cap, tile)
    key_t = bias(u32_to_device(hk, "cpu"))
    pid = trp._pids(key_t, bits, skip).numpy()
    cnt = np.zeros((regions * n_tiles, F), np.int32)
    for g in range(regions * n_tiles):
        r, t = divmod(g, n_tiles)
        seg = pid[r * n + t * tile: r * n + min((t + 1) * tile, n)]
        cnt[g] = np.bincount(seg[seg < F], minlength=F)
    dst, counts, overflow = trp._destinations(torch.from_numpy(cnt), regions,
                                              mrr, cap)
    dst = dst.numpy()
    out_k = np.zeros(regions * F * cap, np.uint32)
    out_v = np.zeros(regions * F * cap, np.uint32)
    for g in range(regions * n_tiles):
        r, t = divmod(g, n_tiles)
        lo, hi = r * n + t * tile, r * n + min((t + 1) * tile, n)
        off = np.zeros(F, np.int64)
        for c0 in range(lo, hi, sub):
            p = pid[c0:min(c0 + sub, hi)]
            for q in np.unique(p[p < F]):
                at = c0 + np.nonzero(p == q)[0]  # input order
                if dst[g, q] >= 0:
                    slot = dst[g, q] * 128 + off[q] + np.arange(len(at))
                    out_k[slot] = hk[at]
                    out_v[slot] = vals[at]
                off[q] += len(at)
    return out_k, out_v, counts.numpy(), int(overflow)


@pytest.mark.parametrize("n,bits,skip,cap,tile,regions,sub,nulls,ovf", [
    (6000, 3, 0, 0, 2048, 1, 256, 300, 0),  # 8 sub-chunks a tile
    (5000, 2, 5, 0, 1536, 1, 1024, 0, 0),  # tile = 1.5 sub-chunks, ragged
    (3 * 2000, 3, 3, 0, 1024, 3, 384, 100, 0),  # regions, ragged
    (4096, 3, 0, 512, 2048, 1, 512, 0, 1),  # an overflowing region
])
def test_subchunked_scatter_model_matches_plain(n, bits, skip, cap, tile,
                                                regions, sub, nulls, ovf):
    """Running offsets across sub-chunks keep the scatter stable: the
    model equals the plain version slot for slot, pads included."""
    hk, vals = _data(n, n + sub)
    rng = np.random.default_rng(sub)
    hk[rng.integers(0, n, nulls)] = 0
    if ovf:
        hk[: n // 2] = 0x9E3779B1
    want = _port(hk, vals, bits, skip, cap, tile, regions)
    got = _subchunk_model(hk, vals, bits, skip, cap, tile, regions, sub)
    assert got[3] == want[3] == ovf
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (want[0] != 0).sum() > n // 4
