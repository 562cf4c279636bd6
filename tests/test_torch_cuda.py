"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX (the machine with the card has none): the kernels are
held against the plain versions, which the other test_torch_* files hold
against the JAX package.  On the card, run it without the JAX-importing
conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import dataclasses

from hash_join_codes_knl_tpu_torch.engine import npj, phj
from hash_join_codes_knl_tpu_torch.engine.config import (
    DEFAULT_FACTOR,
    JoinPlan,
    plan_join,
)
from hash_join_codes_knl_tpu_torch.engine.convert import result_to_numpy
from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
from hash_join_codes_knl_tpu_torch.ops import merge_probe as mp
from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg
from hash_join_codes_knl_tpu_torch.ops import partition as pa
from hash_join_codes_knl_tpu_torch.ops import probe as pt
from hash_join_codes_knl_tpu_torch.ops import radix_partition as rp
from hash_join_codes_knl_tpu_torch.ops import scramble as sc
from hash_join_codes_knl_tpu_torch.relgen.generate import generate
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    BIAS,
    bias,
    mod_inverse_u32,
    to_numpy_u32,
    u32_to_device,
)
from torch_cases import (
    case_boundary_and_pads,
    case_long_duplicate_runs,
    case_many_tiles,
    case_uniform,
    case_wide_window_max_key,
)

CASES = [case_uniform, case_long_duplicate_runs, case_wide_window_max_key,
         case_boundary_and_pads, case_many_tiles]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    """Decided at run time, so every test worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _equal(got, want):
    torch.cuda.synchronize()
    return all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n,cap,C", [(1000, 1024, 8), (0, 256, 1),
                                     (3 * 2048 - 7, 3 * 2048, 1),
                                     (64 * 3072 - 100, 64 * 3072, 64)])
def test_flat_to_rows_kernel_matches_plain(cuda, n, cap, C):
    rng = np.random.default_rng(n)
    keys = u32_to_device(rng.integers(0, 2**32, n, dtype=np.uint32), cuda)
    vals = u32_to_device(rng.integers(0, 2**32, n, dtype=np.uint32), cuda)
    before = cl.flat_to_rows.launches
    got = cl.flat_to_rows(keys, vals, cap, C, DEFAULT_FACTOR)
    assert cl.flat_to_rows.launches == before + 1
    assert _equal(got, cl.flat_to_rows_torch(keys, vals, cap, C,
                                             DEFAULT_FACTOR))


# the unsigned keys 0, 0xFFFFFFFF and 0x80000000 (INT32_MIN's bits, the
# biased null pad)
SCRAMBLE_EDGES = np.array([0, 0xFFFFFFFF, 0x80000000, 1, 0x7FFFFFFF],
                          np.uint32)


def _scramble_input(n, dev, offset=0):
    rng = np.random.default_rng(n + offset)
    a = rng.integers(0, 2**32, n + offset, dtype=np.uint32)
    a[offset:offset + 5] = SCRAMBLE_EDGES[:n]
    return u32_to_device(a, dev)[offset:]


@pytest.mark.parametrize("xor_in,xor_out", [(0, 0), (BIAS, 0), (0, BIAS),
                                            (BIAS, BIAS)])
@pytest.mark.parametrize("factor", [0x9E3779B1, mod_inverse_u32(0x9E3779B1),
                                    DEFAULT_FACTOR])
@pytest.mark.parametrize("n", [0, 1, 1023, 4096 + 3, 2**24])
def test_mul_u32_kernel_matches_plain(cuda, n, factor, xor_in, xor_out):
    x = _scramble_input(n, cuda)
    before = sc.mul_u32.launches
    got = sc.mul_u32(x, factor, xor_in, xor_out)
    assert sc.mul_u32.launches == before + (n > 0)
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert _equal([got], [sc.mul_u32_torch(x, factor, xor_in, xor_out)])


@pytest.mark.parametrize("offset", [1, 2, 3, 4])
@pytest.mark.parametrize("n", [1, 1023, 4096 + 3, 2**24])
def test_mul_u32_kernel_misaligned_slice(cuda, n, offset):
    """A slice t[offset:] of a 16-byte-aligned column: offsets 1-3 take
    the scalar path, 4 the vector path again with a scalar tail."""
    x = _scramble_input(n, cuda, offset)
    assert x.is_contiguous() and (x.data_ptr() % 16 != 0) == (offset < 4)
    for xi, xo in ((0, 0), (BIAS, BIAS)):
        got = sc.mul_u32(x, 0x9E3779B1, xi, xo)
        assert _equal([got], [sc.mul_u32_torch(x, 0x9E3779B1, xi, xo)])


def test_unscramble_of_flat_to_rows_gives_back_the_keys(cuda):
    """K1's biased scrambled column, unscrambled by the kernel: the
    original keys, and 0 in every pad slot."""
    n, cap = 100_003, 128 * 1024
    rng = np.random.default_rng(5)
    keys = rng.integers(0, 2**32, n, dtype=np.uint32)
    keys[:5] = SCRAMBLE_EDGES
    k = u32_to_device(keys, cuda)
    hk, _ = cl.flat_to_rows(k, k, cap, 8, DEFAULT_FACTOR)
    before = sc.mul_u32.launches
    got = to_numpy_u32(sc.unscramble(hk.reshape(-1), DEFAULT_FACTOR))
    assert sc.mul_u32.launches == before + 1
    np.testing.assert_array_equal(got[:n], keys)
    assert not got[n:].any()


@pytest.mark.parametrize("make", CASES, ids=lambda f: f.__name__)
def test_window_probe_kernels_match_plain(cuda, make):
    bhk, bval, ohk, tile, window = make()
    o, b = bias(u32_to_device(ohk, cuda)), bias(u32_to_device(bhk, cuda))
    v = u32_to_device(bval, cuda)
    wrow, stats = phj._merge_windows(b, o, tile, window, len(bhk) // 128)
    assert int(stats[0]) == 0
    want = mp.merge_probe_torch(o, b, v, wrow, tile, window)
    assert int(want[1].sum()) > 0
    for kernel in (mp.merge_probe, mg.merge_probe_gather):
        before = kernel.launches
        assert _equal(kernel(o, b, v, wrow, tile, window), want), \
            kernel.__name__
        assert kernel.launches == before + 1


def test_dense_kernel_unsorted_windows(cuda):
    """The dense probe must not assume a sorted window."""
    rng = np.random.default_rng(37)
    b = bias(u32_to_device(rng.integers(0, 50, 40 * 128, dtype=np.uint32),
                           cuda))
    v = u32_to_device(rng.integers(0, 2**32, 40 * 128, dtype=np.uint32),
                      cuda)
    o = bias(u32_to_device(rng.integers(0, 50, 16 * 3072, dtype=np.uint32),
                           cuda))
    wrow = torch.from_numpy(rng.integers(0, 30, 16).astype(np.int32)).to(cuda)
    want = mp.merge_probe_torch(o, b, v, wrow, 3072, 2560)
    assert _equal(mp.merge_probe(o, b, v, wrow, 3072, 2560), want)


def _probe_from(rng, pool, n, miss=0.2, null=0.1):
    """n probe keys drawn from `pool`, with random misses and null keys."""
    ok = pool[rng.integers(0, len(pool), n)].astype(np.uint32)
    m = rng.random(n) < miss
    ok[m] = rng.integers(1, 2**32, int(m.sum()), dtype=np.uint32)
    ok[rng.random(n) < null] = 0
    return ok


def _k2_case(dev, case):
    """K2's arguments for a named case: (probe, build keys, build values,
    wrow, tile, window, chunks); unsorted M:N windows with null slots
    unless the case says otherwise."""
    rng = np.random.default_rng(len(case) * 7 + 1)
    window, tile, n_tiles, chunks, null = 1024, 512, 24, 1, 0.4
    if case.startswith("window_"):
        window = int(case.split("_")[1])
        tile = 128 if window == 128 else 512
    elif case == "past_121_chunks":  # the dense fallback: three rounds
        window, tile, n_tiles, null = 160 * 128, 128, 12, 0.0
    elif case == "every_slot_live":
        null = 0.0
    elif case == "chunks_ragged":
        n_tiles, chunks = 21, 8
    rows = max(3 * window // 128, 40)
    pool = np.unique(rng.integers(1, 2**32, window, dtype=np.uint32))
    bk = pool[rng.integers(0, len(pool), rows * 128)]  # M:N
    bk[rng.random(len(bk)) < null] = 0
    bv = rng.integers(0, 2**32, len(bk), dtype=np.uint32)
    if case == "runs_cut_at_edge":
        # sorted runs of 1 to 400 equal keys: the 128-slot window edges
        # cut through them
        bk = np.repeat(np.sort(pool), rng.integers(1, 400, len(pool)))
        bk = bk[: rows * 128]
    ok = _probe_from(rng, pool, n_tiles * tile)
    if case == "all_null_tiles":
        ok[: 3 * tile] = 0
        ok[-tile:] = 0
        bk[: 2 * window] = 0  # and windows with no live slot
    # sorted anchors with repeats: several tiles share a window start
    wrow = np.sort(rng.integers(0, rows - window // 128 + 1, n_tiles))
    wrow[3:7] = wrow[3]
    if case == "chunks_ragged":
        wrow = rng.permutation(wrow)  # anchors in no order
    return (bias(u32_to_device(ok, dev)), bias(u32_to_device(bk, dev)),
            u32_to_device(bv, dev),
            torch.from_numpy(wrow.astype(np.int32)).to(dev), tile, window,
            chunks)


@pytest.mark.parametrize("case", [
    "window_128", "window_896", "window_1024", "window_1280",
    "past_121_chunks", "every_slot_live", "runs_cut_at_edge",
    "all_null_tiles", "chunks_ragged", "unaligned"])
def test_dense_kernel_hash_table(cuda, case):
    """K2's shared-memory table of each window against the plain sweep:
    the widths the engine sends (NPJ's 896, the narrow merge windows, the
    dense fallback past 121 chunks in several rounds), windows with every
    slot live, M:N runs cut at the window edge, all-null tiles and
    windows, anchors in no order over a ragged chunk count, and views off
    a 16-byte boundary."""
    o, b, v, wrow, tile, window, chunks = _k2_case(
        cuda, "every_slot_live" if case == "unaligned" else case)
    if case == "unaligned":
        o, b, v = (torch.cat([x[:1], x])[1:] for x in (o, b[:-1], v[:-1]))
        assert all(x.data_ptr() % 16 for x in (o, b, v))
    want = mp.merge_probe_torch(o, b, v, wrow, tile, window)
    assert int(want[1].sum()) > 0
    if case == "past_121_chunks":
        assert mp.window_table_geometry(window, tile, 12).rounds == 3
    if case in ("runs_cut_at_edge", "every_slot_live"):
        assert int(want[1].max()) > 1
    before = mp.merge_probe.launches
    assert _equal(mp.merge_probe(o, b, v, wrow, tile, window, chunks), want)
    assert mp.merge_probe.launches == before + 1


@pytest.mark.parametrize("dups", [False, True])
def test_dense_kernel_on_npj_table(cuda, dups):
    """K2 on a parked NPJ table from npj_build (null-interleaved, windows
    anchored by home bucket), at the auto window and at max_window."""
    rng = np.random.default_rng(91 + dups)
    n = 30000
    ik = rng.integers(1, 2**32, n, dtype=np.uint32)
    if dups:
        ik = ik[rng.integers(0, 5000, n)]
    plan = npj.plan_npj(n)
    tk, tv, ovf, max_disp = npj.npj_build(
        u32_to_device(ik, cuda),
        u32_to_device(rng.integers(0, 2**32, n, dtype=np.uint32), cuda),
        plan)
    assert int(ovf) == 0
    ok = _probe_from(rng, ik, 150000)
    for window in (plan.auto_window(len(ok), int(max_disp) + 128),
                   plan.max_window):
        k_s, _, wrow, _, window = npj.sorted_probe_layout(
            u32_to_device(ok, cuda), plan, tk.shape[0], window)
        args = (bias(k_s), tk, tv, wrow, plan.tile, window)
        want = mp.merge_probe_torch(*args)
        assert int(want[1].sum()) > 0
        assert _equal(mp.merge_probe(*args), want)


def _k3_case(dev, case):
    """K3's arguments for a named case: a (key, value)-sorted M:N build
    side with pads in front, probes sorted within their chunk, anchors
    from the engine's window rows: (probe, keys, values, wrow, tile,
    window, chunks)."""
    rng = np.random.default_rng(len(case) * 11 + 3)
    window, tile, rows, n_tiles, chunks = 121 * 128, 1024, 160, 16, 1
    if case == "chunks_64_ragged":
        tile, rows, n_tiles, chunks = 256, 200, 64 * 3 - 2, 64
    elif case == "two_pieces":  # a run across the staged pieces' boundary
        window, tile, rows, n_tiles = 160 * 128, 512, 200, 8
    pool = np.unique(rng.integers(1, 2**32, 8000, dtype=np.uint32))
    bk = np.sort(pool[rng.integers(0, len(pool), rows * 128)])
    bk[:300] = 0  # build pads
    if case == "two_pieces":
        bk[15000:18000] = bk[15000]
    bv = rng.integers(0, 2**32, len(bk), dtype=np.uint32)
    order = np.lexsort((bv, bk))
    bk, bv = bk[order], bv[order]
    ok = _probe_from(rng, bk[bk != 0], n_tiles * tile)
    if case == "two_pieces":
        ok[::3] = bk[16000]
    if case == "all_miss":
        ok = np.setdiff1d(rng.integers(1, 2**32, 2 * n_tiles * tile,
                                       dtype=np.uint32), bk)[: n_tiles * tile]
        ok = rng.permutation(ok)
        ok[: tile] = 0xFFFFFFFF  # past the last build key
    per_chunk = -(-n_tiles // chunks) * tile
    for c0 in range(0, len(ok), per_chunk):
        ok[c0 : c0 + per_chunk] = np.sort(ok[c0 : c0 + per_chunk])
    o, b = bias(u32_to_device(ok, dev)), bias(u32_to_device(bk, dev))
    wrow = phj._window_rows(b, o, tile, rows)[0].clamp(
        0, rows - window // 128).to(torch.int32)
    if case == "two_pieces":
        wrow[:] = 0  # every window holds the run at 15000..18000
    if case == "unsorted":
        o = o.view(n_tiles, tile)[:, torch.randperm(
            tile, generator=torch.Generator().manual_seed(5)).to(dev)]
        o = o.reshape(-1).contiguous()
    return o, b, u32_to_device(bv, dev), wrow, tile, window, chunks


@pytest.mark.parametrize("case", ["window_15488", "chunks_64_ragged",
                                  "all_miss", "unsorted", "two_pieces",
                                  "unaligned"])
def test_gather_kernel_staged_window(cuda, case):
    """K3's searches in the staged window against the plain sweep: the
    gather band's widest window (121 chunks), 64 chunks with a ragged last
    chunk, tiles whose probes all miss, probes in no order within their
    tiles, a window in two pieces with a run across their boundary, and
    views off a 16-byte boundary (4-byte copies)."""
    o, b, v, wrow, tile, window, chunks = _k3_case(
        cuda, "window_15488" if case == "unaligned" else case)
    if case == "unaligned":
        o, b, v = (torch.cat([x[:1], x])[1:] for x in (o, b[:-1], v[:-1]))
        assert all(x.data_ptr() % 16 for x in (o, b, v))
    want = mp.merge_probe_torch(o, b, v, wrow, tile, window)
    if case == "all_miss":
        assert int(want[1].sum()) == 0
    else:
        assert int(want[1].sum()) > 0
    if case == "two_pieces":
        assert mg.gather_geometry(window, tile)[0] < window
        assert int(want[1].max()) >= 3000
    before = mg.merge_probe_gather.launches
    assert _equal(mg.merge_probe_gather(o, b, v, wrow, tile, window, chunks),
                  want)
    assert mg.merge_probe_gather.launches == before + 1


def _indexed_inputs(dev, tile, n_tiles, window, seed, staging="vec16"):
    """A sorted M:N build side (at least 40 rows, and 8 rows past the
    window), key-sorted probe tiles and anchors from the engine's own
    window rows, clamped for `window`.  staging "vec4" drops the build
    side's last key and shifts every column off a 16-byte boundary, so K4
    stages its window with 4-byte copies."""
    rng = np.random.default_rng(seed)
    rows = max(40, window // 128 + 8)
    keys = np.unique(rng.integers(1, 2**32, 6000, dtype=np.uint32))[:4000]
    bk = keys[rng.integers(0, len(keys), rows * 128)]
    bk[:300] = 0  # build pads
    bv = rng.integers(0, 2**32, len(bk), dtype=np.uint32)
    order = np.lexsort((bv, bk))
    b, v = bias(u32_to_device(bk[order], dev)), u32_to_device(bv[order], dev)
    ok = keys[rng.integers(0, len(keys), tile * n_tiles)]
    ok[rng.integers(0, len(ok), len(ok) // 20)] = 0  # null probes
    o = bias(u32_to_device(np.sort(ok), dev))
    wrow_raw, _ = phj._window_rows(b, o, tile, rows)
    if staging == "vec4":
        o, b, v = (torch.cat([x[:1], x])[1:] for x in (o, b[:-1], v[:-1]))
        assert b.shape[0] % 4 and all(x.data_ptr() % 16 for x in (o, b, v))
    return o, b, v, wrow_raw.clamp(0, rows - window // 128)


def _indexed_list(dev, pick, n_tiles, seed):
    rng = np.random.default_rng(seed)
    tidx = {"random": rng.permutation(n_tiles)[:9],
            "duplicates": np.array([4, 4, 7, 4, 7, 7, 0]),
            "edges": np.array([0, n_tiles - 1]),
            "outside": np.array([n_tiles, 2, -1, 9, 1 << 30])}[pick]
    return torch.from_numpy(tidx.astype(np.int32)).to(dev)


@pytest.mark.parametrize("staging,chunks", [("vec16", 1), ("vec16", 64),
                                            ("vec4", 5)])
@pytest.mark.parametrize("window", [2560, 15104])
@pytest.mark.parametrize("tile", [1024, 3072])
@pytest.mark.parametrize("pick", ["random", "duplicates", "edges"])
def test_indexed_kernel_matches_plain(cuda, pick, tile, window, staging,
                                      chunks):
    """K4 against its plain version: random tile lists, repeated entries
    and the first and last tile, at a narrow window and at a full 59 KB
    piece (15104 keys), with 16-byte and 4-byte staging, its blocks in
    list order and over 64 and 5 runs of the list (more runs than
    entries, and ragged ones); unlisted slots keep their values."""
    n_tiles = 24
    o, b, v, wrow_w = _indexed_inputs(cuda, tile, n_tiles, window,
                                      seed=tile + window, staging=staging)
    ti = _indexed_list(cuda, pick, n_tiles, tile + len(pick))
    wc = wrow_w[ti.long()].to(torch.int32).contiguous()
    mv0 = torch.randint(-2**31, 2**31, o.shape, dtype=torch.int32,
                        device=cuda)
    mc0 = torch.randint(0, 9, o.shape, dtype=torch.int32, device=cuda)
    want = mg.merge_probe_gather_indexed_torch(o, b, v, wc, ti, mv0.clone(),
                                               mc0.clone(), tile, window)
    before = mg.merge_probe_gather_indexed.launches
    got = mg.merge_probe_gather_indexed(o, b, v, wc, ti, mv0.clone(),
                                        mc0.clone(), tile, window, chunks)
    assert mg.merge_probe_gather_indexed.launches == before + 1
    assert _equal(got, want)
    keep = torch.ones(n_tiles, dtype=torch.bool, device=cuda)
    keep[ti.long()] = False
    keep = keep.repeat_interleave(tile)
    assert torch.equal(got[0][keep], mv0[keep])
    assert int(got[1][~keep].sum()) > 0


@pytest.mark.parametrize("chunks", [1, 3])
@pytest.mark.parametrize("window", [2560, 15104])
def test_indexed_kernel_skips_ids_outside_the_probe(cuda, window, chunks):
    """K4 writes nothing for a tile id outside [0, tiles), as its plain
    version; the slots of unlisted tiles keep their values."""
    tile, n_tiles = 512, 24
    o, b, v, wrow_w = _indexed_inputs(cuda, tile, n_tiles, window, seed=5)
    ti = _indexed_list(cuda, "outside", n_tiles, 0)
    wc = wrow_w[ti.long().clamp(0, n_tiles - 1)].to(torch.int32).contiguous()
    mv0 = torch.randint(-2**31, 2**31, o.shape, dtype=torch.int32,
                        device=cuda)
    mc0 = torch.full(o.shape, -1, dtype=torch.int32, device=cuda)
    got = mg.merge_probe_gather_indexed(o, b, v, wc, ti, mv0.clone(),
                                        mc0.clone(), tile, window, chunks)
    want = mg.merge_probe_gather_indexed_torch(o, b, v, wc, ti, mv0.clone(),
                                               mc0.clone(), tile, window)
    assert _equal(got, want)
    written = (got[1] != -1).view(n_tiles, tile).all(1)
    assert written.nonzero().view(-1).tolist() == [2, 9]


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("staging", ["vec16", "vec4"])
@pytest.mark.parametrize("pick", ["random", "duplicates", "outside"])
def test_indexed_kernel_equals_k3_on_listed_tiles(cuda, pick, staging,
                                                  chunks):
    """K4 and K3 are one kernel body: on every listed tile K4's output is
    K3's over all tiles at the same window and anchors, slot for slot,
    whatever order K4's blocks take the list in."""
    tile, n_tiles, window = 3072, 24, 15104
    o, b, v, wrow_w = _indexed_inputs(cuda, tile, n_tiles, window, seed=11,
                                      staging=staging)
    wrow_w = wrow_w.to(torch.int32).contiguous()
    ti = _indexed_list(cuda, pick, n_tiles, 3)
    wc = wrow_w[ti.long().clamp(0, n_tiles - 1)].contiguous()
    full = mg.merge_probe_gather(o, b, v, wrow_w, tile, window, chunks)
    got = mg.merge_probe_gather_indexed(
        o, b, v, wc, ti, torch.zeros_like(o), torch.zeros_like(o), tile,
        window, chunks)
    torch.cuda.synchronize()
    listed = ti.long()[(ti >= 0) & (ti < n_tiles)]
    for g, f in zip(got, full):
        assert torch.equal(g.view(n_tiles, tile)[listed],
                           f.view(n_tiles, tile)[listed])
    assert int(got[1].sum()) > 0


def _mn_build(seed=7, ni=4096, no=32768, distinct=1500):
    rng = np.random.default_rng(seed)
    ik = rng.integers(1, 2**32, distinct, dtype=np.uint32)[
        rng.integers(0, distinct, ni)]
    iv = rng.integers(0, 2**32, ni, dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, ni, no - no // 4)],
                         rng.integers(1, 2**32, no // 4, dtype=np.uint32)])
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    return ik, iv, ok, ov


def _padded_layout(dev, ni, no, p_bits, slots, tile, distinct, seed):
    """Sort-mode probe layout and dense table over M:N build keys with
    null probes, built by the port's own partition operators."""
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**32, distinct, dtype=np.uint32)
    P = 1 << p_bits
    ik = bias(u32_to_device(keys[rng.integers(0, distinct, ni)], dev))
    ok_np = keys[rng.integers(0, distinct, no)]
    ok_np[rng.integers(0, no, no // 10)] = 0
    ok = bias(u32_to_device(ok_np, dev))
    iv = u32_to_device(rng.integers(0, 2**32, ni, dtype=np.uint32), dev)
    tk, tv, _ = pa.build_dense_table(
        ik, iv, pa.pids_from_hk(ik, p_bits, null_pid=P), P, slots)
    pk, _, offsets, _ = pa.partition_padded(
        ok, ok, pa.pids_from_hk(ok, p_bits, null_pid=P), P, tile)
    return pk, tk, tv, pa.tile_pids(offsets, pk.shape[0] // tile, tile)


@pytest.mark.parametrize("ni,no,p_bits,slots,tile,distinct", [
    (2000, 8192, 4, 256, 128, 3000),  # M:N, tile 128
    (5000, 30000, 3, 1024, 3072, 100000),  # the sort-mode tile
    (60000, 40000, 2, 20480, 256, 200000),  # rows wider than one stage
    (100, 1000, 1, 128, 128, 50),  # heavy duplicates
])
def test_probe_tiles_kernel_matches_plain(cuda, ni, no, p_bits, slots, tile,
                                          distinct):
    args = (*_padded_layout(cuda, ni, no, p_bits, slots, tile, distinct,
                            seed=ni), tile)
    want = pt.probe_tiles_torch(*args)
    assert int(want[1].sum()) > 0
    before = pt.probe_tiles.launches
    assert _equal(pt.probe_tiles(*args), want)
    assert pt.probe_tiles.launches == before + 1


def test_probe_tiles_kernel_on_radix_regions(cuda):
    """Null-interleaved table rows and 128-slot tiles: the radix mode's
    geometry."""
    rng = np.random.default_rng(38)
    ik = bias(u32_to_device(rng.permutation(np.unique(rng.integers(
        1, 2**32, 60000, dtype=np.uint32)))[:50000], cuda))
    ok = ik[torch.from_numpy(rng.integers(0, 50000, 200000)).to(cuda)]
    iv = u32_to_device(rng.integers(0, 2**32, 50000, dtype=np.uint32), cuda)
    tk, tv, _, o1 = rp.multipass_partition(ik, iv, (3, 3))
    pk, _, _, o2 = rp.multipass_partition(ok, ok, (3, 3))
    assert int(o1) == int(o2) == 0
    slots, ocap = tk.shape[0] // 64, pk.shape[0] // 64
    tpid = pa.tile_pids(torch.arange(65, device=cuda) * ocap,
                        pk.shape[0] // 128, 128)
    args = (pk, tk.view(64, slots), tv.view(64, slots), tpid, 128)
    want = pt.probe_tiles_torch(*args)
    assert int(want[1].sum()) == 200000
    assert _equal(pt.probe_tiles(*args), want)


def _constructed_probe_case(dev, case):
    """A table and a probe layout built slot by slot (the kernel takes
    tile_pid as given, so keys need not hash to their partition).
    Returns probe_tiles' arguments."""
    rng = np.random.default_rng(len(case))
    P, slots, tile, tiles_per_pid = 3, 9216, 128, 5
    if case in ("one_index", "block_crosses_partitions"):
        P, slots, tiles_per_pid = 8, 1024, 3
    if case == "block_crosses_partitions":  # 3 tiles a block, on average
        tiles_per_pid = [1, 5, 2, 4, 1, 5, 3, 3]
    if case == "unaligned":
        P, slots, tile, tiles_per_pid = 3, 1030, 129, 4
    pool = np.unique(rng.integers(1, 2**32, 4 * P * slots, dtype=np.uint32))
    pool = rng.permutation(pool)
    tk = pool[: P * slots].reshape(P, slots).copy()
    if case == "full_row":
        pass  # every slot live: 9216 live slots take two rounds
    elif case == "one_key_row":
        tk[0, :] = tk[0, 0]  # one entry, its count split over two rounds
        tk[1, 100:] = tk[1, 7]
    elif case == "one_index":
        # every key of a row starts its walk at the same table entry
        entries = pt.table_geometry(slots, tile, P * tiles_per_pid, P)[1]
        cand = np.unique(rng.integers(1, 2**32, 400_000, dtype=np.uint32))
        idx = pt.table_index(bias(u32_to_device(cand, dev)),
                             entries).cpu().numpy()
        for p in range(P):
            same = cand[idx == p][:40]
            assert len(same) == 40
            tk[p, :] = 0
            tk[p, rng.permutation(slots)[:120]] = np.repeat(same, 3)
    elif case == "null_rows":
        tk[1, :] = 0
        tk[2, 50:] = 0
    else:
        tk[rng.random(tk.shape) < 0.55] = 0  # null-interleaved rows
    tv = rng.integers(0, 2**32, tk.shape, dtype=np.uint32)
    tpid = np.repeat(np.arange(P), tiles_per_pid).astype(np.int32)
    n_tiles = len(tpid)
    pk = np.empty((n_tiles, tile), np.uint32)
    for t in range(n_tiles):
        row = tk[tpid[t]]
        live = row[row != 0]
        src = live if len(live) else pool[-100:]
        pk[t] = src[rng.integers(0, len(src), tile)]
        pk[t, rng.random(tile) < 0.3] = pool[-1 - rng.integers(0, 1000)]
        pk[t, rng.random(tile) < 0.1] = 0
    if case == "null_probe_tiles":
        pk[2:7] = 0
        pk[-1] = 0
    return (bias(u32_to_device(pk.reshape(-1), dev)),
            bias(u32_to_device(tk.reshape(-1), dev)).view(P, slots),
            u32_to_device(tv.reshape(-1), dev).view(P, slots),
            torch.from_numpy(tpid).to(dev), tile)


@pytest.mark.parametrize("case", [
    "full_row", "one_key_row", "one_index", "null_rows", "null_probe_tiles",
    "block_crosses_partitions", "unaligned"])
def test_probe_tiles_kernel_constructed(cuda, case):
    """The hash-table probe on rows that fill a round and spill into a
    second one, on one key repeated through a row (its count summed over
    the rounds), on keys that all start at one table entry, on all-null
    rows and all-null probe tiles, on a block whose run of tiles crosses
    partitions, and on shapes that rule out 16-byte accesses."""
    args = _constructed_probe_case(cuda, case)
    tile, slots = args[4], args[1].shape[1]
    if case == "block_crosses_partitions":
        tpb = pt.table_geometry(slots, tile, args[3].shape[0],
                                args[1].shape[0])[4]
        first_block = args[3][:tpb].tolist()
        assert tpb == 3 and first_block == [0, 1, 1]
    want = pt.probe_tiles_torch(*args)
    assert int(want[1].sum()) > 0
    if case == "one_key_row":
        assert int(want[1].max()) == slots
    assert _equal(pt.probe_tiles(*args), want)
    if case == "unaligned":  # a view that starts off a 16-byte boundary
        pk = torch.cat([args[0][:1], args[0]])[1:]
        assert pk.data_ptr() % 16 and pk.is_contiguous()
        assert _equal(pt.probe_tiles(pk, *args[1:]), want)


def _radix_inputs(dev, n, seed, nulls=0, skew=False):
    rng = np.random.default_rng(seed)
    hk = rng.integers(1, 2**32, n, dtype=np.uint32)
    if skew:
        hk[: n // 2] = 0x9E3779B1
    hk[rng.integers(0, max(n, 1), nulls)] = 0
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    return bias(u32_to_device(hk, dev)), u32_to_device(vals, dev)


@pytest.mark.parametrize("n,bits,skip,cap,tile,nulls,skew,regions", [
    (20000, 3, 0, 0, 4096, 0, False, 1),
    (30000, 4, 0, 0, 4096, 3000, False, 1),
    (8192, 4, 3, 0, 32768, 0, False, 1),
    (8192, 3, 0, 512, 4096, 0, True, 1),  # overflow
    (12000, 3, 0, 3000, 2048, 0, False, 1),  # explicit cap
    (1 << 20, 6, 0, 0, 32768, 1000, False, 1),
    (1 << 20, 12, 0, 0, 32768, 0, False, 1),  # 4096-way in one pass
    (1 << 20, 1, 31, 0, 32768, 0, False, 1),
    (64 * 5000, 6, 6, 0, 32768, 20000, False, 64),  # a pass-2 batch
    (50000, 6, 0, 0, 12288, 500, False, 1),  # tile = 1.5 sub-chunks
    (100000, 6, 0, 0, 20480, 0, False, 1),  # tile = 2.5 sub-chunks, ragged
    (1 << 19, 11, 0, 0, 32768, 100, False, 1),  # a smaller block
    (3 * 70000, 1, 4, 0, 16384, 9000, False, 3),  # long runs, 3 regions
    (0, 3, 0, 0, 32768, 0, False, 1),  # empty: no launch
])
def test_radix_partition_kernel_matches_plain(cuda, n, bits, skip, cap, tile,
                                              nulls, skew, regions):
    hk, vals = _radix_inputs(cuda, n, n + bits, nulls, skew)
    args = (hk, vals, bits, skip, cap, tile, regions)
    want = rp.radix_partition_torch(*args)
    before = rp.radix_partition.launches
    assert _equal(rp.radix_partition(*args), want)
    assert rp.radix_partition.launches == before + (1 if n else 0)
    assert int(want[3]) == (1 if skew else 0)
    assert int(want[2].sum()) == int((hk != bias(torch.zeros_like(hk)))
                                     .sum())


@pytest.mark.parametrize("pass_bits", [(3, 3), (6, 6), (2, 2, 2)])
def test_multipass_kernel_matches_plain(cuda, pass_bits):
    hk, vals = _radix_inputs(cuda, 300000, 39, nulls=100)
    got = rp.multipass_partition(hk, vals, pass_bits)
    cpu = rp.multipass_partition(hk.cpu(), vals.cpu(), pass_bits)
    assert _equal(got, [c.to(cuda) for c in cpu])
    assert int(got[3]) == 0


@pytest.mark.parametrize("case", ["uniform", "mn", "chunked", "gather",
                                  "padded_sort", "padded_argsort",
                                  "radix"])
def test_join_on_card_matches_cpu(cuda, case):
    """join() on CUDA tensors (the kernels) equals join() on CPU tensors
    (the plain versions), slot for slot, with the same final plan."""
    if case == "mn":
        ik, iv, ok, ov = _mn_build()
        plan = None
    else:
        # the radix layout's pads make the plain probe slow on the host
        ni, no = (1024, 8192) if case == "radix" else (4096, 65536)
        inner, outer, _ = generate(seed=17, inner_tuples=ni,
                                   outer_tuples=no, mode="uniform")
        ik, iv, ok, ov = inner.keys, inner.vals, outer.keys, outer.vals
        plan = {
            "uniform": None,
            "chunked": plan_join(4096, 65536, tile=512, probe_chunks=8),
            "gather": plan_join(4096, 65536, tile=512, probe_chunks=16),
            "padded_sort": JoinPlan(p_bits=4, slots=512, tile=256,
                                    probe_impl="pallas"),
            "padded_argsort": JoinPlan(p_bits=3, slots=1024, tile=3072,
                                       skip_bits=2, partition_impl="argsort",
                                       probe_impl="auto"),
            "radix": JoinPlan(p_bits=6, slots=1024, tile=2048,
                              pass_bits=(3, 3), partition_impl="radix",
                              probe_impl="pallas"),
        }[case]
    counts = (cl.flat_to_rows.launches, mp.merge_probe.launches,
              mg.merge_probe_gather.launches, pt.probe_tiles.launches,
              rp.radix_partition.launches)
    res_c, plan_c = phj.join(ik, iv, ok, ov, plan, device=cuda)
    res_h, plan_h = phj.join(ik, iv, ok, ov, plan, device="cpu")
    assert plan_c == plan_h
    got, want = result_to_numpy(res_c), result_to_numpy(res_h)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    after = (cl.flat_to_rows.launches, mp.merge_probe.launches,
             mg.merge_probe_gather.launches, pt.probe_tiles.launches,
             rp.radix_partition.launches)
    assert after[0] >= counts[0] + 2  # build and probe sides
    if case.startswith(("padded", "radix")):
        assert after[3] == counts[3] + 1
        assert after[4] == counts[4] + (4 if case == "radix" else 0)
    else:
        assert after[1] + after[2] > counts[1] + counts[2]


def test_two_class_join_on_card_matches_cpu(cuda):
    """The two-class plan through join() on the card (the narrow dense
    probe, then K4) equals the CPU run slot for slot."""
    rng = np.random.default_rng(131)
    ik = np.unique(rng.integers(1, 2**32, 4896, dtype=np.uint32))[:4096]
    iv = rng.integers(0, 2**32, 4096, dtype=np.uint32)
    ok = ik[rng.integers(0, 4096, 65536)].astype(np.uint32)
    ov = rng.integers(0, 2**32, 65536, dtype=np.uint32)
    plan = dataclasses.replace(plan_join(4096, 65536, tile=512),
                               probe_chunks=8, window=384, window_wide=1920,
                               wide_cap=128)
    before = mg.merge_probe_gather_indexed.launches
    res_c, plan_c = phj.join(ik, iv, ok, ov, plan, device=cuda)
    assert mg.merge_probe_gather_indexed.launches == before + 1
    res_h, plan_h = phj.join(ik, iv, ok, ov, plan, device="cpu")
    assert plan_c == plan_h == plan
    got, want = result_to_numpy(res_c), result_to_numpy(res_h)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("order", ["input", "sorted", "chain"])
def test_npj_join_on_card_matches_cpu(cuda, order):
    """npj_join on the card (K2 over the parked table) equals the CPU run
    (the plain probe), slot for slot, M:N build keys and null probes
    included."""
    rng = np.random.default_rng(83)
    ik = rng.integers(1, 4000, 3000, dtype=np.uint32)
    iv = rng.integers(0, 2**32, 3000, dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, 3000, 50000)],
                         rng.integers(1, 2**32, 20000, dtype=np.uint32)]
                        ).astype(np.uint32)
    ok[::97] = 0
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    plan = npj.plan_npj(len(ik))
    if order == "chain":
        plan = dataclasses.replace(plan, probe_impl="chain")
    kw = dict(order="input" if order == "chain" else order)
    before = mp.merge_probe.launches
    got = npj.npj_join(ik, iv, ok, ov, plan, **kw)  # the card by default
    launched = mp.merge_probe.launches - before
    want = npj.npj_join(ik, iv, ok, ov, plan, device="cpu", **kw)
    assert launched == (0 if order == "chain" else 1)
    assert got[-1] == want[-1]
    for g, w in zip(got[:-1], want[:-1]):
        assert g.device.type == "cuda"
        assert torch.equal(g.cpu(), w)
    assert int(got[-2].max()) > 1


def _mn_cols(seed=91, ni=6000, no=60000, distinct=2000):
    rng = np.random.default_rng(seed)
    ik = rng.integers(1, 2**32, distinct, dtype=np.uint32)[
        rng.integers(0, distinct, ni)]
    ik[:40] = 0xFFFFFFFF
    iv = rng.integers(2**32 - 2**20, 2**32, ni, dtype=np.uint32)
    ok = np.concatenate([ik[rng.integers(0, ni, no - no // 4)],
                         rng.integers(1, 2**32, no // 4, dtype=np.uint32)])
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    return ik, iv, ok, ov


def test_expansion_and_aggregates_on_card_match_cpu(cuda):
    """materialize_expanded, the M:N aggregate, the aligned aggregate and
    the chunked aggregate on the card (scatters and int64 cumsums there)
    equal the CPU runs slot for slot."""
    from hash_join_codes_knl_tpu_torch.ops import aggregate as agg

    cols = _mn_cols()
    res_c, _ = phj.join(*cols, device=cuda)
    res_h, _ = phj.join(*cols, device="cpu")
    for kw in ({}, {"block_rows": 5000}):
        for g, w in zip(phj.materialize_expanded(res_c, *cols[:2], **kw),
                        phj.materialize_expanded(res_h, *cols[:2], **kw)):
            np.testing.assert_array_equal(g, w)
    for kw in ({}, {"block_rows": 4096, "partial_budget": 128}):
        got = agg.aggregate_join_result_expanded(res_c, *cols[:2], **kw)
        want = agg.aggregate_join_result_expanded(res_h, *cols[:2], **kw)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    k, v = u32_to_device(cols[2], cuda), u32_to_device(cols[3], cuda)
    k[::13] = 0
    for name, kw in (("hash_aggregate", {}),
                     ("hash_aggregate_chunked",
                      {"chunks": 8, "partial_cap": 4096}),
                     ("hash_aggregate_auto",
                      {"chunks": 8, "partial_cap": 1024})):
        got = getattr(agg, name)(k, v, **kw)
        want = getattr(agg, name)(k.cpu(), v.cpu(), **kw)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want)), name


def test_staged_validate_and_cli_on_card(cuda, tmp_path, capsys):
    """The staged merge pipeline equals the fused one on the card; the
    checks pass there with the CPU run's stats; the CLI's phj and npj on
    the card (the default device) print the CPU run's join_tuples and
    AGGREGATE and CHECK OK lines."""
    import json

    from hash_join_codes_knl_tpu_torch.cli import main
    from hash_join_codes_knl_tpu_torch.engine.validate import (
        validate_join_result,
    )
    from hash_join_codes_knl_tpu_torch.utils.timing import PhaseTimer

    inner, outer, _ = generate(seed=5, inner_tuples=50_000,
                               outer_tuples=400_000, mode="uniform")
    cols = [u32_to_device(c, cuda) for c in
            (inner.keys, inner.vals, outer.keys, outer.vals)]
    plan = plan_join(50_000, 400_000)
    timer = PhaseTimer()
    staged = phj.phj_join_merge_staged(*cols, plan, timer)
    fused = phj.phj_join_merge(*cols, plan)
    assert _equal([staged.probe_keys, staged.match_vals, staged.match_cnts,
                   staged.build_counts],
                  [fused.probe_keys, fused.match_vals, fused.match_cnts,
                   fused.build_counts])
    assert list(timer.phases) == ["partition_build", "partition_probe",
                                  "windows", "probe"]
    host, _ = phj.join(*(c.cpu() for c in cols), plan)
    assert validate_join_result(staged, outer.keys, plan) == \
        validate_join_result(host, outer.keys, plan)
    assert main(["write", "1", "400000", "50000", "--dir",
                 str(tmp_path)]) == 0
    capsys.readouterr()
    for argv in (["phj", "--check", "--aggregate", "--timelog"],
                 ["npj", "--sorted-order"]):
        runs = []
        for device in ([], ["--device", "cpu"]):
            assert main([argv[0], "1", "400000", "50000", "--dir",
                         str(tmp_path), "--json", *argv[1:], *device]) == 0
            cap = capsys.readouterr()
            runs.append((json.loads(cap.out.strip().splitlines()[-1]),
                         [line for line in cap.err.splitlines()
                          if line.startswith(("CHECK", "AGGREGATE"))]))
        (card, card_lines), (cpu, cpu_lines) = runs
        assert card["join_tuples"] == cpu["join_tuples"] == 400_000
        assert card_lines == cpu_lines
        if argv[0] == "phj":
            assert card["hbm_peak_source"] != "cpu (nominal DDR)"


def _host_cols(res) -> dict:
    return {f: v for f, v in result_to_numpy(res).items()
            if f != "build_counts"}


def test_stream_double_buffered_equals_one_chunk_at_a_time(cuda):
    """stream_join on the card (pinned buffers, a copy stream, events)
    equals the same stages run one chunk at a time from a synchronous
    copy, and the CPU stream, slot for slot; every probe byte crosses to
    the card once."""
    from hash_join_codes_knl_tpu_torch.engine.stream import stream_join

    inner, outer, _ = generate(seed=61, inner_tuples=200_000,
                               outer_tuples=1_300_000, mode="uniform")
    ik, iv, ok, ov = inner.keys, inner.vals, outer.keys, outer.vals
    chunk = 300_000
    live = []
    res = stream_join(ik, iv, ok, ov, chunk, device=cuda,
                      on_chunk=lambda cm, r: live.append(_host_cols(r)))
    host = []
    res_h = stream_join(ik, iv, ok, ov, chunk, device="cpu",
                        on_chunk=lambda cm, r: host.append(_host_cols(r)))
    assert res.plan == res_h.plan and len(live) == len(host) == 5
    assert res.join_tuples == res_h.join_tuples == len(ok)
    tile, window, rows, cap = phj._merge_params(res.plan, len(ik), chunk)
    sort_side, windows, probe = phj._staged_fns(res.plan, tile, window, rows)
    bhk, bval = sort_side(u32_to_device(ik, cuda), u32_to_device(iv, cuda),
                          rows * 128, True)
    for k, (got, want) in enumerate(zip(live, host)):
        sl = slice(k * chunk, (k + 1) * chunk)
        ohk, ov_s = sort_side(u32_to_device(ok[sl], cuda),
                              u32_to_device(ov[sl], cuda), cap)
        one = _host_cols(probe(bhk, bval, ohk, ov_s, *windows(bhk, ohk)))
        for f in want:
            np.testing.assert_array_equal(got[f], one[f], err_msg=f)
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    t = res.transfer
    assert t["h2d_bytes"] == 8 * len(ok)
    assert 0 <= t["hidden_ms"] <= t["h2d_ms"] and t["compute_ms"] > 0


def test_stream_resume_on_card(cuda, tmp_path):
    from hash_join_codes_knl_tpu_torch.engine.stream import (
        SpilledChunk,
        replay_probe_columns,
        stream_join,
    )

    inner, outer, _ = generate(seed=62, inner_tuples=50_000,
                               outer_tuples=400_000, mode="uniform")
    ik, iv, ok, ov = inner.keys, inner.vals, outer.keys, outer.vals
    d = str(tmp_path / "spill")
    live = []
    first = stream_join(ik, iv, ok, ov, 100_000, spill_dir=d, device=cuda,
                        on_chunk=lambda cm, r: live.append(_host_cols(r)))
    blob = tmp_path / "spill" / "chunk_000002_mval.bin"
    raw = bytearray(blob.read_bytes())
    raw[40] ^= 0xFF
    blob.write_bytes(bytes(raw))
    seen = {}

    def on_chunk(cm, payload):
        if isinstance(payload, SpilledChunk):
            sl = slice(cm.index * 100_000, (cm.index + 1) * 100_000)
            pk, pv = replay_probe_columns(ok[sl], ov[sl], first.plan,
                                          len(payload.match_vals), cuda)
            seen[cm.index] = {"probe_keys": pk, "probe_vals": pv,
                              "match_vals": payload.match_vals,
                              "match_cnts": payload.match_cnts}
        else:
            seen[cm.index] = _host_cols(payload)

    second = stream_join(ik, iv, ok, ov, 100_000, spill_dir=d, device=cuda,
                         on_chunk=on_chunk)
    assert [c.resumed for c in second.chunks] == [True, True, False, True]
    assert second.join_tuples == first.join_tuples == len(ok)
    for k, want in enumerate(live):
        for f in want:
            np.testing.assert_array_equal(seen[k][f], want[f], err_msg=f)


def test_grace_phase1_kernel_files_equal_plain(cuda, tmp_path):
    """The radix-pass kernel's partition files (compacted on the card)
    hold the plain pass's rows as multisets, with equal counts and
    checksums; grace_join on the card equals the CPU run partition for
    partition, a hot-key chunk taking the host path in both."""
    import json
    import os

    from hash_join_codes_knl_tpu_torch.engine import grace

    rng = np.random.default_rng(63)
    keys = rng.integers(1, 2**32, 700_000, dtype=np.uint32)
    vals = rng.integers(0, 2**32, 700_000, dtype=np.uint32)
    keys[:2000] = 0  # null keys are dropped
    keys[300_000:500_000] = keys[5000]  # chunk 1: a hot key
    files = {}
    for dev in (cuda, "cpu"):
        d = str(tmp_path / str(dev))
        os.makedirs(d)
        *state, host = grace._partition_side(keys, vals, DEFAULT_FACTOR, 5,
                                             250_000, d, "probe",
                                             device=dev)
        assert host == 1
        meta = json.load(open(os.path.join(d, "probe_partition.json")))
        files[str(dev)] = meta, [
            np.sort(np.fromfile(os.path.join(d, f"probe_{p}_hk.bin"),
                                "<u4").astype(np.uint64) << 32
                    | np.fromfile(os.path.join(d, f"probe_{p}_val.bin"),
                                  "<u4")) for p in range(32)]
    (m_c, f_c), (m_h, f_h) = files[str(cuda)], files["cpu"]
    assert m_c == m_h and sum(m_c["counts"]) == 698_000
    for a, b in zip(f_c, f_h):
        np.testing.assert_array_equal(a, b)
    ik = np.unique(rng.integers(1, 2**32, 60_000, dtype=np.uint32))[:50_000]
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    ok = ik[rng.integers(0, len(ik), 600_000)]
    ov = rng.integers(0, 2**32, len(ok), dtype=np.uint32)
    before = rp.radix_partition.launches
    g_c = grace.grace_join(ik, iv, ok, ov, f_bits=4, chunk_rows=200_000,
                           spill_dir=str(tmp_path / "gc"), device=cuda)
    assert rp.radix_partition.launches - before == 1 + 3
    g_h = grace.grace_join(ik, iv, ok, ov, f_bits=4, chunk_rows=200_000,
                           spill_dir=str(tmp_path / "gh"), device="cpu")
    assert g_c.join_tuples == g_h.join_tuples == len(ok)
    assert [m.join_tuples for m in g_c.partitions] == \
        [m.join_tuples for m in g_h.partitions]


def test_tuner_pick_cached_per_device_name(cuda, tmp_path, monkeypatch):
    import json

    from hash_join_codes_knl_tpu_torch.engine import tune

    path = str(tmp_path / "tune.json")
    got = tune.tuned_probe_chunks(2_000_000, tile=1024, default=99,
                                  candidates=(8, 16), cache_path=path)
    assert got in (8, 16)
    name = torch.cuda.get_device_name(cuda)
    key = f"2000000|1024|8,16|{torch.__version__}|{name}"
    entry = json.load(open(path))[key]
    assert entry["C"] == got and set(entry["times"]) == {"8", "16"}

    def untimed(*a):
        raise AssertionError("a cached verdict was timed again")

    monkeypatch.setattr(tune, "_time_sort", untimed)
    assert tune.tuned_probe_chunks(2_000_000, tile=1024, candidates=(8, 16),
                                   cache_path=path) == got
    monkeypatch.setattr(tune, "_device_name", lambda d: "another card")
    with pytest.raises(AssertionError, match="timed again"):
        tune.tuned_probe_chunks(2_000_000, tile=1024, candidates=(8, 16),
                                cache_path=path)


def _dist_relations(seed=5, ni=4096, no=65536, **kw):
    inner, outer, _ = generate(seed=seed, inner_tuples=ni, outer_tuples=no,
                               mode=kw.pop("mode", "uniform"), **kw)
    return inner.keys, inner.vals, outer.keys, outer.vals


def _dist_runs(meshes, cols, with_padded=True):
    """Every distributed path of parallel/ over `meshes`: cpra_join with
    the sort pack, the radix pack, tier routing, skew and (with_padded)
    a padded radix local plan; the pipelined and two-level steps;
    npj_join_dist; grace_join_dist.  Per rank: the columns of every
    result, on the host."""
    import tempfile

    from hash_join_codes_knl_tpu_torch.parallel import cpra
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        run_ranks,
        shard_null_padded,
        split_2level,
    )
    from hash_join_codes_knl_tpu_torch.parallel.grace_dist import (
        grace_join_dist,
    )
    from hash_join_codes_knl_tpu_torch.parallel.npj_dist import (
        npj_join_dist,
    )

    W = len(meshes)
    plan = JoinPlan(p_bits=6, slots=512, tile=512, pass_bits=(6,))
    padded = JoinPlan(p_bits=4, slots=1024, tile=128, pass_bits=(4,),
                      partition_impl="radix", probe_impl="pallas")
    spill = tempfile.mkdtemp()

    def host(res):
        return [t.cpu() for t in (res.probe_keys, res.probe_vals,
                                  res.match_vals, res.match_cnts,
                                  res.build_counts)]

    def body(m):
        out = {}
        runs = [("sort", {}), ("radix", dict(pack_impl="radix")),
                ("tier", dict(tier_ratio=0.75))]
        if with_padded:
            runs.append(("padded", dict(plan=padded)))
        for name, kw in runs:
            kw.setdefault("plan", plan)
            out[name] = host(cpra.cpra_join(*cols, m, slack=4.0, **kw)[0])
        res, heavy, _ = cpra.cpra_join(*cols, m, plan, slack=4.0, skew=True,
                                       heavy_frac=1 / 64)
        out["skew"] = host(res) + [t.cpu() for t in heavy]
        args = [shard_null_padded(c, m) for c in cols]
        ni, no = len(cols[0]), len(cols[2])
        if W > 1:
            res, ovf = cpra.make_cpra_step_pipelined(
                m, plan, 4 * ni // W**2, 4 * no // W**2, 4)(*args)
            out["pipelined"] = host(res) + [ovf]
            h, c = split_2level(m, 2)
            res, ovf = cpra.make_cpra_step_2level(
                h, c, plan, 4 * ni // W, 4 * no // W)(*args)
            out["2level"] = host(res) + [ovf]
        mv, mc, total, _ = npj_join_dist(*cols, m)
        out["npj"] = [mv, mc, total]
        g = grace_join_dist(*cols, m, f_bits=4, chunk_rows=ni,
                            spill_dir=f"{spill}/{m.device.type}")
        out["grace"] = [g.join_tuples, [(p.build_rows, p.probe_rows,
                                         p.join_tuples) for p in g.partitions]]
        return out

    return run_ranks(meshes, body, timeout_s=600)


def _same_runs(got, want):
    for r, (g, w) in enumerate(zip(got, want)):
        assert g.keys() == w.keys()
        for name in g:
            for a, b in zip(g[name], w[name]):
                if isinstance(a, torch.Tensor):
                    assert torch.equal(a, b), (r, name)
                elif isinstance(a, np.ndarray):
                    np.testing.assert_array_equal(a, b, err_msg=name)
                else:
                    assert a == b, (r, name)


def test_distributed_thread_ranks_on_card_match_cpu(cuda):
    """Four gloo thread ranks sharing the card: every distributed path's
    results equal, rank by rank and slot by slot, the same ranks' run on
    the CPU (the plain versions); the kernels were launched."""
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        thread_meshes,
    )

    cols = _dist_relations()
    before = {k: f.launches for k, f in (
        ("rp", rp.radix_partition), ("pt", pt.probe_tiles),
        ("cl", cl.flat_to_rows))}
    got = _dist_runs(thread_meshes(4, cuda, timeout_s=300), cols)
    assert all(f.launches > before[k] for k, f in (
        ("rp", rp.radix_partition), ("pt", pt.probe_tiles),
        ("cl", cl.flat_to_rows)))
    _same_runs(got, _dist_runs(thread_meshes(4, "cpu", timeout_s=300), cols))


def test_distributed_nccl_world_of_one_on_card(cuda, tmp_path):
    """A world of one NCCL rank (a FileStore): cpra_join's shortcut and
    its full skew step on Zipf z=1.0 probes, npj_join_dist and
    grace_join_dist equal the CPU world of one.  (A padded radix plan
    overflows its pass's run bound on these probes, on both devices.)"""
    import torch.distributed as dist

    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        data_mesh,
        initialize,
        thread_meshes,
    )

    cols = _dist_relations(seed=6, mode="zipf", zipf=1.0)
    initialize(f"file://{tmp_path}/store", world_size=1, rank=0,
               backend="nccl")
    try:
        mesh = data_mesh()
        assert mesh.size == 1 and mesh.device.type == "cuda"
        got = _dist_runs([mesh], cols, with_padded=False)
    finally:
        dist.destroy_process_group()
    _same_runs(got, _dist_runs(thread_meshes(1, "cpu"), cols,
                               with_padded=False))


def _fuzz_on_card(cuda, tmp_path, campaign, seed):
    """A draw of tests/torch_fuzz_cases.py on the card equals the same
    draw on the CPU, output for output and slot for slot (the final plans
    included), and agrees with the port's oracle."""
    import torch_fuzz_cases as fz

    from hash_join_codes_knl_tpu_torch.engine.oracle import (
        join_oracle,
        multiset_digest,
    )

    if not fz.card_vs_cpu(campaign, seed, cuda, str(tmp_path), join_oracle,
                          multiset_digest):
        pytest.skip("degenerate after shard rounding")


def _fuzz_draws(*campaigns):
    from torch_fuzz_cases import all_draws

    return [pytest.param(c, s, id=f"{c}-{s}") for c, s in all_draws()
            if c in campaigns]


@pytest.mark.parametrize("campaign,seed", _fuzz_draws(
    "merge", "radix", "npj", "stream", "columns", "aggregate"))
def test_fuzz_draw_on_card_matches_cpu(cuda, tmp_path, campaign, seed):
    """The single-device campaigns of tests/test_fuzz.py on the card: the
    merge join, the padded radix join with the tile probe, NPJ in both
    orders, the stream's crash and resume, the four column-join modes
    and the composite key, the aggregates."""
    _fuzz_on_card(cuda, tmp_path, campaign, seed)


@pytest.mark.parametrize("campaign,seed", _fuzz_draws("cpra", "grace"))
def test_fuzz_distributed_draw_on_card_matches_cpu(cuda, tmp_path, campaign,
                                                   seed):
    """cpra_join and grace_join_dist on W gloo thread ranks sharing the
    card against the same ranks on the CPU, rank by rank."""
    _fuzz_on_card(cuda, tmp_path, campaign, seed)
