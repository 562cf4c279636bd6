"""The launch geometry and the algorithms of the port's window-probe
kernels, on the CPU: K2's shared-memory table of a window
(ops/merge_probe.py ``window_table_geometry``, csrc/merge_probe.cu) and
K3's search in a staged window (ops/merge_probe_gather.py
``gather_geometry``, csrc/merge_probe_gather.cu), and the block order
both kernels share (``block_tiles``).  Plain Python models of exactly
what the kernels do are held against the plain version
``merge_probe_torch``, slot for slot.  The kernels themselves run in
tests/test_torch_cuda.py, on the card."""

import dataclasses

import numpy as np
import pytest
import torch

from hash_join_codes_knl_tpu_torch.engine import npj, phj
from hash_join_codes_knl_tpu_torch.engine.config import plan_join
from hash_join_codes_knl_tpu_torch.ops import merge_probe as mp
from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg
from hash_join_codes_knl_tpu_torch.ops._build import SMEM_LIMIT
from hash_join_codes_knl_tpu_torch.ops.probe import ENTRY_BYTES
from hash_join_codes_knl_tpu_torch.utils.hashing import bias, u32_to_device

NULL = -2**31
TILES = [128, 256, 512, 1024, 2048, 3072, 4096]


def _allowed_windows(tile):
    """Every window an explicit plan may give K2 at this tile (the dense
    ceiling of _check_explicit_window) and every window NPJ's sorted
    probe may reach (NpjPlan.max_window)."""
    rows = max(1, tile // 128)
    dense = phj.DENSE_ROWCHUNK_BUDGET // rows
    npj_max = npj.NpjPlan(buckets=1 << 20, tile=tile).max_window // 128
    return [c * 128 for c in range(1, max(dense, npj_max) + 1)]


@pytest.mark.parametrize("tile", TILES)
def test_window_table_geometry_covers_every_allowed_window(tile):
    """Within one block's shared memory, entries a power of two of at
    least twice the round, a chunk of four slots a thread within a round,
    and the rounds a window with every slot live takes."""
    windows = _allowed_windows(tile)
    plan = dataclasses.replace(plan_join(1 << 20, 1 << 24, tile=tile),
                               probe_impl="merge_pallas")
    phj._check_explicit_window(plan, tile, windows[-1])
    with pytest.raises(ValueError):
        phj._check_explicit_window(plan, tile, windows[-1] + 128)
    for window in windows:
        g = mp.window_table_geometry(window, tile, 1000)
        assert g.entries & (g.entries - 1) == 0
        assert g.entries >= 2 * g.stage
        assert g.smem == ENTRY_BYTES * g.entries <= SMEM_LIMIT
        assert g.threads % 32 == 0 and 32 <= g.threads <= 1024
        assert 4 * g.threads <= g.stage and g.stage % (4 * g.threads) == 0
        assert g.rounds == -(-window // g.stage)
        assert (g.rounds == 1) == (window <= g.stage)
        assert 1 <= g.tiles_per_block
        assert g.tiles_per_block == 1 or (
            g.tiles_per_block * tile <= mp.BLOCK_PROBES)
    # NPJ's default window at 16M x 256M: one round of a 24 KB table
    assert mp.window_table_geometry(896, 2048, 125_000)[:4] == (
        1024, 2048, 24 * 1024, 256)


def test_window_table_geometry_refuses_nonsense():
    for bad in [(0, 128, 4), (128, 0, 4), (128, 128, -1)]:
        with pytest.raises(ValueError):
            mp.window_table_geometry(*bad)


def _segments(wrow, t0, t1, window, n_build):
    """The kernel's segments of tiles [t0, t1): runs of equal clamped
    window starts."""
    start = lambda t: max(0, min(int(wrow[t]) * 128, n_build - window))
    t = t0
    while t < t1:
        s, u = start(t), t + 1
        while u < t1 and start(u) == s:
            u += 1
        yield s, t, u
        t = u


def _dense_model(pk, bk, bv, wrow, tile, window, chunks, stage, threads,
                 tiles_per_block):
    """K2 in plain Python: the blocks of block_tiles, each segment's
    window read in chunks of 4 * threads slots, a round taking whole
    chunks while its live slots stay within `stage`, a dict key ->
    (count, max) per round; the first round writes, later ones add.
    Returns (mv, mc, the most rounds a segment took)."""
    mv = np.zeros(len(pk), np.int64)
    mc = np.zeros(len(pk), np.int64)
    chunk, most = 4 * threads, 0
    first, end = mp.block_tiles(len(pk) // tile, chunks, tiles_per_block)
    for t0, t1 in zip(first.tolist(), end.tolist()):
        for s, a, b in _segments(wrow, t0, t1, window, len(bk)):
            w0, rounds = 0, 0
            while True:
                table, room = {}, stage
                while w0 < window:
                    live = [j for j in range(s + w0, s + min(w0 + chunk,
                                                              window))
                            if bk[j] != NULL]
                    if window - w0 > room and len(live) > room:
                        break
                    room -= len(live)
                    for j in live:
                        c, m = table.get(bk[j], (0, 0))
                        table[bk[j]] = (c + 1, max(m, bv[j] & 0xFFFFFFFF))
                    w0 += chunk
                for i in range(a * tile, b * tile):
                    c, m = table.get(pk[i], (0, 0)) if pk[i] != NULL else (
                        0, 0)
                    if rounds == 0:
                        mc[i], mv[i] = c, m
                    elif c:
                        mc[i], mv[i] = mc[i] + c, max(mv[i], m)
                rounds += 1
                if w0 >= window:
                    break
            most = max(most, rounds)
    return mv, mc, most


def _window_case(case):
    """(probe, build keys, build values, wrow, tile, window, chunks) as
    CPU tensors of biased keys, for a named case."""
    rng = np.random.default_rng(len(case))
    tile, n_tiles, window, rows, chunks = 64, 12, 512, 16, 1
    pool = rng.integers(1, 2**32, 300, dtype=np.uint32)
    if case == "npj_table":
        ik = pool[rng.integers(0, 300, 600)]  # M:N
        plan = dataclasses.replace(npj.plan_npj(len(ik)), tile=tile)
        tk, tv, ovf, max_disp = npj.npj_build(
            u32_to_device(ik, "cpu"),
            u32_to_device(rng.integers(0, 2**32, 600, dtype=np.uint32),
                          "cpu"), plan)
        assert int(ovf) == 0 and (tk == NULL).any()
        ok = pool[rng.integers(0, 300, n_tiles * tile)]
        ok[::7] = 0
        k_s, _, wrow, _, window = npj.sorted_probe_layout(
            u32_to_device(ok, "cpu"), plan, tk.shape[0],
            plan.auto_window(len(ok), int(max_disp) + 128))
        return bias(k_s), tk, tv, wrow, tile, window, 1
    if case == "every_slot_live":
        bk = pool[rng.integers(0, 300, rows * 128)]
    else:  # sorted runs of 1 to 90 equal keys, cut by the window edges
        bk = np.repeat(np.sort(pool), rng.integers(1, 90, 300))[: rows * 128]
        chunks = 5  # and tiles of five chunks, the last one short
    ok = bk[rng.integers(0, len(bk), n_tiles * tile)]
    ok[rng.random(len(ok)) < 0.2] = 1  # misses
    ok[::9] = 0
    wrow = np.sort(rng.integers(0, rows - window // 128 + 1, n_tiles))
    wrow[2:5] = wrow[2]
    bv = rng.integers(0, 2**32, len(bk), dtype=np.uint32)
    return (bias(u32_to_device(ok, "cpu")), bias(u32_to_device(bk, "cpu")),
            u32_to_device(bv, "cpu"),
            torch.from_numpy(wrow.astype(np.int32)), tile, window, chunks)


@pytest.mark.parametrize("case", ["every_slot_live", "runs_cut",
                                  "npj_table"])
@pytest.mark.parametrize("stage,threads,tiles_per_block",
                         [(None, None, None), (128, 8, 2), (64, 16, 5)])
def test_dense_rounds_model_matches_plain(case, stage, threads,
                                          tiles_per_block):
    """K2's per-window rounds equal the plain sweep on windows with every
    slot live (several rounds when the stage is small), on sorted windows
    whose M:N runs the window edges cut, and on NPJ's parked table (null
    slots never inserted), at the shipped geometry and at small stages."""
    pk, bk, bv, wrow, tile, window, chunks = _window_case(case)
    geo = mp.window_table_geometry(window, tile, pk.shape[0] // tile)
    stage = stage or geo.stage
    mv, mc, most = _dense_model(
        pk.numpy(), bk.numpy(), bv.numpy().astype(np.int64), wrow.numpy(),
        tile, window, chunks, stage, threads or geo.threads,
        tiles_per_block or geo.tiles_per_block)
    want_mv, want_mc = mp.merge_probe_torch(pk, bk, bv, wrow, tile, window)
    np.testing.assert_array_equal(mc, want_mc.numpy())
    np.testing.assert_array_equal(
        mv, want_mv.numpy().astype(np.int64) & 0xFFFFFFFF)
    assert want_mc.max() > 1
    if case == "every_slot_live":
        assert most == -(-window // stage)


def _run_end(keys, lo, p):
    """The kernel's run_end: steps of 1, 2, 4, ... past the run's start,
    then a binary search inside the last step."""
    n = len(keys)
    if lo >= n or keys[lo] != p:
        return lo
    a, step = lo + 1, 1
    b = a
    while b < n and keys[b] == p:
        a = b + 1
        step <<= 1
        b = a + step - 1
    e = min(b, n)
    while a < e:
        m = (a + e) >> 1
        if keys[m] <= p:
            a = m + 1
        else:
            e = m
    return a


def _gather_model(pk, bk, bv, wrow, tile, window, piece):
    """K3 in plain Python: each tile's window staged in pieces of `piece`
    keys; a probe inside [first, last] key of a piece takes a lower bound
    and the run's end there; the first piece writes, later ones add their
    count and take their value on a hit."""
    mv = np.zeros(len(pk), np.int64)
    mc = np.zeros(len(pk), np.int64)
    for t in range(len(pk) // tile):
        start = max(0, min(int(wrow[t]) * 128, len(bk) - window))
        for w0 in range(0, window, piece):
            keys = bk[start + w0 : start + min(window, w0 + piece)]
            for i in range(t * tile, (t + 1) * tile):
                p, c, v = pk[i], 0, 0
                if p != NULL and keys[0] <= p <= keys[-1]:
                    lo = int(np.searchsorted(keys, p, "left"))
                    hi = _run_end(keys, lo, p)
                    c = hi - lo
                    if c:
                        v = int(bv[start + w0 + hi - 1]) & 0xFFFFFFFF
                if w0 == 0:
                    mc[i], mv[i] = c, v
                elif c:
                    mc[i], mv[i] = mc[i] + c, v
    return mv, mc


@pytest.mark.parametrize("piece", [None, 256, 128])
@pytest.mark.parametrize("shuffle", [False, True])
def test_gather_pieces_model_matches_plain(piece, shuffle):
    """K3's staged search equals the plain sweep on a (key, value)-sorted
    M:N window, in one piece and in pieces whose boundaries cut runs, with
    the probes sorted within their tiles or not."""
    rng = np.random.default_rng(3)
    tile, rows, window = 64, 12, 640
    pool = np.unique(rng.integers(1, 2**32, 120, dtype=np.uint32))
    bk = np.repeat(pool, rng.integers(1, 40, len(pool)))[: rows * 128]
    bk[:50] = 0  # build pads in front
    bv = rng.integers(0, 2**32, len(bk), dtype=np.uint32)
    order = np.lexsort((bv, bk))
    bk, bv = bk[order], bv[order]
    ok = np.sort(bk[rng.integers(0, len(bk), 10 * tile)])
    ok[::11] = 0
    o, b = bias(u32_to_device(ok, "cpu")), bias(u32_to_device(bk, "cpu"))
    wrow = phj._window_rows(b, o, tile, rows)[0].clamp(
        0, rows - window // 128).to(torch.int32)
    if shuffle:
        o = o.view(-1, tile)[:, torch.from_numpy(rng.permutation(tile))]
        o = o.reshape(-1).contiguous()
    v = u32_to_device(bv, "cpu")
    piece = piece or mg.gather_geometry(window, tile)[0]
    mv, mc = _gather_model(o.numpy(), b.numpy(), v.numpy(), wrow.numpy(),
                           tile, window, piece)
    want_mv, want_mc = mp.merge_probe_torch(o, b, v, wrow, tile, window)
    np.testing.assert_array_equal(mc, want_mc.numpy())
    np.testing.assert_array_equal(
        mv, want_mv.numpy().astype(np.int64) & 0xFFFFFFFF)
    assert want_mc.max() > 1


@pytest.mark.parametrize("tile", TILES)
def test_gather_staged_window_fits_at_the_gather_ceiling(tile):
    """The widest window the gather band sends (121 chunks, or the row
    budget's cap at this tile) is staged in one piece within one block's
    shared memory, three blocks to an SM; wider windows (a forced gather
    probe) take pieces of a 128-slot multiple."""
    rows = max(1, tile // 128)
    cap = min(phj.GATHER_MAX_CHUNKS, phj.GATHER_ROWCHUNK_BUDGET // rows)
    for window in range(128, cap * 128 + 1, 128):
        piece, smem, threads = mg.gather_geometry(window, tile)
        assert piece == window and smem == 4 * window <= SMEM_LIMIT
        assert threads % 32 == 0 and 32 <= threads <= mg.MAX_THREADS
    assert 3 * (4 * mg.MAX_PIECE + 1024) <= 228 * 1024
    piece, smem, _ = mg.gather_geometry(160 * 128, tile)
    assert piece == mg.MAX_PIECE and piece % 128 == 0 and smem <= SMEM_LIMIT
    if tile == 3072:  # the headline plan's window
        assert mg.gather_geometry(15104, tile) == (15104, 60416, 256)


@pytest.mark.parametrize("chunks", [1, 8, 64])
@pytest.mark.parametrize("n_tiles", [1, 7, 64, 65, 190, 1000])
@pytest.mark.parametrize("tiles_per_block", [1, 3])
def test_block_order_is_a_permutation(chunks, n_tiles, tiles_per_block):
    """The blocks' tile runs cover every tile once, each inside one chunk
    (ceil(n_tiles / chunks) tiles; a ragged count leaves the last chunks
    short or empty), and the first blocks take position 0 of every
    chunk."""
    first, end = mp.block_tiles(n_tiles, chunks, tiles_per_block)
    tiles = torch.cat([torch.arange(a, b) for a, b in
                       zip(first.tolist(), end.tolist())])
    assert sorted(tiles.tolist()) == list(range(n_tiles))
    per_chunk = -(-n_tiles // chunks)
    nonempty = end > first
    assert (first[nonempty] // per_chunk
            == (end[nonempty] - 1) // per_chunk).all()
    assert first.shape[0] == chunks * -(-per_chunk // tiles_per_block)
    lead = first[:chunks][nonempty[:chunks]]
    assert (lead % per_chunk == 0).all()
    if n_tiles % chunks == 0 and tiles_per_block == 1:
        assert bool(nonempty.all())
