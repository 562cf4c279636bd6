"""chip_smoke.py's helpers on the CPU: the padded stage breakdown runs
_phj_join_padded's steps one by one, and its results must equal the
engine's; the two-class plan's set-up leaves the launch counts as they
were; the trace's interval union, the binary-search probe's bound and
the tile probe's."""

import dataclasses
import importlib.util
import os

import numpy as np
import pytest
import torch

from hash_join_codes_knl_tpu_torch.engine import phj as tphj
from hash_join_codes_knl_tpu_torch.engine.config import (
    DEFAULT_FACTOR,
    JoinPlan,
    plan_join,
)
from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plan", [
    JoinPlan(p_bits=4, slots=512, tile=256, pass_bits=(4,),
             partition_impl="sort", probe_impl="pallas"),
    JoinPlan(p_bits=3, slots=1024, tile=384, pass_bits=(3,), skip_bits=3,
             partition_impl="argsort", probe_impl="jnp"),
    JoinPlan(p_bits=6, slots=1024, tile=2048, pass_bits=(3, 3),
             partition_impl="radix", probe_impl="pallas"),
], ids=["sort", "argsort", "radix"])
def test_padded_stages_equal_the_engine(plan):
    smoke = _chip_smoke()
    rng = np.random.default_rng(41)
    ik = np.unique(rng.integers(1, 2**32, 4096, dtype=np.uint32))[:2048]
    iv = rng.integers(0, 2**32, ik.size, dtype=np.uint32)
    ok = ik[rng.integers(0, ik.size, 6144)]
    ok[::17] = 0  # null probes
    ov = rng.integers(0, 2**32, ok.size, dtype=np.uint32)
    cols = [u32_to_device(c, "cpu") for c in (ik, iv, ok, ov)]
    st = smoke._padded_stages(*cols, plan)
    res = tphj._phj_join_padded(*cols, plan)
    for f in smoke.RESULT_COLUMNS:
        assert torch.equal(st[f], getattr(res, f)), f
    assert st["join_tuples"] == int(res.join_tuples) > 0


def _skewed_columns():
    """30 hot keys from the first half of the (scrambled) build order, a
    1024-key spread over the second half: hot tiles span one row, the
    spread's tiles half the build side."""
    rng = np.random.default_rng(5)
    n = 8192
    ik = np.unique(rng.integers(1, 2**32, n + 2000, dtype=np.uint32))[:n]
    iv = rng.integers(0, 2**32, n, dtype=np.uint32)
    hk = tphj.flat_to_rows(u32_to_device(ik, "cpu"),
                           u32_to_device(iv, "cpu"), n, 1,
                           DEFAULT_FACTOR)[0]
    by_rank = ik[torch.argsort(hk.reshape(-1)).numpy()]
    hot = by_rank[rng.choice(n // 2, 30, replace=False)]
    ok = np.concatenate([np.repeat(hot, 1024),
                         rng.choice(by_rank[n // 2:], 1024, replace=False)])
    rng.shuffle(ok)
    ov = rng.integers(0, 2**32, ok.size, dtype=np.uint32)
    return [u32_to_device(c, "cpu") for c in (ik, iv, ok, ov)]


def test_two_class_plan_puts_the_launch_counts_back(monkeypatch):
    """The two-class plan's set-up sorts launch K1 on the card; the
    path's launch counts must not see them.  Its wide count is
    _merge_windows' at the narrow window, and join() takes the plan as
    it is, with the single-class plan's cardinality."""
    smoke = _chip_smoke()
    cols = _skewed_columns()
    plan = dataclasses.replace(plan_join(8192, 31744, tile=512),
                               probe_chunks=1)
    res, plan = tphj.join(*cols, plan, device="cpu")
    real = tphj.flat_to_rows
    seen = []

    def counted(*a):  # what the kernel's wrapper does on the card
        cl.flat_to_rows.launches += 1
        seen.append(1)
        return real(*a)

    monkeypatch.setattr(tphj, "flat_to_rows", counted)
    before = smoke._launches()
    two, qs, n_wide = smoke._two_class_plan(cols, plan)
    assert seen and smoke._launches() == before
    monkeypatch.setattr(tphj, "flat_to_rows", real)
    assert qs[1] < qs[2] and two.window < two.window_wide == plan.window
    tile, _, rows, cap = tphj._merge_params(plan, 8192, 31744)
    bhk, _ = tphj._merge_sort_side(cols[0], cols[1], rows * 128,
                                   plan.factor)
    ohk, _ = tphj._merge_sort_probe(cols[2], cols[3], cap, 1, plan.factor)
    wide_ovf = tphj._merge_windows(bhk, ohk, tile, two.window, rows,
                                   two.window_wide, 0)[2][2]
    assert int(wide_ovf) == n_wide > 0
    res2, final = tphj.join(*cols, two)
    assert final == two
    assert int(res2.join_tuples) == int(res.join_tuples) == 31744


@pytest.mark.parametrize("intervals,want", [
    ([], 0.0),
    ([(0, 4), (1, 2), (3, 6)], 6.0),
    ([(5, 7), (0, 1), (1, 2), (6, 9)], 6.0),
], ids=["empty", "nested", "touching"])
def test_union_of_intervals(intervals, want):
    assert _chip_smoke()._union_us(intervals) == want


def test_search_bound_reads_the_union_of_windows():
    """Windows [0, 256), [0, 256), [128, 384), [1280, 1536): 640 keys,
    each read once; one value per matched probe."""
    smoke = _chip_smoke()
    probe = torch.tensor([-2**31, 5, 6, 7] * 64, dtype=torch.int32)
    wrow = torch.tensor([0, 0, 1, 10], dtype=torch.int32)
    mc = torch.tensor([0, 1, 2, 0] * 64, dtype=torch.int32)
    got = smoke._search_bound(probe, wrow, 256, 4096, mc)
    nbytes = 12 * 256 + 4 * 4 + 4 * 640 + 4 * 128
    assert got == smoke._bound(nbytes, 2 * 192 * 8)
    assert got["bound_by"] == "bytes"


def test_tile_probe_bound_counts_bytes_and_one_lookup_per_probe():
    """5 tiles of 64 probes on rows 1, 1, 2, 2 and 5 of an (8, 256)
    table: probes (4 B) and both outputs (8 B) per slot, a tile id per
    tile, keys and values of the three rows used; one lookup per live
    probe, far under the bytes' time."""
    smoke = _chip_smoke()
    pk = torch.arange(1, 321, dtype=torch.int32)
    pk[::5] = -2**31  # null probes: read and written, never looked up
    tk = torch.zeros((8, 256), dtype=torch.int32)
    tpid = torch.tensor([1, 1, 2, 2, 5], dtype=torch.int32)
    got = smoke._tile_probe_bound(pk, tk, tpid, 64)
    nbytes = 12 * 320 + 4 * 5 + 8 * 256 * 3
    assert got == smoke._bound(nbytes, 256)
    assert got["bound_by"] == "bytes"
    assert got["bound_ms"] == nbytes / smoke.HBM_BYTES_PER_S * 1e3


def test_full_rows_fill_only_the_rows_under_the_tiles():
    """Every slot of a row under a listed tile becomes live (a probe key
    of that tile, or a key of its own under a null probe); live slots and
    all other rows stay; the kernel's wrapper, on the CPU, then agrees on
    those tiles inside a run over all tiles."""
    smoke = _chip_smoke()
    null = -2**31
    g = torch.Generator().manual_seed(3)
    tk = torch.randint(1, 1000, (6, 40), dtype=torch.int32, generator=g)
    tk[torch.rand(tk.shape, generator=g) < 0.6] = null
    tv = torch.randint(0, 99, (6, 40), dtype=torch.int32, generator=g)
    tpid = torch.tensor([0, 0, 1, 3, 3, 3, 4, 5], dtype=torch.int32)
    pk = torch.randint(1, 1000, (8 * 16,), dtype=torch.int32, generator=g)
    pk[::3] = null
    pk_s, tp_s, sel = smoke._spread_tiles(pk, tpid, 16, 3)
    assert sel.tolist() == [0, 3, 7] and tp_s.tolist() == [0, 3, 5]
    full = smoke._full_rows(tk, pk_s, tp_s, 16)
    assert bool((full[[0, 3, 5]] != null).all())
    assert torch.equal(full[[1, 2, 4]], tk[[1, 2, 4]])
    assert bool((full == tk)[tk != null].all())
    from hash_join_codes_knl_tpu_torch.ops import probe as pt

    want = pt.probe_tiles_torch(pk_s, full, tv, tp_s, 16)
    assert int(want[1].max()) > 1
    smoke._check_full_probe("cpu", (pk, full, tv, tpid, 16), sel, want)


def test_oracle_threads_give_the_oracle_digests(monkeypatch):
    """The digest cases: each relation comes with a future of
    join_oracle's digest of it, computed on a host thread; the 1M x 8M
    case is the relation handed in."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "HEADLINE_4M", (2000, 9000))
    monkeypatch.setattr(smoke, "RADIX_4M", (1000, 3000))
    small, _ = smoke._generate(500, 2000, seed=41, mode="uniform")
    cases = smoke._start_oracles(small)
    assert sorted(cases) == ["radix_4m", "small", "uniform_4m", "zipf_4m"]
    assert cases["small"][0] is small
    for name, rows in (("small", 2000), ("uniform_4m", 9000),
                       ("zipf_4m", 9000), ("radix_4m", 3000)):
        data, digest = cases[name]
        want = digest.result(timeout=120)
        assert len(data[1].keys) == rows
        assert want == smoke._oracle_digest(data) and want[0] > 0
    top = [np.unique(cases[name][0][1].keys, return_counts=True)[1].max()
           for name in ("zipf_4m", "uniform_4m")]
    assert top[0] > 3 * top[1]  # the Zipf case is the skewed one
