"""chip_smoke.py's helpers on the CPU: the padded stage breakdown runs
_phj_join_padded's steps one by one, and its results must equal the
engine's; the two-class plans' set-up (the Zipf phase's and the fuzz
phase's) leaves the launch counts as they were; the fuzz phase's plans
and its kernel checks; K4's headline-list check holds K4 against K3's
output; the trace's
interval union, the sorted-window probes' bound and the tile probe's;
the names of ptxas' report."""

import dataclasses
import importlib.util
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from hash_join_codes_knl_tpu_torch.engine import phj as tphj
from hash_join_codes_knl_tpu_torch.engine.config import (
    DEFAULT_FACTOR,
    JoinPlan,
    plan_join,
)
from hash_join_codes_knl_tpu_torch.engine.tune import DEFAULT_CANDIDATES
from hash_join_codes_knl_tpu_torch.ops import chunk_layout as cl
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    to_numpy_u32,
    u32_to_device,
)

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


def test_fuzz_plans_stay_under_the_window_cap():
    """The fuzz phase's full-width plans: a tile of FUZZ_TILES, a chunk
    count among the tuner's candidates or a multiple of 8 below them that
    the window cap's c_win admits, the window auto."""
    smoke = _chip_smoke()
    ni, no = smoke.HEADLINE
    rng = np.random.default_rng(5)
    for _ in range(50):
        plan = smoke._fuzz_plan(rng)
        c = plan.probe_chunks
        assert plan.tile in smoke.FUZZ_TILES and plan.window == 0
        assert c in DEFAULT_CANDIDATES or (
            c % 8 == 0 and 8 <= c < min(DEFAULT_CANDIDATES))
        assert c <= 12_500 * no // (plan.tile * ni)


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_two_class_plan_splits_the_tiles(seed):
    """The fuzz phase's two-class plan narrows the window to a random
    tile-span quantile: some tiles go to the wide pass, and join() runs
    it as it is, exactly."""
    smoke = _chip_smoke()
    cols = _skewed_columns()
    res, plan = tphj.join(*cols, plan_join(8192, 31744, tile=512),
                          device="cpu")
    two, label = smoke._fuzz_two_class(np.random.default_rng(seed), cols,
                                       plan)
    assert two.window < two.window_wide and two.wide_cap >= 128
    assert " 0 wide tiles" not in label
    res2, final = tphj.join(*cols, two)
    assert final == two
    assert int(res2.join_tuples) == int(res.join_tuples)


def test_fuzz_kernel_checks_reach_every_probe_of_the_draws():
    """The checks after the fuzz phase's counts are read, on a
    single-class draw and a two-class one: K1, the probe each plan
    dispatches on its spread tiles, and K4 on the two-class draw's own
    tile list, each against its plain version (on the CPU both sides are
    the plain version)."""
    smoke = _chip_smoke()
    cols = _skewed_columns()
    rel = [SimpleNamespace(keys=to_numpy_u32(k), vals=to_numpy_u32(v))
           for k, v in (cols[:2], cols[2:])]
    _, plan = tphj.join(*cols, plan_join(8192, 31744, tile=512),
                        device="cpu")
    two, _ = smoke._fuzz_two_class(np.random.default_rng(0), cols, plan)
    called = []
    real = smoke._k4_vs_plain

    def k4(dev, lay, p, label):
        called.append(p)
        return real(dev, lay, p, label)

    smoke._k4_vs_plain = k4
    errs = smoke._fuzz_kernel_checks(torch.device("cpu"),
                                     [("one", rel, plan), ("two", rel, two)])
    assert called == [two]
    assert set(errs) >= {"flat_to_rows", "merge_probe_gather_indexed"}
    assert set(errs) - {"flat_to_rows", "merge_probe_gather_indexed"} <= {
        "merge_probe", "merge_probe_gather"}
    assert not any(errs.values())


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


@pytest.mark.parametrize("stride", [1, 3, 16])
def test_k4_headline_list_check_holds_k4_to_k3(monkeypatch, stride):
    """The headline-list check of K4, on a small merge layout through the
    wrappers' CPU path: every stride-th tile agrees with K3's output over
    all tiles, and a K3 output that differs on a listed tile fails it."""
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "K4_HEADLINE_STRIDE", stride)
    monkeypatch.setattr(smoke, "_median_ms", lambda fn, reps: fn() and 0.0)
    monkeypatch.setattr(smoke, "_queued_ms", lambda fn: fn() and 0.0)
    from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg

    rng = np.random.default_rng(stride)
    ik = np.unique(rng.integers(1, 2**32, 5000, dtype=np.uint32))[:4096]
    ok = ik[rng.integers(0, ik.size, 16384)]
    ok[::13] = 0  # null probes
    ik, iv, ok, ov = (u32_to_device(c, "cpu") for c in (
        ik, rng.integers(0, 2**32, ik.size, dtype=np.uint32), ok,
        rng.integers(0, 2**32, ok.size, dtype=np.uint32)))
    plan = dataclasses.replace(plan_join(ik.shape[0], ok.shape[0],
                                         tile=256), probe_chunks=4)
    bhk, bval, ohk, _, wrow, tile, window = smoke._stages(
        (ik, iv, ok, ov), plan)
    k3 = mg.merge_probe_gather(ohk, bhk, bval, wrow, tile, window)
    assert int(k3[1].sum()) > 0
    got = smoke._kernel_indexed_headline(ohk, bhk, bval, wrow, tile, window,
                                         k3, plan.probe_chunks)
    n_tiles = ohk.shape[0] // tile
    assert got["entries_headline_list"] == -(-n_tiles // stride)
    assert got["max_abs_err_headline"] == 0 and got["ms_headline_list"] == 0
    assert got["bound_ms_headline_list"] > 0
    k3[1][0] += 1  # tile 0 is always listed
    with pytest.raises(AssertionError, match="all .* listed"):
        smoke._kernel_indexed_headline(ohk, bhk, bval, wrow, tile, window,
                                       k3, plan.probe_chunks)


def test_ptxas_report_names_each_instance_of_a_templated_kernel():
    """ptxas reports mangled names; a kernel templated on one bool (K3
    and K4's shared body) is named kernel<false> and kernel<true>."""
    entry = ("ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_1"
             "{}' for 'sm_90a'\n")
    use = ("ptxas info    : Function properties for x\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
           "loads\nptxas info    : Used {} registers, used 1 barriers\n")
    text = "".join(entry.format(name) + use.format(r) for name, r in (
        ("25merge_probe_gather_kernelILb0EEEvPKilllS2_", 32),
        ("25merge_probe_gather_kernelILb1EEEvPKilllS2_", 34),
        ("24merge_probe_dense_kernelEPKi", 50)))
    got = _chip_smoke()._ptxas_report(text)
    assert [k for k, _ in got] == ["merge_probe_gather_kernel<false>",
                                   "merge_probe_gather_kernel<true>",
                                   "merge_probe_dense_kernel"]
    assert got[1][1].startswith("Used 34 registers")
    assert "0 bytes spill stores" in got[1][1]
