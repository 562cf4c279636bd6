"""The staged merge pipeline, PhaseTimer and the roofline against the
JAX package's on the CPU: the staged result equals the fused one slot
for slot (single-class and two-class) and the JAX staged result by
digest, cardinality and build_counts; the timer's phases, metrics and
report have the JAX shape; the traffic model and the report's
fractions are the JAX package's."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import hash_join_codes_knl_tpu.engine.phj as jphj
from hash_join_codes_knl_tpu.engine.oracle import join_oracle, multiset_digest
from hash_join_codes_knl_tpu.utils import roofline as jroof
from hash_join_codes_knl_tpu.utils.timing import PhaseTimer as JaxTimer
from hash_join_codes_knl_tpu_torch.engine import phj as tphj
from hash_join_codes_knl_tpu_torch.engine.convert import result_to_numpy
from hash_join_codes_knl_tpu_torch.relgen.generate import generate
from hash_join_codes_knl_tpu_torch.utils import roofline as troof
from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device
from hash_join_codes_knl_tpu_torch.utils.timing import PhaseTimer

STAGES = ["partition_build", "partition_probe", "windows", "probe"]


def test_phase_timer_like_jax():
    """Phases accumulate by name, the timeline stamps every boundary,
    and metrics() / report() have the JAX timer's keys."""
    timers = (PhaseTimer(), JaxTimer())
    for t in timers:
        assert t.run("a", lambda x: x + 1, 1) == 2
        t.run("b", lambda: None)
        t.run("a", lambda: torch.ones(3))
        assert list(t.phases) == ["a", "b"]
        assert [n for n, _ in t.timeline] == ["a", "b", "a"]
        stamps = [s for _, s in t.timeline]
        assert stamps == sorted(stamps)
        assert t.total == pytest.approx(sum(t.phases.values()))
    port, ref = (t.metrics(algorithm="phj", join_tuples=5) for t in timers)
    assert list(port) == list(ref) == ["a_s", "b_s", "total_s", "algorithm",
                                       "join_tuples"]
    assert json.loads(timers[0].report(x=1))["x"] == 1


def test_hbm_peak_on_cpu_like_jax():
    assert troof.hbm_peak_bytes_per_s("cpu") == \
        jroof.hbm_peak_bytes_per_s() == (50e9, "cpu (nominal DDR)")
    if not torch.cuda.is_available():
        assert troof.hbm_peak_bytes_per_s() == (50e9, "cpu (nominal DDR)")


@pytest.mark.parametrize("name,peak,label", [
    ("NVIDIA H100 80GB HBM3", 3.35e12, "NVIDIA H100 80GB HBM3"),
    ("NVIDIA A100-SXM4-80GB", 3.35e12,
     "assumed: the H100 SXM's peak for 'NVIDIA A100-SXM4-80GB'"),
])
def test_hbm_peak_by_card_name(monkeypatch, name, peak, label):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    assert troof.hbm_peak_bytes_per_s("cuda") == (peak, label)


@pytest.mark.parametrize("ni,no,tile,window", [(1000, 16000, 2048, 384),
                                               (16_000_000, 256_000_000,
                                                3072, 15104)])
def test_traffic_model_and_report_like_jax(ni, no, tile, window):
    traffic = troof.merge_phj_traffic(ni, no, tile, window)
    assert traffic == jroof.merge_phj_traffic(ni, no, tile, window)
    secs = {"load_device": 0.5, "partition_build": 0.01,
            "partition_probe": 0.02, "windows": 0.0, "probe": 0.003}
    assert troof.roofline_report(secs, traffic, "cpu") == \
        jroof.roofline_report(secs, traffic)


def _uniform(seed=3, ni=1024, no=8192):
    inner, outer, _ = generate(seed=seed, inner_tuples=ni, outer_tuples=no,
                               mode="uniform")
    return inner.keys, inner.vals, outer.keys, outer.vals


def _skewed(seed=131, ni=2048, no=8192):
    """Two of 32 tile spans past the narrow window at 4 probe chunks."""
    rng = np.random.default_rng(seed)
    ik = np.unique(rng.integers(1, 2**32, ni + 800, dtype=np.uint32))[:ni]
    iv = rng.integers(0, 2**32, ni, dtype=np.uint32)
    ok = ik[rng.integers(0, ni, no)].astype(np.uint32)
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    return ik, iv, ok, ov


def _plans():
    single = tphj.plan_join(1024, 8192)
    two = dataclasses.replace(tphj.plan_join(2048, 8192, tile=256),
                              probe_chunks=4, window=384, window_wide=1024,
                              wide_cap=16)
    chunked = dataclasses.replace(single, probe_chunks=8, tile=512)
    return {"single-class": (_uniform, single),
            "chunked": (_uniform, chunked),
            "two-class": (_skewed, two)}


@pytest.mark.parametrize("case", list(_plans()))
def test_staged_equals_fused_and_jax_staged(case):
    make, plan = _plans()[case]
    cols = make()
    t = [u32_to_device(c, "cpu") for c in cols]
    timer = PhaseTimer()
    staged = tphj.phj_join_merge_staged(*t, plan, timer)
    assert list(timer.phases) == STAGES
    fused = tphj.phj_join_merge(*t, plan)
    for f in ("probe_keys", "probe_vals", "match_vals", "match_cnts",
              "build_counts"):
        assert torch.equal(getattr(staged, f), getattr(fused, f)), f
    jtimer = JaxTimer()
    ref = jphj.phj_join_merge_staged(
        *(jnp.asarray(c) for c in cols),
        jphj.JoinPlan(**dataclasses.asdict(plan)), jtimer)
    assert list(jtimer.phases) == STAGES
    got = result_to_numpy(staged)
    np.testing.assert_array_equal(got["build_counts"],
                                  np.asarray(ref.build_counts))
    assert int(staged.join_tuples) == int(ref.join_tuples) \
        == len(join_oracle(*cols)[0])
    assert multiset_digest(*tphj.materialize(staged)) == \
        multiset_digest(*jphj.materialize(ref)) == \
        multiset_digest(*join_oracle(*cols))
    if case == "two-class":
        # the wide class is populated: the narrow window alone misses
        tile, window, rows, cap = tphj._merge_params(plan, 2048, 8192)
        bhk, _ = tphj._merge_sort_side(t[0], t[1], rows * 128, plan.factor)
        ohk, _ = tphj._merge_sort_probe(t[2], t[3], cap, 4, plan.factor)
        assert int(tphj._merge_windows(bhk, ohk, tile, window,
                                       rows)[1][0]) > 0


def test_staged_counts_overflow_without_replanning():
    """The staged path pins its geometry: a window too narrow is counted
    in build_counts[0] (the CLI then exits 1), as in the JAX package."""
    cols = _skewed()
    plan = dataclasses.replace(tphj.plan_join(2048, 8192, tile=256),
                               probe_chunks=4, window=256)
    res = tphj.phj_join_merge_staged(
        *(u32_to_device(c, "cpu") for c in cols), plan, PhaseTimer())
    ref = jphj.phj_join_merge_staged(
        *(jnp.asarray(c) for c in cols),
        jphj.JoinPlan(**dataclasses.asdict(plan)), JaxTimer())
    assert int(res.build_counts[0]) > 0
    np.testing.assert_array_equal(res.build_counts.numpy(),
                                  np.asarray(ref.build_counts))
