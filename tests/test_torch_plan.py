"""The port's plans and merge geometry against the JAX package's: the
same sizes give the same plan, window, cap and re-plan, field for field."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

import hash_join_codes_knl_tpu.engine.phj as jphj
import hash_join_codes_knl_tpu.engine.tune as jtune
from hash_join_codes_knl_tpu.engine.config import JoinPlan as JaxPlan
from hash_join_codes_knl_tpu.engine.config import plan_join as jax_plan_join
from hash_join_codes_knl_tpu_torch.engine import phj as tphj
from hash_join_codes_knl_tpu_torch.engine.config import JoinPlan, plan_join
from hash_join_codes_knl_tpu_torch.engine.convert import plan_from_jax

SIZES = [
    (5, 7), (1000, 1000), (4096, 65536), (1_000_000, 8_000_000),
    (4_000_000, 64_000_000), (16_000_000, 64_000_000),
    (16_000_000, 256_000_000), (1_000_000, 300_000_000),
    (100_000_000, 100_000_000), (16_000_000, 400_000_000),
    (64_000_000, 128_000_000), (100, 64_000_000),
]


@pytest.fixture
def untuned(monkeypatch):
    """The JAX planner times chunk counts on its device inside
    64M <= outer <= 320M; the port takes the tuner's default instead."""
    monkeypatch.setattr(
        jtune, "tuned_probe_chunks",
        lambda outer_n, tile, default, candidates: default,
    )


def _fields(plan):
    return dataclasses.asdict(plan)


@pytest.mark.parametrize("ni,no", SIZES)
@pytest.mark.parametrize("tile,chunks", [(None, None), (1024, None),
                                          (None, 8), (512, 16)])
def test_plan_join_matches(untuned, ni, no, tile, chunks):
    want = jax_plan_join(ni, no, tile=tile, probe_chunks=chunks)
    got = plan_join(ni, no, tile=tile, probe_chunks=chunks)
    assert _fields(got) == _fields(want)


def _plans():
    base = [plan_join(4096, 65536), plan_join(16_000_000, 256_000_000),
            plan_join(1_000_000, 8_000_000, tile=1024)]
    out = []
    for p, chunks, window, impl in itertools.product(
        base, (0, 8, 21, 64), (0, 1280, 2048),
        ("merge", "merge_gather", "merge_pallas", "merge_jnp"),
    ):
        out.append(dataclasses.replace(p, probe_chunks=chunks,
                                       window=window, probe_impl=impl))
    return out


@pytest.mark.parametrize("ni,no", [(4096, 65536), (1000, 3001),
                                   (16_000_000, 256_000_000)])
def test_merge_params_match(ni, no):
    for plan in _plans():
        jp = JaxPlan(**_fields(plan))
        assert tphj._merge_params(plan, ni, no) == \
            jphj._merge_params(jp, ni, no), plan


@pytest.mark.parametrize("tile,window,impl", [
    (3072, 16384, "merge_gather"),  # past the gather ceiling at tile 3072
    (2048, 20480, "merge"),  # dense sweep past its rowchunk budget
    (4096, 9000, "merge_pallas"),
])
def test_explicit_window_refusals_match(tile, window, impl):
    plan = JoinPlan(p_bits=4, slots=64, tile=tile, window=window,
                    probe_impl=impl)
    with pytest.raises(ValueError):
        jphj._merge_params(JaxPlan(**_fields(plan)), 4096, 65536)
    with pytest.raises(ValueError):
        tphj._merge_params(plan, 4096, 65536)


def test_merge_impl_band():
    plan = plan_join(4096, 65536)
    for chunks, want in ((9, "merge_pallas"), (10, "merge_gather"),
                         (121, "merge_gather"), (122, "merge_pallas")):
        assert tphj._merge_impl(plan, chunks * 128) == want
    forced = dataclasses.replace(plan, probe_impl="merge_jnp")
    assert tphj._merge_impl(forced, 1280) == "merge_jnp"


def test_window_helpers_match():
    for span in (0, 1, 128, 700, 5000, 15104, 40_000, 10**6):
        assert tphj.window_from_span(span) == jphj.window_from_span(span)
    for tile in (128, 512, 896, 1024, 2048, 3072, 4096, 8192):
        assert tphj.replan_window_cap(tile) == jphj.replan_window_cap(tile)


@pytest.mark.parametrize("span", [300, 2000, 14_000, 15_500, 40_000,
                                  250_000, 3_000_000])
def test_replan_from_span_matches(span):
    for plan in (plan_join(16_000_000, 256_000_000),
                 plan_join(4096, 65536),
                 dataclasses.replace(plan_join(4096, 65536), tile=512,
                                     probe_chunks=8)):
        got = tphj.replan_from_span(plan, span)
        want = jphj.replan_from_span(JaxPlan(**_fields(plan)), span)
        assert _fields(got) == _fields(want)


def test_downgrade_plan_opts_matches():
    plan = dataclasses.replace(plan_join(4096, 65536), unique_build=True,
                               gather_select="rowbase", window=1280)
    got = tphj.downgrade_plan_opts(plan)
    want = jphj.downgrade_plan_opts(JaxPlan(**_fields(plan)))
    assert _fields(got) == _fields(want)


@pytest.mark.parametrize("plan", [
    JaxPlan(p_bits=17, slots=512, tile=3072, pass_bits=(8, 8, 1),
            probe_chunks=64),
    JaxPlan(p_bits=3, slots=64, tile=512, probe_impl="merge_gather",
            window=1280, unique_build=True, gather_select="flat",
            factor=0xDEADBEEF | 1, skip_bits=2),
])
def test_plan_from_jax_round_trips(plan):
    port = plan_from_jax(plan)
    assert isinstance(port, JoinPlan)
    assert JaxPlan(**_fields(port)) == plan


def test_unported_modes_raise():
    """Nothing is left unported: a two-class plan's geometry equals the
    JAX package's, and the padded modes run."""
    plan = plan_join(4096, 65536)
    for window, wide, impl in ((1280, 4096, "merge"), (384, 1920, "merge"),
                               (2048, 15104, "merge_gather"),
                               (640, 3072, "merge_jnp")):
        two_class = dataclasses.replace(plan, window=window,
                                        window_wide=wide, probe_impl=impl)
        assert tphj._merge_params(two_class, 4096, 65536) == \
            jphj._merge_params(JaxPlan(**_fields(two_class)), 4096, 65536)
    rng = np.random.default_rng(2)
    cols = [torch.from_numpy(rng.integers(1, 2**31, n).astype(np.int32))
            for n in (512, 512, 2048, 2048)]
    for impl in ("auto", "pallas", "jnp"):
        res = tphj.phj_join(*cols, dataclasses.replace(
            plan_join(512, 2048), probe_impl=impl))
        assert res.build_counts.shape == (plan_join(512, 2048)
                                          .num_partitions,)


def _two_class_plans():
    base = plan_join(16_000_000, 256_000_000)
    return [dataclasses.replace(base, window=2048, window_wide=15104,
                                wide_cap=1024),
            dataclasses.replace(plan_join(4096, 65536, tile=512),
                                probe_chunks=8, window=384, window_wide=1920,
                                wide_cap=128, unique_build=True)]


def test_downgrade_plan_opts_two_class_matches():
    for plan in _two_class_plans():
        got = tphj.downgrade_plan_opts(plan)
        want = jphj.downgrade_plan_opts(JaxPlan(**_fields(plan)))
        assert _fields(got) == _fields(want)
        assert got.window_wide == 0 and got.window == plan.window_wide


@pytest.mark.parametrize("span", [300, 2000, 15_500, 40_000, 3_000_000])
def test_replan_from_span_two_class_matches(span):
    for plan in _two_class_plans():
        got = tphj.replan_from_span(plan, span)
        want = jphj.replan_from_span(JaxPlan(**_fields(plan)), span)
        assert _fields(got) == _fields(want)
        assert got.window_wide == 0
