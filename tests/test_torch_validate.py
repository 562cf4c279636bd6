"""The port's oracle-free invariant checks (engine/validate.py) against
the JAX package's on the CPU: the same stats dict on a sound result, and
the same ValueError diagnosis, word for word, on each tampered one (the
cases of tests/test_validate.py)."""

import dataclasses

import numpy as np
import pytest

import hash_join_codes_knl_tpu.engine.phj as jphj
from hash_join_codes_knl_tpu.engine.validate import (
    validate_join_result as jax_validate,
)
from hash_join_codes_knl_tpu_torch.engine import phj as tphj
from hash_join_codes_knl_tpu_torch.engine.convert import result_to_numpy
from hash_join_codes_knl_tpu_torch.engine.validate import (
    validate_join_result,
)
from hash_join_codes_knl_tpu_torch.relgen.generate import generate
from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

COLUMNS = ("probe_keys", "probe_vals", "match_vals", "match_cnts")


@pytest.fixture(scope="module", params=[0, 4], ids=["global", "4-chunks"])
def joined(request):
    inner, outer, _ = generate(seed=67, inner_tuples=1024,
                               outer_tuples=8000, mode="uniform")
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    plan = dataclasses.replace(tphj.plan_join(1024, 8000),
                               probe_chunks=request.param)
    res_t, plan_t = tphj.join(*cols, plan, device="cpu")
    res_j, plan_j = jphj.join(*cols, plan=jphj.JoinPlan(
        **dataclasses.asdict(plan)))
    return res_t, plan_t, res_j, plan_j, outer


def _tampered(res_t, res_j, column=None, fn=None):
    """Both packages' results with `fn` applied to the same slots of one
    column (the port's probe keys, match values and counts equal the JAX
    package's slot for slot)."""
    # copies: on the CPU the numpy columns share the tensors' memory
    port = {f: a.copy() for f, a in result_to_numpy(res_t).items()}
    ref = {f: np.asarray(getattr(res_j, f)).reshape(-1).copy()
           for f in (*COLUMNS, "build_counts")}
    if fn is not None:
        fn(port[column], port)
        fn(ref[column], ref)
    dev = res_t.probe_keys.device
    as_t = lambda a: (u32_to_device(a, dev) if a.dtype == np.uint32
                      else u32_to_device(a.view(np.uint32), dev))
    return (tphj.JoinResult(**{f: as_t(port[f]) for f in COLUMNS},
                            build_counts=res_t.build_counts),
            jphj.JoinResult(**ref))


def _both(joined, column=None, fn=None):
    res_t, plan_t, res_j, plan_j, outer = joined
    t, j = _tampered(res_t, res_j, column, fn)
    outcomes = []
    for validate, res, plan in ((validate_join_result, t, plan_t),
                                (jax_validate, j, plan_j)):
        try:
            outcomes.append(validate(res, outer.keys, plan))
        except ValueError as e:
            outcomes.append(f"ValueError: {e}")
    return outcomes


def test_valid_result_same_stats(joined):
    port, ref = _both(joined)
    assert port == ref
    assert port["live_slots"] == 8000 and port["join_tuples"] == 8000
    assert port["monotonicity"] == "checked"


def _drop_one(pk, cols):
    pk[np.flatnonzero(pk != 0)[3]] = 0


def _corrupt_key(pk, cols):
    pk[np.flatnonzero(pk != 0)[0]] ^= 0x10  # same count, other checksum


def _dirty_pad(mc, cols):
    mc[np.flatnonzero(cols["probe_keys"] == 0)[0]] = 1


def _swap_keys(pk, cols):
    live = np.flatnonzero(pk != 0)
    a, b = live[0], live[-1]
    pk[a], pk[b] = pk[b], pk[a]


def _value_without_match(mc, cols):
    mc[np.flatnonzero((cols["probe_keys"] != 0)
                      & (cols["match_vals"] != 0))[0]] = 0


def _negative_count(mc, cols):
    mc[np.flatnonzero(cols["probe_keys"] != 0)[5]] = -1


@pytest.mark.parametrize("column,fn,diagnosis", [
    ("probe_keys", _drop_one, "conservation"),
    ("probe_keys", _corrupt_key, "checksum"),
    ("match_cnts", _dirty_pad, "pad hygiene"),
    ("probe_keys", _swap_keys, "monotonicity"),
    ("match_cnts", _value_without_match, "match value without a match"),
    ("match_cnts", _negative_count, "negative match count"),
])
def test_same_diagnosis(joined, column, fn, diagnosis):
    assert bool((joined[0].probe_keys == 0).any())  # pad slots exist
    port, ref = _both(joined, column, fn)
    assert port == ref
    assert port.startswith("ValueError") and diagnosis in port


def test_irregular_geometry_reported_like_jax(joined):
    """A result whose length is not a multiple of the chunk count: the
    monotonicity check is reported skipped by both."""
    res_t, plan_t, res_j, plan_j, outer = joined
    odd_t = dataclasses.replace(plan_t, probe_chunks=3)
    odd_j = dataclasses.replace(plan_j, probe_chunks=3)
    assert res_t.probe_keys.numel() % 3
    port = validate_join_result(res_t, outer.keys, odd_t)
    assert port == jax_validate(res_j, outer.keys, odd_j)
    assert port["monotonicity"].startswith("skipped: irregular geometry")


def test_outer_keys_as_tensor(joined):
    res_t, plan_t, _, _, outer = joined
    assert validate_join_result(
        res_t, u32_to_device(outer.keys, "cpu"), plan_t) == \
        validate_join_result(res_t, outer.keys, plan_t)
