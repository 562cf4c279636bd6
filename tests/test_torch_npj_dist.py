"""The port's distributed NPJ (parallel/npj_dist.py) against the JAX
package's on the same numpy inputs, W thread ranks against W virtual
CPU devices: the match columns (aligned to the whole outer relation,
the same on every rank) slot for slot, and join_tuples."""

import dataclasses

import jax
import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine.npj import plan_npj as jax_plan_npj
from hash_join_codes_knl_tpu.parallel.npj_dist import (
    npj_join_dist as jax_npj_join_dist,
)
from hash_join_codes_knl_tpu.relgen.generate import generate
from hash_join_codes_knl_tpu_torch.engine.npj import NpjPlan, plan_npj
from hash_join_codes_knl_tpu_torch.engine.oracle import (
    join_oracle,
    multiset_digest,
)
from hash_join_codes_knl_tpu_torch.parallel.distributed import (
    run_ranks,
    thread_meshes,
)
from hash_join_codes_knl_tpu_torch.parallel.npj_dist import npj_join_dist


def _ranks(W, fn):
    return run_ranks(thread_meshes(W, "cpu", timeout_s=120), fn,
                     timeout_s=300)


def _jax(W, *cols, **kw):
    mesh = jax.make_mesh((W,), ("x",), devices=jax.devices()[:W])
    return jax_npj_join_dist(*cols, mesh, **kw)


def _assert_like_jax(out, want):
    for mv, mc, total, _ in out:
        np.testing.assert_array_equal(mv, np.asarray(want[0]))
        np.testing.assert_array_equal(mc, np.asarray(want[1]))
        assert total == want[2]


@pytest.mark.parametrize("W", [1, 2, 4])
def test_npj_dist_like_jax(W):
    inner, outer, _ = generate(seed=11, inner_tuples=2048,
                               outer_tuples=16384, mode="uniform",
                               prefer_native=False)
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    want = _jax(W, *cols)
    out = _ranks(W, lambda m: npj_join_dist(*cols, m))
    _assert_like_jax(out, want)
    ok, ov, tv = join_oracle(*cols)
    mv, mc, total, _ = out[0]
    assert total == len(ok)
    m = mc == 1
    assert multiset_digest(outer.keys[m], outer.vals[m], mv[m]) == \
        multiset_digest(ok, ov, tv)


def test_npj_dist_odd_sizes_and_duplicates_like_jax():
    """Odd lengths shard by null padding and the outputs trim back to the
    input length; duplicate build keys count M:N."""
    rng = np.random.default_rng(43)
    ik = np.unique(rng.integers(1, 2**32, 3000, dtype=np.uint32))[:1255]
    ik = np.concatenate([ik, ik[:100]])
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    ok = ik[rng.integers(0, 1255, 9377)].astype(np.uint32)
    ov = rng.integers(0, 2**32, 9377, dtype=np.uint32)
    want = _jax(4, ik, iv, ok, ov)
    out = _ranks(4, lambda m: npj_join_dist(ik, iv, ok, ov, m))
    _assert_like_jax(out, want)
    assert len(out[0][0]) == 9377
    assert out[0][2] == len(join_oracle(ik, iv, ok, ov)[0])


def test_npj_dist_window_replan_and_chain_like_jax():
    """An undersized explicit window re-plans as the JAX driver does; the
    chain walk needs no window."""
    inner, outer, _ = generate(seed=13, inner_tuples=4096,
                               outer_tuples=8192, mode="uniform",
                               prefer_native=False)
    cols = (inner.keys, inner.vals, outer.keys, outer.vals)
    jplan = jax_plan_npj(4096)
    for kw in (dict(window=128, tile=2048), dict(probe_impl="chain")):
        want = _jax(2, *cols, plan=dataclasses.replace(jplan, **kw))
        plan = dataclasses.replace(plan_npj(4096), **kw)
        out = _ranks(2, lambda m: npj_join_dist(*cols, m, plan=plan))
        _assert_like_jax(out, want)
        assert out[0][2] == 8192


def test_npj_dist_build_overflow_raises():
    keys = np.full(4096, 7, dtype=np.uint32)
    plan = NpjPlan(buckets=64, margin=16)

    def body(m):
        with pytest.raises(RuntimeError, match="build overflow"):
            npj_join_dist(keys, keys, keys, keys, m, plan=plan)
        return True

    assert all(_ranks(2, body))
