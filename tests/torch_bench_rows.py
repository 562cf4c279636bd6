"""Shared by the tests of scripts/torch_bench_configs.py: the port's
matrix run at --small on the CPU for some of its gates, and each row's
cardinality (or group count) from the JAX package's functions on the
same inputs (the JAX script takes minutes at --small on the CPU).  The
port's plain probes on the CPU compare every probe with its whole
window, so a --small join takes seconds: the tests hold each row's
count, so a row runs its checked warm-up alone (``sync_run`` stubbed
here; tests/test_torch_bench.py tests ``sync_run`` itself), and the
tests are split over several files so that the test workers run them
side by side."""

import importlib.util
import json
import os

import numpy as np
import pytest

from hash_join_codes_knl_tpu_torch.utils import bench as hb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "scripts", "torch_bench_configs.py")
I, O = 200_000, 1_600_000  # bench_configs.py's --small shapes
NPJ_I, NPJ_O = 100_000, 400_000


def load_script():
    spec = importlib.util.spec_from_file_location("_torch_configs", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_gates(tmp_dir, *onlys) -> dict:
    """The port's --small rows of each --only filter, merged into one
    file as --only merges; the rows."""
    out = os.path.join(str(tmp_dir), "bench.json")
    def warm_up_only(fn, device, reps=3):
        return hb.fenced_seconds(lambda: fn(0), device)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(hb, "sync_run", warm_up_only)
        main = load_script().main
        for only in onlys:
            assert main(["--small", "--only", only, "--device", "cpu",
                         "--out", out]) == 0
    return json.load(open(out))


def check_row(rows, name):
    """The row's cardinality (or group count) equals the JAX function's,
    and it was timed on the CPU."""
    field, jax_fn = JAX_COUNTS[name]
    assert rows[name][field] == jax_fn()
    assert rows[name]["seconds"] > 0 and rows[name]["reps"] >= 1
    assert rows[name]["device"] == {"name": "cpu", "power_limit": None}


def _uniform():
    from hash_join_codes_knl_tpu.relgen.generate import generate

    inner, outer, _ = generate(seed=42, inner_tuples=I, outer_tuples=O,
                               mode="uniform")
    return inner.keys, inner.vals, outer.keys, outer.vals


def _npj_data():
    from hash_join_codes_knl_tpu.relgen.generate import generate

    inner, outer, _ = generate(seed=44, inner_tuples=NPJ_I,
                               outer_tuples=NPJ_O, mode="uniform")
    return inner.keys, inner.vals, outer.keys, outer.vals


def _fold(k):
    return (k & np.uint32(0xFFFF)) + np.uint32(1)


def _jax_phj():
    from hash_join_codes_knl_tpu.engine.config import plan_join
    from hash_join_codes_knl_tpu.engine.phj import phj_join

    return int(phj_join(*_uniform(), plan_join(I, O)).join_tuples)


def _jax_aggregate(fold, chunked=False):
    from hash_join_codes_knl_tpu.ops.aggregate import (
        hash_aggregate,
        hash_aggregate_chunked,
    )

    _, _, ok, ov = _uniform()
    k = _fold(ok) if fold else ok
    if chunked:
        return int(hash_aggregate_chunked(k, ov, chunks=64,
                                          partial_cap=1 << 23)[0])
    return int(hash_aggregate(k, ov)[0])


def _jax_npj(data, order="input"):
    from hash_join_codes_knl_tpu.engine.npj import (
        npj_build,
        npj_probe_sorted,
        plan_npj,
    )

    ik, iv, ok, ov = data
    plan = plan_npj(len(ik))
    tk, tv, _, max_disp = npj_build(ik, iv, plan)
    out = npj_probe_sorted(tk, tv, ok, plan, max_disp,
                           plan.auto_window(len(ok)), probe_vals=ov,
                           order=order)
    assert int(out[-1]) == 0
    return int(np.asarray(out[-2]).astype(np.int64).sum())


def _jax_zipf(z):
    from hash_join_codes_knl_tpu.engine.config import plan_join
    from hash_join_codes_knl_tpu.engine.phj import join
    from hash_join_codes_knl_tpu.relgen.generate import generate

    ik, iv, _, _ = _uniform()
    _, outer, _ = generate(seed=43, inner_tuples=I, outer_tuples=O,
                           mode="zipf", zipf=z)
    res, _ = join(ik, iv, outer.keys, outer.vals, plan_join(I, O))
    return int(res.join_tuples)


def _jax_chain(unique):
    import dataclasses

    from hash_join_codes_knl_tpu.engine.npj import (
        npj_build,
        npj_probe,
        plan_npj,
    )

    ik, iv, ok, _ = _npj_data()
    plan = dataclasses.replace(plan_npj(NPJ_I), unique=unique,
                               probe_impl="chain")
    tk, tv, _, _ = npj_build(ik, iv, plan)
    _, mc = npj_probe(tk, tv, ok[: NPJ_O // 8], plan)
    return int(np.asarray(mc).astype(np.int64).sum())


def _jax_cpra():
    import jax

    from hash_join_codes_knl_tpu.parallel.cpra import cpra_join

    mesh = jax.make_mesh((1,), ("x",))
    res, _ = cpra_join(*_uniform(), mesh, slack=3.0)
    return int(np.asarray(res.join_tuples).sum())


JAX_COUNTS = {
    "phj_uniform": ("join_tuples", _jax_phj),
    "hash_aggregate_1M": ("groups", lambda: _jax_aggregate(False)),
    "hash_aggregate_chunked_1M_64Kgroups": (
        "groups", lambda: _jax_aggregate(True, chunked=True)),
    "hash_aggregate_1M_64Kgroups": ("groups", lambda: _jax_aggregate(True)),
    "npj_uniform_full": ("join_tuples", lambda: _jax_npj(_uniform())),
    "npj_uniform_full_sorted_order": (
        "join_tuples", lambda: _jax_npj(_uniform(), order="sorted")),
    "phj_zipf_0.75": ("join_tuples", lambda: _jax_zipf(0.75)),
    "phj_zipf_1.0": ("join_tuples", lambda: _jax_zipf(1.0)),
    "npj_uniform": ("join_tuples", lambda: _jax_npj(_npj_data())),
    "npj_chain": ("join_tuples", lambda: _jax_chain(False)),
    "npj_chain_unique": ("join_tuples", lambda: _jax_chain(True)),
    "cpra": ("join_tuples", _jax_cpra),
}


