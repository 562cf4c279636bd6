"""tests/torch_fuzz_cases.py draws exactly what tests/test_fuzz.py draws.

Each JAX campaign runs with its engine entry point replaced by a stub
that records the arguments it was given and stops the test there; the
recorded columns, plans and knobs must equal the helper's draw for the
same seed, array for array and field for field.  The stream campaign
draws its crash point after its first run: the stub's first run reports
ceil(rows / chunk_rows) chunks, and the resumed run's count comparison
records the point drawn."""

import dataclasses
import os
import types

import numpy as np
import pytest

import hash_join_codes_knl_tpu.engine.columns as jcols
import hash_join_codes_knl_tpu.engine.npj as jnpj
import hash_join_codes_knl_tpu.engine.phj as jphj
import hash_join_codes_knl_tpu.engine.stream as jstream
import hash_join_codes_knl_tpu.ops.aggregate as jagg
import hash_join_codes_knl_tpu.parallel.cpra as jcpra
import hash_join_codes_knl_tpu.parallel.grace_dist as jgrace
import test_fuzz
import torch_fuzz_cases as fz
from hash_join_codes_knl_tpu_torch.engine.npj import plan_npj


class _Drawn(Exception):
    """Raised by a stub once the campaign's inputs are recorded."""


def _recorder(seen):
    def stub(*args, **kw):
        seen.update(args=args, kw=kw)
        raise _Drawn
    return stub


def _plan_fields(plan):
    return dataclasses.asdict(plan)


def _eq(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and np.array_equal(got, want), what


def _same_cols(args, d, keys=("ik", "iv", "ok", "ov")):
    for a, k in zip(args, keys):
        _eq(a, d[k], k)


def _stream_stub(seen):
    """First call: record the knobs, make the spill directory, report
    ceil(rows / chunk_rows) chunks.  Second call: a result whose resumed
    count records what it is compared with."""

    class _Keep:
        def __eq__(self, other):
            seen["keep"] = other
            raise _Drawn

    def stub(ik, iv, ok, ov, chunk_rows, spill_dir, **kw):
        if "args" in seen:
            return types.SimpleNamespace(join_tuples=seen["tuples"],
                                         resumed_chunks=_Keep())
        seen.update(args=(ik, iv, ok, ov), chunk_rows=chunk_rows)
        os.makedirs(spill_dir)
        seen["tuples"] = len(test_fuzz.join_oracle(ik, iv, ok, ov)[0])
        return types.SimpleNamespace(
            join_tuples=seen["tuples"], plan=None,
            chunks=[None] * -(-len(ok) // chunk_rows))
    return stub


def _jax_draw(monkeypatch, campaign, seed, tmp_path):
    """Run the JAX campaign's test for `seed` up to its engine call;
    returns what the call was given."""
    seen = {}
    stub = _recorder(seen)
    target = {
        "merge": (test_fuzz, "join"),
        "radix": (jphj, "phj_join"),
        "npj": (jnpj, "npj_join"),
        "cpra": (jcpra, "cpra_join"),
        "grace": (jgrace, "grace_join_dist"),
        "columns": (jcols, "join_columns"),
        "aggregate": (jagg, "hash_aggregate_chunked"),
    }
    if campaign == "stream":
        monkeypatch.setattr(jstream, "stream_join", _stream_stub(seen))
    else:
        monkeypatch.setattr(*target[campaign], stub)
    fn = {
        "merge": test_fuzz.test_fuzz_join_vs_oracle,
        "radix": test_fuzz.test_fuzz_radix_padded_vs_oracle,
        "npj": test_fuzz.test_fuzz_npj_vs_oracle,
        "stream": test_fuzz.test_fuzz_stream_resume_vs_oracle,
        "cpra": test_fuzz.test_fuzz_cpra_vs_oracle,
        "grace": test_fuzz.test_fuzz_grace_dist_vs_oracle,
        "columns": test_fuzz.test_fuzz_column_join_modes_vs_oracle,
        "aggregate": test_fuzz.test_fuzz_chunked_aggregate_vs_numpy,
    }[campaign]
    args = (seed, tmp_path) if campaign in ("stream", "grace") else (seed,)
    try:
        fn(*args)
    except _Drawn:
        return seen
    except pytest.skip.Exception:
        seen["skipped"] = True
        return seen
    raise AssertionError("the JAX campaign never reached its engine call")


@pytest.mark.parametrize("campaign,seed", fz.all_draws(),
                         ids=[f"{c}-{s}" for c, s in fz.all_draws()])
def test_draws_equal_the_jax_campaigns(monkeypatch, tmp_path, campaign,
                                       seed):
    d = fz.draw(campaign, seed)
    seen = _jax_draw(monkeypatch, campaign, seed, tmp_path)
    args, kw = seen.get("args", ()), seen.get("kw", {})
    if campaign in ("merge", "radix"):
        _same_cols(args, d)
        assert _plan_fields(args[4]) == _plan_fields(d["plan"])
    elif campaign == "npj":
        _same_cols(args, d)
        assert _plan_fields(args[4]) == _plan_fields(
            plan_npj(len(d["ik"]), load=d["load"]))
    elif campaign == "stream":
        _same_cols(args, d)
        assert seen["chunk_rows"] == d["chunk_rows"]
        assert seen["keep"] == d["keep"]
    elif campaign == "cpra":
        assert seen.get("skipped", False) == d["skip"]
        if not d["skip"]:
            _same_cols(args, d)
            assert args[4].devices.size == d["W"]
            assert _plan_fields(args[5]) == _plan_fields(d["plan"])
            assert kw == dict(slack=4.0, retries=3)
    elif campaign == "grace":
        _same_cols(args, d)
        assert args[4].devices.size == d["W"]
        assert (kw["f_bits"], kw["chunk_rows"]) == (d["f_bits"],
                                                    d["chunk_rows"])
    elif campaign == "columns":
        ik, inner_cols, ok, outer_cols = args
        _eq(ik, d["ik"], "ik")
        _eq(ok, d["ok"], "ok")
        for got, want in ((inner_cols, d["inner_cols"]),
                          (outer_cols, d["outer_cols"])):
            assert set(got) == set(want)
            for name in want:
                _eq(got[name], want[name], name)
        assert kw == {"how": "inner"}
        assert d["multi_how"] == ("inner", "left", "semi", "anti")[seed % 4]
    else:
        _eq(args[0], d["keys"], "keys")
        _eq(args[1], d["vals"], "vals")
        assert kw == dict(chunks=d["chunks"], partial_cap=d["cap"])
