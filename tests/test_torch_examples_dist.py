"""examples/torch_*.py against the JAX package's examples: multichip (8
gloo thread ranks) and out_of_core, each run as a process with --device
cpu: exit 0, and the same printed lines as the JAX example on the same
arguments, totals included (plans and the first materialized row left
out: each package prints its plan in its own types).  The processes run
at once (tests/torch_example_runs.py)."""

import pytest

import torch_example_runs as ter

NAMES = ["multichip", "out_of_core"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return ter.run_examples(NAMES, tmp_path_factory)


@pytest.mark.parametrize("name", NAMES)
def test_example_like_jax(runs, name):
    (rc, out, err), (rc_j, out_j, err_j) = runs[name]
    assert rc == 0, err[-2000:]
    assert rc_j == 0, err_j[-2000:]
    assert ter.lines(out) == ter.lines(out_j)
    assert any(ch.isdigit() for ch in out)
