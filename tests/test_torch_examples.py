"""examples/torch_*.py against the JAX package's examples: basic_join,
dataframe_style and aggregate, each run as a process with --device cpu:
exit 0, and the same printed lines as the JAX example on the same
arguments, totals included (plans and the first materialized row left
out: each package prints its plan in its own types).  The processes run
at once (tests/torch_example_runs.py)."""

import pytest

import torch_example_runs as ter

NAMES = ["basic_join", "dataframe_style", "aggregate"]


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


def test_examples_need_the_card():
    """Without a card and without --device cpu an example exits 1."""
    import os
    import subprocess
    import sys

    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    proc = subprocess.run(
        [sys.executable, os.path.join(ter.REPO, "examples",
                                      "torch_basic_join.py"), "4096",
         "16384"], cwd=ter.REPO, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 1
    assert "no CUDA device is available" in proc.stderr
