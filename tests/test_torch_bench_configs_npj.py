"""scripts/torch_bench_configs.py --small --only npj --device cpu: the
NPJ rows (the sorted probe at both shapes and in both orders, and the
chain walk), each count equal to the JAX function's on the same inputs
(tests/torch_bench_rows.py)."""

import pytest

import torch_bench_rows as tbr


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    return tbr.run_gates(tmp_path_factory.mktemp("configs"), "npj")


def test_filter_rows(rows):
    assert set(rows) == {"npj_uniform_full", "npj_uniform_full_sorted_order",
                         "npj_uniform", "npj_chain", "npj_chain_unique"}


@pytest.mark.parametrize("name", [
    "npj_chain", "npj_chain_unique", "npj_uniform", "npj_uniform_full",
    "npj_uniform_full_sorted_order"])
def test_row_count_like_jax(rows, name):
    tbr.check_row(rows, name)
