"""scripts/torch_bench_configs.py --small --device cpu against the JAX
package (tests/torch_bench_rows.py): the gates and the --small row names
of scripts/bench_configs.py, and the phj_uniform, aggregate and cpra
rows' counts equal to the JAX functions'.  The NPJ and Zipf rows are in
test_torch_bench_configs_npj.py, _zipf075.py and _zipf10.py, so that the
test workers run them side by side."""

import ast
import os

import pytest

import torch_bench_rows as tbr

# the rows scripts/bench_configs.py --small writes (O = 1.6M names the
# aggregate rows "1M"); the radix row runs at full size only
SMALL_ROWS = {
    "phj_uniform", "hash_aggregate_1M",
    "hash_aggregate_chunked_1M_64Kgroups", "hash_aggregate_1M_64Kgroups",
    "npj_uniform_full", "npj_uniform_full_sorted_order", "phj_zipf_0.75",
    "phj_zipf_1.0", "npj_uniform", "npj_chain", "npj_chain_unique", "cpra"}
# the --only filters the four test files run; together every gate
FILTERS = {"phj_uniform": {"phj_uniform"},
           "aggregate": {"hash_aggregate_1M",
                         "hash_aggregate_chunked_1M_64Kgroups",
                         "hash_aggregate_1M_64Kgroups"},
           "cpra": {"cpra"},
           "npj": {"npj_uniform_full", "npj_uniform_full_sorted_order",
                   "npj_uniform", "npj_chain", "npj_chain_unique"},
           "phj_zipf_0.75": {"phj_zipf_0.75"},
           "phj_zipf_1.0": {"phj_zipf_1.0"}}


def _jax_gate_rows():
    tree = ast.parse(open(os.path.join(tbr.REPO, "scripts",
                                       "bench_configs.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                        ast.Name)
                and node.targets[0].id == "GATE_ROWS"):
            return ast.literal_eval(node.value)
    raise AssertionError("no GATE_ROWS in scripts/bench_configs.py")


def test_gates_like_jax():
    """The port's gates are the JAX runner's, the filters' rows are the
    JAX runner's --small rows, once each, and every row has its JAX
    count here or in the other three files."""
    assert tbr.load_script().GATE_ROWS == _jax_gate_rows()
    rows = [r for names in FILTERS.values() for r in names]
    assert len(rows) == len(set(rows)) and set(rows) == SMALL_ROWS
    assert set(tbr.JAX_COUNTS) == SMALL_ROWS


@pytest.fixture(scope="module")
def rows(tmp_path_factory):
    return tbr.run_gates(tmp_path_factory.mktemp("configs"), "phj_uniform",
                         "aggregate", "cpra")


def test_filters_merge_their_rows(rows):
    """Each --only run merges its rows into the file."""
    assert set(rows) == (FILTERS["phj_uniform"] | FILTERS["aggregate"]
                         | FILTERS["cpra"])


@pytest.mark.parametrize("name", sorted(
    FILTERS["phj_uniform"] | FILTERS["aggregate"] | FILTERS["cpra"]))
def test_row_count_like_jax(rows, name):
    tbr.check_row(rows, name)
