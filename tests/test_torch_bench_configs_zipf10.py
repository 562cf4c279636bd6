"""scripts/torch_bench_configs.py --small --only phj_zipf_1.0 --device cpu:
the Zipf z=1.0 row (join() re-plans first; the script also holds its
digest against join_oracle at --small), its count equal to the JAX
join's on the same inputs (tests/torch_bench_rows.py)."""

import torch_bench_rows as tbr


def test_row_count_like_jax(tmp_path):
    rows = tbr.run_gates(tmp_path, "phj_zipf_1.0")
    assert set(rows) == {"phj_zipf_1.0"}
    tbr.check_row(rows, "phj_zipf_1.0")
