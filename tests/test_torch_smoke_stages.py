"""chip_smoke.py's padded stage breakdown runs _phj_join_padded's steps
one by one; here, on the CPU, its result must equal the engine's."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from hash_join_codes_knl_tpu_torch.engine import phj as tphj
from hash_join_codes_knl_tpu_torch.engine.config import JoinPlan
from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("plan", [
    JoinPlan(p_bits=4, slots=512, tile=256, pass_bits=(4,),
             partition_impl="sort", probe_impl="pallas"),
    JoinPlan(p_bits=3, slots=1024, tile=384, pass_bits=(3,), skip_bits=3,
             partition_impl="argsort", probe_impl="jnp"),
    JoinPlan(p_bits=6, slots=1024, tile=2048, pass_bits=(3, 3),
             partition_impl="radix", probe_impl="pallas"),
], ids=["sort", "argsort", "radix"])
def test_padded_stages_equal_the_engine(plan):
    smoke = _chip_smoke()
    rng = np.random.default_rng(41)
    ik = np.unique(rng.integers(1, 2**32, 4096, dtype=np.uint32))[:2048]
    iv = rng.integers(0, 2**32, ik.size, dtype=np.uint32)
    ok = ik[rng.integers(0, ik.size, 6144)]
    ok[::17] = 0  # null probes
    ov = rng.integers(0, 2**32, ok.size, dtype=np.uint32)
    cols = [u32_to_device(c, "cpu") for c in (ik, iv, ok, ov)]
    st = smoke._padded_stages(*cols, plan)
    res = tphj._phj_join_padded(*cols, plan)
    for f in smoke.RESULT_COLUMNS:
        assert torch.equal(st[f], getattr(res, f)), f
    assert st["join_tuples"] == int(res.join_tuples) > 0
