"""The port's stage spill (engine/spill.py) against the JAX package's, on
the CPU.  Exact: a round trip gives the same tensors, and a spill
written by either package resumes in the other with equal columns (the
JAX package's raw keys are the port's keys unbiased), equal counts and
equal u64 checksums.  Corruption of either column is refused."""

import json

import numpy as np
import pytest
import torch

from hash_join_codes_knl_tpu.engine import spill as jspill
from hash_join_codes_knl_tpu_torch.engine import spill as tspill
from hash_join_codes_knl_tpu_torch.ops.radix_partition import (
    radix_partition_torch,
)
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    bias,
    to_numpy_u32,
    u32_to_device,
    unbias,
)


@pytest.fixture(scope="module")
def partitioned():
    """A null-padded 8-way layout from the port's pass (biased keys)."""
    rng = np.random.default_rng(0)
    hk = u32_to_device(rng.integers(1, 2**32, 20000, dtype=np.uint32),
                       "cpu")
    vals = u32_to_device(rng.integers(0, 2**32, 20000, dtype=np.uint32),
                         "cpu")
    out_k, out_v, counts, ovf = radix_partition_torch(bias(hk), vals, 3,
                                                      tile=4096)
    assert int(ovf) == 0
    return out_k, out_v, counts


def test_round_trip(tmp_path, partitioned):
    out_k, out_v, counts = partitioned
    tspill.spill_partitions(str(tmp_path), "pass1", out_k, out_v, counts,
                            meta={"bits": 3})
    rk, rv, rc, meta = tspill.resume_partitions(str(tmp_path), "pass1",
                                                device="cpu")
    assert torch.equal(rk, out_k) and torch.equal(rv, out_v)
    assert torch.equal(rc, counts)
    assert meta["bits"] == 3 and meta["n"] == out_k.shape[0]


def test_port_spill_resumes_in_jax(tmp_path, partitioned):
    out_k, out_v, counts = partitioned
    tspill.spill_partitions(str(tmp_path), "s", out_k, out_v, counts)
    hk, vals, rc, meta = jspill.resume_partitions(str(tmp_path), "s")
    raw = to_numpy_u32(unbias(out_k))
    np.testing.assert_array_equal(hk, raw)
    assert (hk == 0).sum() == (out_k == -2**31).sum().item()  # pads: key 0
    np.testing.assert_array_equal(vals, to_numpy_u32(out_v))
    np.testing.assert_array_equal(rc, counts.numpy())
    assert meta["checksum"] == int(raw.astype(np.uint64).sum())


def test_jax_spill_resumes_in_port(tmp_path, partitioned):
    out_k, out_v, counts = partitioned
    raw_k = to_numpy_u32(unbias(out_k))
    raw_v = to_numpy_u32(out_v)
    jspill.spill_partitions(str(tmp_path), "s", raw_k, raw_v,
                            counts.numpy(), meta={"bits": 3})
    rk, rv, rc, meta = tspill.resume_partitions(str(tmp_path), "s",
                                                device="cpu")
    assert torch.equal(rk, out_k) and torch.equal(rv, out_v)
    assert torch.equal(rc, counts) and meta["bits"] == 3
    # the sidecars of both packages agree field for field
    t_dir = tmp_path / "port"
    tspill.spill_partitions(str(t_dir), "s", out_k, out_v, counts,
                            meta={"bits": 3})
    assert json.loads((t_dir / "s.json").read_text()) == \
        json.loads((tmp_path / "s.json").read_text())
    for col in ("hk", "val"):
        assert (t_dir / f"s_{col}.bin").read_bytes() == \
            (tmp_path / f"s_{col}.bin").read_bytes()


@pytest.mark.parametrize("col,offset,match", [
    ("hk", 17, "spill s: checksum"), ("val", 21, "val checksum")])
def test_corruption_refused(tmp_path, col, offset, match):
    hk = torch.arange(1, 1001, dtype=torch.int32)
    tspill.spill_partitions(str(tmp_path), "s", bias(hk), hk * 3,
                            torch.tensor([1000], dtype=torch.int32))
    p = tmp_path / f"s_{col}.bin"
    data = bytearray(p.read_bytes())
    data[offset] ^= 0xFF
    p.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=match):
        tspill.resume_partitions(str(tmp_path), "s", device="cpu")
    with pytest.raises(ValueError, match=match):
        jspill.resume_partitions(str(tmp_path), "s")


def test_meta_cannot_clobber_integrity_fields(tmp_path):
    hk = torch.arange(1, 257, dtype=torch.int32)
    tspill.spill_partitions(str(tmp_path), "m", bias(hk), hk,
                            torch.tensor([256], dtype=torch.int32),
                            meta={"n": 7, "counts": [1], "checksum": 0})
    rk, _, rc, meta = tspill.resume_partitions(str(tmp_path), "m",
                                               device="cpu")
    assert meta["n"] == 256 and rk.shape[0] == 256
    assert rc.tolist() == [256]
