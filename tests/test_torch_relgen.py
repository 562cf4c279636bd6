"""The port's own host modules against the JAX package's: the relation
generator gives byte-identical relations for the same arguments,
through the native generator and the Python one; relation files
interchange byte for byte, through the native relation IO and numpy's;
the checksums agree; and the join oracle and the multiset digest give
identical values."""

import os

import numpy as np
import pytest

from hash_join_codes_knl_tpu.engine import oracle as joracle
from hash_join_codes_knl_tpu.relation import Relation as JaxRelation
from hash_join_codes_knl_tpu.relation import (
    expected_join_tuples as jax_expected,
)
from hash_join_codes_knl_tpu.relation import load_relation as jax_load
from hash_join_codes_knl_tpu.relation import save_relation as jax_save
from hash_join_codes_knl_tpu.utils.host import u64sum as jax_u64sum
from hash_join_codes_knl_tpu.relgen.generate import generate as jax_generate
from hash_join_codes_knl_tpu.utils.mt19937 import MT19937 as JaxMT
from hash_join_codes_knl_tpu_torch import native
from hash_join_codes_knl_tpu_torch.engine import oracle as toracle
from hash_join_codes_knl_tpu_torch.relation import (
    Relation,
    expected_join_tuples,
    load_relation,
    save_relation,
)
from hash_join_codes_knl_tpu_torch.relgen.generate import generate
from hash_join_codes_knl_tpu_torch.utils.host import u64sum
from hash_join_codes_knl_tpu_torch.utils.mt19937 import MT19937

MODES = [dict(mode="uniform"), dict(mode="zipf", zipf=0.75),
         dict(mode="zipf", zipf=1.0), dict(mode="ref")]


def _same(a, b):
    for ra, rb in zip(a[:2], b[:2]):
        assert ra.keys.dtype == rb.keys.dtype == np.uint32
        assert ra.keys.tobytes() == rb.keys.tobytes()
        assert ra.vals.tobytes() == rb.vals.tobytes()
    assert a[2] == b[2]


@pytest.mark.parametrize("kw", MODES, ids=lambda k: "-".join(
    str(v) for v in k.values()))
@pytest.mark.parametrize("prefer_native", [True, False])
def test_generate_byte_identical(kw, prefer_native):
    ni, no = (3000, 3000) if kw["mode"] == "ref" else (2000, 12000)
    args = dict(seed=1234, inner_tuples=ni, outer_tuples=no,
                prefer_native=prefer_native, **kw)
    if prefer_native:
        assert native.available(), "the port's native generator must build"
    _same(generate(**args), jax_generate(**args))


def test_native_and_python_generators_agree():
    args = dict(seed=9, inner_tuples=1500, outer_tuples=9000, mode="zipf",
                zipf=1.0)
    nat = generate(prefer_native=True, **args)
    py = generate(prefer_native=False, **args)
    for a, b in zip(nat[:2], py[:2]):
        assert a.keys.tobytes() == b.keys.tobytes()
        assert a.vals.tobytes() == b.vals.tobytes()


def test_native_library_lands_in_build_dir():
    path = native.library_path()
    assert path.endswith(".so") and "_build" in path.split("/")[-2]
    assert "hash_join_codes_knl_tpu_torch" in path
    assert native.available()


def test_mt19937_stream_identical():
    assert np.array_equal(MT19937(77).take(2000), JaxMT(77).take(2000))


@pytest.mark.parametrize("seed", [0, 5])
def test_oracle_and_digest_identical(seed):
    rng = np.random.default_rng(seed)
    ik = rng.integers(1, 300, 2000, dtype=np.uint32)  # duplicates: M:N
    iv = rng.integers(0, 2**32, 2000, dtype=np.uint32)
    ok = rng.integers(0, 400, 5000, dtype=np.uint32)
    ov = rng.integers(0, 2**32, 5000, dtype=np.uint32)
    got = toracle.join_oracle(ik, iv, ok, ov)
    want = joracle.join_oracle(ik, iv, ok, ov)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert toracle.multiset_digest(*got) == joracle.multiset_digest(*want)
    assert toracle.multiset_digest(ok, ov, ov) == \
        joracle.multiset_digest(ok, ov, ov)


def test_expected_join_tuples_identical():
    for ni, no, selc in ((16_000_000, 256_000_000, 1.0), (7, 3, 0.5),
                         (1000, 1000, 0.25)):
        assert expected_join_tuples(ni, no, selc) == jax_expected(ni, no,
                                                                  selc)


def _rel(n, seed=0):
    rng = np.random.default_rng(seed)
    keys = rng.integers(1, 2**32, n, dtype=np.uint32)
    keys[:3] = (1, 0xFFFFFFFF, 0)
    return keys, rng.integers(0, 2**32, n, dtype=np.uint32)


@pytest.mark.parametrize("prefer_native", [True, False])
@pytest.mark.parametrize("side", ["inner", "outer"])
def test_relation_files_interchange_with_jax(tmp_path, prefer_native, side):
    """Same names and bytes as the JAX package's files; each package
    loads the other's, natively and through numpy."""
    keys, vals = _rel(5000, seed=3)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    paths = save_relation(Relation(keys, vals), side,
                          str(tmp_path / "port"), prefer_native)
    want = jax_save(JaxRelation(keys, vals), side, str(tmp_path / "jax"),
                    prefer_native)
    assert [os.path.basename(p) for p in paths] == \
        [os.path.basename(p) for p in want]
    for p, w in zip(paths, want):
        assert open(p, "rb").read() == open(w, "rb").read()
    for load, d in ((load_relation, "jax"), (jax_load, "port")):
        back = load(side, 5000, str(tmp_path / d), prefer_native)
        assert back.keys.tobytes() == keys.tobytes()
        assert back.vals.tobytes() == vals.tobytes()


@pytest.mark.parametrize("prefer_native", [True, False])
def test_truncated_relation_raises_value_error(tmp_path, prefer_native):
    keys, vals = _rel(1000, seed=9)
    kpath, _ = save_relation(Relation(keys, vals), "inner", str(tmp_path))
    with open(kpath, "r+b") as f:
        f.truncate(100 * 4)
    with pytest.raises(ValueError):
        load_relation("inner", 1000, str(tmp_path), prefer_native)
    with pytest.raises(FileNotFoundError):
        load_relation("outer", 1000, str(tmp_path), prefer_native)


@pytest.mark.parametrize("n", [0, 4096, 1 << 20])
def test_checksum_like_jax_u64sum(n):
    """Relation.checksum: the u64 wraparound sum of the keys, through
    numpy below 2^20 words and the native sum from there."""
    keys, vals = _rel(n, seed=n) if n else (np.zeros(0, np.uint32),) * 2
    keys = np.maximum(keys, np.uint32(2**32 - 2**10))  # large words
    got = Relation(keys, vals).checksum
    assert got == u64sum(keys) == jax_u64sum(keys) == JaxRelation(
        keys, vals).checksum
    assert got == int(keys.astype(np.uint64).sum(dtype=np.uint64))
    if n:
        assert native.checksum_u32(keys) == got


def test_relio_library_lands_in_build_dir():
    path = native.relio_library_path()
    assert os.path.dirname(path) == os.path.dirname(native.library_path())
    assert os.path.basename(path).startswith("libhjkrelio_")
    assert native.relio_available() and os.path.exists(path)
