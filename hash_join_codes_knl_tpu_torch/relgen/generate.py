"""Relation generation front end: native C++ when available, Python oracle
otherwise; both produce byte-identical relations, and the same bytes as
the JAX package's generator for the same arguments
(tests/test_torch_relgen.py)."""

from __future__ import annotations

from .. import native
from ..relation import Relation, save_relation
from . import _pygen


def generate(
    seed: int,
    inner_tuples: int,
    outer_tuples: int,
    selc: float = 1.0,
    zipf: float = 0.0,
    mode: str = "ref",
    factors=None,
    prefer_native: bool = True,
) -> tuple[Relation, Relation, dict]:
    """Generate an (inner, outer) relation pair.

    mode='ref' is the bit-exact single-thread reference generator
    (write.cpp:1482-1646); 'uniform'/'zipf' are the intended well-defined
    semantics for outer > inner and skewed workloads (see relgen/_pygen.py).
    """
    # one validation for BOTH engines (the native twin returns rc=1 for
    # the same inputs; the Python path would die on an IndexError deep
    # in the walk): degenerate counts, selc outside [0,1], negative zipf
    if inner_tuples <= 0 or outer_tuples <= 0:
        raise ValueError("inner_tuples and outer_tuples must be positive")
    if not 0.0 <= selc <= 1.0:
        raise ValueError(f"selc must be in [0, 1], got {selc}")
    if mode == "zipf" and zipf < 0.0:
        raise ValueError(f"zipf exponent must be >= 0, got {zipf}")
    if factors is None:
        factors = _pygen.default_factors(seed)
    if prefer_native and native.available():
        ik, iv, ok, ov, m = native.generate_native(
            seed, inner_tuples, outer_tuples, selc, zipf, mode,
            factors[2], factors[3],
        )
        meta = {
            **m,
            "inner_distinct": min(inner_tuples, outer_tuples),
            "outer_distinct": min(inner_tuples, outer_tuples),
            "factors": tuple(factors),
            "mode": mode,
            "seed": seed,
            "zipf": zipf,
            "selc": selc,
        }
        return Relation(ik, iv), Relation(ok, ov), meta
    return _pygen.generate_py(
        seed, inner_tuples, outer_tuples, selc, zipf, mode, factors
    )


def generate_to_dir(
    directory: str,
    seed: int,
    inner_tuples: int,
    outer_tuples: int,
    **kw,
) -> dict:
    """The `write` driver: generate and persist ik_/iv_/ok_/ov_<N>.txt
    in `directory`; returns the generation's meta."""
    inner, outer, meta = generate(seed, inner_tuples, outer_tuples, **kw)
    save_relation(inner, "inner", directory)
    save_relation(outer, "outer", directory)
    return meta
