"""Filter operator: predicate -> compacted relation (the JAX package's
``ops/filter.py``)."""

from __future__ import annotations

from .compact import compact_rows


def filter_relation(keys, vals, predicate):
    """predicate(keys, vals) -> bool mask; returns (count, keys, vals) with
    surviving rows packed to the front (order preserved)."""
    return compact_rows(predicate(keys, vals), keys, vals)
