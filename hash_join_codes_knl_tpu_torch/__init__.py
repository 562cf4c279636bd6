"""The query engine's partitioned hash join (merge, padded and radix
modes, the two-class window geometry, the plan-time chunk-count tuner),
its no-partition hash join (NPJ), the out-of-core drivers (``stream_join``
with a host-RAM probe side, ``grace_join`` with both sides in partition
files, checkpoint and resume for both), multi-column joins
(``join_columns*``), the M:N expansion, the hash aggregate, the
distributed modes over ``torch.distributed`` ranks (``cpra_join`` with
heavy-hitter replication, tier routing, the pipelined and two-level
exchanges; the replicated-table NPJ; ``grace_join_dist``; ``data_mesh``
and the thread ranks of ``parallel/distributed.py``) and the CLI
(``python -m hash_join_codes_knl_tpu_torch.cli``) in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100.

A port of ``hash_join_codes_knl_tpu`` (JAX/Pallas on a TPU), which stays
the reference it is tested against.  This package imports no JAX and
nothing of the reference package: it keeps its own copies of the
numpy-only host modules (the relation generator, ``Relation`` and its
files, the relation IO and the join oracle).
"""

__version__ = "0.1.0"

# Lazy top-level API: nothing below is imported (no torch, no kernel
# build) until first use -- `import hash_join_codes_knl_tpu_torch as hjt;
# hjt.join(...)`.
_EXPORTS = {
    "JoinPlan": (".engine.config", "JoinPlan"),
    "plan_join": (".engine.config", "plan_join"),
    "join": (".engine.phj", "join"),
    "materialize": (".engine.phj", "materialize"),
    "materialize_expanded": (".engine.phj", "materialize_expanded"),
    "NpjPlan": (".engine.npj", "NpjPlan"),
    "plan_npj": (".engine.npj", "plan_npj"),
    "npj_join": (".engine.npj", "npj_join"),
    "stream_join": (".engine.stream", "stream_join"),
    "grace_join": (".engine.grace", "grace_join"),
    "data_mesh": (".parallel.distributed", "data_mesh"),
    "cpra_join": (".parallel.cpra", "cpra_join"),
    "npj_join_dist": (".parallel.npj_dist", "npj_join_dist"),
    "grace_join_dist": (".parallel.grace_dist", "grace_join_dist"),
    "generate": (".relgen.generate", "generate"),
    "join_columns": (".engine.columns", "join_columns"),
    "join_columns_u64": (".engine.columns", "join_columns_u64"),
    "join_columns_multi": (".engine.columns", "join_columns_multi"),
    "hash_aggregate": (".ops.aggregate", "hash_aggregate"),
    "hash_aggregate_chunked": (".ops.aggregate", "hash_aggregate_chunked"),
    "hash_aggregate_auto": (".ops.aggregate", "hash_aggregate_auto"),
    "aggregate_join_result": (".ops.aggregate", "aggregate_join_result"),
    "aggregate_join_result_expanded": (
        ".ops.aggregate", "aggregate_join_result_expanded"),
    "join_oracle": (".engine.oracle", "join_oracle"),
    "multiset_digest": (".engine.oracle", "multiset_digest"),
}
__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    try:
        mod, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}"
        ) from None
    import importlib

    return getattr(importlib.import_module(mod, __name__), attr)


def __dir__():
    return sorted(set(globals()) | set(_EXPORTS))
