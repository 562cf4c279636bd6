"""The randomized differential campaigns of tests/test_fuzz.py for the
port: the same random workloads and random plans, draw for draw, and
each campaign's run through the port's entry points on one device.

`draw(campaign, seed)` makes a campaign's inputs from its seed exactly as
tests/test_fuzz.py does (tests/test_torch_fuzz_draws.py holds the two
equal); `run(campaign, d, device, tmp)` drives them through the port and
returns every output as host numpy columns; `check(campaign, d, out,
join_oracle, multiset_digest)` holds the outputs against the oracle
(the JAX package's or the port's copy, the caller's choice); `same(a, b)`
asserts two runs' outputs equal slot for slot.  tests/test_torch_fuzz*.py
run every seed on the CPU, tests/test_torch_cuda.py and chip_smoke.py on
the card against the CPU.  Imports no JAX: the machine with the card has
none.

A radix draw's plan keeps the JAX test's probe_impl="jnp" (the plain
probe, the table-count mask); `run(..., kernels=True)` makes it "pallas",
the tile probe, whose kernel runs on a CUDA tensor."""

from __future__ import annotations

import collections
import dataclasses
import os

import numpy as np

from hash_join_codes_knl_tpu_torch.engine.config import JoinPlan

SEEDS = {
    "merge": range(101, 121),
    "radix": range(201, 206),
    "npj": range(501, 509),
    "stream": range(601, 606),
    "cpra": range(301, 306),
    "grace": range(401, 405),
    "columns": range(601, 609),
    "aggregate": range(240, 252),
}
HOWS = ("inner", "left", "semi", "anti")


def case(seed: int):
    """tests/test_fuzz.py `_case`: (ik, iv, ok, ov, plan), numpy uint32
    columns and the port's JoinPlan."""
    rng = np.random.default_rng(seed)
    ni = int(rng.integers(1, 5000))
    no = int(rng.integers(1, 20000))
    # build keys: sometimes unique, sometimes with duplicates
    pool = np.unique(rng.integers(1, 2**32, ni + 64, dtype=np.uint32))
    if rng.random() < 0.5:
        ik = pool[:ni]
    else:
        ik = pool[rng.integers(0, max(1, len(pool) // 2), ni)].astype(
            np.uint32
        )
    iv = rng.integers(0, 2**32, len(ik), dtype=np.uint32)
    # probes: mix of hits and misses, sometimes heavily skewed
    hits = ik[rng.integers(0, len(ik), no)]
    misses = rng.integers(1, 2**32, no, dtype=np.uint32)
    take_hit = rng.random(no) < rng.random()
    ok = np.where(take_hit, hits, misses).astype(np.uint32)
    if rng.random() < 0.3 and len(ik):
        ok[: no // 3] = ik[0]  # heavy hitter
    ov = rng.integers(0, 2**32, no, dtype=np.uint32)
    # random-but-valid plan geometry (incl. the chunk-sorted probe path)
    tile = int(rng.choice([128, 256, 512, 1024, 2048]))
    window = int(rng.choice([0, 384, 512]))
    p_bits = int(rng.integers(2, 8))
    chunks = int(rng.choice([0, 0, 2, 4, 8]))
    plan = JoinPlan(p_bits=p_bits, slots=4096, tile=tile,
                    pass_bits=(p_bits,), window=window,
                    probe_chunks=chunks)
    return ik, iv, ok, ov, plan


def _cols(seed):
    ik, iv, ok, ov, plan = case(seed)
    return dict(ik=ik, iv=iv, ok=ok, ov=ov, plan=plan)


def _draw_radix(seed):
    """test_fuzz_radix_padded_vs_oracle: a random pass split, slots for
    an occupancy of at most a quarter."""
    rng = np.random.default_rng(seed)
    d = _cols(seed)
    p_bits = int(rng.integers(2, 7))
    if rng.random() < 0.5 or p_bits < 4:
        passes = (p_bits,)
    else:
        lo = int(rng.integers(1, p_bits))
        passes = (p_bits - lo, lo)
    slots = 256
    while slots * (1 << p_bits) < 4 * len(d["ik"]):  # generous occupancy
        slots *= 2
    d["plan"] = JoinPlan(p_bits=p_bits, slots=slots, tile=1024,
                         pass_bits=passes, partition_impl="radix",
                         probe_impl="jnp")
    return d


def _draw_npj(seed):
    rng = np.random.default_rng(seed)
    d = _cols(seed)
    d["load"] = float(rng.choice([0.25, 0.5, 0.9]))
    return d


def _draw_stream(seed):
    """Random chunk rows, and the crash: the spills of chunks keep..end
    are deleted (the JAX test draws keep after its first run, from that
    run's chunk count, ceil(rows / chunk_rows))."""
    rng = np.random.default_rng(seed)
    d = _cols(seed)
    d["chunk_rows"] = int(rng.integers(300, 6000))
    d["n_chunks"] = -(-len(d["ok"]) // d["chunk_rows"])
    d["keep"] = int(rng.integers(0, d["n_chunks"]))
    return d


def _draw_cpra(seed):
    """W ranks, and the columns cut to multiples of W; `skip` marks a
    side left empty by the cut (the JAX test skips it)."""
    rng = np.random.default_rng(seed)
    d = _cols(seed)
    W = int(rng.choice([2, 4, 8]))
    n_i = len(d["ik"]) // W * W
    n_o = len(d["ok"]) // W * W
    d.update(W=W, ik=d["ik"][:n_i], iv=d["iv"][:n_i], ok=d["ok"][:n_o],
             ov=d["ov"][:n_o], skip=n_i == 0 or n_o == 0)
    return d


def _draw_grace(seed):
    rng = np.random.default_rng(seed)
    d = _cols(seed)
    d["W"] = int(rng.choice([2, 4]))
    d["f_bits"] = int(rng.integers((d["W"] - 1).bit_length(), 5))
    d["chunk_rows"] = int(rng.integers(500, 4000))
    return d


def _draw_columns(seed):
    """test_fuzz_column_join_modes_vs_oracle: duplicate-heavy or sparse
    build keys, key 0 planted on both sides in odd seeds, 1-based row
    number payloads, the composite key's mode."""
    rng = np.random.default_rng(seed)
    ni = int(rng.integers(1, 3000))
    no = int(rng.integers(1, 8000))
    dup = rng.random() < 0.5
    span = int(rng.integers(ni // 2 + 1, 2**32)) if not dup else ni // 2 + 1
    ik = rng.integers(1, span + 1, ni, dtype=np.uint32)
    hits = ik[rng.integers(0, ni, no)]
    misses = rng.integers(1, 2**32, no, dtype=np.uint32)
    ok = np.where(rng.random(no) < rng.random(), hits, misses).astype(
        np.uint32
    )
    if seed % 2:
        ik[: max(1, ni // 50)] = 0
        ok[: max(1, no // 50)] = 0
    return dict(ik=ik, ok=ok,
                inner_cols={"iv": np.arange(ni, dtype=np.int64) + 1},
                outer_cols={"ov": np.arange(no, dtype=np.int64) + 1},
                multi_how=HOWS[seed % 4])


def _draw_aggregate(seed):
    """test_fuzz_chunked_aggregate_vs_numpy: rows, groups, chunks, nulls
    and the partial cap."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 40000))
    g_target = int(rng.integers(1, max(2, n)))
    chunks = int(rng.choice([1, 2, 4, 8, 16]))
    pool = np.unique(rng.integers(1, 2**32, g_target + 64,
                                  dtype=np.uint32))[:g_target]
    keys = pool[rng.integers(0, len(pool), n)].astype(np.uint32)
    if rng.random() < 0.5:
        keys[rng.random(n) < rng.random() * 0.3] = 0  # nulls
    vals = rng.integers(0, 2**32, n, dtype=np.uint32)
    cap = int(rng.choice([64, 1024, chunks * (-(-n // chunks))]))
    return dict(keys=keys, vals=vals, chunks=chunks, cap=cap)


_DRAWS = {"merge": _cols, "radix": _draw_radix, "npj": _draw_npj,
          "stream": _draw_stream, "cpra": _draw_cpra, "grace": _draw_grace,
          "columns": _draw_columns, "aggregate": _draw_aggregate}


def draw(campaign: str, seed: int) -> dict:
    return _DRAWS[campaign](seed)


def all_draws():
    """(campaign, seed) of every draw, in tests/test_fuzz.py's order."""
    return [(c, s) for c, seeds in SEEDS.items() for s in seeds]


# ---- runs through the port -------------------------------------------


def _host(x):
    """A tensor as numpy: int32 bit columns as uint32, the rest as they
    are; anything else unchanged."""
    import torch

    from hash_join_codes_knl_tpu_torch.utils.hashing import to_numpy_u32

    if isinstance(x, torch.Tensor):
        if x.dtype == torch.int32 and x.dim():
            return to_numpy_u32(x)
        return x.cpu().numpy()
    return x


def _result(res) -> dict:
    from hash_join_codes_knl_tpu_torch.engine.convert import result_to_numpy

    return result_to_numpy(res)


def _rows(res, ik, iv):
    """The matched rows (keys, vals, tabs) of a JoinResult, expanded
    when a probe matched more than once."""
    from hash_join_codes_knl_tpu_torch.engine.phj import (
        materialize,
        materialize_expanded,
    )

    mc = res.match_cnts
    if mc.numel() and int(mc.max()) > 1:
        return materialize_expanded(res, ik, iv)
    return materialize(res)


def _flat_result(cols):
    """A JoinResult on the CPU of host columns (probe keys, probe values,
    match values, match counts), for the expansion."""
    import torch

    from hash_join_codes_knl_tpu_torch.engine.phj import JoinResult
    from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

    k, v, t, c = cols
    return JoinResult(*(u32_to_device(x, "cpu") for x in (k, v, t)),
                      torch.as_tensor(np.asarray(c, np.int32)),
                      torch.zeros(3, dtype=torch.int32))


def _run_merge(d, dev, tmp, kernels):
    from hash_join_codes_knl_tpu_torch.engine.phj import join

    res, plan = join(d["ik"], d["iv"], d["ok"], d["ov"], d["plan"],
                     device=dev)
    return dict(plan=plan, res=_result(res), tuples=int(res.join_tuples),
                rows=_rows(res, d["ik"], d["iv"]))


def _run_radix(d, dev, tmp, kernels):
    from hash_join_codes_knl_tpu_torch.engine.phj import phj_join
    from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

    cols = [u32_to_device(d[k], dev) for k in ("ik", "iv", "ok", "ov")]
    plan = d["plan"]
    if kernels:
        plan = dataclasses.replace(plan, probe_impl="pallas")
    res = phj_join(*cols, plan)
    return dict(res=_result(res), tuples=int(res.join_tuples),
                rows=_rows(res, d["ik"], d["iv"]))


def _run_npj(d, dev, tmp, kernels):
    from hash_join_codes_knl_tpu_torch.engine.npj import npj_join, plan_npj

    plan = plan_npj(len(d["ik"]), load=d["load"])
    out = {"plan": plan}
    for order in ("input", "sorted"):
        got = npj_join(d["ik"], d["iv"], d["ok"], d["ov"], plan,
                       order=order, device=dev)
        out[order] = [_host(x) for x in got[:-1]]
        out[f"{order}_plan"] = got[-1]
    return out


def _run_stream(d, dev, tmp, kernels):
    """A run that spills, the crash (the spills of chunks keep.. gone),
    the resumed run; every chunk's full columns of the resumed run, the
    spilled ones replayed."""
    from hash_join_codes_knl_tpu_torch.engine.stream import (
        SpilledChunk,
        replay_probe_columns,
        stream_join,
    )

    ik, iv, ok, ov = (d[k] for k in ("ik", "iv", "ok", "ov"))
    rows = d["chunk_rows"]
    spill = os.path.join(tmp, "fz_stream")
    first = stream_join(ik, iv, ok, ov, chunk_rows=rows, spill_dir=spill,
                        device=dev)
    for k in range(d["keep"], len(first.chunks)):
        for f in os.listdir(spill):
            if f.startswith(f"chunk_{k:06d}"):
                os.remove(os.path.join(spill, f))
    chunks = {}

    def collect(cm, payload):
        k = cm.index
        sl = slice(k * rows, min((k + 1) * rows, len(ok)))
        if isinstance(payload, SpilledChunk):
            pk, pv = replay_probe_columns(ok[sl], ov[sl], first.plan,
                                          len(payload.match_vals), dev)
            mval, mcnt = payload.match_vals, payload.match_cnts
        else:
            pk, pv, mval, mcnt = (payload.probe_keys, payload.probe_vals,
                                  payload.match_vals, payload.match_cnts)
        chunks[k] = [_host(x) for x in (pk, pv, mval, mcnt)]

    second = stream_join(ik, iv, ok, ov, chunk_rows=rows, spill_dir=spill,
                         plan=first.plan, on_chunk=collect, device=dev)
    return dict(plan=first.plan, tuples=first.join_tuples,
                first=[(c.join_tuples, c.resumed) for c in first.chunks],
                second=[(c.join_tuples, c.resumed) for c in second.chunks],
                resumed_tuples=second.join_tuples,
                chunks=[chunks[k] for k in sorted(chunks)])


def _run_cpra(d, dev, tmp, kernels):
    """cpra_join on W thread ranks: every rank's result and plan."""
    from hash_join_codes_knl_tpu_torch.parallel.cpra import cpra_join
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        run_ranks,
        thread_meshes,
    )

    cols = [d[k] for k in ("ik", "iv", "ok", "ov")]
    out = run_ranks(thread_meshes(d["W"], dev, timeout_s=300),
                    lambda m: cpra_join(*cols, m, d["plan"], slack=4.0,
                                        retries=3), timeout_s=600)
    ranks = [_result(res) for res, _ in out]
    flat = [np.concatenate([r[f] for r in ranks]) for f in
            ("probe_keys", "probe_vals", "match_vals", "match_cnts")]
    return dict(plans=[plan for _, plan in out], ranks=ranks,
                tuples=[int(res.join_tuples) for res, _ in out],
                rows=_rows(_flat_result(flat), d["ik"], d["iv"]))


def _run_grace(d, dev, tmp, kernels):
    """grace_join_dist on W thread ranks: every partition's rows (from
    its owner rank, by partition index), the global counts on each
    rank."""
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        run_ranks,
        thread_meshes,
    )
    from hash_join_codes_knl_tpu_torch.parallel.grace_dist import (
        grace_join_dist,
    )

    cols = [d[k] for k in ("ik", "iv", "ok", "ov")]
    parts = {}

    def collect(meta, res, raw_pk):
        parts[meta.index] = [raw_pk] + [_host(x) for x in (
            res.probe_vals, res.match_vals, res.match_cnts)]

    out = run_ranks(
        thread_meshes(d["W"], dev, timeout_s=300),
        lambda m: grace_join_dist(*cols, m, f_bits=d["f_bits"],
                                  chunk_rows=d["chunk_rows"],
                                  spill_dir=os.path.join(tmp, "fz_grace"),
                                  on_partition=collect),
        timeout_s=600)
    flat = [np.concatenate([parts[p][i] for p in sorted(parts)])
            if parts else np.zeros(0, np.uint32) for i in range(4)]
    return dict(tuples=[g.join_tuples for g in out],
                metas=[[(m.index, m.build_rows, m.probe_rows, m.join_tuples)
                        for m in g.partitions] for g in out],
                parts=[parts[p] for p in sorted(parts)],
                rows=_rows(_flat_result(flat), d["ik"], d["iv"]))


def _run_columns(d, dev, tmp, kernels):
    """join_columns in the four modes, then join_columns_multi on the
    same keys split into two int32 halves (the same join relation)."""
    from hash_join_codes_knl_tpu_torch.engine.columns import (
        join_columns,
        join_columns_multi,
    )

    ik, ok = d["ik"], d["ok"]
    out = {}
    for how in HOWS:
        out[how] = join_columns(ik, d["inner_cols"], ok, d["outer_cols"],
                                how=how, device=dev)[0]
    halves = [((k >> 16).astype(np.int32), (k & 0xFFFF).astype(np.int32))
              for k in (ik, ok)]
    out["multi"] = join_columns_multi(halves[0], d["inner_cols"], halves[1],
                                      d["outer_cols"], how=d["multi_how"],
                                      device=dev)[0]
    return out


def _run_aggregate(d, dev, tmp, kernels):
    from hash_join_codes_knl_tpu_torch.ops.aggregate import (
        hash_aggregate,
        hash_aggregate_auto,
        hash_aggregate_chunked,
    )
    from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

    keys, vals = (u32_to_device(d[k], dev) for k in ("keys", "vals"))
    kw = dict(chunks=d["chunks"], partial_cap=d["cap"])
    return {name: [_host(x) for x in fn(keys, vals, **k)] for name, fn, k in
            (("chunked", hash_aggregate_chunked, kw),
             ("auto", hash_aggregate_auto, kw),
             ("single", hash_aggregate, {}))}


_RUNS = {"merge": _run_merge, "radix": _run_radix, "npj": _run_npj,
         "stream": _run_stream, "cpra": _run_cpra, "grace": _run_grace,
         "columns": _run_columns, "aggregate": _run_aggregate}


def run(campaign: str, d: dict, device, tmp: str,
        kernels: bool = False) -> dict:
    """The draw `d` through the port on `device`; spill files go under
    `tmp`.  kernels=True gives a radix draw the tile probe (see the
    module's note); both devices of a comparison take the same value."""
    return _RUNS[campaign](d, device, tmp, kernels)


# ---- checks ------------------------------------------------------------


def _check_join(d, out, oracle_rows, digest):
    if out["tuples"] != len(oracle_rows[0]):
        raise AssertionError(f"join_tuples {out['tuples']} != oracle "
                             f"{len(oracle_rows[0])}")
    if digest(*out["rows"]) != digest(*oracle_rows):
        raise AssertionError("row digest differs from the oracle's")


def _check_radix(d, out, oracle_rows, digest):
    if int(out["res"]["build_counts"][-1]) != 0:
        raise AssertionError("radix pass overflow")
    _check_join(d, out, oracle_rows, digest)


def _check_npj(d, out, oracle_rows, digest):
    ok, ov = d["ok"], d["ov"]
    for order in ("input", "sorted"):
        if order == "input":
            mv, mc = out[order]
            k, v = ok, ov
        else:
            k, v, mv, mc = out[order]
        if int(mc.astype(np.int64).sum()) != len(oracle_rows[0]):
            raise AssertionError(f"npj {order}: match count sum "
                                 f"{int(mc.sum())} != oracle "
                                 f"{len(oracle_rows[0])}")
        if mc.max(initial=0) <= 1:
            m = mc == 1
            if digest(k[m], v[m], mv[m]) != digest(*oracle_rows):
                raise AssertionError(f"npj {order}: digest differs")


def _check_stream(d, out, oracle_rows, digest):
    n = d["n_chunks"]
    if out["tuples"] != len(oracle_rows[0]):
        raise AssertionError(f"stream join_tuples {out['tuples']} != "
                             f"{len(oracle_rows[0])}")
    if len(out["first"]) != n or out["resumed_tuples"] != out["tuples"]:
        raise AssertionError(f"stream: {len(out['first'])} chunks (want "
                             f"{n}), resumed total {out['resumed_tuples']}")
    want = [(t, k < d["keep"]) for k, (t, _) in enumerate(out["first"])]
    if out["second"] != want:
        raise AssertionError(f"stream resume: {out['second']} != {want}")
    # the 1:1 rows (match count 1 <=> build multiplicity 1) of every chunk
    got = [np.concatenate([c[i][c[3] == 1] for c in out["chunks"]])
           for i in range(3)]
    wk, wv, wm = oracle_rows
    uk, uc = np.unique(d["ik"], return_counts=True)
    mult = dict(zip(uk.tolist(), uc.tolist()))
    one = np.fromiter((mult.get(int(k), 0) == 1 for k in wk),
                      count=len(wk), dtype=bool)
    if digest(*got) != digest(wk[one], wv[one], wm[one]):
        raise AssertionError("stream: the 1:1 rows' digest differs")


def _check_ranks(d, out, oracle_rows, digest):
    if sum(out["tuples"]) != len(oracle_rows[0]):
        raise AssertionError(f"join_tuples {out['tuples']} != oracle "
                             f"{len(oracle_rows[0])}")
    if digest(*out["rows"]) != digest(*oracle_rows):
        raise AssertionError("row digest differs from the oracle's")


def _check_grace(d, out, oracle_rows, digest):
    want = len(oracle_rows[0])
    if any(t != want for t in out["tuples"]):
        raise AssertionError(f"grace join_tuples {out['tuples']} != {want}")
    if any(m != out["metas"][0] for m in out["metas"]):
        raise AssertionError("grace: the ranks' partition counts differ")
    if digest(*out["rows"]) != digest(*oracle_rows):
        raise AssertionError("grace: row digest differs from the oracle's")


def _oracle_pairs(ik, ok):
    """(outer_idx, inner_idx) pairs of the equi-join, as a multiset
    (tests/test_columns.py `_oracle_rows`)."""
    by_key = collections.defaultdict(list)
    for i, k in enumerate(ik.tolist()):
        by_key[k].append(i)
    out = []
    for o, k in enumerate(ok.tolist()):
        for i in by_key.get(k, ()):
            out.append((o, i))
    return collections.Counter(out)


def _mode_oracle(pairs, n_outer, how):
    """(outer_idx, inner_idx) multiset for a join mode; inner_idx is None
    on anti rows and on semi rows (tests/test_columns.py
    `_mode_oracle`)."""
    matched = {o for (o, _) in pairs}
    if how == "inner":
        return pairs
    if how == "semi":
        return collections.Counter((o, None) for o in matched)
    if how == "anti":
        return collections.Counter(
            (o, None) for o in range(n_outer) if o not in matched
        )
    left = collections.Counter(pairs)
    for o in range(n_outer):
        if o not in matched:
            left[(o, None)] += 1
    return left


def check_mode(out, pairs, n_outer, how):
    """tests/test_columns.py `_check_mode`: the output's (outer row,
    inner row) multiset against the mode's oracle; payloads are 1-based
    row numbers, so 0 marks a null inner row."""
    want = _mode_oracle(pairs, n_outer, how)
    got = collections.Counter()
    if how in ("semi", "anti"):
        if set(out) != {"ov"}:
            raise AssertionError(f"{how}: columns {sorted(out)}")
        for ov in out["ov"].tolist():
            got[(ov - 1, None)] += 1
    else:
        for ov, iv in zip(out["ov"].tolist(), out["iv"].tolist()):
            got[(ov - 1, iv - 1 if iv else None)] += 1
    if got != want:
        raise AssertionError(f"join_columns how={how}: rows differ from "
                             f"the oracle's")


def _check_columns(d, out, oracle_rows, digest):
    pairs = _oracle_pairs(d["ik"], d["ok"])
    n_outer = len(d["ok"])
    for how in HOWS:
        check_mode(out[how], pairs, n_outer, how)
    check_mode(out["multi"], pairs, n_outer, d["multi_how"])


def _check_aggregate(d, out, oracle_rows, digest):
    """Exact against numpy where the chunked aggregate counted no dropped
    partial; the auto wrapper and the single-level aggregate always."""
    keys, vals = d["keys"], d["vals"]
    uk = np.unique(keys[keys != 0])
    ng, gk, sums, counts, ovf = out["chunked"]
    if int(ovf) == 0:
        g = int(ng)
        if g != len(uk) or not np.array_equal(np.sort(gk[:g]), uk):
            raise AssertionError(f"chunked: {g} groups != {len(uk)}")
        for j, k in enumerate(gk[: min(g, 50)]):
            rows = keys == k
            if (sums[j] != np.uint32(vals[rows].sum())
                    or counts[j] != rows.sum()):
                raise AssertionError(f"chunked: group {int(k)} differs")
    n0, k0, s0, c0 = out["single"]
    g0 = int(n0)
    if not int(out["auto"][0]) == g0 == len(uk):
        raise AssertionError(f"groups: auto {int(out['auto'][0])}, single "
                             f"{g0}, numpy {len(uk)}")
    for a, b in zip(out["auto"][1:], (k0, s0, c0)):
        if not np.array_equal(a[:g0], b[:g0]):
            raise AssertionError("auto differs from the single-level "
                                 "aggregate")


_CHECKS = {"merge": _check_join, "radix": _check_radix, "npj": _check_npj,
           "stream": _check_stream, "cpra": _check_ranks,
           "grace": _check_grace, "columns": _check_columns,
           "aggregate": _check_aggregate}


def check(campaign: str, d: dict, out: dict, join_oracle,
          multiset_digest) -> None:
    """Raise AssertionError unless `out` (run's outputs for draw `d`)
    agrees with the oracle: cardinality and the row digest for the
    joins, the 1:1 rows after a resume for the stream, the modes'
    row-index multisets for the columns, numpy's groups for the
    aggregate."""
    rows = (join_oracle(d["ik"], d["iv"], d["ok"], d["ov"])
            if campaign not in ("columns", "aggregate") else None)
    _CHECKS[campaign](d, out, rows, multiset_digest)


def same(got, want, path: str = "") -> None:
    """Two runs' outputs equal slot for slot: arrays by dtype-free value
    and shape, everything else by ==."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{path}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        for k in want:
            same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} items != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray):
        g = np.asarray(got)
        if g.shape != want.shape or not np.array_equal(g, want):
            raise AssertionError(f"{path}: arrays differ")
    elif got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")


def card_vs_cpu(campaign: str, seed: int, device, tmp: str, join_oracle,
                multiset_digest) -> bool:
    """A draw on `device` (the card) against the same draw on the CPU,
    output for output and slot for slot (the final plans included), and
    against the oracle.  False for a draw that skips (a side cut empty
    for its ranks, where tests/test_fuzz.py skips); AssertionError, with
    the campaign and seed, on a difference."""
    d = draw(campaign, seed)
    if d.get("skip"):
        return False
    got = run(campaign, d, device, os.path.join(tmp, "card"), kernels=True)
    want = run(campaign, d, "cpu", os.path.join(tmp, "host"), kernels=True)
    try:
        same(got, want)
        check(campaign, d, got, join_oracle, multiset_digest)
    except AssertionError as e:
        raise AssertionError(f"fuzz {campaign} seed {seed}: {e}") from e
    return True
