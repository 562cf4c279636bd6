"""The port's indexed wide-window probe (K4's plain version,
ops/merge_probe_gather.merge_probe_gather_indexed_torch, its wrapper on
CPU tensors, and the plain Python model of K4's kernel mapping from
tests/test_torch_window_probes.py) against the JAX package's
merge_probe_gather_indexed in Pallas interpret mode, on the same inputs.
Slot for slot, zero tolerance; the slots of unlisted tiles keep their
input values.  Both packages refuse a window wider than 128 chunks."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hash_join_codes_knl_tpu.ops.merge_probe_gather import (
    merge_probe_gather_indexed as jax_indexed,
)
from hash_join_codes_knl_tpu_torch.engine.phj import _window_rows
from hash_join_codes_knl_tpu_torch.ops import merge_probe_gather as mg
from hash_join_codes_knl_tpu_torch.utils.hashing import (
    bias,
    to_numpy_u32,
    u32_to_device,
)
from torch_cases import (
    case_boundary_and_pads,
    case_long_duplicate_runs,
    case_uniform,
    case_wide_window_max_key,
)
from test_torch_window_probes import indexed_model


def _inputs(make, wide, pick):
    """The case's columns, a tile list from `pick(n_tiles)` with anchors
    clamped for the wide width, and random first-pass outputs."""
    bhk, bval, ohk, tile, _ = make()
    rows = len(bhk) // 128
    wide = min(wide, rows * 128)
    o, b = bias(u32_to_device(ohk, "cpu")), bias(u32_to_device(bhk, "cpu"))
    v = u32_to_device(bval, "cpu")
    n_tiles = len(ohk) // tile
    tidx = np.asarray(pick(n_tiles), np.int32)
    wrow_raw, _ = _window_rows(b, o, tile, rows)
    wrow_c = wrow_raw.clamp(0, rows - wide // 128)[torch.from_numpy(tidx)
                                                  .long()].to(torch.int32)
    rng = np.random.default_rng(len(ohk) + wide)
    mv_in = rng.integers(0, 2**32, len(ohk), dtype=np.uint32)
    mc_in = rng.integers(0, 50, len(ohk)).astype(np.int32)
    return dict(bhk=bhk, bval=bval, ohk=ohk, rows=rows, tile=tile,
                wide=wide, tidx=tidx, wrow_c=wrow_c.numpy(), mv_in=mv_in,
                mc_in=mc_in, o=o, b=b, v=v, n_tiles=n_tiles)


def _jax(d):
    return jax_indexed(
        jnp.asarray(d["ohk"]), jnp.asarray(d["bhk"]).reshape(d["rows"], 128),
        jnp.asarray(d["bval"]).reshape(d["rows"], 128),
        jnp.asarray(d["wrow_c"]), jnp.asarray(d["tidx"]),
        jnp.asarray(d["mv_in"]), jnp.asarray(d["mc_in"]), d["tile"],
        d["wide"], interpret=True)


def _port(fn, d):
    mv = u32_to_device(d["mv_in"], "cpu")
    mc = torch.from_numpy(d["mc_in"].copy())
    out = fn(d["o"], d["b"], d["v"], torch.from_numpy(d["wrow_c"]),
             torch.from_numpy(d["tidx"]), mv, mc, d["tile"], d["wide"])
    assert out[0] is mv and out[1] is mc  # written in place
    return to_numpy_u32(mv), mc.numpy()


def _model(d, chunks=1):
    """K4's kernel mapping in plain Python, on the case's columns, its
    blocks over `chunks` runs of the list."""
    mv, mc = indexed_model(d["o"].numpy(), d["b"].numpy(), d["v"].numpy(),
                           d["wrow_c"], d["tidx"], d["mv_in"], d["mc_in"],
                           d["tile"], d["wide"], chunks)
    return mv.astype(np.uint32), mc.astype(np.int32)


# (case, wide window, tile list): pad entries repeat real tiles; the
# first and last tile; a window reaching the build side's end; M:N runs
CASES = {
    "pads_repeat_tiles": (case_uniform, 1536,
                          lambda n: [3, 5, 5, 3, 3, 3]),
    "first_and_last": (case_boundary_and_pads, 1152,
                       lambda n: [0, n - 1, 1]),
    "window_to_build_end": (case_wide_window_max_key, 118 * 128,
                            lambda n: [n - 1, 0]),
    "mn_runs": (case_long_duplicate_runs, 2048,
                lambda n: list(range(0, n, 2)) + [0, 0]),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_indexed_matches_jax_interpret(name):
    make, wide, pick = CASES[name]
    d = _inputs(make, wide, pick)
    mv_j, mc_j = (np.asarray(x) for x in _jax(d))
    for chunks in (1, 3):
        mv, mc = _model(d, chunks)
        np.testing.assert_array_equal(mc, mc_j, err_msg=f"model {chunks}")
        np.testing.assert_array_equal(mv, mv_j, err_msg=f"model {chunks}")
    for fn in (mg.merge_probe_gather_indexed_torch,
               mg.merge_probe_gather_indexed):
        mv, mc = _port(fn, d)
        np.testing.assert_array_equal(mc, mc_j, err_msg=fn.__name__)
        np.testing.assert_array_equal(mv, mv_j, err_msg=fn.__name__)
    # unlisted tiles keep the first pass's values, listed ones change
    keep = np.ones(d["n_tiles"], bool)
    keep[d["tidx"]] = False
    keep = np.repeat(keep, d["tile"])
    np.testing.assert_array_equal(mv[keep], d["mv_in"][keep])
    np.testing.assert_array_equal(mc[keep], d["mc_in"][keep])
    assert (mc[~keep] != d["mc_in"][~keep]).any()
    assert mc[~keep].sum() > 0
    if name == "window_to_build_end":
        start = int(d["wrow_c"][0]) * 128
        assert start + d["wide"] == d["rows"] * 128


def test_indexed_equals_full_probe_on_listed_tiles():
    """On the listed tiles the result is the plain probe's at the wide
    width from the same anchors."""
    d = _inputs(case_long_duplicate_runs, 2048, lambda n: [1, 4, 6])
    mv, mc = _port(mg.merge_probe_gather_indexed_torch, d)
    tile = d["tile"]
    for j, t in enumerate(d["tidx"]):
        sub = d["o"][t * tile:(t + 1) * tile].contiguous()
        pmv, pmc = mg.merge_probe_torch(sub, d["b"], d["v"],
                                        torch.tensor([d["wrow_c"][j]],
                                                     dtype=torch.int32),
                                        tile, d["wide"])
        np.testing.assert_array_equal(mc[t * tile:(t + 1) * tile],
                                      pmc.numpy())
        np.testing.assert_array_equal(mv[t * tile:(t + 1) * tile],
                                      to_numpy_u32(pmv))


def test_indexed_empty_list_and_bad_arguments():
    d = _inputs(case_uniform, 1024, lambda n: [])
    mv, mc = _port(mg.merge_probe_gather_indexed, d)
    np.testing.assert_array_equal(mv, d["mv_in"])
    np.testing.assert_array_equal(mc, d["mc_in"])
    args = [d["o"], d["b"], d["v"], torch.zeros(2, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32),
            torch.zeros_like(d["o"]), torch.zeros_like(d["o"]), d["tile"],
            1024]
    with pytest.raises(ValueError, match="anchor"):
        mg.merge_probe_gather_indexed(*args)
    args[3] = torch.zeros(3, dtype=torch.int32)
    args[5] = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="mv"):
        mg.merge_probe_gather_indexed(*args)


def test_indexed_skips_ids_outside_the_probe():
    """An entry outside [0, tiles) writes nothing (K4 skips it too); the
    other entries give what they give without it."""
    d = _inputs(case_uniform, 1536, lambda n: [3, 5])
    want = _port(mg.merge_probe_gather_indexed, d)
    n = d["n_tiles"]
    bad = dict(d, tidx=np.array([n, 3, -1, 5, n + 7], np.int32),
               wrow_c=np.array([0, d["wrow_c"][0], 0, d["wrow_c"][1], 0],
                               np.int32))
    for fn in (mg.merge_probe_gather_indexed_torch,
               mg.merge_probe_gather_indexed):
        mv, mc = _port(fn, bad)
        np.testing.assert_array_equal(mc, want[1], err_msg=fn.__name__)
        np.testing.assert_array_equal(mv, want[0], err_msg=fn.__name__)
    mv, mc = _model(bad)
    np.testing.assert_array_equal(mc, want[1], err_msg="model")
    np.testing.assert_array_equal(mv, want[0], err_msg="model")


@pytest.mark.parametrize("path", ["plain", "wrapper", "model", "jax"])
def test_indexed_refuses_more_than_128_chunks_like_jax(path):
    """A window of 129 chunks is refused: by the port's plain version and
    its wrapper (ValueError, on the CPU path as on the CUDA path), by K4's
    model (one staged piece), and by the JAX wrapper (AssertionError, its
    window // 128 <= 128); the port takes 128 chunks, MAX_PIECE slots."""
    rng = np.random.default_rng(129)
    rows, tile = 130, 128
    bhk = np.sort(rng.integers(1, 2**32, rows * 128, dtype=np.uint32))
    bval = rng.integers(0, 2**32, rows * 128, dtype=np.uint32)
    ohk = np.sort(bhk[rng.integers(0, len(bhk), 4 * tile)])
    d = dict(bhk=bhk, bval=bval, ohk=ohk, rows=rows, tile=tile,
             tidx=np.array([1, 3], np.int32), wrow_c=np.zeros(2, np.int32),
             mv_in=np.zeros(len(ohk), np.uint32),
             mc_in=np.zeros(len(ohk), np.int32),
             o=bias(u32_to_device(ohk, "cpu")),
             b=bias(u32_to_device(bhk, "cpu")), v=u32_to_device(bval, "cpu"))
    run = {"plain": lambda: _port(mg.merge_probe_gather_indexed_torch, d),
           "wrapper": lambda: _port(mg.merge_probe_gather_indexed, d),
           "model": lambda: _model(d), "jax": lambda: _jax(d)}[path]
    assert mg.MAX_PIECE == 128 * 128
    if path != "jax":
        d["wide"] = mg.MAX_PIECE
        mv, mc = run()
        assert mc.sum() > 0
    d["wide"] = mg.MAX_PIECE + 128
    if path == "jax":
        with pytest.raises(AssertionError, match=str(d["wide"])):
            run()
    else:
        with pytest.raises(ValueError, match="wider than|more than one"):
            run()
