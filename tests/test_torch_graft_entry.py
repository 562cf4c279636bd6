"""__graft_entry_torch__.py against __graft_entry__.py on the CPU: the
forward step's result slot for slot, and the multi-rank dry run's
distributed steps, each exact, on gloo thread ranks."""

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_entry
import __graft_entry_torch__ as port_entry


def test_entry_like_jax():
    """The same plan on the same inputs: every slot equal (the port's
    columns are flat uint32 bits, the JAX package's arrays)."""
    from hash_join_codes_knl_tpu_torch.engine.convert import result_to_numpy

    fn, args = port_entry.entry(device="cpu")
    assert all(a.device.type == "cpu" and a.dtype == torch.int32
               for a in args)
    got = result_to_numpy(fn(*args))
    jfn, jargs = jax_entry.entry()
    want = jfn(*jargs)
    for name in ("probe_keys", "probe_vals", "match_vals", "match_cnts"):
        w = np.asarray(getattr(want, name)).reshape(-1)
        assert np.array_equal(got[name], w.astype(got[name].dtype)), name
    assert int(got["match_cnts"].sum()) == 16384


@pytest.mark.parametrize("n", [1, 2, 4])
def test_dryrun_multichip_on_thread_ranks(n):
    port_entry.dryrun_multichip(n, device="cpu")


def test_entries_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is real")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_entry.dryrun_multichip(2)
