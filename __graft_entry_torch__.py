"""Entry points of the PyTorch/CUDA port for an outside harness (the
counterpart of __graft_entry__.py): a one-device forward step, and a
multi-rank dry run of every distributed step.

    entry(device=None)                 -> (fn, example_args)
    dryrun_multichip(n, device=None)   -> None (raises on a wrong count)

Both run on the card unless asked for the CPU (device="cpu"); without a
card and not asked they raise.  The dry run's n ranks are gloo threads
of this process sharing the one device (thread_meshes), the port's
counterpart of JAX's n-device CPU mesh.
"""

import collections
import tempfile

import numpy as np


def _device(device):
    import torch

    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available: pass "
                               "device='cpu' to run the plain versions on "
                               "the host")
        return torch.device("cuda")
    return torch.device(device)


def entry(device=None):
    """(fn, example_args): fn is phj_join at __graft_entry__.py's plan
    (JoinPlan(p_bits=6, slots=256, tile=256, pass_bits=(6,)); its other
    fields default as there, so it is the merge-mode join at a 256-row
    tile, which launches K1 and the window probe), example_args its
    4096 x 16384 inputs as int32 bit tensors on the device."""
    from hash_join_codes_knl_tpu_torch.engine.config import JoinPlan
    from hash_join_codes_knl_tpu_torch.engine.phj import phj_join
    from hash_join_codes_knl_tpu_torch.utils.hashing import u32_to_device

    dev = _device(device)
    plan = JoinPlan(p_bits=6, slots=256, tile=256, pass_bits=(6,))

    def fwd(inner_keys, inner_vals, outer_keys, outer_vals):
        return phj_join(inner_keys, inner_vals, outer_keys, outer_vals, plan)

    rng = np.random.default_rng(0)
    ik_np = rng.integers(1, 2**32, 4096, dtype=np.uint32)
    ok_np = ik_np[rng.integers(0, 4096, 16384)]  # all probes match
    args = tuple(u32_to_device(a, dev) for a in (
        ik_np, ik_np * np.uint32(7), ok_np, ok_np * np.uint32(13)))
    return fwd, args


def _expect(ok: bool, step: str, got=None, want=None) -> None:
    """A dry-run check (not an assert: it must hold under -O too)."""
    if not ok:
        raise AssertionError(f"{step}: got {got}, want {want}")


def _expect_total(mesh, res, expect: int, step: str) -> None:
    """The join cardinality summed over the mesh's ranks is `expect`."""
    total = int(mesh.all_sum([int(res.join_tuples)])[0])
    _expect(total == expect, step, total, expect)


def _steps(mesh, cols, plan, expect: int, spill_dir: str) -> None:
    """Every distributed step of __graft_entry__.dryrun_multichip on this
    rank; each checks the exact cardinality over the mesh."""
    from hash_join_codes_knl_tpu_torch.parallel.cpra import (
        cpra_join,
        make_cpra_step,
        make_cpra_step_2level,
        make_cpra_step_pipelined,
        make_cpra_steps_staged,
    )
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        shard_null_padded,
        split_2level,
    )
    from hash_join_codes_knl_tpu_torch.parallel.grace_dist import (
        grace_join_dist,
    )
    from hash_join_codes_knl_tpu_torch.parallel.npj_dist import npj_join_dist

    n = mesh.size
    n_inner, n_outer = len(cols[0]), len(cols[2])
    res, _ = cpra_join(*cols, mesh, plan, slack=4.0)
    _expect_total(mesh, res, expect, "cpra_join")
    if n >= 2:
        # tier-ratio placement (simd_hash_ratio analog) over mesh halves
        res_t, _ = cpra_join(*cols, mesh, plan, slack=4.0, tier_ratio=0.75)
        _expect_total(mesh, res_t, expect, "tier ratio 0.75")

        local = [shard_null_padded(c, mesh) for c in cols]
        caps = (4 * n_inner // (n * n), 4 * n_outer // (n * n))
        # chunked exchange/compute pipeline
        res_p, ovf = make_cpra_step_pipelined(mesh, plan, *caps,
                                              chunks=2)(*local)
        _expect(not ovf, "pipelined overflow", ovf, False)
        _expect_total(mesh, res_p, expect, "pipelined")

        # radix-pack exchange (one pass of the radix kernel as the pack)
        res_r, _, diag = make_cpra_step(mesh, plan, *caps,
                                        pack_impl="radix")(*local)
        _expect(int(diag[0]) == 0 and int(diag[1]) == 0,
                "radix pack overflow", diag.tolist(), "no overflow")
        _expect_total(mesh, res_r, expect, "radix pack")

        # staged exchange/local-join split (the --timelog metering path)
        ex, jo = make_cpra_steps_staged(mesh, plan, *caps)
        *exchanged, eovf = ex(*local)
        res_s, jovf = jo(*exchanged)
        _expect(not (eovf or jovf), "staged overflow", (eovf, jovf),
                (False, False))
        _expect_total(mesh, res_s, expect, "staged")

        # replicated-shared-table NPJ
        _, _, total_npj, _ = npj_join_dist(*cols, mesh)
        _expect(total_npj == expect, "npj_join_dist", total_npj, expect)

        # distributed Grace: out-of-core radix pass + owner all-to-all,
        # partition-parallel joins (neither relation need fit the mesh)
        gres = grace_join_dist(*cols, mesh,
                               f_bits=max(2, (n - 1).bit_length()),
                               chunk_rows=n_inner, spill_dir=spill_dir)
        _expect(gres.join_tuples == expect, "grace_join_dist",
                gres.join_tuples, expect)

    if n >= 4:
        # two-level host/chip exchange on a (2, n/2) split of the ranks
        host, chip = split_2level(mesh, 2)
        res2, ovf2 = make_cpra_step_2level(
            host, chip, plan, inner_cap=n_inner,
            outer_cap=n_outer // 2)(*local)
        _expect(not ovf2, "2-level overflow", ovf2, False)
        _expect_total(mesh, res2, expect, "2-level")


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Run every distributed step of __graft_entry__.dryrun_multichip
    (plain, tier-ratio, pipelined, radix pack, staged, NPJ, Grace, and
    2-level at n >= 4) on n_devices gloo thread ranks sharing one
    device, with its data and its exact cardinality checks."""
    from hash_join_codes_knl_tpu_torch.engine.config import JoinPlan
    from hash_join_codes_knl_tpu_torch.parallel.distributed import (
        run_ranks,
        thread_meshes,
    )

    dev = _device(device)
    plan = JoinPlan(p_bits=5, slots=128, tile=128, pass_bits=(5,))
    rng = np.random.default_rng(1)
    n_inner = 512 * n_devices
    n_outer = 2048 * n_devices
    ik = rng.integers(1, 2**32, n_inner, dtype=np.uint32)
    ok = ik[rng.integers(0, n_inner, n_outer)]  # each probe matches
    iv = ik * np.uint32(7)
    ov = ok * np.uint32(13)
    # exact expectation: the number of (outer, matching inner) pairs
    c = collections.Counter(ik.tolist())
    expect = sum(c[k] for k in ok.tolist())

    meshes = thread_meshes(n_devices, dev)
    with tempfile.TemporaryDirectory() as td:
        run_ranks(meshes, lambda m: _steps(m, (ik, iv, ok, ov), plan,
                                           expect, td))
