"""The port's distributed runtime (parallel/distributed.py) on the CPU:
the process-group bring-up, meshes over the world and over thread
ranks, their collectives, the liveness check and the drivers' abort on
a dead mesh -- the port's side of tests/test_distributed.py, where a
mesh of W thread ranks with gloo stands for the JAX package's W virtual
devices."""

import sys
import time

import numpy as np
import pytest
import torch

import hash_join_codes_knl_tpu_torch.parallel.distributed as dist_mod
from hash_join_codes_knl_tpu_torch.parallel.distributed import (
    data_mesh,
    initialize,
    liveness_check,
    require_live_mesh,
    run_ranks,
    shard_null_padded,
    split_2level,
    thread_meshes,
)


def test_initialize_single_host_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    initialize()  # must not raise, and brings up no group
    assert not torch.distributed.is_initialized()


def test_data_mesh_is_a_world_of_one():
    mesh = data_mesh(device="cpu")
    assert (mesh.rank, mesh.size, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cpu")
    require_live_mesh(mesh, timeout_s=0.01)  # one rank: skipped
    x = torch.arange(8, dtype=torch.int32)
    assert torch.equal(mesh.all_to_all(x), x)
    assert torch.equal(mesh.all_gather(x), x)
    assert mesh.all_sum([3, 4]).tolist() == [3, 4]
    assert mesh.broadcast_object({"a": 1}) == {"a": 1}
    with pytest.raises(ValueError, match="world of 1"):
        data_mesh(4, device="cpu")


@pytest.mark.parametrize("world", [2, 4])
def test_thread_meshes_collectives(world):
    meshes = thread_meshes(world, "cpu", timeout_s=60)
    assert [m.rank for m in meshes] == list(range(world))

    def body(m):
        x = torch.arange(2 * world, dtype=torch.int32) + 100 * m.rank
        got = m.all_to_all(x)
        pend = m.all_to_all(x, async_op=True)
        gathered = m.all_gather(torch.tensor([m.rank, -m.rank],
                                             dtype=torch.int32))
        sums = m.all_sum([m.rank, 1])
        maxs = m.all_max([m.rank])
        plan = m.root_call(lambda: ("plan", m.rank))
        m.barrier()
        return got, pend.wait(), gathered, sums, maxs, plan

    out = run_ranks(meshes, body, timeout_s=60)
    for r, (got, again, gathered, sums, maxs, plan) in enumerate(out):
        want = torch.tensor([2 * r + j + 100 * s for s in range(world)
                             for j in range(2)], dtype=torch.int32)
        assert torch.equal(got, want) and torch.equal(again, want)
        assert gathered.tolist() == [v for s in range(world)
                                     for v in (s, -s)]
        assert sums.tolist() == [world * (world - 1) // 2, world]
        assert maxs.tolist() == [world - 1]
        assert plan == ("plan", 0)  # rank 0's, on every rank


def test_root_call_raises_on_every_rank():
    meshes = thread_meshes(2, "cpu", timeout_s=60)

    def body(m):
        def plan():
            raise RuntimeError("planner failed")
        try:
            m.root_call(plan)
        except RuntimeError as e:
            return str(e)

    assert run_ranks(meshes, body, timeout_s=60) == ["planner failed"] * 2


def test_split_2level_groups():
    meshes = thread_meshes(4, "cpu", timeout_s=60)

    def body(m):
        h, c = split_2level(m, 2)
        # the host mesh joins one chip position across hosts, the chip
        # mesh the ranks of one host
        return ((h.rank, h.size, c.rank, c.size),
                h.all_gather(torch.tensor([m.rank])).tolist(),
                c.all_gather(torch.tensor([m.rank])).tolist())

    out = run_ranks(meshes, body, timeout_s=60)
    assert [o[0] for o in out] == [(0, 2, 0, 2), (0, 2, 1, 2),
                                   (1, 2, 0, 2), (1, 2, 1, 2)]
    assert [o[1] for o in out] == [[0, 2], [1, 3], [0, 2], [1, 3]]
    assert [o[2] for o in out] == [[0, 1], [0, 1], [2, 3], [2, 3]]


def test_shard_null_padded_blocks():
    x = np.arange(1, 11, dtype=np.uint32)
    meshes = thread_meshes(4, "cpu", timeout_s=60)
    blocks = [shard_null_padded(x, m).numpy().view(np.uint32)
              for m in meshes]
    assert [b.tolist() for b in blocks] == [[1, 2, 3], [4, 5, 6],
                                           [7, 8, 9], [10, 0, 0]]


def test_data_mesh_and_liveness():
    for world in (4, 8):
        meshes = thread_meshes(world, "cpu", timeout_s=60)
        assert all(run_ranks(meshes, lambda m: liveness_check(
            m, timeout_s=60.0), timeout_s=120))


def test_liveness_timeout_path():
    """A hanging heartbeat (a dead participant) returns False within the
    deadline instead of blocking."""
    mesh = thread_meshes(1, "cpu")[0]

    def hangs(x):
        time.sleep(3600)

    t0 = time.monotonic()
    assert liveness_check(mesh, timeout_s=0.5, _beat_fn=hangs) is False
    assert time.monotonic() - t0 < 5


def test_drivers_abort_on_dead_mesh(monkeypatch, tmp_path):
    """The distributed drivers run the liveness guard at their stage
    boundary and abort with a diagnosis instead of entering the
    exchange."""
    from hash_join_codes_knl_tpu_torch.parallel.cpra import cpra_join
    from hash_join_codes_knl_tpu_torch.parallel.grace_dist import (
        grace_join_dist,
    )
    from hash_join_codes_knl_tpu_torch.parallel.npj_dist import (
        npj_join_dist,
    )

    monkeypatch.setattr(dist_mod, "liveness_check", lambda *a, **k: False)
    ik = np.arange(1, 257, dtype=np.uint32)
    iv = ik * np.uint32(3)

    def body(m):
        errors = []
        for call in (
                lambda: cpra_join(ik, iv, ik, iv, m),
                lambda: npj_join_dist(ik, iv, ik, iv, m),
                lambda: grace_join_dist(ik, iv, ik, iv, m, f_bits=2,
                                        spill_dir=str(tmp_path / "g"))):
            with pytest.raises(RuntimeError, match="liveness") as e:
                call()
            errors.append(str(e.value))
        return errors

    out = run_ranks(thread_meshes(4, "cpu", timeout_s=60), body,
                    timeout_s=120)
    assert all(len(e) == 3 for e in out)


def test_launch_counts_survive_concurrent_ranks():
    """The kernel wrappers' launch counts take every increment from
    concurrent thread ranks (a bare += loses some)."""
    from hash_join_codes_knl_tpu_torch.ops import _build

    def wrapper():
        pass

    wrapper.launches = 0
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        dist_mod._on_threads(16, lambda i: [
            _build.count_launch(wrapper) for _ in range(2000)], 60)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == 16 * 2000
