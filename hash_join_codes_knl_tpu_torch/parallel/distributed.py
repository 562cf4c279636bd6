"""Distributed runtime: process groups, meshes, collectives, health checks.

Counterpart of ``hash_join_codes_knl_tpu/parallel/distributed.py``.  The
JAX package is single-controller: one process holds an N-device mesh and
``shard_map`` runs each step on every device.  The port takes PyTorch's
idiom instead: one process (or thread) per rank, each calling the same
driver with the same replicated host relations, each holding only its
own block of them, joined by a ``torch.distributed`` process group.

A ``Mesh`` is one rank's view of a 1-D data mesh: its group, rank, size
and device.  Its collectives (all-to-all of equal blocks, all-gather,
sum and max all-reduce, broadcast, barrier) call the ``ProcessGroup``
object's own methods, so one code path serves torchrun's WORLD group,
groups made by ``new_group`` and groups built directly; the implicit
default group is never used.  A world of one rank needs no group.

Transport: both backends take the rank's device tensors.  NCCL moves
them over the interconnect; gloo copies CUDA tensors through host
memory and moves them over TCP, so the packs, the kernels and the joins
stay on the card either way.  Gloo is the form ``thread_meshes`` gives
several ranks sharing one card (NCCL refuses two ranks on one GPU);
its seconds measure host copies and loopback TCP, not an interconnect.

Failure detection, as in the JAX package (SURVEY.md section 5), is a
liveness barrier: one small all-reduce with a bounded wait.  A silent
participant fails the check and the driver aborts with a diagnosis
instead of hanging in a data collective; every stage is a pure function
of its inputs, so re-running it is safe.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import itertools
import os
import pickle
import threading

import numpy as np
import torch
import torch.distributed as dist

from ..utils.hashing import u32_to_device

_thread_ids = itertools.count()


def _default_device(device) -> torch.device:
    """`device` (a card given without an index is the current one), or
    the card of this process's local rank (RuntimeError where there is
    none: the drivers never carry on on the host unasked)."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available for the mesh: pass device='cpu' "
            "to run the plain versions on the host"
        )
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a 1-D data mesh of `size` ranks.

    group: the ProcessGroup joining the ranks (None for a world of one);
    backend: "nccl" or "gloo"; store and prefix: the shared store of
    thread ranks, from which subgroups are made (split_2level);
    timeout_s: the gloo groups' operation timeout."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "x"
    backend: str | None = None
    store: object = None
    prefix: str = ""
    timeout_s: float = 300.0

    def all_to_all(self, x: torch.Tensor, async_op: bool = False):
        """Block i of the flat tensor x (size equal blocks) goes to rank
        i; the result holds block `rank` of every rank, in rank order.
        async_op=True returns a handle whose wait() gives the result."""
        if x.shape[0] % self.size:
            raise ValueError(f"{x.shape[0]} rows do not split into "
                             f"{self.size} equal blocks")
        if self.group is None:
            return _Pending(None, x) if async_op else x
        x = x.contiguous()
        out = torch.empty_like(x)
        work = self.group.alltoall_base(out, x, [], [],
                                        dist.AllToAllOptions())
        pending = _Pending(work, out)
        return pending if async_op else pending.wait()

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's x concatenated in rank order (tiled)."""
        if self.group is None:
            return x
        x = x.contiguous()
        outs = [torch.empty_like(x) for _ in range(self.size)]
        self.group.allgather([outs], [x]).wait()
        return torch.cat(outs)

    def _reduce_host(self, values, op) -> np.ndarray:
        a = np.asarray(values, dtype=np.int64).reshape(-1)
        if self.group is None:
            return a
        dev = "cpu" if self.backend == "gloo" else self.device
        t = torch.from_numpy(a.copy()).to(dev)
        opts = dist.AllreduceOptions()
        opts.reduceOp = op
        self.group.allreduce([t], opts).wait()
        return t.cpu().numpy()

    def all_sum(self, values) -> np.ndarray:
        """Element-wise sum over the ranks of an int64 host vector."""
        return self._reduce_host(values, dist.ReduceOp.SUM)

    def all_max(self, values) -> np.ndarray:
        """Element-wise maximum over the ranks of an int64 host vector."""
        return self._reduce_host(values, dist.ReduceOp.MAX)

    def broadcast_object(self, obj=None, root: int = 0):
        """Rank root's picklable `obj` on every rank."""
        if self.group is None:
            return obj
        payload = pickle.dumps(obj) if self.rank == root else b""
        n = self._bcast(np.array([len(payload)], np.int64), root)[0]
        buf = np.frombuffer(payload, np.uint8) if self.rank == root else \
            np.zeros(int(n), np.uint8)
        data = self._bcast(buf, root)
        return obj if self.rank == root else pickle.loads(data.tobytes())

    def _bcast(self, a: np.ndarray, root: int) -> np.ndarray:
        dev = "cpu" if self.backend == "gloo" else self.device
        t = torch.from_numpy(np.array(a, copy=True)).to(dev)
        opts = dist.BroadcastOptions()
        opts.rootRank = root
        self.group.broadcast([t], opts).wait()
        return t.cpu().numpy()

    def root_call(self, fn, *args, **kw):
        """fn(*args) run on rank 0 alone and its result (or the exception
        it raised) on every rank: one plan for all ranks, where a
        per-rank planner could time its candidates differently on each."""
        out = None
        if self.rank == 0:
            try:
                out = ("ok", fn(*args, **kw))
            except Exception as e:  # re-raised on every rank below
                out = ("err", e)
        kind, value = self.broadcast_object(out)
        if kind == "err":
            raise value
        return value

    def barrier(self) -> None:
        if self.group is not None:
            self.group.barrier().wait()


class _Pending:
    """A started collective (or None: nothing to wait for); wait()
    finishes it and gives the result."""

    def __init__(self, work, result):
        self.work, self.result = work, result

    def wait(self):
        if self.work is not None:
            self.work.wait()
        return self.result


def initialize(init_method: str | None = None, world_size: int | None = None,
               rank: int | None = None, backend: str | None = None,
               device=None) -> None:
    """Bring up the process group.

    Explicit arguments go to ``init_process_group`` as given (world_size
    set).  With none, torchrun's environment (WORLD_SIZE, RANK,
    MASTER_ADDR) brings it up through ``env://``; otherwise this is a
    no-op, as the JAX package's is on one host.  The backend is NCCL for
    the card and gloo for the CPU (`device`, by default the card where
    there is one)."""
    if dist.is_initialized():
        return
    if backend is None:
        on_card = (torch.device(device).type == "cuda" if device is not None
                   else torch.cuda.is_available())
        backend = "nccl" if on_card else "gloo"
    if world_size is not None:
        dist.init_process_group(backend, init_method=init_method,
                                world_size=world_size, rank=rank)
        return
    if all(os.environ.get(v) for v in ("WORLD_SIZE", "RANK", "MASTER_ADDR")):
        dist.init_process_group(backend, init_method="env://")


@contextlib.contextmanager
def process_group(**kw):
    """initialize(**kw) for the block.  A group that this brought up is
    destroyed when the block ends, so it is never left to the
    interpreter's exit (gloo can abort there); a group the caller set up
    stays up."""
    was_up = dist.is_initialized()
    initialize(**kw)
    try:
        yield
    finally:
        if not was_up and dist.is_initialized():
            dist.destroy_process_group()


def data_mesh(n_devices: int | None = None, axis: str = "x",
              device=None) -> Mesh:
    """This rank's mesh over the whole world: the WORLD group when one is
    up (its collectives run even in a world of one), else a world of one
    with no group.  n_devices, when given, must equal the
    world size (a rank outside a smaller mesh would have nothing to run).
    The device is cuda:LOCAL_RANK by default, the CPU only when asked."""
    dev = _default_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} ranks in a world of {world}: launch "
            f"{n_devices} ranks (torchrun --nproc-per-node {n_devices})"
        )
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        return Mesh(None, 0, 1, dev, axis)
    return Mesh(dist.group.WORLD, dist.get_rank(), world, dev, axis,
                backend=dist.get_backend())


def _gloo_group(store, prefix: str, rank: int, size: int, timeout_s: float):
    return dist.ProcessGroupGloo(dist.PrefixStore(prefix, store), rank, size,
                                 datetime.timedelta(seconds=timeout_s))


def _on_threads(n: int, fn, timeout_s: float | None = None) -> list:
    """fn(i) for i in range(n), each on its own thread; results in order.
    The first exception, by index, is raised once every thread is done."""
    out, err = [None] * n, [None] * n

    def run(i):
        try:
            out[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 -- re-raised below
            err[i] = e

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_s)
        if t.is_alive():
            raise TimeoutError(f"a rank thread did not finish in "
                               f"{timeout_s} s")
    for e in err:
        if e is not None:
            raise e
    return out


def thread_meshes(world: int, device=None, axis: str = "x",
                  timeout_s: float = 300.0) -> list:
    """`world` gloo ranks as threads of this process, one Mesh each,
    all on `device` (the card by default): the port's counterpart of
    JAX's --xla_force_host_platform_device_count, for the tests and for
    several ranks on one card.  Run a driver on them with run_ranks."""
    dev = _default_device(device)
    store = dist.HashStore()
    prefix = f"threads{next(_thread_ids)}"
    if world == 1:
        return [Mesh(None, 0, 1, dev, axis, store=store, prefix=prefix,
                     timeout_s=timeout_s)]
    return _on_threads(world, lambda r: Mesh(
        _gloo_group(store, prefix, r, world, timeout_s), r, world, dev, axis,
        backend="gloo", store=store, prefix=prefix, timeout_s=timeout_s))


def run_ranks(meshes: list, fn, timeout_s: float | None = None) -> list:
    """fn(mesh) on every thread rank of `meshes` at once; the results in
    rank order.  A rank's exception is raised after all have ended."""
    def one(r):
        if meshes[r].device.type == "cuda":
            torch.cuda.set_device(meshes[r].device)
        return fn(meshes[r])

    return _on_threads(len(meshes), one, timeout_s)


def split_2level(mesh: Mesh, hosts: int) -> tuple:
    """(host mesh, chip mesh) of this rank for the two-level exchange:
    the world as `hosts` rows of size/hosts ranks, rank = h * C + c.  The
    host mesh joins the ranks of one chip position c across the hosts
    (the slow hop), the chip mesh the ranks of one host.  Every rank of
    the world calls this, in the same order."""
    if hosts < 1 or mesh.size % hosts:
        raise ValueError(f"{mesh.size} ranks do not split into {hosts} "
                         "hosts")
    C = mesh.size // hosts
    h, c = divmod(mesh.rank, C)
    members = {"h": [hh * C + c for hh in range(hosts)],
               "c": [h * C + cc for cc in range(C)]}

    def sub(kind, sub_rank, sub_size, key):
        if sub_size == 1:
            return Mesh(None, 0, 1, mesh.device, kind, store=mesh.store,
                        prefix=f"{mesh.prefix}/{kind}{key}",
                        timeout_s=mesh.timeout_s)
        if mesh.store is not None:
            group = _gloo_group(mesh.store, f"{mesh.prefix}/{kind}{key}",
                                sub_rank, sub_size, mesh.timeout_s)
        else:
            group = own[kind]
        return Mesh(group, sub_rank, sub_size, mesh.device, kind,
                    backend=mesh.backend, store=mesh.store,
                    prefix=f"{mesh.prefix}/{kind}{key}",
                    timeout_s=mesh.timeout_s)

    own = {}
    if mesh.store is None and mesh.group is not None:
        # new_group is collective over the world: every rank makes every
        # group, in one order, and keeps its own
        for kind, groups in (("h", [[hh * C + cc for hh in range(hosts)]
                                    for cc in range(C)]),
                             ("c", [[hh * C + cc for cc in range(C)]
                                    for hh in range(hosts)])):
            for ranks in groups:
                g = dist.new_group(ranks) if len(ranks) > 1 else None
                if ranks == members[kind]:
                    own[kind] = g
    return sub("h", h, hosts, c), sub("c", c, C, h)


def shard_null_padded(x, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a replicated column (numpy uint32, np.memmap,
    or an int32 bit tensor on the rank's device), null-padded to a
    multiple of the mesh size first: key 0 is the inert null everywhere,
    so any relation length shards, and the pads land at the tail of the
    last block.  Only the block is read."""
    n = len(x)
    block = -(-n // mesh.size)
    lo = min(n, mesh.rank * block)
    hi = min(n, lo + block)
    if isinstance(x, torch.Tensor):
        out = torch.zeros(block, dtype=torch.int32, device=mesh.device)
        out[: hi - lo] = x[lo:hi]
        return out
    out = np.zeros(block, np.uint32)
    out[: hi - lo] = np.asarray(x[lo:hi], dtype=np.uint32)
    return u32_to_device(out, mesh.device)


def _heartbeat(mesh: Mesh, x: torch.Tensor, timeout_s: float):
    opts = dist.AllreduceOptions()
    opts.reduceOp = dist.ReduceOp.SUM
    work = mesh.group.allreduce([x], opts)
    work.wait(datetime.timedelta(seconds=timeout_s))
    return x


def liveness_check(mesh: Mesh, timeout_s: float = 30.0,
                   _beat_fn=None) -> bool:
    """All-ranks heartbeat: one small all-reduce with a bounded wait.

    True if every rank answered within the deadline.  False means a
    participant is unreachable: abort the job and rerun the stage
    (stages are pure).  The drivers run it at their stage boundary
    through require_live_mesh; _beat_fn(x) is a test hook that replaces
    the all-reduce (one that hangs exercises the timeout)."""
    dev = "cpu" if mesh.backend != "nccl" else mesh.device
    x = torch.ones(1, dtype=torch.int64, device=dev)
    fn = _beat_fn or (lambda t: _heartbeat(mesh, t, timeout_s))
    result: list[bool] = []

    def run():
        try:
            result.append(int(fn(x)[0]) == mesh.size)
        except Exception:  # a failed or timed-out beat is a dead mesh
            result.append(False)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    return bool(result and result[0])


def require_live_mesh(mesh: Mesh, timeout_s: float | None,
                      stage: str = "") -> None:
    """Stage-boundary guard of the distributed drivers: abort with a
    diagnosis instead of hanging inside a data collective when a rank is
    gone.  timeout_s=None skips the check, and a one-rank mesh skips it
    (there is nobody else to wait for)."""
    if timeout_s is None or mesh.size <= 1:
        return
    if not liveness_check(mesh, timeout_s=timeout_s):
        raise RuntimeError(
            f"mesh liveness check failed before stage {stage!r}: a rank "
            f"of the {mesh.size}-rank {mesh.axis!r} mesh did not answer "
            f"the heartbeat within {timeout_s}s -- abort and rerun the "
            "stage (stages are pure)"
        )
