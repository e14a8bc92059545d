"""Process meshes on ``torch.distributed`` and a local launcher.

Port of ``slam_tpu/parallel/mesh.py``.  A JAX ``Mesh`` is one controller
over n devices; ``torch.distributed`` runs one process per rank.  So a
:class:`Mesh` here is one rank's view: its rank, the world size, its
device, and one process group per named axis.  ``make_edge_mesh`` and
``make_block_mesh`` give a one-axis mesh over the world;
``make_replica_block_mesh`` a ``replicas x blocks`` mesh whose ranks
``r * blocks + k`` form one group per replica row (the block axis, where
the separator reductions run) and one per block column (the replica
axis, which only gathers the results).

:func:`launch` is the counterpart of "build an n-device mesh on this
host": it starts n local ranks (forked from a server process that has
imported the solvers once), joins them through a file rendezvous in a
fresh directory, runs a function in each and returns rank 0's result
(or every rank's).  :func:`shutdown` stops that server and the
resource tracker the ranks share; it runs at the launching process's
exit, so the process leaves no helper behind.  :func:`init_multihost`
joins a job started elsewhere (torchrun).  Both put a rank on the card of its local rank
unless the caller asks for the CPU.  The backend is ``nccl`` when every
rank of the host has a CUDA device of its own, ``gloo`` on the CPU and
``gloo`` on CUDA tensors when ranks share a card; both print their
choice.  A failed collective
raises; nothing switches backend after a failure.  On CUDA the parent
builds the kernel library before any rank starts, and the ranks only
load it.

:func:`all_reduce` and :func:`all_gather` count the bytes they move
(:data:`COLLECTIVES`), and time themselves, the device synchronised on
both sides, when ``COLLECTIVES["timed"]`` is set.
"""

from __future__ import annotations

import atexit
import dataclasses
import datetime
import gc
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

EDGE_AXIS = "edges"        # data-parallel axis over graph edges
BLOCK_AXIS = "blocks"      # map-block axis of the partitioned Schur solver
REPLICA_AXIS = "replicas"  # independent problems (outlier seeds)

#: Collective traffic of this process: calls, bytes reduced or gathered
#: (the tensor's size on this rank), and seconds when ``timed``.
COLLECTIVES = {"calls": 0, "bytes": 0, "seconds": 0.0, "timed": False}

_DEVICE: torch.device | None = None  # this rank's device (launch,
#                                      init_multihost)
#: Seconds of the last :func:`launch`, the slowest rank's: from the
#: launch to its start (``spawn_s``), to the joined group (``join_s``),
#: to its result (``run_s``), and the whole launch (``total_s``).
LAST_LAUNCH: dict = {}


def reset_collectives(timed: bool = False) -> None:
    COLLECTIVES.update(calls=0, bytes=0, seconds=0.0, timed=timed)


def rank_device() -> torch.device:
    """The device of this rank, as :func:`launch` or
    :func:`init_multihost` chose it."""
    if _DEVICE is None:
        raise RuntimeError("no rank device: join through init_multihost or "
                           "launch")
    return _DEVICE


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of a process mesh: ``shape[axis]`` ranks along
    each axis, this rank at ``index[axis]``, collectives of an axis over
    ``groups[axis]`` (None: the world)."""

    axes: tuple
    shape: dict
    index: dict
    groups: dict
    rank: int
    world_size: int
    device: torch.device


def _require_world(n: int | None) -> int:
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised (see "
                           "init_multihost or launch)")
    world = dist.get_world_size()
    if n is not None and n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    return world


def _one_axis(axis: str, n: int | None) -> Mesh:
    world = _require_world(n)
    rank = dist.get_rank()
    return Mesh(axes=(axis,), shape={axis: world}, index={axis: rank},
                groups={axis: None}, rank=rank, world_size=world,
                device=rank_device())


def make_edge_mesh(num_ranks: int | None = None) -> Mesh:
    """1-D mesh over the edge data-parallel axis (the whole world)."""
    return _one_axis(EDGE_AXIS, num_ranks)


def make_block_mesh(num_ranks: int | None = None) -> Mesh:
    """1-D mesh over graph partitions (map blocks; the whole world)."""
    return _one_axis(BLOCK_AXIS, num_ranks)


def make_replica_block_mesh(num_replicas: int, num_blocks: int) -> Mesh:
    """2-D mesh ``replicas x blocks`` over the world; rank ``r * num_blocks
    + k`` is replica ``r``, block ``k``.  Every rank creates every group,
    in the same order (``new_group``'s contract)."""
    world = _require_world(num_replicas * num_blocks)
    rank = dist.get_rank()
    r, k = divmod(rank, num_blocks)
    rows = [dist.new_group([i * num_blocks + j for j in range(num_blocks)])
            for i in range(num_replicas)]
    cols = [dist.new_group([i * num_blocks + j for i in range(num_replicas)])
            for j in range(num_blocks)]
    return Mesh(axes=(REPLICA_AXIS, BLOCK_AXIS),
                shape={REPLICA_AXIS: num_replicas, BLOCK_AXIS: num_blocks},
                index={REPLICA_AXIS: r, BLOCK_AXIS: k},
                groups={REPLICA_AXIS: cols[k], BLOCK_AXIS: rows[r]},
                rank=rank, world_size=world, device=rank_device())


def _sync(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def all_reduce(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """In-place ``SUM`` of ``t`` over ``axis``; returns ``t``."""
    if not t.is_contiguous():
        raise ValueError("all_reduce takes a contiguous tensor")
    timed = COLLECTIVES["timed"]
    if timed:
        _sync(t)
        t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.groups[axis])
    if timed:
        _sync(t)
        COLLECTIVES["seconds"] += time.perf_counter() - t0
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += t.numel() * t.element_size()
    return t


def all_gather(t: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``t`` of every rank of ``axis``, stacked in the axis' order."""
    flat = t.reshape(-1).contiguous()
    out = [torch.empty_like(flat) for _ in range(mesh.shape[axis])]
    dist.all_gather(out, flat, group=mesh.groups[axis])
    COLLECTIVES["calls"] += 1
    COLLECTIVES["bytes"] += flat.numel() * flat.element_size()
    return torch.stack(out).reshape(len(out), *t.shape)


def init_multihost(init_method: str | None = None,
                   world_size: int | None = None, rank: int | None = None,
                   backend: str | None = None, device=None) -> bool:
    """Join the process group of a multi-process run.

    Reads torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``) where no argument is given.  A no-op returning
    False when there is nothing to join; safe to call twice; True only for
    more than one process.  The rank runs on ``device`` (default ``cuda``:
    the card of its local rank, which becomes the current device), and
    the meshes carry it."""
    global _DEVICE
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and "MASTER_ADDR" in env:
        init_method = "env://"
    if init_method is None and world_size is None:
        return False  # one process: nothing to join
    if world_size is None or rank is None or init_method is None:
        raise ValueError("init_multihost needs an init method, a world "
                         "size and a rank (or torchrun's environment)")
    from slam_tpu_torch import runtime

    runtime.setup_device(device)
    cards = torch.cuda.device_count()
    dev, chosen = local_plan(device, int(env.get("LOCAL_RANK", rank)),
                             int(env.get("LOCAL_WORLD_SIZE", world_size)),
                             cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    _DEVICE = dev
    backend = backend or chosen
    print(f"[dist] backend={backend} rank={rank} world={world_size} "
          f"device={dev} cards={cards}", flush=True)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return world_size > 1


def local_plan(device, local_rank: int, local_ranks: int,
               cards: int) -> tuple[torch.device, str]:
    """The device and backend of local rank ``local_rank`` of
    ``local_ranks`` on a host with ``cards`` CUDA devices: ``device``
    (default ``cuda``) where it names an index, else the card
    ``local_rank mod cards``; ``nccl`` when every local rank has a card
    of its own, ``gloo`` on the CPU or when ranks share a card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev, "gloo"
    if dev.index is None:
        dev = torch.device("cuda", local_rank % cards)
    return dev, "nccl" if cards >= local_ranks else "gloo"


_PRELOAD = ["torch", "slam_tpu_torch.parallel.distributed",
            "slam_tpu_torch.parallel.schur_dist"]


def _to_host(x):
    """Tensors -> NumPy arrays, through tuples, lists, dicts and
    NamedTuples (results cross the process boundary as plain pickles)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, world, init_method, backend, device, timeout, fn,
               args, results) -> None:
    global _DEVICE
    stamps = [time.time()]
    try:
        from slam_tpu_torch import runtime

        dev = runtime.setup_device(device)
        if dev.type == "cuda":
            dev = local_plan(dev, rank, world, torch.cuda.device_count())[0]
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        _DEVICE = dev
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout))
        stamps.append(time.time())
        try:
            out = _to_host(fn(*args))
            stamps.append(time.time())
            dist.barrier()
        finally:
            dist.destroy_process_group()
        results.put((rank, True, (out, stamps)))
    except BaseException:  # noqa: BLE001 -- reported to the parent
        results.put((rank, False, traceback.format_exc()))


def launch(nprocs: int, fn, *args, device="cuda", backend: str | None = None,
           timeout: float = 900.0, all_ranks: bool = False):
    """Run ``fn(*args)`` in ``nprocs`` new local ranks joined in one
    process group; return rank 0's result (``all_ranks``: the list of
    every rank's, in rank order), its tensors as NumPy arrays.

    ``fn`` must be importable by name (a module-level function), and the
    ranks import only what it needs.  Rank ``r`` runs on card ``r mod
    cards`` (``device="cpu"``: the CPU, one thread a rank).  A rank that
    raises, dies or outlives ``timeout`` seconds ends every rank, and the
    error is raised here."""
    from slam_tpu_torch import runtime

    dev = runtime.setup_device(device)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = backend or local_plan(dev, 0, nprocs, cards)[1]
    if backend == "nccl" and cards < nprocs:
        raise ValueError(f"nccl needs a CUDA device per rank; {nprocs} "
                         f"ranks on {device}")
    print(f"[dist] backend={backend} ranks={nprocs} device={dev.type} "
          f"cards={cards}", flush=True)
    if dev.type == "cuda":
        from slam_tpu_torch.ops import _build

        _build.build()
    atexit.unregister(shutdown)
    atexit.register(shutdown)
    ctx = multiprocessing.get_context("forkserver")
    # Ranks fork from a server that imported torch and the solvers once
    # (a fresh interpreter, so no CUDA context is inherited); a rank
    # started from scratch would import them anew.
    ctx.set_forkserver_preload(_PRELOAD)
    results = ctx.Queue()
    rdv = tempfile.mkdtemp(prefix="slam_dist_")
    init_method = "file://" + os.path.join(rdv, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, nprocs, init_method, backend, dev.type,
                               timeout, fn, args, results),
                         daemon=True)
             for r in range(nprocs)]
    out: dict = {}
    t0 = time.time()
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < nprocs:
            try:
                rank, ok, val = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"ranks {dead} died (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks ran past {timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            out[rank] = val
        for p in procs:
            p.join(timeout=60)
        LAST_LAUNCH.clear()
        LAST_LAUNCH.update(
            {k: max(v[1][i] for v in out.values()) - t0
             for i, k in enumerate(("spawn_s", "join_s", "run_s"))},
            total_s=time.time() - t0)
    finally:
        for p in procs:
            if p.pid is None:  # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        # Release the queue's semaphores now, even when an error's
        # traceback keeps this frame alive (see shutdown).
        del results, procs
        shutil.rmtree(rdv, ignore_errors=True)
    return [out[r][0] for r in range(nprocs)] if all_ranks else out[0][0]


def shutdown() -> None:
    """Stop the forkserver :func:`launch` starts and the resource tracker
    its ranks share, and wait for both to end.  Runs at the exit of a
    process that launched ranks (helpers that outlive their parent are
    a leak); a later :func:`launch` starts them anew."""
    from multiprocessing import forkserver, resource_tracker

    gc.collect()  # release what still holds a launch's semaphores, or
    #               the tracker would be started again to unregister them
    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()


def run_jobs(jobs) -> list:
    """Each ``(fn, args)`` of ``jobs`` in turn, in this rank's process
    group: several jobs in one :func:`launch`."""
    return [fn(*args) for fn, args in jobs]


def info_job() -> dict:
    """This rank's view of its process group: what
    :func:`init_multihost` says (the group is already joined), the rank,
    the world size, the backend, the device and the loaded modules'
    top-level packages."""
    import sys

    return dict(multihost=init_multihost(), rank=dist.get_rank(),
                world_size=dist.get_world_size(),
                backend=dist.get_backend(), device=str(rank_device()),
                packages=sorted({m.split(".")[0] for m in sys.modules}))


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def bitwise_equal(results) -> bool:
    """Whether every rank's result (as :func:`launch` returns them with
    ``all_ranks``) holds the same bits."""
    def flat(x):
        if isinstance(x, np.ndarray):
            return [x]
        if isinstance(x, dict):
            return [a for k in sorted(x) for a in flat(x[k])]
        if isinstance(x, (tuple, list)):
            return [a for v in x for a in flat(v)]
        return [np.asarray(x)]

    first = flat(results[0])
    return all(len(f) == len(first) and all(
        a.shape == b.shape and a.dtype == b.dtype
        and a.tobytes() == b.tobytes() for a, b in zip(f, first))
        for f in map(flat, results[1:]))
