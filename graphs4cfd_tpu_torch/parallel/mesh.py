"""Process groups (the counterpart of ``graphs4cfd_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` and runs one program
over it; the port runs one process per rank and joins them in a
``torch.distributed`` process group.  ``initialize_distributed`` joins a
rank from its environment (the JAX package's variables or a launcher's);
``init_process_group`` joins one rank explicitly; ``make_mesh`` lays the
ranks out as a (data, graph) mesh and makes each graph group;
``spawn_ranks`` starts local ranks, runs a function on each and returns
what each returned, or fails, naming the rank, when a rank raises or does
not finish in time.

The backend is always the caller's choice: ``"nccl"`` when every rank has
its own card, ``"gloo"`` on the CPU and for several ranks on one card
(NCCL refuses two ranks on one device).
"""
from __future__ import annotations

import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def init_process_group(rank: int, world: int, backend: str,
                       init_method: str, timeout: float = 300.0):
    """Join rank ``rank`` of ``world`` to the default process group over
    ``backend`` (``"nccl"`` or ``"gloo"``), meeting the other ranks at
    ``init_method`` (``"tcp://host:port"`` or ``"file:///path"``).  A
    collective that waits longer than ``timeout`` seconds fails.  Returns
    the group (``dist.group.WORLD``)."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    return dist.group.WORLD


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None,
                           backend: Optional[str] = None,
                           timeout: float = 1800.0) -> int:
    """Join this process to the default process group from its arguments
    or its environment (the counterpart of
    ``graphs4cfd_tpu/parallel/mesh.py:61``); returns the number of
    processes, 1 when nothing asks for more.

    Read in turn: the arguments; the JAX package's variables
    ``GRAPHS4CFD_COORDINATOR`` (``host:port``, or an ``init_method`` URL
    such as ``file:///path``), ``GRAPHS4CFD_NUM_PROCESSES`` and
    ``GRAPHS4CFD_PROCESS_ID``; then a launcher's ``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``torchrun``).  With
    none of them set it joins nothing.  ``backend`` is ``"nccl"`` unless
    given or set in ``GRAPHS4CFD_BACKEND`` (``"gloo"`` on the CPU or for
    ranks that share a card).  ``local_device_ids[0]``, else a launcher's
    ``LOCAL_RANK`` under NCCL, becomes this process's current card.  A
    process already in a group is left as it is."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get("GRAPHS4CFD_COORDINATOR"))
    if num_processes is None and "GRAPHS4CFD_NUM_PROCESSES" in env:
        num_processes = int(env["GRAPHS4CFD_NUM_PROCESSES"])
    if process_id is None and "GRAPHS4CFD_PROCESS_ID" in env:
        process_id = int(env["GRAPHS4CFD_PROCESS_ID"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
        if num_processes is None and "WORLD_SIZE" in env:
            num_processes = int(env["WORLD_SIZE"])
        if process_id is None and "RANK" in env:
            process_id = int(env["RANK"])
    if coordinator_address is None and num_processes is None:
        return 1
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError(
            f"initialize_distributed needs a coordinator, a process count "
            f"and a process id; got {coordinator_address!r}, "
            f"{num_processes!r}, {process_id!r}")
    backend = backend or env.get("GRAPHS4CFD_BACKEND", "nccl")
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    elif backend == "nccl" and "LOCAL_RANK" in env:
        torch.cuda.set_device(int(env["LOCAL_RANK"]))
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    init_process_group(process_id, num_processes, backend, init_method,
                       timeout)
    return num_processes


@dataclass
class Mesh:
    """One rank's place in a (data, graph) mesh of the default group:
    ranks laid out row-major, so rank ``r`` has data index
    ``r // num_graph`` and graph index ``r % num_graph``, and a graph
    group is ``num_graph`` consecutive ranks.  ``graph_group`` is this
    rank's graph group (the halo exchange runs over it); ``group`` is the
    whole mesh (the loss and the gradient sums run over it)."""
    num_data: int
    num_graph: int
    rank: int
    graph_group: object
    group: object

    @property
    def shape(self) -> dict:
        return {"data": self.num_data, "graph": self.num_graph}

    @property
    def data_index(self) -> int:
        return self.rank // self.num_graph

    @property
    def graph_index(self) -> int:
        return self.rank % self.num_graph


def make_mesh(num_data: Optional[int] = None, num_graph: int = 1) -> Mesh:
    """Lay the ranks of the default process group out as a (data, graph)
    mesh (the counterpart of ``graphs4cfd_tpu/parallel/mesh.py:19``):
    ``num_data`` defaults to the world size over ``num_graph``, and
    ``num_data * num_graph`` must be the world size.  Every rank must call
    it, in the same order as its other group creations: each graph group
    is made by every rank (``dist.new_group``)."""
    world = dist.get_world_size()
    if num_data is None:
        num_data = world // num_graph
    if num_data * num_graph != world:
        raise ValueError(f"mesh {num_data}x{num_graph} does not match the "
                         f"{world} ranks of the process group")
    rank = dist.get_rank()
    mine = None
    for d in range(num_data):
        ranks = list(range(d * num_graph, (d + 1) * num_graph))
        group = dist.new_group(ranks)
        if rank in ranks:
            mine = group
    return Mesh(num_data, num_graph, rank, mine, dist.group.WORLD)


def make_hybrid_mesh(dcn_data: int, ici_data: int = 1,
                     ici_graph: int = 1) -> Mesh:
    """The JAX package's multi-slice mesh
    (``graphs4cfd_tpu/parallel/mesh.py:31``) on one set of ranks: a
    (``dcn_data * ici_data``, ``ici_graph``) ``make_mesh``, as the JAX
    package lays it out on one slice (graph groups stay consecutive
    ranks)."""
    return make_mesh(num_data=dcn_data * ici_data, num_graph=ici_graph)


def _rank_main(fn, rank, world, backend, init_method, timeout, num_threads,
               by_env, args, results):
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        if by_env:
            os.environ.update({
                "GRAPHS4CFD_COORDINATOR": init_method,
                "GRAPHS4CFD_NUM_PROCESSES": str(world),
                "GRAPHS4CFD_PROCESS_ID": str(rank),
                "GRAPHS4CFD_BACKEND": backend})
        else:
            init_process_group(rank, world, backend, init_method, timeout)
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, backend: str, *args,
                timeout: float = 600.0,
                num_threads: Optional[int] = None,
                by_env: bool = False) -> List:
    """Run ``fn(rank, world, *args)`` in ``world`` new local processes
    joined in one process group over ``backend``; returns their results in
    rank order.

    The processes start from ``torch.multiprocessing``'s ``spawn`` context
    (so ``fn`` and ``args`` must pickle: a module-level function, numpy
    arrays) and meet through a file store in a new temporary directory,
    which no other run shares.  Build the CUDA kernels first
    (``ops._build.load()``) when the ranks use them, or they race to build
    the same library.  ``num_threads`` sets each rank's
    ``torch.set_num_threads``.  A collective that waits longer than
    ``timeout`` seconds fails in its rank.  With ``by_env`` a rank joins
    no group before ``fn`` runs: it finds the ``GRAPHS4CFD_*`` variables
    of ``initialize_distributed`` in its environment, as under a
    launcher, and ``fn`` joins the group itself.

    Raises ``RuntimeError`` naming the ranks as soon as one raises (with
    its traceback), or when ``timeout`` seconds pass before every rank has
    returned (a rank that hangs, for example in a collective that another
    rank never reaches); every process is killed before it returns or
    raises."""
    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="g4c_ranks_")
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        fn, r, world, backend, init_method, timeout, num_threads, by_env,
        args, results)) for r in range(world)]
    done, errors = {}, {}
    start = time.monotonic()
    try:
        for p in procs:
            p.start()
        while len(done) < world and not errors:
            left = start + timeout - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0) and r not in done:
                        errors[r] = (f"exited with code {p.exitcode} "
                                     f"without a result")
                continue
            (done if ok else errors)[rank] = value
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    waiting = [r for r in range(world) if r not in done and r not in errors]
    if errors:
        raise RuntimeError(
            "spawn_ranks: " + (f"ranks {waiting} had not finished; "
                               if waiting else "")
            + "; ".join(f"rank {r} failed: {msg}"
                        for r, msg in sorted(errors.items())))
    if waiting:
        raise RuntimeError(f"spawn_ranks: ranks {waiting} did not finish "
                           f"within {timeout} s")
    return [done[r] for r in range(world)]
