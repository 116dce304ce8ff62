"""Process groups (the counterpart of ``graphs4cfd_tpu/parallel/mesh.py``).

The JAX package lays its devices out as a ``Mesh`` and runs one program
over it; the port runs one process per rank and joins them in a
``torch.distributed`` process group.  ``init_process_group`` joins one
rank; ``spawn_ranks`` starts local ranks, runs a function on each and
returns what each returned, or fails, naming the rank, when a rank raises
or does not finish in time.

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
from typing import Callable, List, Optional

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


def _rank_main(fn, rank, world, backend, init_method, timeout, num_threads,
               args, results):
    try:
        if num_threads:
            torch.set_num_threads(num_threads)
        init_process_group(rank, world, backend, init_method, timeout)
        out = fn(rank, world, *args)
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        return
    dist.destroy_process_group()


def spawn_ranks(fn: Callable, world: int, backend: str, *args,
                timeout: float = 600.0,
                num_threads: Optional[int] = None) -> List:
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
    ``timeout`` seconds fails in its rank.

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
        fn, r, world, backend, init_method, timeout, num_threads, args,
        results)) for r in range(world)]
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
