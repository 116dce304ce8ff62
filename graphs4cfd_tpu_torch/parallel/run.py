"""A rank's share of a partitioned MuS-GNN run, for ``spawn_ranks``.

    results = spawn_ranks(run_gp_tasks, world, "gloo", job)

``run_gp_tasks(rank, world, job)`` builds the model, takes its part of
each partitioned graph and runs the job's tasks in order; it returns a
list with one result per task, in numpy, so that the parent can compare
the ranks' results with each other and with a single-device run.

``job``: ``{"arch": arch dict, "params": the JAX package's numpy parameter
tree (or "seed": the seed of ``MuSGNN``'s own initialisation), "device":
"cpu" or "cuda:0", "graphs": {name: partitioned graph (the ``.data`` of
``partition_graph``'s output, with ``attach_gp_sorts``)}, "tasks":
[(kind, graph name, {arguments}), ...]}``.  With ``"hook": fn`` instead
of ``"tasks"``, the rank returns ``fn(rank, world, model, parts, job)``
(``parts``: {name: the rank's ``Graph``}): a module-level function of the
caller's that times, tallies or profiles what it runs.  Kinds:

* ``forward``: the rank's rows of one time step;
* ``rollout`` (``n_out``): the rank's rows of ``make_gp_rollout``;
* ``loss`` (``lambda_d``, ``pred``, ``target``: ``[P, V_local, nf]``
  arrays in part order): ``GraphLoss(lambda_d).distributed`` of the
  rank's rows;
* ``grads`` (``lambda_d``): ``(loss, {parameter name: gradient})`` of the
  first time step, the gradients summed over the ranks;
* ``train`` (``lambda_d``, ``n_out``, ``lr``, ``clip``, ``steps``): from
  the job's parameters and a new Adam state, ``steps`` calls of
  ``make_gp_train_step``; ``(losses, gradient norms, {parameter name:
  value after})``;
* ``val`` (``lambda_d``, ``max_n_out``): ``make_gp_val_step``'s loss.

``barrier_unless`` is a test helper: a rank that never reaches a
collective.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from ..graph import Graph
from ..nn import GraphLoss, MuSGNN, params_from_jax
from ..training.trainer import adam_init
from .graph_parallel import (gp_loss_and_grads, make_gp_forward,
                             make_gp_rollout, make_gp_train_step,
                             make_gp_val_step, part_of)


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def run_gp_tasks(rank: int, world: int, job: dict):
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    model = MuSGNN(arch=job["arch"], seed=job.get("seed", 0), device=device)
    if "params" in job:
        model.load_state_dict(params_from_jax(job["params"]))
    parts = {name: part_of(Graph(data), rank, device)
             for name, data in job["graphs"].items()}
    if "hook" in job:
        return job["hook"](rank, world, model, parts, job)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]
    nf = model.num_fields
    out = []
    for kind, name, kw in job["tasks"]:
        g = parts[name]
        if kind == "forward":
            with torch.no_grad():
                out.append(_numpy(make_gp_forward(model)(g)))
        elif kind == "rollout":
            out.append(_numpy(make_gp_rollout(model, kw["n_out"])(g)))
        elif kind == "loss":
            pred, target = (torch.from_numpy(np.ascontiguousarray(
                kw[k][rank])).to(device) for k in ("pred", "target"))
            with torch.no_grad():
                out.append(float(GraphLoss(kw["lambda_d"]).distributed(
                    g, pred, target)))
        elif kind == "grads":
            loss, _, grads = gp_loss_and_grads(
                model, GraphLoss(kw["lambda_d"]), g, g.target[:, :nf])
            out.append((loss.item(), dict(zip(names, map(_numpy, grads)))))
        elif kind == "train":
            model.load_state_dict(init)
            state = adam_init(model.parameters())
            step = make_gp_train_step(model, GraphLoss(kw["lambda_d"]),
                                      kw["n_out"], kw["clip"])
            res = [step(state, g, kw["lr"]) for _ in range(kw["steps"])]
            out.append(([float(l) for l, _ in res],
                        [float(n) for _, n in res],
                        {n: _numpy(p) for n, p in model.named_parameters()}))
            model.load_state_dict(init)
        elif kind == "val":
            out.append(float(make_gp_val_step(
                model, GraphLoss(kw["lambda_d"]), kw["max_n_out"])(g)))
        else:
            raise ValueError(f"unknown task {kind!r}")
    return out


def barrier_unless(rank: int, world: int, absent: int, seconds: float):
    """A test helper: every rank but ``absent`` waits at a barrier, which
    ``absent`` never reaches (it sleeps ``seconds``): a rank that hangs,
    for checking that ``spawn_ranks`` names it within its time limit."""
    if rank == absent:
        time.sleep(seconds)
    else:
        dist.barrier()
    return rank
