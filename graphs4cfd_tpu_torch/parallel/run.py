"""A rank's share of a parallel run, for ``spawn_ranks``.

    results = spawn_ranks(run_gp_tasks, world, "gloo", job)
    results = spawn_ranks(run_dp_tasks, world, "gloo", job)

``run_gp_tasks`` runs graph-parallel tasks of any family (below);
``run_dp_tasks`` runs data-parallel and DP x GP tasks and ``fit`` (its
docstring).

``run_gp_tasks(rank, world, job)`` builds the model, takes its part of
each partitioned graph and runs the job's tasks in order; it returns a
list with one result per task, in numpy, so that the parent can compare
the ranks' results with each other and with a single-device run.
``{"jobs": [job, ...]}`` runs each job in turn in the one spawn and
returns their results in a list.

``job``: ``{"family": "mus" (the default) | "remus" | "gmus", "arch":
arch dict, "params": the JAX package's numpy parameter tree (or "seed":
the seed of the model's own initialisation), "compute_dtype" (torch
dtype, f32 by default), "device":
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
* ``val`` (``lambda_d``, ``max_n_out``): ``make_gp_val_step``'s loss;
* ``fit``: as ``run_dp_tasks``' (below), on the default group of the
  ``world`` ranks (``TrainConfig(graph_devices=world)``).

``barrier_unless`` is a test helper: a rank that never reaches a
collective.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..graph import Graph
from ..loader import DataLoader, shard_of
from ..nn import GraphLoss, MuGSGNN, MuSGNN, REMuSGNN, params_from_jax
from ..training.config import TrainConfig
from ..training.trainer import adam_init
from .dp import (dp_loss_and_grads, make_dp_rollout, make_dp_train_step,
                 make_dp_val_step)
from .graph_parallel import (attach_gp_sorts, gp_loss_and_grads,
                             make_dp_gp_train_step, make_dp_gp_val_step,
                             make_gp_forward, make_gp_rollout,
                             make_gp_train_step, make_gp_val_step, part_of)
from .mesh import initialize_distributed, make_mesh

FAMILIES = {"mus": MuSGNN, "remus": REMuSGNN, "gmus": MuGSGNN}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _model_of(job: dict, device, seed=None):
    """The job's model: its family and arch, the JAX package's parameters
    if the job has them (else the seed's), its compute dtype."""
    model = FAMILIES[job.get("family", "mus")](
        arch=job["arch"], seed=job.get("seed", 0) if seed is None else seed,
        device=device, compute_dtype=job.get("compute_dtype", torch.float32))
    if "params" in job:
        model.load_state_dict(params_from_jax(job["params"]))
    return model


def run_gp_tasks(rank: int, world: int, job: dict):
    if "jobs" in job:
        return [run_gp_tasks(rank, world, j) for j in job["jobs"]]
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    model = _model_of(job, device)
    parts = {name: part_of(Graph(data), rank, device)
             for name, data in job["graphs"].items()}
    if "hook" in job:
        return job["hook"](rank, world, model, parts, job)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]
    nf = model.num_fields
    out = []
    for kind, name, kw in job["tasks"]:
        g = None if name is None else parts[name]
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
        elif kind == "fit":
            out.append(_fit_task(model, lambda seed: _model_of(
                job, device, seed), kw))
        else:
            raise ValueError(f"unknown task {kind!r}")
    return out


def run_dp_tasks(rank: int, world: int, job: dict):
    """One rank of a data-parallel (``graph_devices`` 1) or DP x GP run
    on a (``devices``, ``graph_devices``) ``make_mesh`` of the ``world``
    ranks; returns one result per task, in numpy.  A rank spawned with
    ``by_env`` joins the group here (``initialize_distributed``).

    ``job``: ``{"jobs": [job, ...]}`` runs each job in turn (each on a
    mesh of its own) and returns their results in a list; else
    ``{"family": "mus" | "remus" | "gmus", "arch", "params" (the
    JAX package's numpy tree) or "seed", "compute_dtype" (torch dtype, f32
    by default), "device", "devices", "graph_devices", "graphs": {name:
    the ``.data`` of a ``collate_sharded`` batch (DP) or of
    ``partition_batches(regroup_sharded(...))``'s graph (DP x GP)},
    "tasks": [(kind, graph name, {arguments})]}``, or ``"hook": fn`` in
    place of ``"tasks"`` (the rank returns ``fn(rank, world, model, parts,
    mesh, job)``).  A rank's graph is its shard, through the model's
    ``prepare_batch`` (DP), or its part of its shard's group with the GP
    host sorts (DP x GP).  Kinds, each from the job's parameters:

    * ``grads`` (``lambda_d``): ``(loss, {parameter name: gradient})`` of
      the first time step, the gradients reduced over the mesh;
    * ``train`` (``lambda_d``, ``n_out``, ``lr``, ``clip``, ``steps``):
      ``steps`` calls of the train step from a new Adam state;
      ``(losses, gradient norms, {parameter name: value after})``;
    * ``val`` (``lambda_d``, ``max_n_out``): the val step's loss;
    * ``rollout`` (``n_out``, DP only): this rank's rows of
      ``make_dp_rollout``;
    * ``fit`` (graph name ``None``; ``samples`` and ``val``: lists of
      sample ``.data``, ``loader``: ``DataLoader`` keywords, ``config``:
      ``TrainConfig`` keywords, ``folder``, ``resume_epochs``,
      ``resume_seed``): ``fit`` with a ``DataLoader`` over the samples,
      then a model built from ``resume_seed`` resumed from the checkpoint
      with ``epochs = resume_epochs`` over the same loaders; ``{"history",
      "files"`` (the folder's names after the first ``fit``), ``"resumed"``
      (the resumed run's history), ``"params"`` (after the resume)``}``,
      the histories without their times.  With ``"refuse": {config
      keywords}`` it first runs ``fit`` with those and records the
      exception it raises under ``"refused"`` (``None`` if none).
    """
    initialize_distributed()
    if "jobs" in job:
        return [run_dp_tasks(rank, world, j) for j in job["jobs"]]
    device = torch.device(job["device"])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    D, G = job["devices"], job.get("graph_devices", 1)
    mesh = make_mesh(D, G)
    new_model = lambda seed=None: _model_of(job, device, seed)
    model = new_model()

    def rank_graph(data):
        shard = shard_of(Graph(data), mesh.data_index)
        if G > 1:
            return part_of(attach_gp_sorts(shard), mesh.graph_index, device)
        return Graph.from_numpy(model.prepare_batch(shard), device)

    parts = {name: rank_graph(data) for name, data in job["graphs"].items()}
    if "hook" in job:
        return job["hook"](rank, world, model, parts, mesh, job)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    names = [n for n, _ in model.named_parameters()]
    nf = model.num_fields
    out = []
    for kind, name, kw in job["tasks"]:
        g = parts.get(name)
        model.load_state_dict(init)
        if kind == "grads":
            crit = GraphLoss(kw["lambda_d"])
            target = g.target[:, :nf]
            loss, _, grads = (
                gp_loss_and_grads(model, crit, g, target, mesh.graph_group,
                                  mesh.group) if G > 1
                else dp_loss_and_grads(model, crit, g, target))
            out.append((loss.item(), dict(zip(names, map(_numpy, grads)))))
        elif kind == "train":
            state = adam_init(model.parameters())
            crit = GraphLoss(kw["lambda_d"])
            step = (make_dp_gp_train_step(model, crit, mesh, kw["n_out"],
                                          kw["clip"]) if G > 1
                    else make_dp_train_step(model, crit, kw["n_out"],
                                            kw["clip"]))
            res = [step(state, g, kw["lr"]) for _ in range(kw["steps"])]
            out.append(([float(l) for l, _ in res],
                        [float(n) for _, n in res],
                        {n: _numpy(p) for n, p in model.named_parameters()}))
        elif kind == "val":
            crit = GraphLoss(kw["lambda_d"])
            val = (make_dp_gp_val_step(model, crit, mesh, kw["max_n_out"])
                   if G > 1 else make_dp_val_step(model, crit,
                                                  kw["max_n_out"]))
            out.append(float(val(g)))
        elif kind == "rollout":
            out.append(_numpy(make_dp_rollout(model, kw["n_out"])(g)))
        elif kind == "fit":
            out.append(_fit_task(model, new_model, kw))
        else:
            raise ValueError(f"unknown task {kind!r}")
    return out


def _fit_task(model, new_model, kw):
    samples, val = ([Graph(d) for d in kw[k]] for k in ("samples", "val"))
    train_loader = DataLoader(samples, **kw["loader"])
    val_loader = DataLoader(val, **{k: v for k, v in kw["loader"].items()
                                    if k not in ("shuffle", "seed")})
    out = {}
    if "refuse" in kw:
        try:
            model.fit(TrainConfig(folder=kw["folder"], **{
                **kw["config"], **kw["refuse"]}), train_loader, val_loader)
            out["refused"] = None
        except Exception as exc:
            out["refused"] = f"{type(exc).__name__}: {exc}"
    cfg = TrainConfig(folder=kw["folder"], **kw["config"])
    drop = lambda h: [{k: v for k, v in r.items()
                       if k not in ("seconds", "edges_per_s")} for r in h]
    out["history"] = drop(model.fit(cfg, train_loader, val_loader))
    out["files"] = sorted(os.listdir(kw["folder"]))
    resumed = new_model(kw["resume_seed"])
    cfg.checkpoint = os.path.join(kw["folder"], f"{cfg.name}.chk")
    cfg.epochs = kw["resume_epochs"]
    out["resumed"] = drop(resumed.fit(cfg, train_loader, val_loader))
    out["params"] = {n: _numpy(p) for n, p in resumed.named_parameters()}
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
