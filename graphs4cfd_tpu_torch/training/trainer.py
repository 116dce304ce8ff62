"""The training step and ``fit`` (port of
``graphs4cfd_tpu/training/trainer.py``).

Semantics of the JAX package's ``make_train_step``, which follow the
reference's ``GNN.fit``:

* one Adam update per rollout step ``t``, not per batch;
* the gradient norm is taken before the clip; the global clip scales the
  gradients by ``limit / max(norm, 1e-12)`` when ``clip_on`` and the norm
  is above the limit;
* the prediction is fed back detached.

Adam is ``optax.scale_by_adam()`` followed by ``-lr * u``: b1 0.9, b2
0.999, eps 1e-8 outside the square root, eps_root 0, and a bias
correction that counts the rollout steps taken.  The model's parameters
and the Adam state are updated in place (the JAX step returns new ones).

``fit`` is the JAX package's epoch loop, on one device or on the ranks
of a process group (see its docstring).
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..graph import Graph
from ..nn.model import (grad_norm2, params_from_jax, params_to_numpy,
                        tree_leaves)
from ..ops import launch_counts
from ..utils.profiling import trace_annotation

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass
class AdamState:
    """``optax.ScaleByAdamState``: the steps taken and the first and
    second moments, one tensor per parameter in ``model.parameters()``
    order."""
    count: int
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]

    def clone(self) -> "AdamState":
        return AdamState(self.count, [m.clone() for m in self.mu],
                         [n.clone() for n in self.nu])


def adam_init(params) -> AdamState:
    params = list(params)
    return AdamState(0, [torch.zeros_like(p) for p in params],
                     [torch.zeros_like(p) for p in params])


def adam_state_from_jax(model, count, mu: dict, nu: dict) -> AdamState:
    """The JAX package's Adam state (``count`` and the ``mu``/``nu``
    parameter trees, as numpy) as an ``AdamState`` of ``model``."""
    names = [n for n, _ in model.named_parameters()]
    dev = next(model.parameters()).device
    mu_s, nu_s = params_from_jax(mu), params_from_jax(nu)
    return AdamState(int(np.asarray(count)),
                     [mu_s[n].to(dev) for n in names],
                     [nu_s[n].to(dev) for n in names])


def adam_update_(params, grads, state: AdamState, lr: float) -> None:
    """One Adam step in place: moments, bias correction (in f32, as optax
    computes it), ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)``."""
    state.count += 1
    torch._foreach_mul_(state.mu, B1)
    torch._foreach_add_(state.mu, grads, alpha=1 - B1)
    torch._foreach_mul_(state.nu, B2)
    torch._foreach_addcmul_(state.nu, grads, grads, value=1 - B2)
    bc1 = float(1 - np.float32(B1) ** np.float32(state.count))
    bc2 = float(1 - np.float32(B2) ** np.float32(state.count))
    denom = torch._foreach_div(state.nu, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, EPS)
    upd = torch._foreach_div(state.mu, bc1)
    torch._foreach_div_(upd, denom)
    with torch.no_grad():
        torch._foreach_add_(params, upd, alpha=-lr)


def clip_and_update_(params, grads, state: AdamState, lr: float,
                     grad_clip_limit: Optional[float],
                     clip_on: bool) -> torch.Tensor:
    """The gradient norm, then the global clip (``grads`` scaled in place
    by ``limit / max(norm, 1e-12)`` when ``clip_on`` and the norm is above
    the limit), then one Adam step on ``params``.  Returns the norm taken
    before the clip."""
    gnorm = grad_norm2(grads)
    if grad_clip_limit is not None and clip_on:
        scale = torch.where(gnorm > grad_clip_limit,
                            grad_clip_limit / gnorm.clamp_min(1e-12),
                            torch.ones_like(gnorm))
        torch._foreach_mul_(grads, scale)
    adam_update_(params, grads, state, lr)
    return gnorm


def make_train_step(model, criterion, num_fields: int, n_out: int,
                    grad_clip_limit: Optional[float]):
    """``train_step(state, graph, lr, clip_on=True) -> (mean loss, mean
    gradient norm)`` over ``n_out`` rollout steps; updates the model's
    parameters and ``state`` in place.  The two results are 0-d tensors
    on the model's device (nothing waits for the device)."""
    params = list(model.parameters())

    def train_step(state: AdamState, graph, lr: float, clip_on: bool = True):
        target = graph.target
        field = graph.field
        losses, gnorms = [], []
        for t in range(n_out):
            g = graph.replace(field=field)
            pred = model(g)
            loss = criterion(g, pred, target[:, t * num_fields:
                                             (t + 1) * num_fields])
            grads = list(torch.autograd.grad(loss, params))
            gnorm = clip_and_update_(params, grads, state, lr,
                                     grad_clip_limit, clip_on)
            field = torch.cat([field[:, num_fields:], pred.detach()], dim=1)
            losses.append(loss.detach())
            gnorms.append(gnorm)
        return torch.stack(losses).mean(), torch.stack(gnorms).mean()

    return train_step


def make_val_step(model, criterion, num_fields: int, max_n_out: int):
    """``val_step(graph) -> mean loss`` of a ``max_n_out``-step rollout,
    under ``torch.no_grad``."""

    @torch.no_grad()
    def val_step(graph):
        target = graph.target
        field = graph.field
        losses = []
        for t in range(max_n_out):
            g = graph.replace(field=field)
            pred = model(g)
            losses.append(criterion(g, pred, target[:, t * num_fields:
                                                    (t + 1) * num_fields]))
            field = torch.cat([field[:, num_fields:], pred], dim=1)
        return torch.stack(losses).mean()

    return val_step


def _check_resume(model, state: dict, path: str) -> None:
    """The checkpoint's arch dict, then its parameter shapes, against the
    model's, with the JAX ``fit``'s messages."""
    chk_arch = state.get("arch")
    if chk_arch is not None and dict(chk_arch) != dict(model.arch):
        diff_keys = [k for k in (set(chk_arch) | set(model.arch))
                     if chk_arch.get(k) != model.arch.get(k)]
        raise ValueError(
            f"checkpoint {path!r} does not match this "
            f"model's architecture — written by a different arch dict "
            f"(mismatched entries: {sorted(diff_keys)[:5]}); resume it "
            f"with the matching model class/arch")
    chk_shapes = [np.shape(x) for x in tree_leaves(state["weights"])]
    own_shapes = [x.shape for x in tree_leaves(params_to_numpy(model))]
    if chk_shapes != own_shapes:
        if len(chk_shapes) != len(own_shapes):
            first_mismatch = (f"leaf count {len(chk_shapes)} vs "
                              f"{len(own_shapes)}")
        else:
            first_mismatch = next((a, b) for a, b in
                                  zip(chk_shapes, own_shapes) if a != b)
        raise ValueError(
            f"checkpoint {path!r} does not match this "
            f"model's architecture: {len(chk_shapes)} saved arrays "
            f"vs {len(own_shapes)} parameters (first mismatch: "
            f"{first_mismatch}) — was it written by a different arch "
            f"dict?")


def _mean(values: List[torch.Tensor]) -> float:
    """The mean of 0-d device tensors, read in one transfer and summed in
    Python in their order: the number the JAX loop's ``float()`` per
    batch gives."""
    total = 0.0
    for v in (torch.stack(values).tolist() if values else []):
        total += v
    return total / max(len(values), 1)


def _parallel(model, cfg):
    """The mesh ``TrainConfig(devices, graph_devices)`` asks for, or None
    for one device; raises before anything is trained when the default
    process group does not have ``devices * graph_devices`` ranks, or
    when ``graph_devices > 1`` asks for a model that graph parallelism
    does not run (one of no family of the port's)."""
    dp = int(cfg["devices"] or 1)
    gpd = int(cfg["graph_devices"] or 1)
    if gpd > 1:
        from ..parallel.graph_parallel import gp_apply_fn
        gp_apply_fn(model)
    if dp * gpd == 1:
        return None
    have = (dist.get_world_size() if dist.is_available()
            and dist.is_initialized() else None)
    if have != dp * gpd:
        raise RuntimeError(
            f"TrainConfig(devices={dp}, graph_devices={gpd}) trains on "
            f"{dp * gpd} ranks, each calling fit, but the default process "
            f"group has " + (f"{have}" if have else "not been initialised")
            + " (parallel.initialize_distributed, or parallel.spawn_ranks "
            "for local ranks)")
    from ..parallel.mesh import make_mesh
    return make_mesh(dp, gpd)


def fit(model, train_config, train_loader, val_loader=None) -> list:
    """Train ``model`` with the semantics of the JAX package's ``fit``
    (``graphs4cfd_tpu/training/trainer.py:113-412``) on the device of the
    model's parameters:

    * resume from ``checkpoint``: the arch dict and the parameter shapes
      are checked, then the weights, the Adam state, ``lr``, the scheduler
      state, the curriculum position and ``epoch + 1`` are restored;
    * an existing ``<folder>/<name>.chk`` is renamed to ``.chk.bck``;
    * the rollout curriculum ``num_steps`` advances when the ``add_steps``
      loss is below its tolerance, and then Adam and the scheduler start
      again at the base ``lr``;
    * the gradient clip applies from the epoch after ``grad_clip["epoch"]``;
    * ``ReduceLROnPlateau`` on the training or validation loss; a
      checkpoint every ``chk_interval`` epochs; the lr floor ``stopping``
      saves and stops; a non-finite training loss saves
      ``<path>.nan_epoch{n}`` and stops;
    * ``devices`` / ``graph_devices`` above 1: data parallelism, graph
      parallelism or both (``trainer.py:225-295``) on a (devices,
      graph_devices) ``parallel.make_mesh`` of the default process group,
      whose every rank calls ``fit`` with the same model, config and
      loaders.  The loaders yield ``collate_sharded`` batches
      (``num_shards = devices``); each rank builds every batch and keeps
      its shard (``loader.shard_of``), its part (``partition_graph``) or
      its part of its shard's group (``partition_batches``).  Rank 0's
      parameters are broadcast first; the loss and gradients are those of
      the whole batch on every rank, so every decision reads the same
      bits.  Rank 0 alone renames, saves and writes the metrics, and the
      ranks wait for it.

    Each host batch goes through ``model.prepare_batch`` (the host sorts
    its backward walks), then to the device, inside a ``host_to_device``
    range; each training step runs inside a ``train_step`` range
    (``utils.profiling.trace_annotation``, recorded by a ``start_trace``
    session).  The steps' losses and gradient norms are read once, after
    the epoch, so on a card a ``train_step`` range ends when the host has
    enqueued the step, not when the card has run it.  ``mixed_precision``
    sets ``model.compute_dtype = torch.bfloat16``.  Returns
    one record per epoch trained: ``{"epoch", "n_out", "lr",
    "train_loss", "grad_norm", "val_loss", "edges_per_s", "seconds",
    "steps"}`` (the first also ``"launches"``, the kernel launches of its
    training steps).
    """
    from .. import parallel as par
    from ..loader import shard_of
    from .checkpoint import adam_state_from_checkpoint, load_checkpoint
    from .metrics_writer import MetricsWriter
    from .schedule import ReduceLROnPlateau
    cfg = train_config
    device = next(model.parameters()).device
    if cfg["device"] is not None and torch.device(cfg["device"]).type \
            != device.type:
        raise ValueError(f"TrainConfig(device={cfg['device']!r}), but the "
                         f"model's parameters are on {device}")
    mesh = _parallel(model, cfg)
    dp, gpd = (1, 1) if mesh is None else (mesh.num_data, mesh.num_graph)
    rank0 = mesh is None or mesh.rank == 0
    say = print if rank0 else (lambda *args: None)

    def on_rank0(fn):
        """``fn`` on rank 0 alone; every rank waits for it."""
        if rank0:
            fn()
        if mesh is not None:
            dist.barrier()

    criterion = cfg["training_loss"]
    num_steps_list = cfg["num_steps"]
    max_n_out = num_steps_list[-1]
    num_steps = iter(num_steps_list)
    n_out = next(num_steps)

    def new_scheduler():
        if cfg["scheduler"] is None:
            return None
        return ReduceLROnPlateau(lr, cfg["scheduler"]["factor"],
                                 cfg["scheduler"]["patience"])

    opt_state = adam_init(model.parameters())
    lr = cfg["lr"]
    scheduler = new_scheduler()
    initial_epoch = 1

    state = None
    if cfg["checkpoint"] is not None and os.path.exists(cfg["checkpoint"]):
        state = load_checkpoint(cfg["checkpoint"])
    if state is not None:
        say("Training from an existing check-point:", cfg["checkpoint"])
        _check_resume(model, state, cfg["checkpoint"])
        model.load_state_dict(params_from_jax(state["weights"]))
        opt_state = adam_state_from_checkpoint(model, state) or opt_state
        lr = state.get("lr", lr)
        if scheduler is not None and "scheduler" in state:
            scheduler.load_state_dict(state["scheduler"])
            lr = scheduler.lr
        if state["n_out"] > max_n_out:
            raise ValueError(
                f"checkpoint {cfg['checkpoint']!r} was saved at curriculum "
                f"position n_out={state['n_out']}, beyond this run's "
                f"num_steps={num_steps_list} — extend num_steps to cover "
                f"the checkpoint's position")
        while n_out < state["n_out"]:
            n_out = next(num_steps)
        initial_epoch = state["epoch"] + 1
    else:
        if cfg["checkpoint"] is not None:
            say("Not matching check-point file:", cfg["checkpoint"])
        say("Training from randomly initialised weights")
    if mesh is not None:
        # every rank has read the checkpoint before rank 0 renames it
        dist.barrier()
        params = list(model.parameters())
        flat = torch.cat([p.detach().reshape(-1) for p in params])
        dist.broadcast(flat, 0)
        with torch.no_grad():
            for p, x in zip(params, flat.split([p.numel() for p in params])):
                p.copy_(x.view_as(p))

    path = os.path.join(cfg["folder"], cfg["name"] + ".chk")

    def rename():
        if os.path.exists(path):
            print("Renaming", path, "to:", path + ".bck")
            os.rename(path, path + ".bck")
    on_rank0(rename)

    writer = MetricsWriter(
        os.path.join(cfg["tensor_board"], cfg["name"])
        if cfg["tensor_board"] is not None and rank0 else None)
    if cfg["mixed_precision"]:
        # the JAX fit's bf16 policy (trainer.py:217-220): bf16 activations
        # and products; parameters, Adam state and checkpoints stay f32
        say("Training with bf16 matmul compute")
        model.compute_dtype = torch.bfloat16
    clip_limit = (cfg["grad_clip"]["limit"]
                  if cfg["grad_clip"] is not None else None)
    if mesh is not None:
        say(f"Training on mesh {mesh.shape}")
    if dp > 1:
        for loader in (train_loader, val_loader):
            if loader is not None and hasattr(loader, "num_shards"):
                loader.num_shards = dp
    step_cache = {}

    def get_step(n):
        if n not in step_cache:
            if dp > 1 and gpd > 1:
                step = par.make_dp_gp_train_step(model, criterion, mesh, n,
                                                 clip_limit)
            elif dp > 1:
                step = par.make_dp_train_step(model, criterion, n,
                                              clip_limit)
            elif gpd > 1:
                step = par.make_gp_train_step(model, criterion, n,
                                              clip_limit)
            else:
                step = make_train_step(model, criterion, model.num_fields,
                                       n, clip_limit)
            step_cache[n] = step
        return step_cache[n]

    val_step = None
    if val_loader is not None:
        val_criterion = cfg["validation_loss"] or criterion
        if dp > 1 and gpd > 1:
            val_step = par.make_dp_gp_val_step(model, val_criterion, mesh,
                                               max_n_out)
        elif dp > 1:
            val_step = par.make_dp_val_step(model, val_criterion, max_n_out)
        elif gpd > 1:
            val_step = par.make_gp_val_step(model, val_criterion, max_n_out)
        else:
            val_step = make_val_step(model, val_criterion, model.num_fields,
                                     max_n_out)

    def prepare(batch, train=True):
        """The host batch as this rank's ``Graph`` on the device: the
        whole batch, its shard (DP), its part (GP) or its part of its
        shard's group (DP x GP), with the host sorts the backward walks
        (training)."""
        if gpd > 1:
            if dp > 1:
                sharded = par.partition_batches(
                    par.regroup_sharded(batch, dp), gpd)[0]
                sharded = shard_of(sharded, mesh.data_index)
            else:
                sharded = par.partition_graph(batch, gpd)[0]
            return par.part_of(par.attach_gp_sorts(sharded),
                               mesh.graph_index, device)
        if dp > 1:
            batch = shard_of(batch, mesh.data_index)
        return Graph.from_numpy(model.prepare_batch(batch) if train
                                else batch, device)

    say(f"Number of trainable parameters: {model.num_params}")
    sched_state = scheduler.state_dict() if scheduler else None

    def save_state(epoch, file_name=path):
        on_rank0(lambda: model.save_checkpoint(
            file_name, n_out, epoch, opt_state=opt_state, lr=lr,
            scheduler_state=sched_state))

    history = []
    try:
        for epoch in range(initial_epoch, cfg["epochs"] + 1):
            if lr < cfg["stopping"]:
                say(f"The learning rate is smaller than {cfg['stopping']}."
                    " Stopping training.")
                save_state(epoch)
                break
            say(f"Hyperparameters: n_out = {n_out}, lr = {lr}")
            train_step = get_step(n_out)
            clip_on = (cfg["grad_clip"] is not None
                       and epoch > cfg["grad_clip"]["epoch"])
            losses, gnorms = [], []
            edges = 0
            before = launch_counts()
            t0 = time.perf_counter()
            for batch in train_loader:
                em = batch.get("edge_mask")
                edges += (int(np.asarray(em).sum()) if em is not None
                          else batch.num_edges) * n_out
                with trace_annotation("host_to_device"):
                    graph = prepare(batch)
                with trace_annotation("train_step"):
                    loss, gnorm = train_step(opt_state, graph, lr, clip_on)
                losses.append(loss)
                gnorms.append(gnorm)
            training_loss = _mean(losses)
            gradients_norm = _mean(gnorms)
            dt = time.perf_counter() - t0
            record = {"epoch": epoch, "n_out": n_out, "lr": lr,
                      "train_loss": training_loss,
                      "grad_norm": gradients_norm, "val_loss": None,
                      "edges_per_s": edges / dt if dt > 0 else 0.0,
                      "seconds": dt, "steps": len(losses)}
            if epoch == initial_epoch:
                after = launch_counts()
                record["launches"] = {k: after[k] - before[k]
                                      for k in after}
                say(f"Kernel launches: {record['launches']}")
            history.append(record)
            if not (training_loss == training_loss
                    and abs(training_loss) != float("inf")):
                post = path + f".nan_epoch{epoch}"
                say(f"Non-finite training loss at epoch {epoch}; saving "
                    f"post-mortem checkpoint to {post} and stopping.")
                save_state(epoch, post)
                break
            say(f"Epoch: {epoch:4d}, Training   loss: "
                f"{training_loss:.4e}, Gradients: {gradients_norm:.4e}, "
                f"edges/s: {record['edges_per_s']:.3e}")

            validation_loss = None
            if val_loader is not None:
                validation_loss = _mean(
                    [val_step(prepare(b, train=False)) for b in val_loader])
                record["val_loss"] = validation_loss
                say(f"Epoch: {epoch:4d}, Validation loss: "
                    f"{validation_loss:.4e}")

            def write_metrics():
                writer.add_scalar("Loss/train", training_loss, epoch)
                if validation_loss is not None:
                    writer.add_scalar("Loss/test", validation_loss, epoch)
                writer.add_scalar("lr", lr, epoch)
                writer.add_scalar("edges_per_s", record["edges_per_s"],
                                  epoch)
            on_rank0(write_metrics)

            if scheduler is not None:
                sched_loss = (training_loss
                              if cfg["scheduler"]["loss"][:2] == "tr"
                              else validation_loss)
                lr = scheduler.step(sched_loss)
                sched_state = scheduler.state_dict()

            if not epoch % cfg["chk_interval"]:
                save_state(epoch)

            if cfg["add_steps"]["loss"][:2] == "tr":
                tolerance_loss = training_loss
            elif cfg["add_steps"]["loss"][:3] == "val":
                tolerance_loss = validation_loss
            else:
                raise NameError(
                    "Invalid parameter config['add_steps']['loss'].")
            if (tolerance_loss < cfg["add_steps"]["tolerance"]
                    and n_out < max_n_out):
                n_out = next(num_steps)
                opt_state = adam_init(model.parameters())
                lr = cfg["lr"]
                scheduler = new_scheduler()
                sched_state = scheduler.state_dict() if scheduler else None
    finally:
        writer.close()
    say("Finished training")
    return history
