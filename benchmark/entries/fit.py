"""Training cells: ``graphs4cfd_tpu_torch.training.trainer.fit``.

Set-up: the traffic's pool of clouds through the program's transforms,
the model with the benchmark's weights, and one ``fit`` call over the
pool's first batch (``n_out`` rollout steps, one Adam step each), which
builds and warms every kernel and is what the reference follows: the
loss the program is given records each step's loss, hooks on the
parameters record the norm of each leaf's first gradient, and the
parameters are taken after ``check_steps`` steps.

The window: one ``fit`` call (one epoch of the traffic's ``TrainConfig``)
over a feed that draws batches from a shuffled ``DataLoader`` over the
pool until ``--seconds`` have passed, then a synchronise.  ``fit`` reads
its losses at the end of the epoch.  Counted over the window: batches,
valid level-1 edges x ``n_out``, the loader's time per batch, a CUDA
event each time ``fit`` asks for a batch, the kernel launches, and the
model's products.  ``--trace 1`` adds a profiled ``fit`` of
``trace_batches`` batches after the window.
"""
from __future__ import annotations

import contextlib
import shutil
import sys
import tempfile
import time

import numpy as np

from .. import compare, counts, data, harness, reference, weights
from .. import trace as tr
from . import common


class Probe:
    """The training loss that ``fit`` is given: the program's own loss,
    each step's value kept (a 0-d tensor; nothing waits).  With ``model``
    it also records, through hooks on the parameters, each leaf's
    gradient at the first step, and the parameters after ``follow``
    steps."""

    def __init__(self, loss, model=None, follow: int = 0):
        self.loss, self.model, self.follow = loss, model, follow
        self.values, self.calls = [], 0
        self.grads, self.after, self.hooks = {}, None, []
        if model is not None:
            for name, p in model.named_parameters():
                self.hooks.append(p.register_hook(self._hook(name)))

    def _hook(self, name):
        def hook(g):
            if self.calls == 1:
                self.grads[name] = g.detach().float().clone()
        return hook

    def _snapshot(self):
        self.after = {n: p.detach().clone()
                      for n, p in self.model.named_parameters()}

    def __call__(self, graph, pred, target):
        self.calls += 1
        if self.model is not None and self.calls == self.follow + 1:
            self._snapshot()
        out = self.loss(graph, pred, target)
        self.values.append(out.detach())
        return out

    def close(self):
        for h in self.hooks:
            h.remove()
        if self.model is not None and self.after is None:
            self._snapshot()


class Feed:
    """The batches ``fit`` trains on: a ``DataLoader``'s, pass after pass,
    until ``deadline`` (host clock) when ``fit`` asks for the next, or
    ``count`` batches.  Each ask records a mark on the device's timeline
    (``ctx.mark``); each batch's loader time, valid level-1 edges and
    sizes are kept."""

    def __init__(self, ctx, loader, deadline=None, count=None):
        self.ctx, self.loader = ctx, loader
        self.deadline, self.count = deadline, count
        self.marks, self.loader_s, self.sizes = [], [], []
        self.edges = 0

    def __iter__(self):
        from torch.autograd.profiler import record_function
        it = iter(self.loader)
        while True:
            self.marks.append(self.ctx.mark())
            if (self.count is not None and len(self.sizes) >= self.count) \
                    or (self.deadline is not None
                        and time.perf_counter() >= self.deadline):
                return
            t = time.perf_counter()
            with record_function("harness.next_batch"):
                batch = next(it, None)
                if batch is None:
                    it = iter(self.loader)
                    batch = next(it)
            self.loader_s.append(time.perf_counter() - t)
            sz = common.sizes(batch)
            self.sizes.append(sz)
            self.edges += sz["E1"]
            yield batch


def run(ctx) -> harness.Outcome:
    import torch
    from graphs4cfd_tpu_torch.loader import DataLoader
    from graphs4cfd_tpu_torch.training.trainer import fit
    cfg, trf = ctx.cell.config, ctx.cell.traffic
    B, n_out, prec = trf["batch"], trf["n_out"], trf["precision"]
    follow = min(trf["check_steps"], n_out)
    fam = counts.family(cfg["family"])
    raws = data.inputs(trf, cfg, ctx.seed)
    pool = common.program_graphs(raws, cfg)
    W = weights.make(cfg["arch"], ctx.seed, ctx.device)
    model = common.program_model(cfg, W, ctx.device, prec)
    folder = tempfile.mkdtemp(prefix="bench_fit_")
    quiet = contextlib.redirect_stdout(sys.stderr)
    train_config, loss = configs(trf, folder)
    try:
        checked = first_steps(model, pool[:B], train_config, loss(), follow,
                              ctx.sync)
        loader = DataLoader(pool, batch_size=B, shuffle=True,
                            seed=int(data.stream(ctx.seed, "order")
                                     .integers(2 ** 31)))
        window_loss = Probe(loss())
        ctx.reset_peak()
        launched = common.launches()
        t0 = time.perf_counter()
        feed = Feed(ctx, loader, deadline=t0 + ctx.seconds)
        with quiet:
            fit(model, train_config(window_loss), feed)
        ctx.sync()
        t1 = time.perf_counter()
        peak = ctx.peak_bytes()
        launched = common.launches() - launched
        window_s = t1 - t0
        steps = len(feed.sizes) * n_out
        flops = sum(counts.step_model_flops(fam, cfg["arch"], sz, True)
                    for sz in feed.sizes) * n_out
        losses = torch.stack(window_loss.values).float().cpu().numpy() \
            if window_loss.values else np.zeros(0)
        failed = int((~np.isfinite(losses.reshape(-1, n_out))).any(
            axis=1).sum()) if losses.size else 0
        out = harness.Outcome(
            values={"train_edges_per_s": feed.edges * n_out / window_s,
                    "peak_mem_gib": peak / 2 ** 30,
                    "setup_s": t0 - ctx.started},
            attempted=len(feed.sizes), failed=failed, numbers={},
            peak_bytes=peak,
            window={"seconds": window_s, "steps": steps,
                    "launches": launched, "model_flops": flops,
                    "loader_ms": [s * 1e3 for s in feed.loader_s],
                    "batch_ms": [ctx.between_ms(a, b) for a, b in
                                 zip(feed.marks[:-1], feed.marks[1:])],
                    "precision": prec, "kernel_names": common.kernel_names()})
        print(f"window: {len(feed.sizes)} batches, {steps} steps, "
              f"{window_s:.3f} s, peak {peak / 2 ** 30:.3f} GiB",
              file=sys.stderr)
        if ctx.trace:
            tfeed = Feed(ctx, loader, count=trf["trace_batches"])

            def traced():
                with quiet:
                    fit(model, train_config(Probe(loss())), tfeed)
            out.trace = tr.profile(traced, ctx.sync)
            out.traced = {
                "steps": len(tfeed.sizes) * n_out,
                "work_s": sum(counts.step_seconds(fam, cfg["arch"], sz, True,
                                                  prec)
                              for sz in tfeed.sizes) * n_out}
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    del model, pool, feed, loader
    harness.free_memory()
    out.numbers = check(ctx, raws[:B], W, checked, follow)
    return out


def configs(trf: dict, folder: str):
    """``(train_config(loss), loss())``: the traffic's ``TrainConfig`` for
    one epoch (no checkpoint: ``chk_interval`` above it, ``folder`` under
    ``TMPDIR``) and a new ``GraphLoss``."""
    from graphs4cfd_tpu_torch import nn as PN
    from graphs4cfd_tpu_torch.training.config import TrainConfig

    def train_config(loss):
        return TrainConfig(
            name="bench", folder=folder, chk_interval=10 ** 9,
            training_loss=loss, epochs=1, num_steps=[trf["n_out"]],
            lr=trf["lr"], grad_clip={"epoch": 0, "limit": trf["grad_clip"]},
            mixed_precision=trf["precision"] == "bf16")

    return train_config, lambda: PN.GraphLoss(lambda_d=trf["lambda_d"])


def first_steps(model, graphs, train_config, loss, follow, sync) -> dict:
    """The set-up's ``fit`` over one batch of ``graphs``: its first
    ``follow`` losses, each leaf's first gradient and the parameters after
    ``follow`` steps (on the host)."""
    from graphs4cfd_tpu_torch.loader import DataLoader
    from graphs4cfd_tpu_torch.training.trainer import fit
    probe = Probe(loss, model, follow)
    with contextlib.redirect_stdout(sys.stderr):
        fit(model, train_config(probe), DataLoader(graphs,
                                                   batch_size=len(graphs)))
    probe.close()
    sync()
    return {"losses": [float(v) for v in probe.values[:follow]],
            "grads": {k: v.cpu() for k, v in probe.grads.items()},
            "after": {k: v.cpu() for k, v in probe.after.items()}}


def reference_steps(ctx, raws, W, follow, precision="f32"):
    """The reference's ``follow`` steps on the batch ``raws``: ``(losses,
    first gradients, parameters after)``; ``precision`` makes the control,
    and a part of the checked batch a planted fault."""
    trf = ctx.cell.traffic
    ref = reference.Model(ctx.cell.config, dict(W), precision)
    blocks = ref.graphs(raws, ctx.device, trf["reference_block"])
    return reference.train_steps(ref, blocks, follow, trf["lr"],
                                 trf["lambda_d"], trf["grad_clip"])


def as_checked(steps) -> dict:
    """A reference run's outputs in the form of the program's, so that it
    can stand in the program's place."""
    losses, grads, after = steps
    return {"losses": losses, "grads": grads, "after": after}


def check(ctx, raws, W, checked, follow):
    """The compared numbers of the program's first steps (``checked``)
    against the reference's."""
    losses, grads, after = reference_steps(ctx, raws, W, follow)
    return compare.training_numbers(
        checked["losses"], losses, checked["grads"], grads, W,
        checked["after"], after)
