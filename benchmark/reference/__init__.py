"""The benchmark's plain reference: the configurations' models, their loss,
gradient clip and Adam, and their rollouts, in plain PyTorch and numpy.

It imports nothing of the program (``graphs4cfd_tpu_torch``) nor of the
JAX package, and takes nothing the program made: it builds its own graphs
from the raw clouds (``host.build``) and reads the weights the benchmark
made.  Samples are run in blocks (``Model.graphs``), each block joined into one
graph, so that a step's activations fit on the card once the program's
state is freed.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from . import host
from .nn import Numerics

B1, B2, EPS = 0.9, 0.999, 1e-8


def family(name: str):
    """The family module (``mus``, ``remus``) a configuration names."""
    return importlib.import_module(f"{__name__}.{name}")


class Model:
    """One configuration's reference: its family, arch and transforms,
    with weights ``W`` (a dict of tensors by the program's names)."""

    def __init__(self, config: dict, W: dict, precision: str = "f32"):
        self.fam = family(config["family"])
        self.arch = config["arch"]
        self.transforms = config["transforms"]
        self.W = W
        self.num = Numerics(precision)

    def graphs(self, raws, device, block: int = 0):
        """The raw clouds' graphs, in blocks of ``block`` samples (all in
        one when 0), each joined into one graph: the step's tensors and the
        block's fields and targets, on ``device``."""
        block = block or len(raws)
        built = [host.build(raw, self.transforms, device) for raw in raws]
        out = []
        for i in range(0, len(built), block):
            part = built[i:i + block]
            t = self.fam.tensors(part, device)
            for key in ("field", "target"):
                t[key] = torch.as_tensor(np.concatenate([g[key] for g in part]),
                                         device=device)
            out.append(t)
        return out

    def step(self, t: dict, field: torch.Tensor) -> torch.Tensor:
        return self.fam.step(self.W, self.arch, t, field, self.num)

    def rollout(self, t: dict, n_out: int) -> torch.Tensor:
        """``[V, nf * n_out]``: each step's fields fed back through the
        window."""
        field, preds = t["field"], []
        with torch.no_grad():
            for _ in range(n_out):
                pred = self.step(t, field)
                field = torch.cat([field[:, pred.shape[1]:], pred], dim=1)
                preds.append(pred)
        return torch.cat(preds, dim=1)


def train_steps(model: Model, blocks, n_steps: int, lr: float,
                lambda_d: float, clip: float):
    """``n_steps`` rollout steps of training on one batch, each one Adam
    step as the program's ``make_train_step`` takes it: the loss over the
    batch's nodes (mean squared error plus ``lambda_d`` times the mean L1
    error on the Dirichlet nodes), its gradient summed over the blocks of
    samples (``Model.graphs``), the global norm, the clip to ``clip``,
    Adam (0.9, 0.999, 1e-8, bias corrected), the prediction fed back.
    Returns ``(losses, the first step's gradients, the parameters
    after the last step)``, the latter two as dicts by name."""
    names = list(model.W)
    params = {n: model.W[n].detach().clone().requires_grad_(True)
              for n in names}
    model.W = params
    mu = {n: torch.zeros_like(p) for n, p in params.items()}
    nu = {n: torch.zeros_like(p) for n, p in params.items()}
    nodes = sum(t["field"].shape[0] for t in blocks)
    dirichlet = sum(int((t["omega"][:, 0] == 1).sum()) for t in blocks)
    fields = [t["field"] for t in blocks]
    losses, first_grads = [], None
    for step in range(n_steps):
        grads = {n: torch.zeros_like(p) for n, p in params.items()}
        total = 0.0
        for i, t in enumerate(blocks):
            pred = model.step(t, fields[i])
            nf = pred.shape[1]
            diff = pred - t["target"][:, step * nf:(step + 1) * nf]
            d = t["omega"][:, 0] == 1
            part = (torch.sum(diff * diff) / (nodes * nf) + lambda_d
                    * torch.sum(diff[d].abs()) / max(dirichlet * nf, 1))
            g = torch.autograd.grad(part, [params[n] for n in names],
                                    allow_unused=True)
            for n, gi in zip(names, g):
                if gi is not None:
                    grads[n] += gi
            total += float(part.detach())
            fields[i] = torch.cat([fields[i][:, nf:], pred.detach()], dim=1)
        losses.append(total)
        if first_grads is None:
            first_grads = {n: g.clone() for n, g in grads.items()}
        norm = float(torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g) for g in grads.values()])))
        scale = clip / norm if norm > clip else 1.0
        with torch.no_grad():
            for n, p in params.items():
                g = grads[n] * scale
                mu[n].mul_(B1).add_(g, alpha=1 - B1)
                nu[n].mul_(B2).addcmul_(g, g, value=1 - B2)
                m_hat = mu[n] / (1 - B1 ** (step + 1))
                v_hat = nu[n] / (1 - B2 ** (step + 1))
                p.sub_(lr * m_hat / (v_hat.sqrt() + EPS))
    return losses, first_grads, {n: p.detach() for n, p in params.items()}
