"""The training step (port of ``graphs4cfd_tpu/training/trainer.py:47-111``).

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
``fit``, its schedule and checkpoint saving come with the runtime slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..nn.model import grad_norm2, params_from_jax

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
            gnorm = grad_norm2(grads)
            if grad_clip_limit is not None and clip_on:
                scale = torch.where(
                    gnorm > grad_clip_limit,
                    grad_clip_limit / gnorm.clamp_min(1e-12),
                    torch.ones_like(gnorm))
                torch._foreach_mul_(grads, scale)
            adam_update_(params, grads, state, lr)
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
