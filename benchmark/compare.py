"""The numbers that decide ``correct``: the program's outputs against the
plain reference's.

Training (``training_numbers``), over the steps the reference follows:

* ``loss_gap``: the largest relative gap of a step's loss;
* ``grad_gap``: the first gradient, by the worst leaf: the gap between the
  program's norm of a leaf's gradient and the reference's, over the
  larger of the reference's norm of that leaf and of the median leaf;
* ``update_gap``: the parameters' change over the steps, by the worst
  leaf in the same way; leaves whose reference gradient is under a
  thousandth of the median leaf's are left out (they move by round-off
  alone under Adam);
* ``grad_cos_gap_median``: the first gradient's direction, by the median
  leaf: 1 - the cosine between the program's gradient of a leaf and the
  reference's (leaves left out as in ``update_gap``); steady from seed to
  seed where the worst leaf's gaps are not (a leaf whose gradient is a
  sum of residuals, such as the decoder's last bias, can even turn over);
* ``grad_gap_median``, ``update_gap_median``: the median leaf's gap of
  each.

Rollouts (``rollout_numbers``), over the requests checked:

* ``rollout_gap``: the largest relative L2 gap of one time step's fields
  over the request's nodes;
* ``rollout_gap_first``: the same of the first step alone.
"""
from __future__ import annotations

import torch

#: leaves whose first reference gradient is under this share of the
#: median leaf's are left out of ``update_gap``
QUIET_LEAF = 1e-3


def _norms(tensors: dict) -> dict:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if v else 0.0


def leaf_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's ``|prog - ref| / max(ref, median ref)`` of two dicts of
    norms by leaf name (``keep``: the names that count)."""
    names = [n for n in ref if keep is None or n in keep]
    med = _median([ref[n] for n in names])
    return {n: abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
            for n in names}


def cos_gaps(prog: dict, ref: dict, keep=None) -> dict:
    """Each leaf's ``1 - cos(prog, ref)`` of two dicts of tensors by leaf
    name (``keep``: the names that count)."""
    out = {}
    for n in ref:
        if keep is not None and n not in keep:
            continue
        p = prog[n].detach().double().reshape(-1).cpu()
        r = ref[n].detach().double().reshape(-1).cpu()
        den = float(torch.linalg.vector_norm(p) * torch.linalg.vector_norm(r))
        out[n] = 1.0 - float(p @ r) / den if den > 0 else 1.0
    return out


def training_numbers(losses_p, losses_r, grads_p: dict, grads_r: dict,
                     start: dict, after_p: dict, after_r: dict) -> dict:
    """``losses_*``: each followed step's loss; ``grads_*``: each leaf's
    first gradient; ``start``: the weights both began from; ``after_*``:
    the parameters after the followed steps."""
    n = len(losses_r)
    loss_gap = max(abs(float(p) - r) / max(abs(r), 1e-30)
                   for p, r in zip(losses_p[:n], losses_r))
    g_r = _norms(grads_r)
    med = _median(list(g_r.values()))
    keep = {name for name, v in g_r.items() if v >= QUIET_LEAF * med}
    d_p = _norms({k: after_p[k].to(start[k].device) - start[k]
                  for k in start})
    d_r = _norms({k: after_r[k] - start[k] for k in start})
    grads = leaf_gaps(_norms(grads_p), g_r)
    updates = leaf_gaps(d_p, d_r, keep)
    turns = cos_gaps(grads_p, grads_r, keep)
    return {"loss_gap": loss_gap,
            "grad_gap": max(grads.values()),
            "update_gap": max(updates.values()),
            "grad_gap_median": _median(list(grads.values())),
            "update_gap_median": _median(list(updates.values())),
            "grad_cos_gap_median": _median(list(turns.values())),
            "quiet_leaves": float(len(g_r) - len(keep))}


def worst_leaves(prog: dict, ref: dict, n: int = 3) -> list:
    """The ``n`` leaves of largest gap: ``[name, prog norm, ref norm,
    gap]`` (two dicts of norms by name)."""
    gaps = leaf_gaps(prog, ref)
    return [[k, prog[k], ref[k], gaps[k]]
            for k in sorted(gaps, key=lambda k: -gaps[k])[:n]]


def rollout_numbers(pairs, nf: int) -> dict:
    """``pairs``: ``(program [V, nf * n_out], reference)`` per request."""
    worst, first = 0.0, 0.0
    for p, r in pairs:
        p = torch.as_tensor(p, dtype=torch.float64)
        r = torch.as_tensor(r, dtype=torch.float64).to(p.device)
        steps = r.shape[1] // nf
        for t in range(steps):
            pt, rt = p[:, t * nf:(t + 1) * nf], r[:, t * nf:(t + 1) * nf]
            gap = float(torch.linalg.vector_norm(pt - rt)
                        / torch.linalg.vector_norm(rt).clamp_min(1e-30))
            gap = gap if gap == gap else float("inf")
            worst = max(worst, gap)
            if t == 0:
                first = max(first, gap)
    return {"rollout_gap": worst, "rollout_gap_first": first}
