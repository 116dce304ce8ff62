"""Random weights of a configuration, made by the benchmark from the seed.

The names and shapes follow the program's parameter layout (what
``model.state_dict()`` holds): an MLP entry ``(in, widths, layer_norm)``
holds ``layers.<name>.weights.<i> [in, out]``, ``.biases.<i>`` and, with a
LayerNorm, ``.ln_scale`` and ``.ln_bias``; a block entry (a pair of MLPs)
holds its two MLPs under ``edge_mlp``/``node_mlp``, or ``angle_mlp``/
``edge_mlp`` in an arch with angle encoders.  Weights and biases are drawn
from ``U(-1/sqrt(fan_in), 1/sqrt(fan_in))`` (``torch.nn.Linear``'s
default) in one call on the device, LayerNorm scales are 1 and biases 0.
Both the program and the reference are given these tensors.
"""
from __future__ import annotations

import math

import torch

from .data import torch_seed


def _is_mlp(spec) -> bool:
    return len(spec) == 3 and isinstance(spec[0], int)


def layout(arch: dict):
    """``[(name, shape, fan_in or None for a LayerNorm, ln value)]`` in the
    program's parameter order."""
    angle = any(k.startswith("angle_encoder") for k in arch)
    out = []

    def mlp(prefix, spec):
        dims = [int(spec[0])] + [int(w) for w in spec[1]]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out.append((f"{prefix}.weights.{i}", (a, b), a, None))
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            out.append((f"{prefix}.biases.{i}", (b,), a, None))
        if spec[2]:
            out.append((f"{prefix}.ln_scale", (dims[-1],), None, 1.0))
            out.append((f"{prefix}.ln_bias", (dims[-1],), None, 0.0))

    for name, spec in arch.items():
        if _is_mlp(spec):
            mlp(f"layers.{name}", spec)
        else:
            subs = (("angle_mlp", "edge_mlp")
                    if angle and name.startswith(("mp", "down_mp"))
                    else ("edge_mlp", "node_mlp"))
            for sub, s in zip(subs, spec):
                mlp(f"layers.{name}.{sub}", s)
    return out


def make(arch: dict, seed: int, device) -> dict:
    """The weights of ``arch`` for ``--seed`` ``seed``, float32 on
    ``device``, by name."""
    lay = layout(arch)
    sizes = [math.prod(shape) if fan else 0 for _, shape, fan, _ in lay]
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, "weights"))
    u = torch.rand(sum(sizes), generator=gen, device=device)
    out = {}
    for (name, shape, fan, ln), part in zip(lay, u.split(sizes)):
        if fan is None:
            out[name] = torch.full(shape, ln, device=device)
        else:
            out[name] = ((2 * part - 1) / math.sqrt(fan)).reshape(shape)
    return out
