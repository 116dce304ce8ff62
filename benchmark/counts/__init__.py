"""The work a step needs, counted from shapes, and the chip's peaks.

``gn_flops``, ``chain_flops`` and ``chain_bwd_flops`` are frozen copies of
``chip_smoke.py``'s; the bytes count each input once and each output once
(PERF.md section 6).  A kernel's least time is ``max(FLOPs / peak FLOP/s,
bytes / peak bytes/s)``.  The peaks are NVIDIA's H100 SXM data sheet's
(``peaks.json``).

A family module (``counts/<family>.py``, by the configuration's
``family``) lists the kernels of one step (``kernels(arch, sizes,
train, act_bytes)``) and the model's products (``model_flops(arch,
sizes)``), from the arch and the batch's valid sizes.  The work is
counted from shapes, not from launches, so it reads the same whatever
implements it.
"""
from __future__ import annotations

import importlib
import json
import os
from dataclasses import dataclass

with open(os.path.join(os.path.dirname(__file__), "peaks.json")) as _f:
    PEAKS = json.load(_f)

#: bytes of one activation element in a cell of each precision
ACT_BYTES = {"f32": 4, "bf16": 2}


def peak_flops(precision: str) -> float:
    """The tensor cores' dense peak that a cell of ``precision`` is held
    to: bf16 for bf16 cells, TF32 for f32 cells (so that no f32
    implementation can read over 100 %)."""
    return PEAKS["bf16_flops_per_s" if precision == "bf16"
                 else "tf32_flops_per_s"]


def gn_flops(E, V, fe, fv, ed, nd):
    """Products of one GN block: the edge chain over E rows (``We`` and the
    tail), the node side over V rows (``Wr``, ``[Wa; Wv]`` and the tail)."""
    edge = fe * ed[1] + sum(p * q for p, q in zip(ed[1:-1], ed[2:]))
    node = fv * ed[1] + sum(p * q for p, q in zip(nd[:-1], nd[1:]))
    return 2 * E * edge + 2 * V * node


def chain_flops(rows, dims):
    return sum(2 * rows * p * q for p, q in zip(dims[:-1], dims[1:]))


def chain_bwd_flops(rows, dims, ln, need_dx):
    """FLOPs the chain's backward needs: the recomputed forward of layers
    0..n-2 (and of layer n-1 only for its LayerNorm), ``dh = da W^T`` of
    layers 1..n-1 (and of layer 0 only for ``dx``), and every ``dW``."""
    layer = [2 * rows * p * q for p, q in zip(dims[:-1], dims[1:])]
    remat = sum(layer[:-1]) + (layer[-1] if ln else 0)
    dh = sum(layer[1:]) + (layer[0] if need_dx else 0)
    return remat + dh + sum(layer)


def chain_params(dims, ln) -> int:
    return (sum(p * q for p, q in zip(dims[:-1], dims[1:])) + sum(dims[1:])
            + (2 * dims[-1] if ln else 0))


@dataclass
class Kernel:
    """One kernel's work in a step: what it stands for, FLOPs, bytes."""
    name: str
    flops: float
    bytes: float

    def seconds(self, precision: str) -> float:
        return max(self.flops / peak_flops(precision),
                   self.bytes / PEAKS["bytes_per_s"])


def chain_fwd(name, rows, dims, ln, act):
    """A chain kernel: input and output rows at ``act`` bytes, f32
    parameters."""
    return Kernel(name, chain_flops(rows, dims),
                  act * rows * (dims[0] + dims[-1])
                  + 4 * chain_params(dims, ln))


def chain_bwd(name, rows, dims, ln, need_dx, act):
    """A chain backward: reads the input, the output's cotangent and the
    parameters, writes ``dx`` (when needed) and the parameters'
    gradients."""
    return Kernel(name, chain_bwd_flops(rows, dims, ln, need_dx),
                  act * rows * (dims[0] * (2 if need_dx else 1) + dims[-1])
                  + 4 * 2 * chain_params(dims, ln))


def gn_fwd(name, E, V, S, fe, fv, ed, nd, ln, e_out, act):
    """A GN-block kernel: reads ``e [E, fe]``, the sender table ``[S, H]``,
    ``v [V, fv]``, the senders and the parameters; writes ``v'`` and,
    unless it is dead, ``e'``."""
    H = ed[1]
    rows = E * fe + S * H + V * fv + V * nd[-1] + (E * ed[-1] if e_out else 0)
    return Kernel(name, gn_flops(E, V, fe, fv, ed, nd),
                  act * rows + 4 * E
                  + 4 * (chain_params(ed, ln) + chain_params(nd, ln)))


def gn_bwd(name, E, V, S, fe, fv, ed, nd, ln, e_out, act):
    """A GN-block backward with its sender-table sum: three times the
    forward's products; reads the forward's inputs, the senders and their
    sort, the cotangents, the parameters; writes ``de``, ``dv``, the
    table's gradient (float32, summed in float32) and the parameters'
    gradients."""
    H = ed[1]
    reads = E * fe + S * H + V * fv + V * nd[-1] + (E * ed[-1] if e_out
                                                     else 0)
    return Kernel(name, 3 * gn_flops(E, V, fe, fv, ed, nd),
                  act * (reads + E * fe + V * fv) + 4 * S * H + 3 * 4 * E
                  + 4 * 2 * (chain_params(ed, ln) + chain_params(nd, ln)))


def family(name: str):
    """The counts of a family (``counts/<name>.py``)."""
    return importlib.import_module(f"{__name__}.{name}")


def step_seconds(fam, arch, sizes, train: bool, precision: str) -> float:
    """The least time of the work the port's kernels stand for in one step
    (forward, and with ``train`` its backward)."""
    return sum(k.seconds(precision) for k in
               fam.kernels(arch, sizes, train, ACT_BYTES[precision]))


def step_model_flops(fam, arch, sizes, train: bool) -> float:
    """The model's products in one step: forward, three times that in
    training."""
    return fam.model_flops(arch, sizes) * (3 if train else 1)
