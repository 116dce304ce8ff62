"""Plain PyTorch building blocks of the reference models.

Every product goes through ``Numerics.mm``, which rounds both operands to
the precision under test and sums in float32 with TF32 off:

* ``f32``: no rounding (the reference itself);
* ``tf32``: operands rounded to TF32's 10 mantissa bits, as the tensor
  cores read float32 when TF32 is on (the control of a float32 cell);
* ``fp8``: operands scaled per tensor to float8 e4m3's range and rounded
  to it (the control of a bfloat16 cell).

Weights are a dict of the program's parameter names (``layers.<entry>.
[<sub>.]weights.<i>`` and so on) to tensors; ``mlp`` reads one entry's.
"""
from __future__ import annotations

import numpy as np
import torch

SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946
LN_EPS = 1e-5
FP8_MAX = 448.0


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to 10 mantissa bits, nearest even."""
    i = x.contiguous().view(torch.int32).to(torch.int64)
    i = (i + 0xFFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.to(torch.int32).view(torch.float32).reshape(x.shape)


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` scaled so that its largest magnitude is float8 e4m3's largest,
    rounded to e4m3 and scaled back."""
    amax = x.detach().abs().max().clamp_min(1e-30)
    s = FP8_MAX / amax
    return (x * s).to(torch.float8_e4m3fn).float() / s


ROUNDING = {"f32": lambda x: x, "tf32": round_tf32, "fp8": round_fp8}


class Numerics:
    """The precision that every product of a reference run takes."""

    def __init__(self, precision: str = "f32"):
        self.precision = precision
        self._rnd = ROUNDING[precision]

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """``a @ w``, both operands rounded; the rounding's gradient is
        taken as the identity."""
        if self.precision == "f32":
            return a @ w
        ra = a + (self._rnd(a.detach()) - a.detach())
        rw = w + (self._rnd(w.detach()) - w.detach())
        return ra @ rw


def selu(x: torch.Tensor) -> torch.Tensor:
    return SELU_SCALE * torch.where(x > 0, x, SELU_ALPHA * torch.expm1(x))


def layer_norm(h: torch.Tensor, scale, bias) -> torch.Tensor:
    mean = h.mean(dim=-1, keepdim=True)
    c = h - mean
    return c * torch.rsqrt((c * c).mean(dim=-1, keepdim=True) + LN_EPS) \
        * scale + bias


def layers_of(W: dict, prefix: str):
    """The weights, biases and LayerNorm (or None) of one MLP."""
    ws, bs, i = [], [], 0
    while f"{prefix}.weights.{i}" in W:
        ws.append(W[f"{prefix}.weights.{i}"])
        bs.append(W[f"{prefix}.biases.{i}"])
        i += 1
    ln = ((W[f"{prefix}.ln_scale"], W[f"{prefix}.ln_bias"])
          if f"{prefix}.ln_scale" in W else None)
    return ws, bs, ln


def mlp(W: dict, prefix: str, x: torch.Tensor, num: Numerics
        ) -> torch.Tensor:
    """Linear (SELU Linear)* [LayerNorm]."""
    ws, bs, ln = layers_of(W, prefix)
    h = num.mm(x, ws[0]) + bs[0]
    for w, b in zip(ws[1:], bs[1:]):
        h = num.mm(selu(h), w) + b
    return h if ln is None else layer_norm(h, *ln)


def concat(arrays, offsets=None) -> np.ndarray:
    """Samples' arrays joined; with ``offsets`` (each sample's size of the
    space the values index) the values are shifted by the sizes before
    them, and negative values (none) kept."""
    if offsets is None:
        return np.concatenate(arrays)
    base = np.concatenate([[0], np.cumsum(offsets)[:-1]])
    return np.concatenate([np.where(a >= 0, a + b, a)
                           for a, b in zip(arrays, base)])


class Segments:
    """A mean over segments, worked out on the host once: the rows that
    count (index >= 0), their segment, and one over each segment's size,
    so that the device never waits for the host."""

    def __init__(self, index: np.ndarray, num: int, device):
        index = np.asarray(index)
        keep = index >= 0
        self.rows = (None if keep.all() else
                     torch.as_tensor(np.nonzero(keep)[0], device=device))
        self.index = torch.as_tensor(index[keep], device=device)
        count = np.maximum(np.bincount(index[keep], minlength=num), 1)
        self.scale = torch.as_tensor((1.0 / count)[:, None],
                                     dtype=torch.float32, device=device)
        self.num = num

    def mean(self, src: torch.Tensor) -> torch.Tensor:
        """Mean of the rows of ``src`` by segment; an empty segment is 0."""
        rows = src if self.rows is None else src[self.rows]
        total = src.new_zeros((self.num,) + src.shape[1:]).index_add(
            0, self.index, rows)
        return total * self.scale


def gn(W: dict, prefix: str, sub, v_src: torch.Tensor, v_dst: torch.Tensor,
       e: torch.Tensor, senders: torch.Tensor, receivers: torch.Tensor,
       mean, num: Numerics):
    """One GN block: the ``sub[0]`` MLP over ``[e, v_src[s], v_dst[r]]``,
    the mean of its outputs per receiver (``mean``), the ``sub[1]`` MLP
    over ``[that mean, v_dst]``, SELU on both outputs."""
    x = torch.cat([e, v_src[senders], v_dst[receivers]], dim=1)
    e_new = mlp(W, f"{prefix}.{sub[0]}", x, num)
    v_new = mlp(W, f"{prefix}.{sub[1]}", torch.cat([mean(e_new), v_dst],
                                                   dim=1), num)
    return selu(v_new), selu(e_new)
