"""Fused MLP chain: the CUDA kernel ``csrc/mlp_chain.cu``, its wrapper and
its plain PyTorch version.

Counterpart of ``graphs4cfd_tpu/ops/pallas_mlp.py:fused_mlp`` (forward
kernel ``_make_fwd_kernel:75``, called from ``_fused_fwd_impl:185``):
``Linear -> SELU -> ... -> Linear`` then an optional LayerNorm (eps 1e-5,
biased variance, f32 statistics).  ``preact_input`` (``start=1``) means
``x`` is the pre-activation of a first layer computed outside, and the
chain starts with SELU of it.

What bounds it on the H100 and what the design does about it: see the note
at the top of ``csrc/mlp_chain.cu``.

Dispatch: ``mlp_chain`` takes the plain version for a CPU tensor.  For a
CUDA tensor it launches the kernel or raises: the kernel takes 1-8
layers whose output widths are at most 256 and whose widest activation
fits shared memory (input widths up to about 500).  Every MLP of the
models (inputs 2, 3, 4, 5, 130, 258, hidden 128, outputs 3 and 1) fits, so
on CUDA every chain of the path goes through it.  Both kernels run every
product on the tensor cores as 3xTF32 (each f32 operand split into two
TF32 parts, ``csrc/mma_tf32x3.cuh``), which holds them to the f32 gates.

Backward: when a gradient is needed, ``mlp_chain`` runs through
``MlpChainFn``, whose backward is ``mlp_chain_bwd``: the CUDA kernel
``csrc/mlp_chain_bwd.cu`` for a CUDA tensor (counterpart of
``pallas_mlp.py:_fused_vjp_bwd:202``, kernel ``_make_bwd_kernel:88``), its
plain version ``mlp_chain_bwd_plain`` for a CPU tensor.  It recomputes the
forward from the input ("remat") and returns ``dx`` (skipped when no input
needs it), every ``dW``, ``db`` and the LayerNorm's ``(dscale, dbias)``.
The kernel takes output widths up to 128 (and with ``preact_input`` an
input up to 128 wide).  On the card the backward is three launches, as the
GN block's is: a tile kernel (the recomputed forward and the activation
cotangents; it writes each weight gradient's per-row operands and its
tiles' column sums), the weight-gradient kernel (every ``dW = X^T D`` as
a split over fixed chunks of rows; ``ops.wgrad``) and the reduction (the
chunk and tile partials in a fixed order), the last two shared with the GN
backward (``csrc/wgrad.cu``; under the bf16 policy the weight-gradient
kernel is ``csrc/wgrad_bf16.cu``'s).

The bf16 policy (``compute_dtype=torch.bfloat16``, the JAX package's
``fused_mlp(..., compute_dtype=jnp.bfloat16)``, ``pallas_mlp.py:255-275``):
a bf16 ``x`` gives a bf16 output, with the weights, biases and LayerNorm
parameters f32.  Every product takes both operands rounded to bf16 and
sums in f32 (``preferred_element_type=jnp.float32``): the plain versions
compute ``x.to(bf16).float() @ w.to(bf16).float()`` in f32.  Each
direction has a bf16 kernel of its own, on bf16 tiles in shared memory
whose every product is a wgmma (Hopper's warpgroup product): the forward
``csrc/mlp_chain_fwd_bf16.cu`` (a warpgroup takes 64-row m-tiles through
every layer alone, the weights rounded to bf16 once a block; every width
the f32 kernel takes), the backward ``csrc/mlp_chain_bwd_bf16.cu``
(128-row tiles) and ``csrc/wgrad_bf16.cu``.  The biases, SELU and the
LayerNorm run in f32 between the products; the output (and ``dx``) is
rounded to bf16 once.  The backward takes a bf16
cotangent and rounds both operands of every product, as
``pallas_mlp.py:_make_bwd_kernel`` does (``da.astype(bf16)``,
``h_prev.astype(bf16)``); the bias and
LayerNorm gradients sum the f32 cotangents, and every parameter gradient
is f32.  The launches of the bf16 kernels count in ``mlp_chain.bf16`` and
``mlp_chain_bwd.bf16`` (``ops.launch_counters()``), the f32 ones in the
wrappers' own ``launches``.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from . import _build

SELU_ALPHA = 1.6732632423543772848170429916717
SELU_SCALE = 1.0507009873554804934193349852946
LN_EPS = 1e-5
MAX_LAYERS = 8
MAX_OUT_WIDTH = 256


def selu(a: torch.Tensor) -> torch.Tensor:
    """SELU with the constants of the JAX package's kernels; a bf16 ``a``
    is taken through f32 and rounded once."""
    if a.dtype == torch.bfloat16:
        return selu(a.float()).to(torch.bfloat16)
    return SELU_SCALE * torch.where(a > 0, a, SELU_ALPHA * torch.expm1(a))


def is_bf16(t: torch.Tensor) -> bool:
    return t.dtype == torch.bfloat16


def round_bf16(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to bf16 (nearest even) and back to f32: a product
    operand of the bf16 policy."""
    return t.to(torch.bfloat16).float()


def widen(t: torch.Tensor) -> torch.Tensor:
    """A bf16 ``t`` as f32; any other ``t`` as it is."""
    return t.float() if is_bf16(t) else t


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def operand_rounding(bf16: bool):
    """What a product's operands go through: ``round_bf16`` under the bf16
    policy, nothing under f32."""
    return round_bf16 if bf16 else _same


def dselu(a: torch.Tensor) -> torch.Tensor:
    """SELU's derivative at the pre-activation ``a``."""
    return SELU_SCALE * torch.where(a > 0, 1.0, SELU_ALPHA * torch.exp(a))


def layer_norm(h: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(h, h.shape[-1:], scale, bias, eps=LN_EPS)


def _chain_pre_ln(x, weights, biases, preact_input, rnd):
    """The chain's f32 output before its LayerNorm; ``rnd`` is applied to
    both operands of each product."""
    h = selu(x) if preact_input and len(weights) else x
    for i, (w, b) in enumerate(zip(weights, biases)):
        h = torch.addmm(b, rnd(h), rnd(w))
        if i < len(weights) - 1:
            h = selu(h)
    return h


def mlp_chain_plain(x: torch.Tensor, weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor],
                    ln_scale: Optional[torch.Tensor] = None,
                    ln_bias: Optional[torch.Tensor] = None, *,
                    preact_input: bool = False) -> torch.Tensor:
    """The kernel's function in plain PyTorch (weights ``[in, out]``).
    With no layers it applies only the LayerNorm, as ``apply_mlp_tail``
    does when ``start`` is the last layer.  A bf16 ``x``: the bf16 policy
    (f32 between the products, the output rounded to bf16)."""
    h = _chain_pre_ln(widen(x), weights, biases, preact_input,
                      operand_rounding(is_bf16(x)))
    if ln_scale is not None:
        h = layer_norm(h, ln_scale, ln_bias)
    return h.to(x.dtype)


def _check(x, weights, biases, ln_scale, ln_bias):
    if not 1 <= len(weights) <= MAX_LAYERS or len(biases) != len(weights):
        raise ValueError(f"mlp_chain kernel takes 1-{MAX_LAYERS} layers, "
                         f"got {len(weights)} weights, {len(biases)} biases")
    if x.dim() != 2:
        raise ValueError(f"x must be [rows, features], got {tuple(x.shape)}")
    dims = [x.shape[1]] + [w.shape[1] for w in weights]
    for i, (w, b) in enumerate(zip(weights, biases)):
        if tuple(w.shape) != (dims[i], dims[i + 1]) or \
                tuple(b.shape) != (dims[i + 1],):
            raise ValueError(f"layer {i}: weight {tuple(w.shape)}, bias "
                             f"{tuple(b.shape)} do not chain from "
                             f"{dims[i]} features")
    if (ln_scale is None) != (ln_bias is None):
        raise ValueError("LayerNorm needs both scale and bias")
    ln = [t for t in (ln_scale, ln_bias) if t is not None]
    for t in ln:
        if tuple(t.shape) != (dims[-1],):
            raise ValueError(f"LayerNorm params {tuple(t.shape)} do not "
                             f"match width {dims[-1]}")
    for t in [x, *weights, *biases, *ln]:
        want = x.dtype if t is x else torch.float32
        if t.device != x.device or t.dtype != want or not t.is_contiguous():
            raise ValueError("mlp_chain kernel takes a contiguous float32 "
                             "or bfloat16 x and float32 parameters on "
                             f"{x.device}; got {t.dtype} on {t.device}, "
                             f"contiguous={t.is_contiguous()}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mlp_chain kernel takes float32 or bfloat16 x, "
                         f"got {x.dtype}")
    if max(dims[1:]) > MAX_OUT_WIDTH:
        raise ValueError(f"mlp_chain kernel takes output widths up to "
                         f"{MAX_OUT_WIDTH}, got {dims[1:]}")
    return dims


def mlp_chain(x: torch.Tensor, weights: Sequence[torch.Tensor],
              biases: Sequence[torch.Tensor],
              ln_scale: Optional[torch.Tensor] = None,
              ln_bias: Optional[torch.Tensor] = None, *,
              preact_input: bool = False) -> torch.Tensor:
    """Run the chain: the plain version for a CPU tensor, the CUDA kernel
    for a CUDA tensor (or an error if the kernel does not take it).  When
    a gradient is needed it goes through ``MlpChainFn``, whose backward is
    ``mlp_chain_bwd``."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"mlp_chain: unsupported device {x.device}")
    ln = [t for t in (ln_scale, ln_bias) if t is not None]
    if len(weights) and torch.is_grad_enabled() and any(
            t.requires_grad for t in [x, *weights, *biases, *ln]):
        if (ln_scale is None) != (ln_bias is None):
            raise ValueError("LayerNorm needs both scale and bias")
        return MlpChainFn.apply(x, preact_input, len(weights), bool(ln),
                                *weights, *biases, *ln)
    if x.device.type == "cpu":
        return mlp_chain_plain(x, weights, biases, ln_scale, ln_bias,
                               preact_input=preact_input)
    return _launch_fwd(x, weights, biases, ln_scale, ln_bias, preact_input)


def _launch_fwd(x, weights, biases, ln_scale, ln_bias, preact_input):
    dims = _check(x, weights, biases, ln_scale, ln_bias)
    lib = _build.load()
    c_dims = _build.int_array(dims)
    smem = lib.g4c_mlp_chain_smem(len(weights), c_dims, x.shape[0],
                                  int(is_bf16(x)))
    if smem == 0 or smem > _build.MAX_SMEM:
        raise ValueError(f"mlp_chain kernel cannot hold widths {dims} in "
                         f"shared memory ({smem} bytes)")
    out = torch.empty(x.shape[0], dims[-1], device=x.device, dtype=x.dtype)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.g4c_mlp_chain(
            x.data_ptr(), out.data_ptr(), x.shape[0], len(weights),
            _build.ptr_array(weights), _build.ptr_array(biases), c_dims,
            ln_scale.data_ptr() if ln_scale is not None else None,
            ln_bias.data_ptr() if ln_bias is not None else None,
            int(preact_input), int(is_bf16(x)),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err)
    (mlp_chain.bf16 if is_bf16(x) else mlp_chain).launches += 1
    return out


#: kernel launches since the count was last set to 0 (f32; bf16 in
#: ``mlp_chain.bf16.launches``)
mlp_chain.launches = 0
mlp_chain.bf16 = SimpleNamespace(launches=0)


def layer_norm_bwd(g: torch.Tensor, out: torch.Tensor, scale: torch.Tensor):
    """LayerNorm backward at the pre-LN rows ``out`` (f32 statistics,
    biased variance, eps 1e-5): ``(d out, dscale, dbias)``."""
    mean = out.mean(dim=-1, keepdim=True)
    cent = out - mean
    rstd = torch.rsqrt((cent * cent).mean(dim=-1, keepdim=True) + LN_EPS)
    xhat = cent * rstd
    dxhat = g * scale
    da = (dxhat - dxhat.mean(dim=-1, keepdim=True)
          - xhat * (dxhat * xhat).mean(dim=-1, keepdim=True)) * rstd
    return da, (g * xhat).sum(dim=0), g.sum(dim=0)


def chain_bwd_plain(da: torch.Tensor, x: torch.Tensor,
                    weights: Sequence[torch.Tensor],
                    biases: Sequence[torch.Tensor], *, preact_input: bool,
                    need_dx: bool = True, rnd=_same):
    """Backward of the Linear/SELU layers of a chain from ``da`` (the f32
    cotangent of the last pre-LN output), recomputing the forward from the
    f32 ``x``; ``rnd`` is applied to both operands of each product
    (``round_bf16`` under the bf16 policy).  Returns ``(dx or None, [dW],
    [db])``, all f32."""
    if not weights:
        return da, [], []
    h = selu(x) if preact_input else x
    ins, pre = [h], []
    for i, (w, b) in enumerate(zip(weights, biases)):
        a = torch.addmm(b, rnd(h), rnd(w))
        if i < len(weights) - 1:
            pre.append(a)
            h = selu(a)
            ins.append(h)
    dws, dbs, dx = [None] * len(weights), [None] * len(weights), None
    for i in range(len(weights) - 1, -1, -1):
        dws[i] = rnd(ins[i]).t() @ rnd(da)
        dbs[i] = da.sum(dim=0)
        if i == 0 and not need_dx:
            break
        dh = rnd(da) @ rnd(weights[i]).t()
        if i > 0:
            da = dh * dselu(pre[i - 1])
        else:
            dx = dh * dselu(x) if preact_input else dh
    return dx, dws, dbs


#: the bf16 forward's geometry (``csrc/mlp_tile_bf16.cuh``): rows of a
#: warpgroup's m-tile, warpgroups a block at most, the bytes of a k16 step
#: of a 128-column weight image and of the stash (or a slot)
BF16_FWD_ROWS, BF16_FWD_WG_MAX = 64, 4
BF16_FWD_STEP_BYTES, BF16_FWD_AUX_BYTES = 4096, 32768


def _bf16_fwd_wide(dims) -> bool:
    return max(dims[1:]) > 128


def bf16_fwd_weight_bytes(dims) -> int:
    """Bytes of the bf16 forward's resident weight images of a chain of
    widths ``dims`` (``mlp_tile_bf16.cuh:fwd_weight_bytes``)."""
    return sum(-(-k // 16) * BF16_FWD_STEP_BYTES * -(-n // 128)
               for k, n in zip(dims[:-1], dims[1:]))


def bf16_fwd_wg_bytes(dims, streamed: bool) -> int:
    """Bytes of a warpgroup's own tiles (``fwd_wg_bytes``): its activation
    tile (two and the stash for an output over 128 wide), and its weight
    slot if the weights are streamed."""
    wide = _bf16_fwd_wide(dims)
    cols = max(-(-dims[0] // 64) * 64, 256 if wide else 128)
    return (BF16_FWD_ROWS * cols * 2 * (2 if wide else 1)
            + (BF16_FWD_AUX_BYTES if wide else 0)
            + (BF16_FWD_AUX_BYTES if streamed else 0))


def bf16_fwd_smem(dims, streamed: bool, g: int) -> int:
    """Shared-memory bytes of a block of ``g`` warpgroups
    (``fwd_smem_bytes``)."""
    return (1024 + (0 if streamed else bf16_fwd_weight_bytes(dims))
            + g * bf16_fwd_wg_bytes(dims, streamed))


def bf16_fwd_geometry(dims):
    """``(streamed, warpgroups, smem)`` of the bf16 forward of a chain
    of widths ``dims``: the weights resident in shared memory where they
    fit with one warpgroup, else streamed; as many warpgroups a block as
    fit, at most four, and their bytes (``fwd_streamed``, ``fwd_fit``; 0
    warpgroups and 0 bytes if nothing fits)."""
    def fit(streamed):
        g = BF16_FWD_WG_MAX
        while g > 0 and bf16_fwd_smem(dims, streamed, g) > _build.MAX_SMEM:
            g -= 1
        return g
    streamed = fit(False) == 0
    g = fit(streamed)
    return streamed, g, bf16_fwd_smem(dims, streamed, g) if g else 0


#: the bf16 backward tile's geometry (``csrc/mlp_tile_bf16.cuh``): threads
#: of a block (four warpgroups), rows of a tile (two 64-row m-tiles), the
#: bytes of its activation tile, of a weight slice and of the column- and
#: row-sum scratch, and the row stride (floats) of an f32 xo tile
BF16_BWD_THREADS, BF16_BWD_ROWS, BF16_BWD_E_BYTES = 512, 128, 32768
BF16_W_BYTES, BF16_CS_BYTES, BF16_XS_LD = 32768, 5120, 132


def _bf16_bwd_base(k0: int) -> int:
    x_tile = BF16_BWD_ROWS * (-(-k0 // 64) * 64) * 2 if k0 > 128 else 0
    return (1024 + BF16_BWD_E_BYTES + x_tile + BF16_W_BYTES
            + BF16_CS_BYTES)


def bf16_bwd_xs_tiles(k0: int, n: int) -> int:
    """The f32 tiles of the layer inputs that SELU' reads back which the
    bf16 backward tile of an ``n``-layer chain with a ``k0``-wide input
    holds in shared memory: as many of its ``n - 1`` as fit
    (``mlp_tile_bf16.cuh:xs_tiles``)."""
    t = n - 1
    xs = BF16_BWD_ROWS * BF16_XS_LD * 4
    while t > 0 and _bf16_bwd_base(k0) + t * xs > _build.MAX_SMEM:
        t -= 1
    return t


def bf16_bwd_smem(k0: int, n: int) -> int:
    """Shared-memory bytes of the bf16 backward tile of an ``n``-layer
    chain whose input is ``k0`` wide (``mlp_tile_bf16.cuh:smem_bytes``):
    the activation tile, an input tile when ``k0`` is over 128, the weight
    slice, the scratch, 1 KB of alignment and the f32 xo tiles."""
    return (_bf16_bwd_base(k0)
            + bf16_bwd_xs_tiles(k0, n) * BF16_BWD_ROWS * BF16_XS_LD * 4)


def mlp_chain_bwd_plain(x: torch.Tensor, g: torch.Tensor,
                        weights: Sequence[torch.Tensor],
                        biases: Sequence[torch.Tensor],
                        ln_scale: Optional[torch.Tensor] = None, *,
                        preact_input: bool = False, need_dx: bool = True):
    """The backward kernel's function in plain PyTorch: from the chain's
    input ``x`` and the cotangent ``g`` of its output, ``(dx or None,
    [dW], [db], (dscale, dbias) or None)``; under the bf16 policy (bf16
    ``x`` and ``g``) ``dx`` is bf16, the parameter gradients f32."""
    bf = is_bf16(x)
    rnd = operand_rounding(bf)
    xf, gf = widen(x), widen(g)
    with torch.no_grad():
        if ln_scale is not None:
            out = _chain_pre_ln(xf, weights, biases, preact_input, rnd)
            da, dscale, dbias = layer_norm_bwd(gf, out, ln_scale)
            dln = (dscale, dbias)
        else:
            da, dln = gf, None
        dx, dws, dbs = chain_bwd_plain(da, xf, weights, biases,
                                       preact_input=preact_input,
                                       need_dx=need_dx, rnd=rnd)
    if dx is not None:
        dx = dx.to(x.dtype)
    return dx, dws, dbs, dln


def mlp_chain_bwd(x: torch.Tensor, g: torch.Tensor,
                  weights: Sequence[torch.Tensor],
                  biases: Sequence[torch.Tensor],
                  ln_scale: Optional[torch.Tensor] = None, *,
                  preact_input: bool = False, need_dx: bool = True):
    """The chain's backward: the plain version for a CPU tensor, the CUDA
    kernel for a CUDA tensor (or an error if the kernel does not take
    it).  Returns ``(dx or None, [dW], [db], (dscale, dbias) or None)``."""
    if x.device.type == "cpu":
        return mlp_chain_bwd_plain(x, g, weights, biases, ln_scale,
                                   preact_input=preact_input,
                                   need_dx=need_dx)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_chain_bwd: unsupported device {x.device}")
    return _launch_bwd(x, g, weights, biases, ln_scale, preact_input, need_dx)


def _launch_bwd(x, g, weights, biases, ln_scale, preact_input, need_dx,
                events=None):
    """Launch the backward.  With ``events`` (three ``torch.cuda.Event``
    objects) each part runs on its own and is followed by one event: the
    tile kernel, the weight-gradient kernel, the reduction."""
    dims = _check(x, weights, biases, ln_scale, ln_scale)  # no LN bias read
    if tuple(g.shape) != (x.shape[0], dims[-1]) or g.dtype != x.dtype \
            or g.device != x.device or not g.is_contiguous():
        raise ValueError(f"g must be a contiguous {x.dtype} [{x.shape[0]}, "
                         f"{dims[-1]}] on {x.device}, got "
                         f"{tuple(g.shape)} {g.dtype}")
    bf = int(is_bf16(x))
    lib = _build.load()
    n, rows = len(weights), x.shape[0]
    c_dims = _build.int_array(dims)
    smem = lib.g4c_mlp_chain_bwd_smem(n, c_dims, int(preact_input), bf)
    if smem == 0 or smem > _build.MAX_SMEM:
        raise ValueError(f"mlp_chain_bwd kernel cannot hold widths {dims} "
                         f"(preact_input={preact_input}) in shared memory "
                         f"({smem} bytes)")
    # every parameter gradient is a view of one flat buffer, in the order
    # W0, b0, W1, b1, ..., LN scale, LN bias
    sizes = [(dims[i], dims[i + 1]) for i in range(n)]
    numel = sum(a * b + b for a, b in sizes) + (2 * dims[-1]
                                                 if ln_scale is not None
                                                 else 0)
    dx = torch.empty_like(x) if need_dx else None
    if rows == 0:
        flat = torch.zeros(numel, device=x.device, dtype=torch.float32)
    else:
        # the reduction writes every gradient
        flat = torch.empty(numel, device=x.device, dtype=torch.float32)
        # the weight gradients' per-row operands, their chunk partials and
        # the tiles' column sums
        work = torch.empty(lib.g4c_mlp_chain_bwd_work(
            n, c_dims, rows, int(ln_scale is not None), int(preact_input),
            bf), device=x.device, dtype=torch.float32)
        args = (x.data_ptr(), g.data_ptr(),
                dx.data_ptr() if dx is not None else None, rows, n,
                _build.ptr_array(weights), _build.ptr_array(biases), c_dims,
                ln_scale.data_ptr() if ln_scale is not None else None,
                int(preact_input), work.data_ptr(), flat.data_ptr())
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream().cuda_stream
            for part, event in (((7, None),) if events is None else
                                zip((1, 2, 4), events)):
                _build.check(lib.g4c_mlp_chain_bwd(*args, part, bf, stream))
                if event is not None:
                    event.record()
        (mlp_chain_bwd.bf16 if bf else mlp_chain_bwd).launches += 1
        from .wgrad import count_launch
        count_launch(bf)
    dws, dbs, off = [], [], 0
    for a, b in sizes:
        dws.append(flat[off:off + a * b].view(a, b))
        dbs.append(flat[off + a * b:off + a * b + b])
        off += a * b + b
    dln = ((flat[off:off + dims[-1]], flat[off + dims[-1]:])
           if ln_scale is not None else None)
    return dx, dws, dbs, dln


#: kernel launches since the count was last set to 0 (f32; bf16 in
#: ``mlp_chain_bwd.bf16.launches``)
mlp_chain_bwd.launches = 0
mlp_chain_bwd.bf16 = SimpleNamespace(launches=0)


class MlpChainFn(torch.autograd.Function):
    """``mlp_chain`` with ``mlp_chain_bwd`` as its backward; the chain's
    tensors come flattened: ``x, preact_input, n, has_ln, *W, *b, *ln``.
    Only ``x`` and the parameters are saved: the backward recomputes the
    forward."""

    @staticmethod
    def forward(ctx, x, preact_input, n, has_ln, *params):
        ws, bs = params[:n], params[n:2 * n]
        ln = params[2 * n:] if has_ln else (None, None)
        ctx.save_for_backward(x, *params)
        ctx.preact_input, ctx.n, ctx.has_ln = preact_input, n, has_ln
        return mlp_chain(x, ws, bs, *ln, preact_input=preact_input)

    @staticmethod
    def backward(ctx, g):
        x, *params = ctx.saved_tensors
        n = ctx.n
        ws, bs = params[:n], params[n:2 * n]
        dx, dws, dbs, dln = mlp_chain_bwd(
            x, g.contiguous(), ws, bs, params[2 * n] if ctx.has_ln else None,
            preact_input=ctx.preact_input, need_dx=ctx.needs_input_grad[0])
        return (dx, None, None, None, *dws, *dbs, *(dln or ()))
