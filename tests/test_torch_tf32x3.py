"""The arithmetic of the port's GN and MLP-chain kernels on the tensor
cores, on the CPU.

* **3xTF32.**  ``csrc/gn_block.cu``, ``csrc/gn_block_bwd.cu``,
  ``csrc/mlp_chain.cu`` and ``csrc/mlp_chain_bwd.cu`` run every product as
  three TF32 products: each f32 operand is split into ``hi`` (``x`` with
  its 13 low mantissa bits cleared) and ``lo = tf32(x - hi)`` (round to
  nearest, ties away, to TF32's 10-bit mantissa) and ``lo*hi + hi*lo +
  hi*hi`` is accumulated in f32.  ``TF32Products`` runs every matrix
  product of ``gn_block_plain`` so, at the flagship widths (k = 6, H = 128;
  node inputs 128 and 256 wide), and the outputs are held against float64
  at the kernels' forward gate, 2e-4 of max(1, max |ref|); and every
  product of ``mlp_chain_plain`` and ``mlp_chain_bwd_plain`` at the chain
  kernels' measured shapes (``chip_smoke.CHAIN_CASES``) at theirs: 1e-4
  max abs forward, 1e-4 of max(1, max |ref|) backward.  One TF32 product
  per f32 one is printed beside it: it is what the 3xTF32 split buys.
* **The split-over-rows weight gradients.**  The backward computes every
  ``dW = X^T D`` over fixed chunks of rows and every bias and LayerNorm
  gradient over its tiles, each summed in a fixed order;
  ``gn_block_bwd_split_plain`` (here) is that order in plain PyTorch,
  from the per-row operands the tile kernel writes.  It is held
  against ``gn_block_bwd_plain`` (float64, so that no SELU input falls on
  the other side of its kink between the two) at 2e-4 of each tensor's
  max abs, with the kernel's chunk of 2048 rows and with chunks of 64;
  and against ``jax.vjp`` of the JAX package's ``gn_block_fused`` in
  Pallas interpret mode (f32, 2e-4 of each tensor's max abs).  The chain
  backward's order (``mlp_chain_bwd_split_plain``: the same chunks, the
  bias and LayerNorm gradients per tile of ``TILE_ROWS`` rows) is held
  the same ways, against ``mlp_chain_bwd_plain`` and ``jax.vjp`` of
  ``pallas_mlp.fused_mlp``.

``test_torch_cuda.py`` holds the kernels themselves against the plain
versions on a card.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.overrides import TorchFunctionMode

from chip_smoke import CHAIN_CASES, chain_bwd_flops, chain_kinks, quiet
from graphs4cfd_tpu.nn.mlp import init_mlp
from graphs4cfd_tpu.ops import pallas_gnblock as pg
from graphs4cfd_tpu.ops.pallas_mlp import fused_mlp
from graphs4cfd_tpu_torch.ops import gn_block as port_gn
from graphs4cfd_tpu_torch.ops.fused_mlp import (LN_EPS, dselu, layer_norm,
                                                layer_norm_bwd,
                                                mlp_chain_bwd_plain,
                                                mlp_chain_plain, selu)
from graphs4cfd_tpu_torch.ops.gn_block import (_first_edge_layer,
                                               _sender_sort, _split_first,
                                               repeat_k, tile_receivers)
from graphs4cfd_tpu_torch.ops.segment import (aggregate_fixed_k,
                                              sorted_segment_sum_plain)
from test_torch_kernels import _chain, _t
from test_torch_mugs import coarse_case
from test_torch_mugs_train import _assert_bwd
from test_torch_remus_train import _host_sort
from test_torch_train import _assert_chain_grads_to_max, _close_to_max, \
    _mlp_grads

GATE = 2e-4
CHAIN_GATE = 1e-4
CSRC = Path(__file__).resolve().parent.parent / "graphs4cfd_tpu_torch" / "csrc"


def _c_int(header: str, name: str) -> int:
    """The value of ``constexpr int <name> = <n>;`` in ``csrc/<header>``."""
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / header).read_text())
    return int(m.group(1))


#: the weight-gradient kernel's split rule, read from ``csrc/wgrad.cuh``
WGRAD_CHUNK, WGRAD_MIN_CHUNK, WGRAD_MIN_CHUNKS = (
    _c_int("wgrad.cuh", n) for n in ("WG_CHUNK", "WG_MIN_CHUNK",
                                     "WG_MIN_CHUNKS"))


def _chain_bwd_tile_rows() -> int:
    """Rows of a tile of the backward chain kernel, whose bias and
    LayerNorm gradients are summed per tile: ``EdgeL`` of
    ``csrc/gn_tile.cuh``, ``WM * MT`` fragments of 16 rows."""
    assert "  using L = EdgeL;\n" in (CSRC / "mlp_chain_bwd.cu").read_text()
    wm, mt = re.search(r"using EdgeL = Layout<(\d+), (\d+),",
                       (CSRC / "gn_tile.cuh").read_text()).groups()
    return 16 * int(wm) * int(mt)


TILE_ROWS = _chain_bwd_tile_rows()


def wgrad_chunk(rows: int) -> int:
    """Rows of each partial of a weight gradient over ``rows`` rows, as the
    backward kernels split it (``csrc/wgrad.cuh:wgrad_chunk``):
    ``WGRAD_CHUNK``, halved (down to ``WGRAD_MIN_CHUNK``) while there would
    be fewer than ``WGRAD_MIN_CHUNKS`` partials."""
    c = WGRAD_CHUNK
    while c > WGRAD_MIN_CHUNK and -(-rows // c) < WGRAD_MIN_CHUNKS:
        c //= 2
    return c


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) rounded to nearest, ties away, to TF32's 10-bit mantissa,
    as ``cvt.rna.tf32.f32`` rounds it."""
    u = x.contiguous().view(torch.int32)
    finite = (u & 0x7F800000) != 0x7F800000
    return torch.where(finite, (u + 0x1000) & -0x2000, u).view(torch.float32)


def tf32_hi(x: torch.Tensor) -> torch.Tensor:
    """``x`` (f32) with its 13 low mantissa bits cleared: the kernels'
    ``hi`` part (NaN and infinity stay)."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_mm(a: torch.Tensor, b: torch.Tensor, terms: int) -> torch.Tensor:
    """``a @ b`` from TF32 parts, accumulated in f32: one TF32 product
    (``terms`` 1, both operands rounded to nearest) or the kernels' split,
    ``lo*hi + hi*lo + hi*hi`` (3)."""
    if terms == 1:
        return tf32(a) @ tf32(b)
    ah, bh = tf32_hi(a), tf32_hi(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


class TF32Products(TorchFunctionMode):
    """Every f32 ``@``/``matmul``/``mm``/``addmm`` as ``tf32_mm``."""

    def __init__(self, terms):
        super().__init__()
        self.terms = terms

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.__matmul__, torch.matmul, torch.mm,
                    torch.Tensor.matmul, torch.Tensor.mm):
            a, b = args
            if a.dtype == torch.float32:
                return tf32_mm(a, b, self.terms)
        if func is torch.addmm and args[1].dtype == torch.float32:
            return args[0] + tf32_mm(args[1], args[2], self.terms)
        return func(*args, **kwargs)


def _gn_inputs(rng, V, k, H, fv):
    """A GN block at the flagship widths: 3-layer chains with LayerNorm, the
    edge MLP over ``[e, v_s, v_r]``, the node MLP over ``[aggr, v]``."""
    def chain(dims):
        ws = [torch.from_numpy(rng.uniform(-1, 1, (a, b)).astype(np.float32)
                               / np.float32(np.sqrt(a)))
              for a, b in zip(dims[:-1], dims[1:])]
        bs = [torch.from_numpy(rng.uniform(-.1, .1, b).astype(np.float32))
              for b in dims[1:]]
        ln = (torch.from_numpy(rng.uniform(.5, 1.5, dims[-1]).astype(
            np.float32)), torch.from_numpy(rng.uniform(
                -.1, .1, dims[-1]).astype(np.float32)))
        return ws, bs, ln
    edge, node = chain([H + 2 * fv, H, H, H]), chain([H + fv, H, H, H])
    e = torch.from_numpy(rng.normal(size=(V * k, H)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(V, fv)).astype(np.float32))
    senders = torch.from_numpy(rng.integers(0, V, V * k).astype(np.int32))
    vs = v @ edge[0][0][H:H + fv]
    return e, vs, v, senders, edge, node


def _double(chain):
    ws, bs, ln = chain
    return ([w.double() for w in ws], [b.double() for b in bs],
            tuple(t.double() for t in ln) if ln else None)


def _scaled(out, ref):
    return ((out.double() - ref).abs().max() / max(1.0, ref.abs().max())).item()


def test_tf32_rounds_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11,
                      -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0,
                      float("inf"), float("nan")], dtype=torch.float32)
    got = tf32(x)
    want = [1.0 + 2.0 ** -10, 1.0 + 2 * 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
            3.0, float("inf")]
    assert got[:6].tolist() == want and torch.isnan(got[6])
    # the kernels' split: hi + lo is within 2^-22 of x
    y = torch.from_numpy(np.random.default_rng(0).normal(size=4096).astype(
        np.float32))
    hi = tf32_hi(y)
    assert torch.equal(tf32_hi(hi), hi) and (hi.abs() <= y.abs()).all()
    rel = ((hi + tf32(y - hi)).double() - y.double()).abs() / y.double().abs()
    assert rel.max().item() <= 2.0 ** -22


@pytest.mark.parametrize("fv", [128, 256])
def test_3xtf32_gn_block_meets_the_f32_gate(rng, fv):
    """gn_block_plain with every product as 3xTF32, against float64, at
    k = 6 and H = 128: within 2e-4 of max(1, max |ref|), where one TF32
    product per f32 one is not held to it as closely."""
    V, k, H = 256, 6, 128
    e, vs, v, senders, edge, node = _gn_inputs(rng, V, k, H, fv)
    ref = port_gn.gn_block_plain(e.double(), vs.double(), v.double(),
                                 senders, k, _double(edge), _double(node),
                                 out_selu=True)
    errs = {}
    for terms in (3, 1):
        with TF32Products(terms):
            got = port_gn.gn_block_plain(e, vs, v, senders, k, edge, node,
                                         out_selu=True)
        errs[terms] = max(_scaled(a, b) for a, b in zip(got, ref))
    print(f"fv={fv}: 3xTF32 {errs[3]:.2e}, 1xTF32 {errs[1]:.2e} of "
          f"max(1, max|ref|) (gate {GATE})")
    assert errs[3] <= GATE
    assert errs[1] > 10 * errs[3]


def ordered_sum(parts: torch.Tensor) -> torch.Tensor:
    """The sum over the first axis of ``parts`` in the backward reduction's
    order: eight running sums over ``g = w, w + 8, ...`` (``w`` = 0..7),
    each in order, then added in order of ``w``."""
    lanes = []
    for w in range(min(8, parts.shape[0])):
        acc = parts[w].clone()
        for g in range(w + 8, parts.shape[0], 8):
            acc += parts[g]
        lanes.append(acc)
    out = lanes[0]
    for acc in lanes[1:]:
        out = out + acc
    return out


def wgrad_split_plain(x: torch.Tensor, d: torch.Tensor,
                      chunk: int = None) -> torch.Tensor:
    """``x^T d`` as the weight-gradient kernel computes it: one partial per
    fixed chunk of ``chunk`` rows (the kernel's ``wgrad_chunk`` of the row
    count if None), the partials summed by ``ordered_sum``."""
    chunk = chunk or wgrad_chunk(x.shape[0])
    return ordered_sum(torch.stack([x[r:r + chunk].t() @ d[r:r + chunk]
                                    for r in range(0, x.shape[0], chunk)]))


def colsum_split_plain(g: torch.Tensor, rows: int) -> torch.Tensor:
    """Column sums of ``g`` as the backward computes them: one partial per
    tile of ``rows`` rows, the partials summed by ``ordered_sum``."""
    return ordered_sum(torch.stack([g[r:r + rows].sum(dim=0)
                                    for r in range(0, g.shape[0], rows)]))


def _chain_operands(h, weights, biases):
    """Forward of a chain's layers 2.. from the first pre-activation ``h``:
    ``(inputs after SELU, pre-activations, last pre-LN output)``."""
    xs, pres = [], []
    for w, b in zip(weights, biases):
        pres.append(h)
        xs.append(selu(h))
        h = torch.addmm(b, xs[-1], w)
    return xs, pres, h


def _chain_cotangents(da, xs, pres, weights):
    """Backward of those layers: ``(the first pre-activation's cotangent,
    the cotangent of each layer's output)``."""
    ds = [None] * len(weights)
    for i in range(len(weights) - 1, -1, -1):
        ds[i] = da
        da = (da @ weights[i].t()) * dselu(pres[i])
    return da, ds


def _ln_bwd_split(g, out, scale, rows):
    """``layer_norm_bwd`` with its scale and bias gradients summed per tile
    of ``rows`` rows, in the backward's order."""
    da, _, _ = layer_norm_bwd(g, out, scale)
    xhat = F.layer_norm(out, out.shape[-1:], eps=LN_EPS)
    return da, (colsum_split_plain(g * xhat, rows),
                colsum_split_plain(g, rows))


def gn_block_bwd_split_plain(e, vs, v, senders, sender_sort, k: int,
                             edge, node, gv, ge, *,
                             out_selu: bool = False, chunk: int = None):
    """``gn_block_bwd_plain`` with every weight, bias and LayerNorm gradient
    summed in the backward kernel's order: each ``dW = X^T D`` over fixed
    chunks of ``chunk`` rows (``wgrad_split_plain``), each column sum over
    the kernel's tiles (``tile_receivers(k)`` receivers and their edges),
    from the per-row operands the tile kernel writes (``chunk`` None: each
    product's ``wgrad_chunk``).  Returns what ``gn_block_bwd_plain``
    returns."""
    (ew, eb, eln), (nw, nb, nln) = edge, node
    V, fe, fv = v.shape[0], e.shape[1], v.shape[1]
    nrows, erows = tile_receivers(k), tile_receivers(k) * k
    perm, srt = _sender_sort(senders, sender_sort)
    wsplit = lambda x, d: wgrad_split_plain(x, d, chunk)  # noqa: E731
    with torch.no_grad():
        h1 = _first_edge_layer(e, vs, v, senders, k, ew, eb, None)
        exs, epres, e_pre = _chain_operands(h1, ew[1:], eb[1:])
        e_new = layer_norm(e_pre, *eln) if eln else e_pre
        aggr = aggregate_fixed_k(e_new, k, V)
        fa = aggr.shape[1]
        wa, wv = nw[0][:fa], nw[0][fa:]
        hn = aggr @ wa + v @ wv + nb[0]
        nxs, npres, v_pre = _chain_operands(hn, nw[1:], nb[1:])
        v_new = layer_norm(v_pre, *nln) if nln else v_pre
        if out_selu:
            gv = gv * dselu(v_new)
            ge = ge * dselu(e_new) if ge is not None else None
        dnln = None
        if nln:
            gv, dnln = _ln_bwd_split(gv, v_pre, nln[0], nrows)
        dhn, nds = _chain_cotangents(gv, nxs, npres, nw[1:])
        dnw = [torch.cat([wsplit(aggr, dhn), wsplit(v, dhn)])] + [
            wsplit(x, d) for x, d in zip(nxs, nds)]
        dnb = [colsum_split_plain(d, nrows) for d in [dhn] + nds]
        de_new = repeat_k(dhn @ wa.t() / k, k)
        if ge is not None:
            de_new = ge + de_new
        deln = None
        if eln:
            de_new, deln = _ln_bwd_split(de_new, e_pre, eln[0], erows)
        dh1, eds = _chain_cotangents(de_new, exs, epres, ew[1:])
        we, wr = _split_first(ew[0], fe, fv)
        dvr = dh1.reshape(V, k, -1).sum(dim=1)
        dew = [torch.cat([wsplit(e, dh1),
                          torch.zeros_like(ew[0][fe:ew[0].shape[0] - fv]),
                          wsplit(v, dvr)])] + [
            wsplit(x, d) for x, d in zip(exs, eds)]
        deb = [colsum_split_plain(d, erows) for d in [dh1] + eds]
        de = dh1 @ we.t()
        dv = dhn @ wv.t() + dvr @ wr.t()
    dvs = sorted_segment_sum_plain(dh1, perm, srt, vs.shape[0])
    return de, dv, dvs, (dew, deb, deln), (dnw, dnb, dnln)


@pytest.mark.parametrize("V,k,chunk", [(400, 6, WGRAD_CHUNK),
                                       (203, 5, 64), (150, 2, 64),
                                       (40, 13, 64)])
def test_split_weight_gradients_match_the_plain_backward(rng, V, k, chunk):
    """The backward's order (chunks of ``chunk`` rows, tiles of
    ``tile_receivers(k)`` receivers, partials summed by ``ordered_sum``)
    against ``gn_block_bwd_plain``, both in float64: dW, db and dLN at 2e-4
    of each tensor's max abs, de, dv and dvs too."""
    H, fv = 32, 48
    e, vs, v, senders, edge, node = _gn_inputs(rng, V, k, H, fv)
    gv = torch.from_numpy(rng.normal(size=(V, H)))
    ge = torch.from_numpy(rng.normal(size=(V * k, H)))
    args = (e.double(), vs.double(), v.double(), senders, None, k,
            _double(edge), _double(node), gv, ge)
    got = gn_block_bwd_split_plain(*args, out_selu=True, chunk=chunk)
    ref = port_gn.gn_block_bwd_plain(*args, out_selu=True)
    flat = lambda r: [r[0], r[1], r[2], *r[3][0], *r[3][1], *r[3][2],
                      *r[4][0], *r[4][1], *r[4][2]]  # noqa: E731
    for a, b in zip(flat(got), flat(ref)):
        assert a.shape == b.shape
        _close_to_max(a.numpy(), b.numpy(), GATE)
    assert not got[3][0][0][H:H + fv].any()      # the Ws rows


@pytest.mark.parametrize("rows,chunk", [(242688, 2048), (131072, 2048),
                                        (40448, 512), (14336, 256),
                                        (100, 256)])
def test_wgrad_chunk_keeps_products_spread(rows, chunk):
    """``wgrad_chunk`` (the kernels' rule, ``csrc/wgrad.cuh``): 2048 rows,
    halved down to 256 while a product would have fewer than 64
    partials."""
    assert wgrad_chunk(rows) == chunk
    assert chunk == 256 or -(-rows // chunk) >= 64


def test_ordered_sum_is_the_reduction_order():
    """Eight running sums over g = w, w + 8, ..., then added in order."""
    parts = torch.from_numpy(np.random.default_rng(1).normal(
        size=(21, 5)).astype(np.float32))
    want = torch.zeros(5)
    lanes = [torch.zeros(5) for _ in range(8)]
    for g in range(21):
        lanes[g % 8] = lanes[g % 8] + parts[g]
    for lane in lanes:
        want = want + lane
    assert torch.equal(ordered_sum(parts), want)
    assert torch.allclose(ordered_sum(parts), parts.sum(0),
                          atol=1e-5)


@pytest.mark.parametrize("out_selu", [False, True])
def test_split_weight_gradients_match_gn_block_fused_vjp(rng, out_selu):
    """``gn_block_bwd_split_plain`` (chunks of 64 rows) against the JAX
    package's ``gn_block_fused`` VJP in interpret mode, at a coarse level
    with pad nodes (fv 128), f32: 2e-4 of each output's max abs."""
    V, k, H, fv = 64, 6, 128, 128
    v, e, vs, senders, params = coarse_case(rng, fv, V)

    def fwd(em, nm, e, vsg, v):
        return pg.gn_block_fused(em, nm, e, vsg, v, k, block=32,
                                 interpret=True,
                                 out_activation="selu" if out_selu else None)

    _, vjp = jax.vjp(fwd, params["edge_mlp"], params["node_mlp"],
                     jnp.asarray(e), jnp.asarray(vs)[jnp.asarray(senders)],
                     jnp.asarray(v))
    gv = rng.normal(size=(V, H)).astype(np.float32)
    ge = rng.normal(size=(V * k, H)).astype(np.float32)
    r_em, r_nm, r_de, r_dvsg, r_dv = vjp((jnp.asarray(ge), jnp.asarray(gv)))
    ref_dvs = np.zeros((V, H), np.float64)
    np.add.at(ref_dvs, senders, np.asarray(r_dvsg, np.float64))
    got = gn_block_bwd_split_plain(
        _t(e), _t(vs), _t(v), torch.from_numpy(senders), _host_sort(senders),
        k, _chain(params["edge_mlp"]), _chain(params["node_mlp"]), _t(gv),
        _t(ge), out_selu=out_selu, chunk=64)
    _assert_bwd(got, [np.asarray(r_de), np.asarray(r_dv), ref_dvs], r_em,
                r_nm, H, fv)


def _chain64(rng, dims, ln):
    """A chain as ``chip_smoke.uniform_chain`` draws it (f32) and its float64
    copy."""
    ws = [torch.from_numpy(rng.uniform(-1, 1, (a, b)).astype(np.float32)
                           / np.float32(np.sqrt(a)))
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.uniform(-1, 1, b).astype(np.float32)
                           / np.float32(np.sqrt(a)))
          for a, b in zip(dims[:-1], dims[1:])]
    ln = ((torch.from_numpy(rng.uniform(.5, 1.5, dims[-1]).astype(
        np.float32)), torch.from_numpy(rng.uniform(-.1, .1, dims[-1]).astype(
            np.float32))) if ln else None)
    return (ws, bs, ln), _double((ws, bs, ln))


#: multiply-adds a row of each chain case's backward needs: the tail
#: (LN, dx) remats both layers, takes dh of both and dW of both; the edge
#: encoder (no LN, no dx) remats layers 0-1 of 3, dh of layers 1-2; the
#: angle encoder (LN, no dx) remats both layers, dh of layer 1 only
CHAIN_BWD_MACS = {
    "tail": 3 * 2 * 128 * 128,
    "mus_edge_encoder": (2 * 128 + 128 * 128) + 2 * 128 * 128
    + (2 * 128 + 2 * 128 * 128),
    "remus_angle_encoder": (4 * 128 + 128 * 128) + 128 * 128
    + (4 * 128 + 128 * 128)}


@pytest.mark.parametrize("case", CHAIN_CASES, ids=[c[0] for c in CHAIN_CASES])
def test_chain_bwd_flops_count_the_work_the_backward_needs(case):
    """The FLOPs behind the chain backward's bounds: 3x the forward's only
    where the backward recomputes every layer and needs every dh."""
    name, rows, dims, ln, _, need_dx, _ = case
    assert chain_bwd_flops(rows, dims, ln, need_dx) == \
        2 * rows * CHAIN_BWD_MACS[name]


@pytest.mark.parametrize("case", CHAIN_CASES, ids=[c[0] for c in CHAIN_CASES])
def test_3xtf32_mlp_chain_meets_the_f32_gate(rng, case):
    """mlp_chain_plain and mlp_chain_bwd_plain with every product as
    3xTF32, against float64, at a chain case's widths with 300 rows: the
    forward within 1e-4 max abs, each backward output within 1e-4 of
    max(1, max |ref|); the rows whose cotangents would flow through a SELU
    input next to its kink get a zero cotangent (``chip_smoke.KINK``)."""
    name, _, dims, ln, preact, need_dx, _ = case
    rows = 300
    (ws, bs, lns), (ws64, bs64, lns64) = _chain64(rng, dims, ln)
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(np.float32))
    g = quiet(torch.from_numpy(rng.normal(size=(rows, dims[-1])).astype(
        np.float32)), chain_kinks(x, ws, bs, preact)[1])
    lnp, lnp64 = lns or (None, None), lns64 or (None, None)
    ref = mlp_chain_plain(x.double(), ws64, bs64, *lnp64,
                          preact_input=preact)
    ref_b = mlp_chain_bwd_plain(x.double(), g.double(), ws64, bs64, lnp64[0],
                                preact_input=preact, need_dx=need_dx)
    flat = lambda r: [t for t in [r[0], *r[1], *r[2], *(r[3] or ())]
                      if t is not None]  # noqa: E731
    errs = {}
    for terms in (3, 1):
        with TF32Products(terms):
            got = mlp_chain_plain(x, ws, bs, *lnp, preact_input=preact)
            got_b = mlp_chain_bwd_plain(x, g, ws, bs, lnp[0],
                                        preact_input=preact, need_dx=need_dx)
        errs[terms] = ((got.double() - ref).abs().max().item(),
                       max(_scaled(a, b) for a, b in zip(flat(got_b),
                                                         flat(ref_b))))
    print(f"{name}: forward max abs 3xTF32 {errs[3][0]:.2e}, 1xTF32 "
          f"{errs[1][0]:.2e}; backward of max(1, max|ref|) 3xTF32 "
          f"{errs[3][1]:.2e}, 1xTF32 {errs[1][1]:.2e} (gate {CHAIN_GATE})")
    assert errs[3][0] <= CHAIN_GATE and errs[3][1] <= CHAIN_GATE
    assert errs[1][0] > errs[3][0] and errs[1][1] > errs[3][1]


def mlp_chain_bwd_split_plain(x, g, weights, biases, ln_scale=None, *,
                              preact_input=False, need_dx=True,
                              chunk=None):
    """``mlp_chain_bwd_plain`` with every weight, bias and LayerNorm
    gradient summed in the backward kernel's order: each ``dW = X^T D``
    over fixed chunks of ``chunk`` rows (``wgrad_split_plain``; None: the
    kernel's ``wgrad_chunk``), each column sum over the kernel's tiles of
    ``TILE_ROWS`` rows.  Returns what ``mlp_chain_bwd_plain`` returns."""
    n, rows = len(weights), TILE_ROWS
    with torch.no_grad():
        h = selu(x) if preact_input else x
        ins, pres = [h], []
        for i, (w, b) in enumerate(zip(weights, biases)):
            a = torch.addmm(b, h, w)
            if i < n - 1:
                pres.append(a)
                h = selu(a)
                ins.append(h)
        dln = None
        if ln_scale is not None:
            da, dln = _ln_bwd_split(g, a, ln_scale, rows)
        else:
            da = g
        dws, dbs, dx = [None] * n, [None] * n, None
        for i in range(n - 1, -1, -1):
            dws[i] = wgrad_split_plain(ins[i], da, chunk)
            dbs[i] = colsum_split_plain(da, rows)
            if i > 0:
                da = (da @ weights[i].t()) * dselu(pres[i - 1])
            elif need_dx:
                dx = da @ weights[0].t()
                dx = dx * dselu(x) if preact_input else dx
    return dx, dws, dbs, dln


@pytest.mark.parametrize("case,chunk", [
    (c, chunk) for c in CHAIN_CASES for chunk in (None, 64)],
    ids=[f"{c[0]}-{chunk or 'kernel'}" for c in CHAIN_CASES
         for chunk in (None, 64)])
def test_chain_split_weight_gradients_match_the_plain_backward(rng, case,
                                                               chunk):
    """The chain backward's order (chunks of ``chunk`` rows, or the
    kernel's ``wgrad_chunk``: 256 rows here; tiles of ``TILE_ROWS`` rows,
    partials summed by ``ordered_sum``) against ``mlp_chain_bwd_plain``,
    both in float64, at a chain case's widths over a ragged last chunk and
    tile: every output at 2e-4 of its max abs."""
    _, _, dims, ln, preact, need_dx, _ = case
    rows = 2 * (chunk or wgrad_chunk(2100)) + 37
    _, (ws, bs, lns) = _chain64(rng, dims, ln)
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])))
    g = torch.from_numpy(rng.normal(size=(rows, dims[-1])))
    s = lns[0] if lns else None
    got = mlp_chain_bwd_split_plain(x, g, ws, bs, s, preact_input=preact,
                                    need_dx=need_dx, chunk=chunk)
    ref = mlp_chain_bwd_plain(x, g, ws, bs, s, preact_input=preact,
                              need_dx=need_dx)
    assert (got[0] is None) == (not need_dx) and (got[3] is None) == (not ln)
    for a, b in zip([got[0], *got[1], *got[2], *(got[3] or ())],
                    [ref[0], *ref[1], *ref[2], *(ref[3] or ())]):
        if a is not None:
            assert a.shape == b.shape
            _close_to_max(a.numpy(), b.numpy(), GATE)


@pytest.mark.parametrize("in_dim,widths,ln,start", [
    (256, (128, 128, 128), True, 1),     # the coarse tail
    (2, (128, 128, 128), False, 0),      # the MuS edge encoder
    (4, (128, 128), True, 0)])           # the REMuS angle encoder
def test_chain_split_weight_gradients_match_fused_mlp_vjp(rng, in_dim,
                                                          widths, ln, start):
    """``mlp_chain_bwd_split_plain`` (chunks of 64 rows) against the JAX
    package's ``fused_mlp`` VJP in interpret mode, f32: dx and every
    gradient at 2e-4 of its max abs."""
    params = init_mlp(jax.random.key(3), in_dim, widths, ln)
    fin = in_dim if start == 0 else widths[0]
    x = rng.normal(size=(512, fin)).astype(np.float32)
    g = rng.normal(size=(512, widths[-1])).astype(np.float32)
    _, vjp = jax.vjp(lambda x, p: fused_mlp(p, x, start=start, block=256,
                                            interpret=True),
                     jnp.asarray(x), params)
    rdx, rparams = vjp(jnp.asarray(g))
    ws, bs, lns = _chain(params)
    dx, dws, dbs, dln = mlp_chain_bwd_split_plain(
        _t(x), _t(g), ws[start:], bs[start:], lns[0] if lns else None,
        preact_input=start > 0, chunk=64)
    _close_to_max(dx.numpy(), np.asarray(rdx), GATE)
    _assert_chain_grads_to_max((dws, dbs, dln), _mlp_grads(rparams),
                               skip=start, frac=GATE)
