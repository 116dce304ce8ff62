"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked ``cuda``: without a card every test here skips (the kernels have no
CPU mode).  On the card, where JAX is not installed, skip the JAX-based
``conftest.py``: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py``.  This file imports neither JAX nor the JAX
package.  The backward comparisons give a zero cotangent to the rows
whose cotangents would flow through a SELU input next to its kink, where
rounding decides the derivative (``chip_smoke.KINK``).
"""
import numpy as np
import pytest
import torch

from chip_smoke import chain_kinks, gn_kink_nodes, quiet, scaled_err
from graphs4cfd_tpu_torch.ops import fused_mlp, gn_block as gn_op

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _chain(rng, dims, ln, dev):
    ws = [torch.from_numpy(rng.uniform(-1, 1, (a, b)).astype(np.float32)
                           / np.float32(np.sqrt(a))).to(dev)
          for a, b in zip(dims[:-1], dims[1:])]
    bs = [torch.from_numpy(rng.uniform(-.1, .1, b).astype(np.float32)).to(dev)
          for b in dims[1:]]
    lns = ((torch.from_numpy(rng.uniform(.5, 1.5, dims[-1]).astype(
        np.float32)).to(dev),
            torch.from_numpy(rng.uniform(-.1, .1, dims[-1]).astype(
                np.float32)).to(dev)) if ln else None)
    return ws, bs, lns


@pytest.mark.parametrize("rows,dims,preact,ln", [
    (1000, [128, 128, 128, 128], False, True),
    (777, [128, 128, 128], True, True),
    (333, [5, 128, 128, 128], False, False),
    (4096, [258, 128, 128, 128], False, True),
    (129, [128, 128, 128, 3], False, False),
    (65, [40, 200, 256], True, True)])
def test_mlp_chain_kernel_matches_plain(dev, rng, rows, dims, preact, ln):
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev)
    ws, bs, lns = _chain(rng, dims, ln, dev)
    before = fused_mlp.mlp_chain.launches
    got = fused_mlp.mlp_chain(x, ws, bs, *(lns or (None, None)),
                              preact_input=preact)
    ref = fused_mlp.mlp_chain_plain(x, ws, bs, *(lns or (None, None)),
                                    preact_input=preact)
    torch.cuda.synchronize()
    assert fused_mlp.mlp_chain.launches == before + 1
    assert (got - ref).abs().max().item() <= 1e-4


@pytest.mark.parametrize("V,k,H,skip_e,out_selu", [
    (1000, 6, 128, False, True), (1001, 6, 128, True, True),
    (500, 4, 64, False, False), (300, 2, 32, False, True),
    (203, 5, 48, False, True)])
def test_gn_block_kernel_matches_plain(dev, rng, V, k, H, skip_e, out_selu):
    v = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev)
    senders = torch.from_numpy(rng.integers(0, V, V * k).astype(
        np.int32)).to(dev)
    edge = _chain(rng, [3 * H, H, H, H], True, dev)
    node = _chain(rng, [2 * H, H, H, H], True, dev)
    vs = v @ edge[0][0][H:2 * H]
    before = gn_op.gn_block.launches
    got = gn_op.gn_block(e, vs, v, senders, k, edge, node,
                         out_selu=out_selu, skip_e_out=skip_e)
    ref = gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                               out_selu=out_selu, skip_e_out=skip_e)
    torch.cuda.synchronize()
    assert gn_op.gn_block.launches == before + 1
    assert (got[0] - ref[0]).abs().max().item() <= 2e-4
    if skip_e:
        assert got[1] is None
    else:
        assert (got[1] - ref[1]).abs().max().item() <= 2e-4


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(10, 8, device=dev)
    with pytest.raises(ValueError):      # f64
        fused_mlp.mlp_chain(x.double(), [torch.zeros(8, 4, device=dev,
                                                     dtype=torch.float64)],
                            [torch.zeros(4, device=dev,
                                         dtype=torch.float64)])
    with pytest.raises(ValueError):      # output wider than 256
        fused_mlp.mlp_chain(x, [torch.zeros(8, 300, device=dev)],
                            [torch.zeros(300, device=dev)])
    # a tensor that requires a gradient reaches the backward kernel
    w = torch.zeros(8, 4, device=dev, requires_grad=True)
    before = fused_mlp.mlp_chain_bwd.launches
    fused_mlp.mlp_chain(x, [w], [torch.zeros(4, device=dev)]).sum().backward()
    torch.cuda.synchronize()
    assert fused_mlp.mlp_chain_bwd.launches == before + 1
    assert torch.equal(w.grad, torch.zeros_like(w))


def _flat_bwd(out):
    """The outputs of a backward as one list of tensors."""
    flat = []
    for t in out:
        if isinstance(t, torch.Tensor):
            flat.append(t)
        elif isinstance(t, (list, tuple)):
            flat += _flat_bwd(t)
    return flat


@pytest.mark.parametrize("rows,dims,preact,ln", [
    (1000, [128, 128, 128, 128], False, True),
    (777, [128, 128, 128], True, True),
    (333, [5, 128, 128, 128], False, False),
    (4096, [258, 128, 128, 128], False, True),
    (129, [128, 128, 128, 3], False, False),
    (65, [40, 100, 64], True, True)])
def test_mlp_chain_bwd_kernel_matches_plain(dev, rng, rows, dims, preact, ln):
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(rows, dims[-1])).astype(
        np.float32)).to(dev)
    ws, bs, lns = _chain(rng, dims, ln, dev)
    s = lns[0] if lns else None
    g = quiet(g, chain_kinks(x, ws, bs, preact)[1])
    before = fused_mlp.mlp_chain_bwd.launches
    got = fused_mlp.mlp_chain_bwd(x, g, ws, bs, s, preact_input=preact)
    ref = fused_mlp.mlp_chain_bwd_plain(x, g, ws, bs, s, preact_input=preact)
    torch.cuda.synchronize()
    assert fused_mlp.mlp_chain_bwd.launches == before + 1
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert scaled_err(a, b) <= 1e-4
    skip = fused_mlp.mlp_chain_bwd(x, g, ws, bs, s, preact_input=preact,
                                   need_dx=False)
    assert skip[0] is None
    assert all(torch.equal(a, b) for a, b in zip(_flat_bwd(skip),
                                                 _flat_bwd(got)[1:]))


def _gn_case(rng, V, k, H, dev):
    v = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(dev)
    e = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev)
    senders = torch.from_numpy(rng.integers(0, V, V * k).astype(
        np.int32)).to(dev)
    edge = _chain(rng, [3 * H, H, H, H], True, dev)
    node = _chain(rng, [2 * H, H, H, H], True, dev)
    gv = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(dev)
    ge = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev)
    return v, e, senders, edge, node, v @ edge[0][0][H:2 * H], gv, ge


@pytest.mark.parametrize("V,k,H,skip_e,out_selu", [
    (1000, 6, 128, False, True), (1001, 6, 128, True, True),
    (500, 4, 64, False, False), (300, 2, 32, False, True),
    (203, 5, 48, False, True)])
def test_gn_block_bwd_kernel_matches_plain(dev, rng, V, k, H, skip_e,
                                           out_selu):
    v, e, senders, edge, node, vs, gv, ge = _gn_case(rng, V, k, H, dev)
    kinked = gn_kink_nodes(e, vs, v, senders, k, edge, node, out_selu)
    gv = quiet(gv, kinked)
    ge = None if skip_e else quiet(ge, kinked.repeat_interleave(k))
    before = gn_op.gn_block_bwd.launches
    got = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge, node, gv, ge,
                             out_selu=out_selu)
    ref = gn_op.gn_block_bwd_plain(e, vs, v, senders, None, k, edge, node,
                                   gv, ge, out_selu=out_selu)
    torch.cuda.synchronize()
    assert gn_op.gn_block_bwd.launches == before + 1
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert scaled_err(a, b) <= 2e-4
    assert not got[3][0][0][H:2 * H].any()      # the Ws rows


def test_backward_kernels_are_deterministic(dev, rng):
    """Two launches of each backward kernel give the same bits."""
    v, e, senders, edge, node, vs, gv, ge = _gn_case(rng, 3000, 6, 128, dev)
    runs = [_flat_bwd(gn_op.gn_block_bwd(e, vs, v, senders, None, 6, edge,
                                         node, gv, ge, out_selu=True))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    ws, bs, lns = _chain(rng, [128, 128, 128], True, dev)
    runs = [_flat_bwd(fused_mlp.mlp_chain_bwd(e, e[:, :128].contiguous(),
                                              ws, bs, lns[0],
                                              preact_input=True))
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_segment_sums_are_deterministic(dev, rng):
    """The coarse-level reductions give the same bits on every run."""
    from graphs4cfd_tpu_torch.ops.segment import segment_mean
    E, n, F = 242688, 14336, 128
    src = torch.from_numpy(rng.normal(size=(E, F)).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-1, n, E).astype(np.int32)).to(dev)
    mask = idx >= 0
    runs = [segment_mean(src, idx, n, mask=mask) for _ in range(3)]
    ref = segment_mean(src.cpu().double(), idx.cpu(), n, mask=mask.cpu())
    assert all(torch.equal(runs[0], r) for r in runs[1:])
    assert (runs[0].cpu().double() - ref).abs().max().item() <= 1e-5


def _foreign_table_case(rng, V, S, k, fe, fs, fv, H, dev):
    """A GN block whose sender table has S != V rows and whose source
    width fs need not be fv (REMuS ``down_edge_mp``)."""
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    src = t(S, fs)
    edge = _chain(rng, [fe + fs + fv, H, H], True, dev)
    node = _chain(rng, [H + fv, H, H], True, dev)
    senders = torch.from_numpy(rng.integers(0, S, V * k).astype(
        np.int32)).to(dev)
    vs = src @ edge[0][0][fe:fe + fs]
    return t(V * k, fe), vs, t(V, fv), senders, edge, node


@pytest.mark.parametrize("V,S,k,fe,fs,fv,H,skip_e", [
    (2003, 9000, 5, 128, 128, 128, 128, True),    # down_edge_mp
    (4000, 4000, 5, 128, 128, 128, 128, False),   # edge_mp
    (301, 77, 5, 16, 48, 32, 64, False),
    (150, 1000, 3, 40, 24, 8, 32, True)])
def test_gn_block_kernel_takes_a_foreign_table(dev, rng, V, S, k, fe, fs,
                                               fv, H, skip_e):
    e, vs, v, senders, edge, node = _foreign_table_case(
        rng, V, S, k, fe, fs, fv, H, dev)
    before = gn_op.gn_block.launches
    got = gn_op.gn_block(e, vs, v, senders, k, edge, node, out_selu=True,
                         skip_e_out=skip_e)
    ref = gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                               out_selu=True, skip_e_out=skip_e)
    torch.cuda.synchronize()
    assert gn_op.gn_block.launches == before + 1
    assert (got[0] - ref[0]).abs().max().item() <= 2e-4
    if skip_e:
        assert got[1] is None
    else:
        assert (got[1] - ref[1]).abs().max().item() <= 2e-4
    # a sender outside the table poisons its receiver and no other node
    bad = senders.clone()
    bad[3 * k + 1] = S
    out = gn_op.gn_block(e, vs, v, bad, k, edge, node, out_selu=True)[0]
    rows = torch.isnan(out).any(dim=1)
    assert rows[3].item() and int(rows.sum()) == 1


def test_gn_block_bwd_kernel_takes_a_foreign_table(dev, rng):
    V, S, k, fe, fs, fv, H = 301, 77, 5, 16, 48, 32, 64
    e, vs, v, senders, edge, node = _foreign_table_case(
        rng, V, S, k, fe, fs, fv, H, dev)
    kinked = gn_kink_nodes(e, vs, v, senders, k, edge, node, True)
    gv = quiet(torch.from_numpy(rng.normal(size=(V, H)).astype(
        np.float32)).to(dev), kinked)
    ge = quiet(torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev), kinked.repeat_interleave(k))
    got = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge, node, gv,
                             ge, out_selu=True)
    ref = gn_op.gn_block_bwd_plain(e, vs, v, senders, None, k, edge, node,
                                   gv, ge, out_selu=True)
    torch.cuda.synchronize()
    assert got[2].shape == (S, H)
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert scaled_err(a, b) <= 2e-4
    assert not got[3][0][0][fe:fe + fs].any()      # the Ws rows


@pytest.mark.parametrize("bad", [77, -1, 1 << 30])
def test_gn_block_bwd_kernel_gives_nan_for_a_sender_outside_the_table(
        dev, rng, bad):
    """As in the forward: the receiver of a sender outside [0, S) gets NaN
    gradient rows (its k edges' ``de``, its ``dv``); the other receivers'
    rows stay finite, and the table is never read outside its rows."""
    V, S, k, fe, fs, fv, H = 301, 77, 5, 16, 48, 32, 64
    e, vs, v, senders, edge, node = _foreign_table_case(
        rng, V, S, k, fe, fs, fv, H, dev)
    gv = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(dev)
    ge = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev)
    senders[7 * k + 2] = bad
    de, dv, dvs, _, _ = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge,
                                           node, gv, ge, out_selu=True)
    torch.cuda.synchronize()
    bad_edges = torch.zeros(V * k, dtype=torch.bool, device=dev)
    bad_edges[7 * k:8 * k] = True
    assert bool(torch.isnan(de[bad_edges]).all(dim=1).all())
    assert bool(torch.isfinite(de[~bad_edges]).all())
    rows = torch.isnan(dv).any(dim=1)
    assert rows[7].item() and int(rows.sum()) == 1
    assert dvs.shape == (S, H)


@pytest.mark.parametrize("V,S,skip_e", [
    (19 * 60 + 9, 4000, False),    # EdgeMP: a partial last tile of 9
    (19 * 40 + 1, 6000, True)])    # down_edge_mp: S > V, e' not stored
def test_gn_block_bwd_kernel_at_line_graph_shapes(dev, rng, V, S, skip_e):
    """k = 5 at width 128 (a 96-row tile holds 19 receivers and a tail
    row), a table of S rows of which some are never read, the host sort
    of the sources passed in."""
    k, H = 5, 128
    e, vs, v, senders, edge, node = _foreign_table_case(
        rng, V, S, k, H, H, H, H, dev)
    senders = senders % (S - 50)
    kinked = gn_kink_nodes(e, vs, v, senders, k, edge, node, True)
    gv = quiet(torch.from_numpy(rng.normal(size=(V, H)).astype(
        np.float32)).to(dev), kinked)
    ge = None if skip_e else quiet(torch.from_numpy(rng.normal(
        size=(V * k, H)).astype(np.float32)).to(dev),
        kinked.repeat_interleave(k))
    srt, perm = torch.sort(senders, stable=True)
    sort = (perm.int(), srt.int())
    got = gn_op.gn_block_bwd(e, vs, v, senders, sort, k, edge, node, gv, ge,
                             out_selu=True)
    ref = gn_op.gn_block_bwd_plain(e, vs, v, senders, sort, k, edge, node,
                                   gv, ge, out_selu=True)
    torch.cuda.synchronize()
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert scaled_err(a, b) <= 2e-4
    assert not got[2][S - 50:].any()
    again = gn_op.gn_block_bwd(e, vs, v, senders, sort, k, edge, node, gv,
                               ge, out_selu=True)
    assert all(torch.equal(a, b) for a, b in zip(_flat_bwd(got),
                                                 _flat_bwd(again)))


def test_sorted_segment_sum_with_a_long_segment_and_empty_ones(dev, rng):
    """The REMuS angle-source transpose: 12,000 pad rows in segment 0 (as
    ``collate`` pads ``angle_src``), and segments no row reads (zeros)."""
    from graphs4cfd_tpu_torch.ops import segment
    rows, nseg, F = 60000, 30000, 128
    idx = rng.integers(0, nseg - 100, rows).astype(np.int32)
    idx[-12000:] = 0
    src = torch.from_numpy(rng.normal(size=(rows, F)).astype(
        np.float32)).to(dev)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    perm_t = torch.from_numpy(perm).to(dev)
    srt_t = torch.from_numpy(idx[perm]).to(dev)
    got = segment.sorted_segment_sum(src, perm_t, srt_t, nseg)
    ref = segment.sorted_segment_sum_plain(src, perm_t, srt_t, nseg)
    torch.cuda.synchronize()
    assert scaled_err(got, ref) <= 1e-5
    assert not got[nseg - 100:].any()
    assert torch.equal(got, segment.sorted_segment_sum(src, perm_t, srt_t,
                                                       nseg))


def _wide_case(rng, V, k, H, fv, layers, dev):
    """A gMuS block after an up step: the node input ``v`` is ``fv`` wide
    (256 for ``mp121``/``mp221``), the chains ``H`` wide."""
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    edge = _chain(rng, [H + 2 * fv] + [H] * layers, True, dev)
    node = _chain(rng, [H + fv] + [H] * layers, True, dev)
    v, e = t(V, fv), t(V * k, H)
    senders = torch.from_numpy(rng.integers(0, V, V * k).astype(
        np.int32)).to(dev)
    return e, v @ edge[0][0][H:H + fv], v, senders, edge, node


@pytest.mark.parametrize("V,k,H,fv,layers,skip_e", [
    (1000, 6, 128, 256, 3, False),    # mp121 / mp221
    (1001, 6, 128, 256, 3, True),     # a partial last tile, e' not stored
    (203, 5, 128, 256, 2, False),     # k = 5, two-layer chains
    (300, 4, 64, 200, 3, False),      # dv in slices of 64: 64, 64, 64, 8
    (150, 6, 32, 96, 2, True)])       # narrow chains, dv in three slices
def test_gn_block_kernels_take_a_wide_node_input(dev, rng, V, k, H, fv,
                                                 layers, skip_e):
    """The forward and backward kernels with ``fv`` up to 256 against their
    plain versions: 2e-4 forward, 2e-4 of max(1, max |ref|) backward, the
    kinked rows given a zero cotangent; two backward launches give the
    same bits."""
    e, vs, v, senders, edge, node = _wide_case(rng, V, k, H, fv, layers, dev)
    got = gn_op.gn_block(e, vs, v, senders, k, edge, node, out_selu=True,
                         skip_e_out=skip_e)
    ref = gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                               out_selu=True, skip_e_out=skip_e)
    torch.cuda.synchronize()
    assert (got[0] - ref[0]).abs().max().item() <= 2e-4
    if skip_e:
        assert got[1] is None
    else:
        assert (got[1] - ref[1]).abs().max().item() <= 2e-4
    kinked = gn_kink_nodes(e, vs, v, senders, k, edge, node, True)
    gv = quiet(torch.from_numpy(rng.normal(size=(V, H)).astype(
        np.float32)).to(dev), kinked)
    ge = None if skip_e else quiet(torch.from_numpy(rng.normal(
        size=(V * k, H)).astype(np.float32)).to(dev),
        kinked.repeat_interleave(k))
    got = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge, node, gv, ge,
                             out_selu=True)
    ref = gn_op.gn_block_bwd_plain(e, vs, v, senders, None, k, edge, node,
                                   gv, ge, out_selu=True)
    torch.cuda.synchronize()
    assert got[1].shape == (V, fv)
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert scaled_err(a, b) <= 2e-4
    assert not got[3][0][0][H:H + fv].any()     # the Ws rows
    again = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge, node, gv,
                               ge, out_selu=True)
    assert all(torch.equal(a, b) for a, b in zip(_flat_bwd(got),
                                                 _flat_bwd(again)))


def test_gn_block_kernels_refuse_what_they_do_not_take(dev, rng):
    """A node input wider than 256 is refused by both kernels; the
    backward of three-layer chains at k = 5 with ``fv`` 256 does not fit
    shared memory and is refused too (the forward takes it)."""
    e, vs, v, senders, edge, node = _wide_case(rng, 40, 6, 128, 264, 3, dev)
    gv = torch.zeros(40, 128, device=dev)
    with pytest.raises(ValueError):
        gn_op.gn_block(e, vs, v, senders, 6, edge, node)
    with pytest.raises(ValueError):
        gn_op.gn_block_bwd(e, vs, v, senders, None, 6, edge, node, gv, None)
    e, vs, v, senders, edge, node = _wide_case(rng, 40, 5, 128, 256, 3, dev)
    gn_op.gn_block(e, vs, v, senders, 5, edge, node)
    with pytest.raises(ValueError):
        gn_op.gn_block_bwd(e, vs, v, senders, None, 5, edge, node, gv, None)
