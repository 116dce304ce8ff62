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
    (65, [40, 200, 256], True, True),
    # the tensor-core kernel's narrow inputs (padded to 8 columns), a
    # 1-wide output, an input whose rows are not 16-byte units, and ragged
    # last tiles of 96 rows
    (1000, [2, 128, 128, 128], False, False),
    (777, [4, 128, 128], False, True),
    (300, [128, 128, 1], False, False),
    (97, [258, 128, 128], False, True),
    (203, [5, 128, 128, 128], False, False),
    # 96-row tiles (32,768 rows and more), a ragged last one
    (33000, [128, 128, 128], True, True)])
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
    (65, [40, 100, 64], True, True),
    # as in the forward; each also runs without dx (the encoders' case)
    (1000, [2, 128, 128, 128], False, False),
    (777, [4, 128, 128], False, True),
    (300, [128, 128, 1], False, False),
    (97, [258, 128, 128], False, True),
    (203, [5, 128, 128, 128], False, False),
    (33000, [128, 128, 128], True, True)])
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


@pytest.mark.parametrize("rows,dims,preact,ln,need_dx", [
    (40000, [2, 128, 128, 128], False, False, False),
    (5000, [128, 128, 128], True, True, True)])
def test_tensor_core_chain_backward_gives_the_same_bits(dev, rng, rows, dims,
                                                       preact, ln, need_dx):
    """The three launches of the chain backward over several
    weight-gradient chunks and tiles: two calls give the same bits, and so
    do the three parts launched one at a time (as ``chip_smoke`` times
    them)."""
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(rows, dims[-1])).astype(
        np.float32)).to(dev)
    ws, bs, lns = _chain(rng, dims, ln, dev)
    args = (x, g, ws, bs, lns[0] if lns else None, preact, need_dx)
    runs = [_flat_bwd(fused_mlp._launch_bwd(*args)) for _ in range(2)]
    events = [torch.cuda.Event() for _ in range(3)]
    runs.append(_flat_bwd(fused_mlp._launch_bwd(*args, events=events)))
    torch.cuda.synchronize()
    assert len(runs[0]) == 2 * (len(dims) - 1) + 2 * ln + need_dx
    for run in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], run))


@pytest.mark.parametrize("dims,preact,ln", [
    ([3, 128, 128], False, True), ([128, 128, 128, 3], True, False)])
def test_mlp_chain_forward_bits_do_not_depend_on_the_tile_shape(dev, rng,
                                                                dims, preact,
                                                                ln):
    """The forward takes 64-row tiles below 32,768 rows and 96-row tiles
    from there: a row's outputs are the same bits either way (the same
    products in the same order)."""
    x = torch.from_numpy(rng.normal(size=(32768, dims[0])).astype(
        np.float32)).to(dev)
    ws, bs, lns = _chain(rng, dims, ln, dev)
    lnp = lns or (None, None)
    big = fused_mlp.mlp_chain(x, ws, bs, *lnp, preact_input=preact)
    small = fused_mlp.mlp_chain(x[:32767].contiguous(), ws, bs, *lnp,
                                preact_input=preact)
    torch.cuda.synchronize()
    assert torch.equal(big[:32767], small)


def test_gn_kernels_take_no_receivers(dev, rng):
    """At V = 0 both GN kernels' wrappers give what the plain versions
    give: empty activations and activation gradients, a zero ``dvs`` over
    the table's rows, zero parameter gradients; nothing is launched."""
    k, H, S = 6, 128, 7
    edge = _chain(rng, [3 * H, H, H, H], True, dev)
    node = _chain(rng, [2 * H, H, H, H], True, dev)
    e, v = torch.zeros(0, H, device=dev), torch.zeros(0, H, device=dev)
    vs = torch.from_numpy(rng.normal(size=(S, H)).astype(np.float32)).to(dev)
    senders = torch.zeros(0, dtype=torch.int32, device=dev)
    before = (gn_op.gn_block.launches, gn_op.gn_block_bwd.launches)
    got = gn_op.gn_block(e, vs, v, senders, k, edge, node, out_selu=True)
    ref = gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                               out_selu=True)
    assert [t.shape for t in got] == [t.shape for t in ref]
    zero = torch.zeros(0, H, device=dev)
    got = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge, node, zero,
                             zero, out_selu=True)
    ref = gn_op.gn_block_bwd_plain(e, vs, v, senders, None, k, edge, node,
                                   zero, zero, out_selu=True)
    torch.cuda.synchronize()
    assert len(_flat_bwd(got)) == len(_flat_bwd(ref))
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert a.shape == b.shape and torch.equal(a, b)
    assert got[2].shape == (S, H)
    assert (gn_op.gn_block.launches, gn_op.gn_block_bwd.launches) == before


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


def _segment_case(rng, rows, nseg, F, pile, dev):
    """``rows`` rows over ``nseg`` segments drawn at random, ``pile`` of
    them (the last ones) moved onto segment 0 as ``collate`` piles pad
    rows; ``(src, perm, sorted)`` on ``dev``."""
    idx = rng.integers(0, nseg, rows).astype(np.int32)
    idx[rows - pile:] = 0
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    src = rng.normal(size=(rows, F)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (src, perm, idx[perm]))


def _hold_segment_sum(src, perm, srt, nseg):
    """The kernel against its plain version: within 1e-5 of max(1, max
    |ref|), zeros where no row goes, the same bits on two launches, and
    the plain version's bits in every segment one warp adds (at most
    ``LONG_ROWS`` rows)."""
    from graphs4cfd_tpu_torch.ops import segment
    got = segment.sorted_segment_sum(src, perm, srt, nseg)
    ref = segment.sorted_segment_sum_plain(src, perm, srt, nseg)
    again = segment.sorted_segment_sum(src, perm, srt, nseg)
    torch.cuda.synchronize()
    counts = torch.bincount(srt.long(), minlength=nseg)
    assert got.shape == ref.shape == (nseg, src.shape[1])
    assert scaled_err(got, ref) <= 1e-5
    assert not got[counts == 0].any()
    assert torch.equal(got, again)
    short = counts <= segment.LONG_ROWS
    assert torch.equal(got[short], ref[short])


@pytest.mark.parametrize("rows,nseg,F,pile", [
    (242688, 40448, 128, 0),        # MuS level-1 dvs
    (512000, 102400, 128, 12000),   # REMuS level-1 angle sources, the pile
    (115200, 102400, 128, 0),       # REMuS down_edge_mp, most segments empty
    (121344, 21824, 128, 0),        # GP dvs, part 0 of 2
    (1600, 20224, 128, 0),          # GP halo transpose
    (5000, 700, 130, 300),          # F not a multiple of 4: 4-byte loads
    (5000, 700, 256, 300),          # two 128-column slices
    (20000, 1, 128, 0),             # one segment takes every row
    (0, 7, 128, 0),                 # no rows
    (0, 20224, 130, 0),             # every segment empty, 4-byte stores
])
def test_sorted_segment_sum_kernel_matches_plain(dev, rng, rows, nseg, F,
                                                 pile):
    _hold_segment_sum(*_segment_case(rng, rows, nseg, F, pile, dev), nseg)


@pytest.mark.parametrize("extra", [-1, 0, 1])
def test_sorted_segment_sum_splits_long_segments(dev, rng, extra):
    """Segments 123 and 124 of L - 1, L or L + 1 rows each (L =
    ``LONG_ROWS``), and segment 321 of 3 L + 5: up to L rows one warp adds
    them; above L the kernel's tile blocks do, and add their partials in
    a fixed order.  Segment 124 follows 123, so one block tile can hold
    the end of one and the start of the other (both of its partials)."""
    from graphs4cfd_tpu_torch.ops import segment
    L = segment.LONG_ROWS
    idx = rng.integers(0, 500, 3000)
    idx = idx[~np.isin(idx, (123, 124, 321))]
    idx = np.concatenate([idx, np.full(L + extra, 123),
                          np.full(L + extra, 124), np.full(3 * L + 5, 321)])
    idx = rng.permutation(idx).astype(np.int32)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    src = torch.from_numpy(rng.normal(size=(idx.shape[0], 128)).astype(
        np.float32)).to(dev)
    _hold_segment_sum(src, torch.from_numpy(perm).to(dev),
                      torch.from_numpy(idx[perm]).to(dev), 600)


@pytest.mark.parametrize("F", [128, 130])
def test_sorted_segment_sum_with_runs_of_every_length(dev, rng, F):
    """Runs of 1 to 300 rows, as a halo table's transposes have: several
    segments of more than ``LONG_ROWS`` rows inside one of the kernel's
    block tiles (summed there), others across block tiles (partials)."""
    counts = rng.integers(1, 300, 400)
    counts[::7] = 0                                  # empty segments
    idx = rng.permutation(np.repeat(np.arange(400), counts)).astype(np.int32)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    src = torch.from_numpy(rng.normal(size=(idx.shape[0], F)).astype(
        np.float32)).to(dev)
    _hold_segment_sum(src, torch.from_numpy(perm).to(dev),
                      torch.from_numpy(idx[perm]).to(dev), 400)


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
    """A node input wider than 256 is refused by both kernels, and so is k
    above 96 (a tile holds at most 96 edge rows).  Three-layer chains at
    k = 5 with ``fv`` 256, which the backward's shared memory refused
    before the kernels moved to the tensor cores, are taken by both."""
    e, vs, v, senders, edge, node = _wide_case(rng, 40, 6, 128, 264, 3, dev)
    gv = torch.zeros(40, 128, device=dev)
    with pytest.raises(ValueError):
        gn_op.gn_block(e, vs, v, senders, 6, edge, node)
    with pytest.raises(ValueError):
        gn_op.gn_block_bwd(e, vs, v, senders, None, 6, edge, node, gv, None)
    e, vs, v, senders, edge, node = _wide_case(rng, 4, 97, 32, 32, 2, dev)
    with pytest.raises(ValueError):
        gn_op.gn_block(e, vs, v, senders, 97, edge, node)
    with pytest.raises(ValueError):
        gn_op.gn_block_bwd(e, vs, v, senders, None, 97, edge, node,
                           torch.zeros(4, 32, device=dev), None)
    e, vs, v, senders, edge, node = _wide_case(rng, 40, 5, 128, 256, 3, dev)
    gn_op.gn_block(e, vs, v, senders, 5, edge, node)
    got = gn_op.gn_block_bwd(e, vs, v, senders, None, 5, edge, node, gv,
                             None)
    torch.cuda.synchronize()
    assert got[1].shape == (40, 256)


def _tc_case(rng, V, k, S, fv, H, layers, dev):
    """A GN block with a sender table of S rows and chains of ``layers``
    layers, H wide, with LayerNorm."""
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    edge = _chain(rng, [H + 2 * fv] + [H] * layers, True, dev)
    node = _chain(rng, [H + fv] + [H] * layers, True, dev)
    senders = torch.from_numpy(rng.integers(0, S, V * k).astype(
        np.int32)).to(dev)
    vs = t(S, fv) @ edge[0][0][H:H + fv]
    return t(V * k, H), vs, t(V, fv), senders, edge, node


@pytest.mark.parametrize("V,k,S,fv,H,layers,skip_e", [
    (16 * 40 + 7, 6, 16 * 40 + 7, 128, 128, 3, False),   # MuS level 1
    (16 * 9 + 5, 5, 500, 256, 128, 2, True),    # a foreign table, fv 256
    (16 * 9 + 5, 5, 500, 256, 128, 3, False),   # 3 layers at fv 256
    (16 * 4 + 3, 2, 70, 128, 128, 3, False),    # 32-row edge tiles
    (7 * 30 + 2, 13, 90, 64, 96, 2, False)])    # 7 receivers per tile
def test_tensor_core_gn_kernels_match_plain(dev, rng, V, k, S, fv, H,
                                            layers, skip_e):
    """The 3xTF32 kernels at k = 2, 5, 6 and 13, V not a multiple of the
    tile, S != V, fv up to 256 (with 3-layer chains at k = 5, which the
    backward refused before the redesign), ``skip_e_out``: the forward
    within 2e-4, the backward within 2e-4 of max(1, max |ref|) of
    ``gn_block_bwd_plain``, the kinked rows given a zero cotangent; two
    launches the same bits."""
    e, vs, v, senders, edge, node = _tc_case(rng, V, k, S, fv, H, layers,
                                             dev)
    got = gn_op.gn_block(e, vs, v, senders, k, edge, node, out_selu=True,
                         skip_e_out=skip_e)
    ref = gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                               out_selu=True, skip_e_out=skip_e)
    torch.cuda.synchronize()
    assert (got[0] - ref[0]).abs().max().item() <= 2e-4
    assert (got[1] is None) if skip_e else (
        (got[1] - ref[1]).abs().max().item() <= 2e-4)
    again = gn_op.gn_block(e, vs, v, senders, k, edge, node, out_selu=True,
                           skip_e_out=skip_e)
    assert torch.equal(got[0], again[0])
    kinked = gn_kink_nodes(e, vs, v, senders, k, edge, node, True)
    gv = quiet(torch.from_numpy(rng.normal(size=(V, H)).astype(
        np.float32)).to(dev), kinked)
    ge = None if skip_e else quiet(torch.from_numpy(rng.normal(
        size=(V * k, H)).astype(np.float32)).to(dev),
        kinked.repeat_interleave(k))
    args = (e, vs, v, senders, None, k, edge, node, gv, ge)
    got = gn_op.gn_block_bwd(*args, out_selu=True)
    ref = gn_op.gn_block_bwd_plain(*args, out_selu=True)
    torch.cuda.synchronize()
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert a.shape == b.shape
        assert scaled_err(a, b) <= 2e-4
    assert not got[3][0][0][H:H + fv].any()     # the Ws rows
    again = gn_op.gn_block_bwd(*args, out_selu=True)
    assert all(torch.equal(a, b) for a, b in zip(_flat_bwd(got),
                                                 _flat_bwd(again)))


@pytest.mark.parametrize("bad", [16 * 40 + 7, -5])
def test_tensor_core_gn_kernels_give_nan_for_a_sender_outside_the_table(
        dev, rng, bad):
    """At the flagship widths: a sender outside [0, S) makes its receiver's
    outputs NaN, forward and backward, and no other receiver's."""
    V, k, H = 16 * 40 + 7, 6, 128
    e, vs, v, senders, edge, node = _tc_case(rng, V, k, V, 128, H, 3, dev)
    senders[21 * k + 4] = bad
    vo, eo = gn_op.gn_block(e, vs, v, senders, k, edge, node,
                            out_selu=True)
    rows = torch.isnan(vo).any(dim=1)
    assert rows[21].item() and int(rows.sum()) == 1
    assert int(torch.isnan(eo).any(dim=1).sum()) == 1
    gv = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(dev)
    ge = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev)
    de, dv, _, _, _ = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge,
                                         node, gv, ge, out_selu=True)
    torch.cuda.synchronize()
    bad_edges = torch.zeros(V * k, dtype=torch.bool, device=dev)
    bad_edges[21 * k:22 * k] = True
    assert bool(torch.isnan(de[bad_edges]).all(dim=1).all())
    assert bool(torch.isfinite(de[~bad_edges]).all())
    rows = torch.isnan(dv).any(dim=1)
    assert rows[21].item() and int(rows.sum()) == 1


@pytest.mark.parametrize("S,M,H", [(1000, 5000, 128), (77, 300, 64),
                                   (500, 2000, 130), (40, 10, 3)])
def test_gather_rows_kernel_matches_plain(dev, rng, S, M, H):
    """Row gathers from a halo table: the forward is a copy (exact), the
    backward the sorted per-row sum over a host sort."""
    from graphs4cfd_tpu_torch.ops import gather
    table = torch.from_numpy(rng.normal(size=(S, H)).astype(
        np.float32)).to(dev)
    idx_np = rng.integers(0, S - 3, M).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(dev)
    before = gather.gather_rows.launches
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert gather.gather_rows.launches == before + 1
    assert torch.equal(got, gather.gather_rows_plain(table, idx))
    perm = np.argsort(idx_np, kind="stable").astype(np.int32)
    sort = (torch.from_numpy(perm).to(dev),
            torch.from_numpy(idx_np[perm]).to(dev))
    ct = torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32)).to(dev)
    grads = []
    for s in (sort, None):
        tab = table.clone().requires_grad_()
        gather.gather_rows(tab, idx, s).backward(ct)
        grads.append(tab.grad)
    ref = torch.zeros(S, H, device=dev).index_put_(
        (idx.long(),), ct, accumulate=True)
    torch.cuda.synchronize()
    assert scaled_err(grads[0], ref) <= 1e-5
    assert torch.equal(grads[0], grads[1])
    assert not grads[0][S - 3:].any()


@pytest.mark.parametrize("bad", [-1, 1000, 1 << 30])
def test_gather_rows_kernel_gives_nan_for_an_index_outside_the_table(
        dev, rng, bad):
    from graphs4cfd_tpu_torch.ops import gather
    table = torch.from_numpy(rng.normal(size=(1000, 128)).astype(
        np.float32)).to(dev)
    idx = torch.tensor([3, bad, 999], dtype=torch.int32, device=dev)
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert torch.isnan(got[1]).all()
    assert torch.equal(got[0], table[3]) and torch.equal(got[2], table[999])
    with pytest.raises(ValueError):
        gather.gather_rows(table, idx.long())


@pytest.mark.parametrize("S,M,H", [(1000, 5000, 128), (77, 300, 64),
                                   (500, 2000, 130), (40, 10, 3),
                                   (300, 999, 8)])
def test_gather_rows_bf16_kernel_matches_plain(dev, rng, S, M, H):
    """The bf16 row gather (the bf16 policy's halo tables): the forward
    the plain version's bits, 8 bf16 a lane where a row is a multiple of
    16 bytes; its launch counts in ``gather_rows.bf16``; the backward the
    sorted per-row sum in f32, handed to the table in bf16; a NaN row for
    an index outside the table."""
    from graphs4cfd_tpu_torch.ops import gather
    table = torch.from_numpy(rng.normal(size=(S, H)).astype(
        np.float32)).to(dev).bfloat16()
    idx_np = rng.integers(0, S - 3, M).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(dev)
    before = (gather.gather_rows.launches, gather.gather_rows.bf16.launches)
    got = gather.gather_rows(table, idx)
    torch.cuda.synchronize()
    assert (gather.gather_rows.launches,
            gather.gather_rows.bf16.launches) == (before[0], before[1] + 1)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, gather.gather_rows_plain(table, idx))
    assert torch.equal(got, gather.gather_rows(table, idx))
    perm = np.argsort(idx_np, kind="stable").astype(np.int32)
    sort = (torch.from_numpy(perm).to(dev),
            torch.from_numpy(idx_np[perm]).to(dev))
    ct = torch.from_numpy(rng.normal(size=(M, H)).astype(
        np.float32)).to(dev).bfloat16()
    tab = table.clone().requires_grad_()
    gather.gather_rows(tab, idx, sort).backward(ct)
    ref = torch.zeros(S, H, device=dev, dtype=torch.float64).index_put_(
        (idx.long(),), ct.double(), accumulate=True)
    torch.cuda.synchronize()
    assert tab.grad.dtype == torch.bfloat16
    assert scaled_err(tab.grad.double(), ref) <= 2 ** -8
    assert not tab.grad[S - 3:].float().any()
    bad = idx.clone()
    bad[M // 2] = S
    assert torch.isnan(gather.gather_rows(table, bad)[M // 2].float()).all()


def test_fit_launches_the_kernels_and_adds_nothing_to_the_steps(dev,
                                                                 tmp_path):
    """A 1-epoch ``fit`` of a small 3-scale MuS model on the card: every
    kernel of the training step launched, and the epoch's loss the same
    bits as ``make_train_step`` called by hand on the same batches from
    the same weights and Adam state."""
    from chip_smoke import flagship_arch, make_samples
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import DataLoader
    from graphs4cfd_tpu_torch.nn import (GraphLoss, NsThreeScaleGNN,
                                         TrainConfig)
    from graphs4cfd_tpu_torch.ops import launch_counts
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    samples = make_samples(4, 600, seed=3)
    loader = lambda: DataLoader(samples, batch_size=2, shuffle=True, seed=1)
    arch = flagship_arch(w=64)
    ref = NsThreeScaleGNN(arch=arch, seed=2, device=dev)
    step = make_train_step(ref, GraphLoss(0.25), 3, 2, 1.0)
    state = adam_init(ref.parameters())
    hand = [step(state, Graph.from_numpy(b, dev), 1e-3, True)[0].item()
            for b in loader()]
    model = NsThreeScaleGNN(arch=arch, seed=2, device=dev)
    cfg = TrainConfig("card", folder=str(tmp_path), num_steps=[2], lr=1e-3,
                      training_loss=GraphLoss(0.25),
                      grad_clip={"epoch": 0, "limit": 1.0})
    (record,) = model.fit(cfg, loader())
    assert record["train_loss"] == (hand[0] + hand[1]) / 2
    assert set(record["launches"]) == set(launch_counts())
    for kernel in ("mlp_chain", "gn_block", "mlp_chain_bwd", "gn_block_bwd",
                   "sorted_segment_sum"):
        assert record["launches"][kernel] > 0, kernel
    assert record["launches"]["gn_block"] == 2 * 2 * 8


@pytest.mark.parametrize("family", ["remus", "gmus"])
def test_fit_hands_the_backward_its_host_sorts(dev, tmp_path, monkeypatch,
                                               family):
    """A 1-epoch ``fit`` of a REMuS and a gMuS model on the card: every
    GN-block backward walks the host sort that the family's
    ``prepare_batch`` attached (none sorts on the card), the epoch
    launches what the hand-called steps launch, every kernel of the
    training step among them, and its loss has their bits."""
    from chip_smoke import (gmus_arch, make_gmus_samples, make_remus_samples,
                            remus_arch)
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import (DataLoader, attach_angle_sorts,
                                             attach_sender_sorts)
    from graphs4cfd_tpu_torch.nn import (GraphLoss, NsRotEquiThreeScaleGNN,
                                         NsThreeGuillardScaleGNN, TrainConfig)
    from graphs4cfd_tpu_torch.ops import launch_counts
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    cls, arch, samples, attach = {
        "remus": (NsRotEquiThreeScaleGNN, remus_arch(),
                  make_remus_samples(4, 600, seed=3), attach_angle_sorts),
        "gmus": (NsThreeGuillardScaleGNN, gmus_arch(),
                 make_gmus_samples(4, 600, seed=3), attach_sender_sorts),
    }[family]
    loader = lambda: DataLoader(samples, batch_size=2, shuffle=True, seed=1,
                                node_bucket=64, edge_bucket=128)
    sorts = []                      # whether each backward had its sort
    real = gn_op._sender_sort

    def spy(senders, sender_sort):
        sorts.append(sender_sort is not None)
        return real(senders, sender_sort)

    monkeypatch.setattr(gn_op, "_sender_sort", spy)
    ref = cls(arch=arch, seed=2, device=dev)
    step = make_train_step(ref, GraphLoss(0.25), ref.num_fields, 2, 1.0)
    state = adam_init(ref.parameters())
    before = launch_counts()
    hand = [step(state, Graph.from_numpy(attach(b), dev), 1e-3, True)[0]
            .item() for b in loader()]
    after = launch_counts()
    hand_launches = {k: after[k] - before[k] for k in after}
    hand_sorts, sorts[:] = list(sorts), []
    model = cls(arch=arch, seed=2, device=dev)
    cfg = TrainConfig(family, folder=str(tmp_path), num_steps=[2], lr=1e-3,
                      training_loss=GraphLoss(0.25),
                      grad_clip={"epoch": 0, "limit": 1.0})
    (record,) = model.fit(cfg, loader())
    assert record["train_loss"] == (hand[0] + hand[1]) / 2
    assert sorts and all(sorts) and sorts == hand_sorts
    assert record["launches"] == hand_launches
    for kernel in ("mlp_chain", "gn_block", "mlp_chain_bwd", "gn_block_bwd",
                   "sorted_segment_sum"):
        assert record["launches"][kernel] > 0, kernel


# ------------------------------------------------------ the bf16 policy
# Each bf16 kernel against its bf16 plain version on the card: the same
# bf16 operands in every product, f32 sums in another order, so an output
# may round one bf16 ulp apart (forward: BF16_TOL of max(1, max |ref|));
# an operand rounded one ulp apart can put a SELU input on the other side
# of its kink, so the backward is held in relative L2 (BF16_L2), as the
# CPU tests hold the plain versions against the JAX kernels
# (tests/test_torch_bf16.py).
BF16_TOL = 8e-3
BF16_L2 = 1e-2
BF = torch.bfloat16


def _l2(a, b):
    a, b = a.double(), b.double()
    return ((a - b).norm() / b.norm().clamp_min(1e-30)).item()


def _bf16_counts():
    from graphs4cfd_tpu_torch.ops import launch_counts
    return launch_counts()


@pytest.mark.parametrize("rows,dims,preact,ln", [
    (1000, [128, 128, 128, 128], False, True),
    (777, [128, 128, 128], True, True),
    (4096, [258, 128, 128, 128], False, True),
    (129, [128, 128, 128, 3], False, False),
    # outputs over 128 wide: the bf16 forward's two-pass (GENERAL) kernel
    (65, [40, 200, 256], True, True),
    (1000, [2, 128, 128, 128], False, False),
    (777, [4, 128, 128], False, True),
    (300, [128, 128, 1], False, False),
    (97, [258, 128, 128], False, True),
    (203, [5, 128, 128, 128], False, False),
    (33000, [128, 128, 128], True, True)])
def test_bf16_mlp_chain_kernel_matches_plain(dev, rng, rows, dims, preact,
                                             ln):
    """Row 1 in bf16 (``csrc/mlp_chain_fwd_bf16.cu``): x and the output
    bf16, the f32 launch count untouched."""
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev).to(BF)
    ws, bs, lns = _chain(rng, dims, ln, dev)
    before = _bf16_counts()
    got = fused_mlp.mlp_chain(x, ws, bs, *(lns or (None, None)),
                              preact_input=preact)
    ref = fused_mlp.mlp_chain_plain(x, ws, bs, *(lns or (None, None)),
                                    preact_input=preact)
    torch.cuda.synchronize()
    after = _bf16_counts()
    assert after["mlp_chain_bf16"] == before["mlp_chain_bf16"] + 1
    assert after["mlp_chain"] == before["mlp_chain"]
    assert got.dtype == ref.dtype == BF
    assert scaled_err(got.float(), ref.float()) <= BF16_TOL


@pytest.mark.parametrize("rows,dims,preact,ln", [
    (1000, [128, 128, 128, 128], False, True),
    (777, [128, 128, 128], True, True),
    (4096, [258, 128, 128, 128], False, True),
    (129, [128, 128, 128, 3], False, False),
    (1000, [2, 128, 128, 128], False, False),
    (97, [258, 128, 128], False, True),
    (40000, [2, 128, 128, 128], False, False),
    (33000, [128, 128, 128], True, True)])
def test_bf16_mlp_chain_bwd_kernel_matches_plain(dev, rng, rows, dims,
                                                 preact, ln):
    """Row 2 in bf16: dx bf16, the parameter gradients f32, two launches
    the same bits."""
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev).to(BF)
    g = torch.from_numpy(rng.normal(size=(rows, dims[-1])).astype(
        np.float32)).to(dev).to(BF)
    ws, bs, lns = _chain(rng, dims, ln, dev)
    s = lns[0] if lns else None
    before = _bf16_counts()
    got = fused_mlp.mlp_chain_bwd(x, g, ws, bs, s, preact_input=preact)
    ref = fused_mlp.mlp_chain_bwd_plain(x, g, ws, bs, s, preact_input=preact)
    again = fused_mlp.mlp_chain_bwd(x, g, ws, bs, s, preact_input=preact)
    torch.cuda.synchronize()
    after = _bf16_counts()
    assert after["mlp_chain_bwd_bf16"] == before["mlp_chain_bwd_bf16"] + 2
    assert after["mlp_chain_bwd"] == before["mlp_chain_bwd"]
    assert got[0].dtype == BF
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert a.shape == b.shape
        assert _l2(a, b) <= BF16_L2
    assert all(t.dtype == torch.float32 for t in _flat_bwd(got)[1:])
    assert all(torch.equal(a, b) for a, b in zip(_flat_bwd(got),
                                                 _flat_bwd(again)))


def _bf16_tc_case(rng, V, k, S, fv, H, layers, dev):
    e, vs, v, senders, edge, node = _tc_case(rng, V, k, S, fv, H, layers,
                                             dev)
    return e.to(BF), vs.to(BF), v.to(BF), senders, edge, node


@pytest.mark.parametrize("V,k,S,fv,H,layers,skip_e", [
    (16 * 40 + 7, 6, 16 * 40 + 7, 128, 128, 3, False),   # MuS level 1
    (16 * 9 + 5, 5, 500, 256, 128, 2, True),    # a foreign table, fv 256
    (16 * 9 + 5, 5, 500, 256, 128, 3, False),   # 3 layers at fv 256
    (16 * 4 + 3, 2, 70, 128, 128, 3, False),    # 32-row edge tiles
    (7 * 30 + 2, 13, 90, 64, 96, 2, False),     # 7 receivers per tile
    (301, 5, 77, 32, 48, 3, False)])            # widths not 8-multiples
def test_bf16_gn_kernels_match_plain(dev, rng, V, k, S, fv, H, layers,
                                     skip_e):
    """Rows 3-6, 9, 10 in bf16: the forward (bf16 outputs) and the
    backward (bf16 de, dv; f32 dvs and parameter gradients) against their
    bf16 plain versions; two launches the same bits; the f32 launch counts
    untouched."""
    e, vs, v, senders, edge, node = _bf16_tc_case(rng, V, k, S, fv, H,
                                                  layers, dev)
    before = _bf16_counts()
    got = gn_op.gn_block(e, vs, v, senders, k, edge, node, out_selu=True,
                         skip_e_out=skip_e)
    ref = gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                               out_selu=True, skip_e_out=skip_e)
    torch.cuda.synchronize()
    assert got[0].dtype == BF
    assert scaled_err(got[0].float(), ref[0].float()) <= BF16_TOL
    assert (got[1] is None) if skip_e else (
        scaled_err(got[1].float(), ref[1].float()) <= BF16_TOL)
    gv = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(
        dev).to(BF)
    ge = None if skip_e else torch.from_numpy(rng.normal(
        size=(V * k, H)).astype(np.float32)).to(dev).to(BF)
    args = (e, vs, v, senders, None, k, edge, node, gv, ge)
    got = gn_op.gn_block_bwd(*args, out_selu=True)
    ref = gn_op.gn_block_bwd_plain(*args, out_selu=True)
    again = gn_op.gn_block_bwd(*args, out_selu=True)
    torch.cuda.synchronize()
    after = _bf16_counts()
    assert after["gn_block_bf16"] == before["gn_block_bf16"] + 1
    assert after["gn_block_bwd_bf16"] == before["gn_block_bwd_bf16"] + 2
    assert after["sorted_segment_sum_bf16"] == (
        before["sorted_segment_sum_bf16"] + 2)
    for name in ("gn_block", "gn_block_bwd", "sorted_segment_sum"):
        assert after[name] == before[name], name
    assert got[0].dtype == got[1].dtype == BF
    assert got[2].dtype == torch.float32
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert a.shape == b.shape
        assert _l2(a, b) <= BF16_L2
    assert not got[3][0][0][H:H + fv].any()     # the Ws rows
    assert all(torch.equal(a, b) for a, b in zip(_flat_bwd(got),
                                                 _flat_bwd(again)))


def test_bf16_gn_kernels_take_no_receivers(dev, rng):
    """V = 0 in bf16: what the plain versions give, nothing launched."""
    k, H, S = 6, 128, 7
    edge = _chain(rng, [3 * H, H, H, H], True, dev)
    node = _chain(rng, [2 * H, H, H, H], True, dev)
    e = torch.zeros(0, H, device=dev, dtype=BF)
    v = torch.zeros(0, H, device=dev, dtype=BF)
    vs = torch.from_numpy(rng.normal(size=(S, H)).astype(np.float32)).to(
        dev).to(BF)
    senders = torch.zeros(0, dtype=torch.int32, device=dev)
    before = _bf16_counts()
    got = gn_op.gn_block(e, vs, v, senders, k, edge, node, out_selu=True)
    ref = gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                               out_selu=True)
    assert [(t.shape, t.dtype) for t in got] == [(t.shape, t.dtype)
                                                 for t in ref]
    zero = torch.zeros(0, H, device=dev, dtype=BF)
    got = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge, node, zero,
                             zero, out_selu=True)
    ref = gn_op.gn_block_bwd_plain(e, vs, v, senders, None, k, edge, node,
                                   zero, zero, out_selu=True)
    torch.cuda.synchronize()
    assert len(_flat_bwd(got)) == len(_flat_bwd(ref))
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert a.shape == b.shape and torch.equal(a.float(), b.float())
    assert _bf16_counts() == before


@pytest.mark.parametrize("bad", [16 * 40 + 7, -5])
def test_bf16_gn_kernels_give_nan_for_a_sender_outside_the_table(dev, rng,
                                                                 bad):
    """As in f32: a sender outside [0, S) makes its receiver's bf16
    outputs NaN, forward and backward, and no other receiver's."""
    V, k, H = 16 * 40 + 7, 6, 128
    e, vs, v, senders, edge, node = _bf16_tc_case(rng, V, k, V, 128, H, 3,
                                                  dev)
    senders[21 * k + 4] = bad
    vo, eo = gn_op.gn_block(e, vs, v, senders, k, edge, node,
                            out_selu=True)
    rows = torch.isnan(vo).any(dim=1)
    assert rows[21].item() and int(rows.sum()) == 1
    assert int(torch.isnan(eo).any(dim=1).sum()) == 1
    gv = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(
        dev).to(BF)
    ge = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev).to(BF)
    de, dv, _, _, _ = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge,
                                         node, gv, ge, out_selu=True)
    torch.cuda.synchronize()
    bad_edges = torch.zeros(V * k, dtype=torch.bool, device=dev)
    bad_edges[21 * k:22 * k] = True
    assert bool(torch.isnan(de[bad_edges]).all(dim=1).all())
    assert bool(torch.isfinite(de[~bad_edges]).all())
    rows = torch.isnan(dv).any(dim=1)
    assert rows[21].item() and int(rows.sum()) == 1


@pytest.mark.parametrize("V,k,S,fv,H,layers,skip_e", [
    (64 * 40 + 7, 6, 64 * 40 + 7, 128, 128, 3, False),  # MuS, a ragged tile
    (64, 6, 64, 128, 128, 3, False),             # exactly one tile
    (64 * 9 + 5, 5, 700, 128, 128, 2, False),    # k = 5, S != V
    (64 * 9 + 5, 5, 700, 256, 128, 2, True),     # fv 256, skip_e, no ge
    (64 * 7 + 63, 6, 300, 256, 128, 3, False),   # fv 256 at k = 6
    (29 * 4 + 3, 13, 90, 200, 72, 2, False)])    # 29 receivers, odd widths
def test_bf16_wgmma_gn_kernels_match_plain(dev, rng, V, k, S, fv, H, layers,
                                           skip_e):
    """The bf16 tile kernels (``csrc/gn_block_bf16.cu``: 64-receiver
    tiles, wgmma) at k = 5, 6 and 13, fv = 128, 200 and 256, S != V, a
    partial last tile and one whole tile, ``skip_e_out`` with a null
    ``ge``: the forward within 8e-3 of max(1, max |ref|), the backward
    within 1e-2 relative L2 of the bf16 plain versions; two launches the
    same bits, forward and backward."""
    e, vs, v, senders, edge, node = _bf16_tc_case(rng, V, k, S, fv, H,
                                                  layers, dev)
    fwd = lambda: gn_op.gn_block(e, vs, v, senders, k, edge, node,
                                 out_selu=True, skip_e_out=skip_e)
    got, again = fwd(), fwd()
    ref = gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                               out_selu=True, skip_e_out=skip_e)
    torch.cuda.synchronize()
    assert scaled_err(got[0].float(), ref[0].float()) <= BF16_TOL
    assert (got[1] is None) if skip_e else (
        scaled_err(got[1].float(), ref[1].float()) <= BF16_TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, again)
               if a is not None)
    gv = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(
        dev).to(BF)
    ge = None if skip_e else torch.from_numpy(rng.normal(
        size=(V * k, H)).astype(np.float32)).to(dev).to(BF)
    args = (e, vs, v, senders, None, k, edge, node, gv, ge)
    got = gn_op.gn_block_bwd(*args, out_selu=True)
    again = gn_op.gn_block_bwd(*args, out_selu=True)
    ref = gn_op.gn_block_bwd_plain(*args, out_selu=True)
    torch.cuda.synchronize()
    for a, b in zip(_flat_bwd(got), _flat_bwd(ref)):
        assert a.shape == b.shape
        assert _l2(a, b) <= BF16_L2
    assert all(torch.equal(a, b) for a, b in zip(_flat_bwd(got),
                                                 _flat_bwd(again)))


@pytest.mark.parametrize("fv", [128, 256])
def test_bf16_wgmma_gn_forward_takes_a_one_layer_edge_chain(dev, rng, fv):
    """A one-layer edge chain keeps vr and the aggr sums apart in shared
    memory, so its tiles hold fewer receivers (57 at fv = 128, 53 at 256):
    the forward against its bf16 plain version, over several tiles."""
    V, k, H = 300, 6, 128
    e, vs, v, senders, edge, node = _bf16_tc_case(rng, V, k, V, fv, H, 1,
                                                  dev)
    assert gn_op.tile_receivers(k, BF, fv, 1) < 64
    got = gn_op.gn_block(e, vs, v, senders, k, edge, node, out_selu=True)
    ref = gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                               out_selu=True)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert scaled_err(a.float(), b.float()) <= BF16_TOL


def test_bf16_wgmma_gn_tile_geometry_matches_the_wrapper(dev):
    """The shared memory the kernels ask for is what
    ``ops.gn_block.bf16_tile_smem`` computes for ``tile_receivers``'
    geometry, at the bf16 paths' shapes and at the limits."""
    from graphs4cfd_tpu_torch.ops import _build
    lib = _build.load()
    for k, fv, ne in ((6, 128, 3), (5, 128, 2), (6, 256, 3), (6, 128, 1),
                      (6, 256, 1), (13, 200, 2), (96, 256, 2), (2, 16, 2)):
        ed = [128 + 2 * fv] + [128] * ne
        nd = [128 + fv, 128, 128]
        npb = gn_op.tile_receivers(k, BF, fv, ne)
        want = gn_op.bf16_tile_smem(npb, k, fv, ne)
        assert want <= _build.MAX_SMEM
        got = lib.g4c_gn_block_smem(k, 128, fv, ne, _build.int_array(ed), 2,
                                    _build.int_array(nd), 1)
        assert got == want, (k, fv, ne)
        if ne >= 2:
            assert lib.g4c_gn_block_bwd_smem(
                k, 128, fv, ne, _build.int_array(ed), 2,
                _build.int_array(nd), 1) == want


def test_bf16_wgmma_gn_kernels_give_nan_across_m_tiles(dev, rng):
    """A sender outside the table on a receiver whose k = 6 edge rows
    straddle two 64-row m-tiles (receiver 10: rows 60-65) makes that
    receiver's outputs NaN, forward and backward, and no other's; the
    row-order sums over k (aggr, dvr) carry nothing across receivers."""
    V, k, H = 64 * 3 + 5, 6, 128
    e, vs, v, senders, edge, node = _bf16_tc_case(rng, V, k, V, 128, H, 3,
                                                  dev)
    senders[10 * k + 5] = V + 3
    vo, eo = gn_op.gn_block(e, vs, v, senders, k, edge, node, out_selu=True)
    rows = torch.isnan(vo).any(dim=1)
    assert rows[10].item() and int(rows.sum()) == 1
    assert int(torch.isnan(eo).any(dim=1).sum()) == 1  # its edge row
    gv = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(
        dev).to(BF)
    ge = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev).to(BF)
    de, dv, _, _, _ = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge,
                                         node, gv, ge, out_selu=True)
    torch.cuda.synchronize()
    bad = torch.zeros(V * k, dtype=torch.bool, device=dev)
    bad[10 * k:11 * k] = True
    assert bool(torch.isnan(de[bad]).all(dim=1).all())
    assert bool(torch.isfinite(de[~bad]).all())
    rows = torch.isnan(dv).any(dim=1)
    assert rows[10].item() and int(rows.sum()) == 1


@pytest.mark.parametrize("rows,nseg,F,pile", [
    (242688, 40448, 128, 0),        # MuS level-1 dvs
    (512000, 102400, 128, 12000),   # REMuS level-1 angle sources, the pile
    (5000, 700, 130, 300),          # F not a multiple of 4
    (0, 7, 128, 0)])                # no rows
def test_bf16_sorted_segment_sum_kernel_matches_plain(dev, rng, rows, nseg,
                                                      F, pile):
    """Row 8's bf16 rows (and rows 4, 6, 10's dvs) added in f32 into an
    f32 table: as the f32 kernel, the plain version's bits in every
    segment one warp adds."""
    src, perm, srt = _segment_case(rng, rows, nseg, F, pile, dev)
    before = _bf16_counts()
    _hold_segment_sum(src.to(BF), perm, srt, nseg)
    after = _bf16_counts()
    assert after["sorted_segment_sum"] == before["sorted_segment_sum"]
    assert after["sorted_segment_sum_bf16"] > before[
        "sorted_segment_sum_bf16"] or nseg == 0


def test_bf16_wrappers_refuse_mixed_types(dev, rng):
    """No quiet conversion: a bf16 weight, an f32 cotangent of a bf16
    chain, or activations of two types are refused on the card."""
    x = torch.zeros(10, 8, device=dev, dtype=BF)
    with pytest.raises(ValueError):
        fused_mlp.mlp_chain(x, [torch.zeros(8, 4, device=dev, dtype=BF)],
                            [torch.zeros(4, device=dev)])
    w, b = [torch.zeros(8, 4, device=dev)], [torch.zeros(4, device=dev)]
    with pytest.raises(ValueError):
        fused_mlp.mlp_chain_bwd(x, torch.zeros(10, 4, device=dev), w, b)
    e, vs, v, senders, edge, node = _bf16_tc_case(rng, 50, 6, 50, 128, 128,
                                                  2, dev)
    with pytest.raises(ValueError):
        gn_op.gn_block(e.float(), vs, v, senders, 6, edge, node)


@pytest.mark.parametrize("family", ["mus", "remus", "gmus"])
def test_bf16_models_run_only_the_bf16_kernels(dev, family):
    """A bf16 forward and backward of a small model of each family: every
    bf16 kernel of its path launched, no f32 kernel (no quiet f32 path);
    the loss and parameter gradients f32 and finite."""
    from chip_smoke import (flagship_arch, gmus_arch, make_gmus_samples,
                            make_remus_samples, make_samples, remus_arch)
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import (attach_angle_sorts,
                                             attach_sender_sorts, collate)
    from graphs4cfd_tpu_torch.nn import (GraphLoss, NsRotEquiThreeScaleGNN,
                                         NsThreeGuillardScaleGNN,
                                         NsThreeScaleGNN)
    cls, arch, samples, attach = {
        "mus": (NsThreeScaleGNN, flagship_arch(w=64),
                make_samples(2, 600, seed=3), lambda b: b),
        "remus": (NsRotEquiThreeScaleGNN, remus_arch(),
                  make_remus_samples(2, 600, seed=3), attach_angle_sorts),
        "gmus": (NsThreeGuillardScaleGNN, gmus_arch(),
                 make_gmus_samples(2, 600, seed=3), attach_sender_sorts),
    }[family]
    model = cls(arch=arch, seed=2, device=dev, compute_dtype=BF)
    g = Graph.from_numpy(attach(collate(samples, node_bucket=64,
                                        edge_bucket=128)), dev)
    before = _bf16_counts()
    pred = model(g)
    loss = GraphLoss(0.25)(g, pred, g.target[:, :model.num_fields])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    torch.cuda.synchronize()
    after = _bf16_counts()
    ran = {k: after[k] - before[k] for k in after}
    for kernel in ("mlp_chain", "gn_block", "mlp_chain_bwd", "gn_block_bwd",
                   "sorted_segment_sum"):
        assert ran[kernel + "_bf16"] > 0, kernel
        assert ran[kernel] == 0, kernel
    assert pred.dtype == loss.dtype == torch.float32
    assert bool(torch.isfinite(loss))
    assert all(t.dtype == torch.float32 and bool(torch.isfinite(t).all())
               for t in grads)


# ---- the bf16 weight-gradient kernel and chain backward tile (wgmma) ----

def _wgrad_bound(x, d):
    """Each entry's error bound of an f32 sum of the bf16-rounded products
    of x^T d over chunks of ``wgrad_chunk`` rows and then over the chunks
    (``csrc/wgrad_bf16.cu``): (chunk + chunks + 16) * 2^-23 * (|x|^T |d|),
    the worst case of a recursive f32 sum of that many terms when every add
    rounds toward zero (the tensor cores' adds may truncate), in float64."""
    from graphs4cfd_tpu_torch.ops import wgrad
    rows = x.shape[0]
    chunk = wgrad.wgrad_chunk(rows)
    n = chunk + -(-rows // chunk) + 16
    xa = x.to(BF).double().abs()
    da = d.to(BF).double().abs()
    return n * 2.0 ** -23 * (xa.t() @ da)


#: (rows, K, N, X bf16) of the bf16 backwards' products (``ops.wgrad.
#: gn_products``/``chain_products`` at the three families' shapes: K = 2,
#: 3, 4, 5 for the encoders, 128, 130, 256, 258; N = 128, 3, 1; f32 X for
#: the layer inputs), at row counts that are not multiples of 64, a few
#: rows, 256-row chunks and the full level-1 sizes
WGRAD_CASES = [
    (0, 128, 128, True),
    (1, 128, 128, False),
    (77, 128, 128, True),
    (1000, 128, 128, False),
    (14336, 128, 128, False),
    (40448, 256, 128, True),
    (40448, 128, 128, False),
    (40448, 5, 128, True),
    (40448, 128, 3, False),
    (20480, 128, 1, False),
    (3072, 130, 128, True),
    (3072, 258, 128, True),
    (7680, 3, 128, True),
    (1000, 5, 128, False),
    (242688, 128, 128, True),
    (242688, 2, 128, True),
    (512000, 4, 128, True)]


@pytest.mark.parametrize("rows,K,N,xb", WGRAD_CASES)
def test_bf16_wgrad_kernel_matches_mm(dev, rng, rows, K, N, xb):
    """The bf16 weight-gradient kernel (``csrc/wgrad_bf16.cu``) through
    ``ops.wgrad.weight_grads``: X^T D against ``torch.mm`` of the
    bf16-rounded operands in float64, every entry within ``_wgrad_bound``
    (an f32 X rounded to bf16 exactly as the plain version rounds it);
    zero rows give zeros and launch nothing; two launches the same bits;
    one bf16 launch counted and no f32 one."""
    from graphs4cfd_tpu_torch.ops import wgrad
    x = torch.from_numpy(rng.normal(size=(rows, K)).astype(np.float32)).to(
        dev)
    d = torch.from_numpy(rng.normal(size=(rows, N)).astype(np.float32)).to(
        dev).to(BF)
    if xb:
        x = x.to(BF)
    before = _bf16_counts()
    (got,) = wgrad.weight_grads([(x, d)])
    (again,) = wgrad.weight_grads([(x, d)])
    torch.cuda.synchronize()
    after = _bf16_counts()
    assert after["weight_grads_bf16"] == before["weight_grads_bf16"] + (
        2 if rows else 0)
    assert after["weight_grads"] == before["weight_grads"]
    assert got.dtype == torch.float32 and got.shape == (K, N)
    ref = x.to(BF).double().t() @ d.double()
    assert bool(((got.double() - ref).abs() <= _wgrad_bound(x, d)).all())
    (plain,) = wgrad.weight_grads_plain([(x, d)])
    assert _l2(got, plain) <= 1e-5 or rows == 0
    assert torch.equal(got, again)


def test_bf16_wgrad_kernel_takes_a_backwards_products_in_one_launch(dev,
                                                                    rng):
    """The eight products of a GN backward at MuS widths (bf16 and f32 X,
    K up to 256) in one launch, each as it is alone."""
    from graphs4cfd_tpu_torch.ops import wgrad
    pairs = []
    for rows, K, N, xb in wgrad.gn_products(1000, 6, 128, 256,
                                            [384 + 256, 128, 128, 128],
                                            [384, 128, 128, 128]):
        x = torch.from_numpy(rng.normal(size=(rows, K)).astype(
            np.float32)).to(dev)
        d = torch.from_numpy(rng.normal(size=(rows, N)).astype(
            np.float32)).to(dev).to(BF)
        pairs.append((x.to(BF) if xb else x, d))
    got = wgrad.weight_grads(pairs)
    alone = [wgrad.weight_grads([p])[0] for p in pairs]
    torch.cuda.synchronize()
    assert len(got) == 8
    assert all(torch.equal(a, b) for a, b in zip(got, alone))


def test_bf16_wgrad_kernel_refuses_what_it_does_not_take(dev):
    from graphs4cfd_tpu_torch.ops import wgrad
    x = torch.zeros(10, 8, device=dev, dtype=BF)
    with pytest.raises(ValueError):       # an f32 D under a bf16 X
        wgrad.weight_grads([(x, torch.zeros(10, 8, device=dev))])
    with pytest.raises(ValueError):       # N over 128
        wgrad.weight_grads([(x, torch.zeros(10, 129, device=dev, dtype=BF))])
    with pytest.raises(ValueError):       # rows differ
        wgrad.weight_grads([(x, torch.zeros(9, 8, device=dev, dtype=BF))])


#: the bf16 chain backwards of the three families' training steps
#: (direction, widths, LayerNorm, preact_input, need_dx), as a bf16 step of
#: each family calls ``mlp_chain_bwd``: MuS and gMuS decoders (-> 3),
#: pooling chains (258, 130 wide), coarse tails (preact), the edge (K = 2)
#: and node (K = 5) encoders; REMuS's decoder (-> 1), tails and angle (K =
#: 4, 3) encoders
BF16_CHAIN_SHAPES = [
    ([128, 128, 128, 3], False, False, True),
    ([258, 128, 128, 128], True, False, True),
    ([128, 128, 128], True, True, True),
    ([130, 128, 128, 128], True, False, True),
    ([2, 128, 128, 128], False, False, False),
    ([5, 128, 128, 128], False, False, False),
    ([128, 128, 1], False, False, True),
    ([4, 128, 128], True, False, False),
    ([3, 128, 128], True, False, False)]


def _chain_flips():
    """Each of ``BF16_CHAIN_SHAPES`` as called and with one of need_dx,
    preact_input (inputs up to 128 wide: the kernel's limit) or the
    LayerNorm turned over."""
    out = []
    for dims, ln, preact, need_dx in BF16_CHAIN_SHAPES:
        out.append((dims, ln, preact, need_dx, "as called"))
        out.append((dims, ln, preact, not need_dx, "need_dx"))
        if dims[0] <= 128:
            out.append((dims, ln, not preact, need_dx, "preact"))
        out.append((dims, not ln, preact, need_dx, "ln"))
    return out


@pytest.mark.parametrize("rows", [1000, 129])
@pytest.mark.parametrize("dims,ln,preact,need_dx,flip", _chain_flips())
def test_bf16_wgmma_chain_bwd_matches_plain(dev, rng, dims, ln, preact,
                                            need_dx, flip, rows):
    """The bf16 chain backward (``csrc/mlp_chain_bwd_bf16.cu``'s 128-row
    wgmma tiles, then ``csrc/wgrad_bf16.cu``) at every shape the bf16
    training steps call, as called and with ``need_dx``, ``preact_input``
    (inputs up to 128 wide) or the LayerNorm turned over, at 1000 rows
    (a ragged last tile) and 129 (one row in a second tile): within 1e-2
    relative L2 of ``mlp_chain_bwd_plain``, dx bf16, the parameter
    gradients f32, two launches the same bits, one bf16 launch of the
    backward and of the weight-gradient kernel each, no f32 launch."""
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev).to(BF)
    g = torch.from_numpy(rng.normal(size=(rows, dims[-1])).astype(
        np.float32)).to(dev).to(BF)
    ws, bs, lns = _chain(rng, dims, ln, dev)
    s = lns[0] if lns else None
    before = _bf16_counts()
    got = fused_mlp.mlp_chain_bwd(x, g, ws, bs, s, preact_input=preact,
                                  need_dx=need_dx)
    again = fused_mlp.mlp_chain_bwd(x, g, ws, bs, s, preact_input=preact,
                                    need_dx=need_dx)
    ref = fused_mlp.mlp_chain_bwd_plain(x, g, ws, bs, s, preact_input=preact,
                                        need_dx=need_dx)
    torch.cuda.synchronize()
    after = _bf16_counts()
    assert after["mlp_chain_bwd_bf16"] == before["mlp_chain_bwd_bf16"] + 2
    assert after["weight_grads_bf16"] == before["weight_grads_bf16"] + 2
    assert after["mlp_chain_bwd"] == before["mlp_chain_bwd"]
    assert after["weight_grads"] == before["weight_grads"]
    assert (got[0] is None) == (not need_dx)
    if need_dx:
        assert got[0].dtype == BF
    flat, flat_ref = _flat_bwd(got), _flat_bwd(ref)
    assert len(flat) == len(flat_ref)
    for a, b in zip(flat, flat_ref):
        assert a.shape == b.shape
        assert _l2(a, b) <= BF16_L2
    assert all(t.dtype == torch.float32 for t in flat[1 if need_dx else 0:])
    assert all(torch.equal(a, b) for a, b in zip(flat, _flat_bwd(again)))


def test_bf16_wgmma_chain_bwd_geometry_matches_the_wrapper(dev):
    """The shared memory the bf16 chain backward asks for is what
    ``ops.fused_mlp.bf16_bwd_smem`` computes, at inputs 2 to 576 wide and
    1 to 8 layers; ``preact_input`` above 128 is refused."""
    from graphs4cfd_tpu_torch.ops import _build
    lib = _build.load()
    for k0 in (2, 5, 128, 129, 130, 258, 512, 576):
        for n in (1, 2, 3, 4, 8):
            dims = _build.int_array([k0] + [128] * n)
            assert lib.g4c_mlp_chain_bwd_smem(n, dims, 0, 1) == \
                fused_mlp.bf16_bwd_smem(k0, n)
            assert fused_mlp.bf16_bwd_smem(k0, n) <= _build.MAX_SMEM
    assert lib.g4c_mlp_chain_bwd_smem(2, _build.int_array([129, 128, 128]),
                                      1, 1) == 0


# ---- the bf16 chain forward (wgmma) -----------------------------------------
#: (widths, LayerNorm, preact_input) of every bf16 chain forward of the
#: three families' rollout and training steps (the forwards of
#: ``BF16_CHAIN_SHAPES``; a rollout calls the same chains), then shapes
#: past the models' that take the kernel's other paths: outputs wider than
#: 128 (two passes into a second tile, the LayerNorm over both through the
#: stash) and weights that do not fit shared memory with one warpgroup
#: (streamed a 128-row chunk at a time), apart and together
BF16_FWD_SHAPES = ([(dims, ln, preact) for dims, ln, preact, _ in
                    BF16_CHAIN_SHAPES]
                   + [([40, 200, 256], True, True), ([128] * 9, True, False),
                      ([760, 128], False, False), ([376, 256, 256], True, False),
                      ([256] * 9, False, True)])


@pytest.mark.parametrize("rows", [1000, 129])
@pytest.mark.parametrize("dims,ln,preact", BF16_FWD_SHAPES)
def test_bf16_wgmma_chain_forward_matches_plain(dev, rng, dims, ln, preact,
                                                rows):
    """The bf16 chain forward (``csrc/mlp_chain_fwd_bf16.cu``: 64-row
    m-tiles a warpgroup, wgmma) at every bf16 chain of the three families
    and at the wide and streamed shapes, at 1000 rows (a ragged last tile)
    and 129 (one row in a third tile): within BF16_TOL of
    ``mlp_chain_plain``, bf16, one ``mlp_chain_bf16`` launch a call and no
    f32 launch, two launches the same bits."""
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev).to(BF)
    ws, bs, lns = _chain(rng, dims, ln, dev)
    lnp = lns or (None, None)
    before = _bf16_counts()
    got = fused_mlp.mlp_chain(x, ws, bs, *lnp, preact_input=preact)
    again = fused_mlp.mlp_chain(x, ws, bs, *lnp, preact_input=preact)
    ref = fused_mlp.mlp_chain_plain(x, ws, bs, *lnp, preact_input=preact)
    torch.cuda.synchronize()
    after = _bf16_counts()
    assert after["mlp_chain_bf16"] == before["mlp_chain_bf16"] + 2
    assert after["mlp_chain"] == before["mlp_chain"]
    assert got.dtype == ref.dtype == BF and got.shape == ref.shape
    assert scaled_err(got.float(), ref.float()) <= BF16_TOL
    assert torch.equal(got, again)


def test_bf16_chain_forward_takes_no_rows(dev, rng):
    """Zero rows: an empty bf16 output of the chain's width, nothing
    launched."""
    ws, bs, lns = _chain(rng, [4, 128, 128], True, dev)
    x = torch.zeros(0, 4, device=dev, dtype=BF)
    before = _bf16_counts()
    out = fused_mlp.mlp_chain(x, ws, bs, *lns)
    assert out.shape == (0, 128) and out.dtype == BF
    assert _bf16_counts() == before


@pytest.mark.parametrize("dims,ln,preact", [([128, 128, 128], True, True),
                                            ([2, 128, 128, 128], False, False),
                                            ([5, 128, 128, 128], False, False),
                                            ([258, 128, 128, 128], True,
                                             False)])
def test_bf16_chain_forward_bits_do_not_depend_on_the_row_count(dev, rng,
                                                                dims, ln,
                                                                preact):
    """The first 32,767 rows of a 33,000-row call are the bits of a
    32,767-row call: a row's output depends on that row alone (the same
    products in the same order whatever the m-tile, the warpgroups a block
    or the grid)."""
    x = torch.from_numpy(rng.normal(size=(33000, dims[0])).astype(
        np.float32)).to(dev).to(BF)
    ws, bs, lns = _chain(rng, dims, ln, dev)
    lnp = lns or (None, None)
    big = fused_mlp.mlp_chain(x, ws, bs, *lnp, preact_input=preact)
    small = fused_mlp.mlp_chain(x[:32767].contiguous(), ws, bs, *lnp,
                                preact_input=preact)
    torch.cuda.synchronize()
    assert torch.equal(big[:32767], small)


def test_bf16_wgmma_chain_forward_geometry_matches_the_wrapper(dev):
    """The bf16 forward's geometry from the library (weights resident or
    streamed, warpgroups a block, shared memory) is what
    ``ops.fused_mlp.bf16_fwd_geometry`` computes, and what
    ``g4c_mlp_chain_smem`` answers for bf16; every shape of
    ``BF16_FWD_SHAPES`` launches; the kernel keeps to 128 registers a
    thread with at least one block an SM."""
    import ctypes
    from graphs4cfd_tpu_torch.ops import _build
    lib = _build.load()
    for dims, _, _ in BF16_FWD_SHAPES:
        n, c = len(dims) - 1, _build.int_array(dims)
        g, streamed, regs, blocks = (ctypes.c_int(), ctypes.c_int(),
                                     ctypes.c_int(), ctypes.c_int())
        smem = ctypes.c_size_t()
        _build.check(lib.g4c_mlp_chain_fwd_bf16_geometry(
            n, c, ctypes.byref(g), ctypes.byref(smem), ctypes.byref(streamed),
            ctypes.byref(regs), ctypes.byref(blocks)))
        assert (bool(streamed.value), g.value, smem.value) == \
            fused_mlp.bf16_fwd_geometry(dims), dims
        assert lib.g4c_mlp_chain_smem(n, c, 1000, 1) == smem.value
        assert regs.value <= 128 and blocks.value >= 1
