"""The port's REMuS-GNN training slice against the JAX package, on the CPU.

* ``gn_block_bwd_plain`` against ``jax.vjp`` of the JAX package's Pallas
  kernels in interpret mode, at 2e-4: the folded EdgeMP kernel
  (``edge_mp_folded``, whose ``d_tab`` is the port's ``dvs``) and the GN
  block kernel at the ``down_edge_mp`` shapes (``gn_block_fused``, whose
  ``dvsg`` summed per fine edge is the port's ``dvs``);
* the port's autograd through ``blocks.edge_mp`` and
  ``blocks.down_edge_mp`` against ``jax.grad`` of the JAX blocks on their
  Pallas route (interpret mode), at 2e-4, the first angle layer's ``Ws``
  rows included;
* the host sorts of the angle sources (``loader.attach_angle_sorts``);
* a sender outside the table: the plain backward raises;
* ``make_train_step`` and ``make_val_step`` on a 32-wide 3-scale REMuS
  model with the same numpy-seeded weights and the Adam state carried
  across: mean loss and gradient norm at rtol 1e-4, first-step gradients
  at 2e-4 of each tensor's max abs (against the JAX package's float64
  gradients, see ``_jax_grads_f64``), parameters after a step at rtol
  5e-3 and atol 2 lr (the tolerances of ``test_torch_train.py``);
* one training step from the bundled 128-wide REMuS checkpoint: its
  gradients at 2e-4 of each tensor's max abs, loss and gradient norm at
  rtol 1e-4.

Sizes are small: 2 clouds of 300 nodes, k = 5, 3 levels.  On the CPU
every wrapper takes its plain version; ``test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernels against those on a card.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu import config as g4c_config
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.nn import blocks as jax_blocks
from graphs4cfd_tpu.nn.losses import GraphLoss as JaxGraphLoss
from graphs4cfd_tpu.nn.mlp import init_mlp
from graphs4cfd_tpu.nn.model import grad_norm2 as jax_grad_norm2
from graphs4cfd_tpu.ops import pallas_edgemp
from graphs4cfd_tpu.ops.pallas_gnblock import gn_block_fused
from graphs4cfd_tpu.training import trainer as jax_trainer
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import attach_angle_sorts, collate
from graphs4cfd_tpu_torch.nn import (GraphLoss, NsRotEquiThreeScaleGNN,
                                     blocks, init_params_numpy,
                                     params_from_jax)
from graphs4cfd_tpu_torch.ops import gn_block as port_gn
from graphs4cfd_tpu_torch.training import (adam_init, adam_state_from_jax,
                                           make_train_step, make_val_step)
from test_torch_kernels import _chain, _t
from test_torch_remus import (CHK, K, _edge_block, _line_graph_case,
                              port_remus_samples, small_remus_arch)
from test_torch_train import _assert_chain_grads, _close_to_max, _mlp_grads

TOL = dict(rtol=2e-4, atol=2e-4)
LR = 1e-4
N_OUT = 2
NUM_FIELDS = 2


def _host_sort(src):
    flat = np.asarray(src).reshape(-1)
    perm = np.argsort(flat, kind="stable").astype(np.int32)
    return torch.from_numpy(perm), torch.from_numpy(flat[perm])


@pytest.fixture(scope="module")
def remus_batch():
    return collate(port_remus_samples(), node_bucket=64, edge_bucket=128)


# ----------------------------------------------------- row 10: EdgeMP bwd
@pytest.mark.parametrize("out_selu,skip_a", [(True, False), (False, False),
                                             (True, True), (False, True)])
def test_gn_block_bwd_plain_matches_folded_edgemp_vjp(rng, out_selu, skip_a):
    """One EdgeMP layer at width 128, k = 5: the port's backward against
    the folded kernel's custom VJP (``_edgemp_fold_vjp_bwd``)."""
    V, k, H = 64, K, 128
    a, e, _, angle_src, params, plan = _line_graph_case(rng, V, k, H)
    E = V * k
    w1 = params["angle_mlp"]["layers"][0]["w"]
    es = np.asarray(jnp.asarray(e) @ w1[H:2 * H])

    def fwd(am, em, a, tab, e):
        return pallas_edgemp.edge_mp_folded(
            am, em, a, tab, e, k, plan, interpret=True,
            out_activation="selu" if out_selu else None, skip_a_out=skip_a)

    _, vjp = jax.vjp(fwd, params["angle_mlp"], params["edge_mlp"],
                     jnp.asarray(a), jnp.asarray(es.reshape(V, k * H)),
                     jnp.asarray(e))
    ge = rng.normal(size=(E, H)).astype(np.float32)
    ga = None if skip_a else rng.normal(size=(E, k, H)).astype(np.float32)
    r_am, r_em, r_da, r_dtab, r_de = vjp(
        (jnp.asarray(ge), None if skip_a else jnp.asarray(ga)))
    de, dv, dvs, dang, dedge = port_gn.gn_block_bwd_plain(
        _t(a.reshape(E * k, H)), _t(es), _t(e),
        torch.from_numpy(angle_src.reshape(-1)), _host_sort(angle_src), k,
        _chain(params["angle_mlp"]), _chain(params["edge_mlp"]), _t(ge),
        None if skip_a else _t(ga.reshape(E * k, H)), out_selu=out_selu)
    np.testing.assert_allclose(de.numpy(),
                               np.asarray(r_da).reshape(E * k, H), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(r_de), **TOL)
    # d_tab is [V, k*H]: row v holds the cotangents of table rows v*k..
    np.testing.assert_allclose(dvs.numpy(),
                               np.asarray(r_dtab).reshape(E, H), **TOL)
    _assert_chain_grads(dang, _mlp_grads(r_am), **TOL)
    _assert_chain_grads(dedge, _mlp_grads(r_em), **TOL)
    assert not dang[0][0][H:2 * H].any()        # the Ws rows


# ------------------------------------------------- row 4: DownEdgeMP bwd
@pytest.mark.parametrize("out_selu", [False, True])
def test_gn_block_bwd_plain_matches_gn_block_fused_vjp_down_shapes(
        rng, out_selu):
    """``down_edge_mp``: 128 coarse edges fed by a table of 640 fine edges
    (S > V), of which the last 140 are never referenced.  JAX's ``dvsg``
    is per inter-level angle; summed per fine edge in float64 it is the
    port's ``dvs``."""
    Ec, Ef, k, H = 128, 640, K, 128
    a12 = rng.normal(size=(Ec * k, H)).astype(np.float32)
    e_fine = rng.normal(size=(Ef, H)).astype(np.float32)
    e_coarse = rng.normal(size=(Ec, H)).astype(np.float32)
    xsrc = rng.integers(0, Ef - 140, size=Ec * k).astype(np.int32)
    params = {"angle_mlp": init_mlp(jax.random.key(2), 3 * H, (H, H), True),
              "edge_mlp": init_mlp(jax.random.key(3), 2 * H, (H, H), True)}
    w1 = params["angle_mlp"]["layers"][0]["w"]
    es = np.asarray(jnp.asarray(e_fine) @ w1[H:2 * H])

    def fwd(am, em, a, asg, ec):
        return gn_block_fused(am, em, a, asg, ec, k, block=64,
                              interpret=True, skip_e_out=True,
                              out_activation="selu" if out_selu else None)

    _, vjp = jax.vjp(fwd, params["angle_mlp"], params["edge_mlp"],
                     jnp.asarray(a12), jnp.asarray(es[xsrc]),
                     jnp.asarray(e_coarse))
    gv = rng.normal(size=(Ec, H)).astype(np.float32)
    r_am, r_em, r_da, r_dasg, r_dec = vjp((None, jnp.asarray(gv)))
    ref_dvs = np.zeros((Ef, H), np.float64)
    np.add.at(ref_dvs, xsrc, np.asarray(r_dasg, np.float64))
    de, dv, dvs, dang, dedge = port_gn.gn_block_bwd_plain(
        _t(a12), _t(es), _t(e_coarse), torch.from_numpy(xsrc),
        _host_sort(xsrc), k, _chain(params["angle_mlp"]),
        _chain(params["edge_mlp"]), _t(gv), None, out_selu=out_selu)
    np.testing.assert_allclose(de.numpy(), np.asarray(r_da), **TOL)
    np.testing.assert_allclose(dv.numpy(), np.asarray(r_dec), **TOL)
    assert dvs.shape == (Ef, H)
    np.testing.assert_allclose(dvs.numpy(), ref_dvs, **TOL)
    assert not dvs[Ef - 140:].any()
    _assert_chain_grads(dang, _mlp_grads(r_am), **TOL)
    _assert_chain_grads(dedge, _mlp_grads(r_em), **TOL)


def test_gn_block_bwd_plain_raises_on_a_sender_outside_the_table(rng):
    """The kernels give NaN for such a sender; the plain versions raise
    (a negative index would otherwise wrap round)."""
    V, S, k, H = 12, 40, K, 16
    t = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32))
    edge = ([t(3 * H, H), t(H, H)], [t(H), t(H)], None)
    node = ([t(2 * H, H), t(H, H)], [t(H), t(H)], None)
    e, vs, v, gv = t(V * k, H), t(S, H), t(V, H), t(V, H)
    for bad in (S, -1):
        senders = torch.from_numpy(rng.integers(0, S, V * k).astype(
            np.int32))
        senders[7] = bad
        with pytest.raises(IndexError):
            port_gn.gn_block_bwd_plain(e, vs, v, senders, None, k, edge,
                                       node, gv, None)
        with pytest.raises(IndexError):
            port_gn.gn_block_plain(e, vs, v, senders, k, edge, node)


# --------------------------------------------------------- block autograd
@pytest.fixture
def pallas_on(monkeypatch):
    """The JAX blocks take their Pallas route (interpret mode here)."""
    monkeypatch.setattr(g4c_config, "use_pallas", True)
    g4c_config.fast_path_report(reset=True)


def _assert_block_grads(block, ref_params):
    for name in ("angle_mlp", "edge_mlp"):
        mlp = getattr(block, name)
        got = ([w.grad for w in mlp.weights], [b.grad for b in mlp.biases],
               (mlp.ln_scale.grad, mlp.ln_bias.grad))
        _assert_chain_grads(got, _mlp_grads(ref_params[name]), **TOL)


@pytest.mark.parametrize("skip_a", [False, True])
def test_edge_mp_autograd_matches_jax_block_grads(rng, pallas_on, skip_a):
    """Every parameter gradient (the ``Ws`` rows of the first angle layer,
    which autograd gives through ``es = e @ Ws``, included), ``de`` and
    ``da``.  256 edges: the JAX GN kernel's node block."""
    E, k, H = 256, K, 128
    a = rng.normal(size=(E, k, H)).astype(np.float32)
    e = rng.normal(size=(E, H)).astype(np.float32)
    angle_src = rng.integers(0, E, size=(E, k)).astype(np.int32)
    params = {"angle_mlp": init_mlp(jax.random.key(9), 3 * H, (H, H), True),
              "edge_mlp": init_mlp(jax.random.key(10), 2 * H, (H, H), True)}
    ge = rng.normal(size=(E, H)).astype(np.float32)
    ga = rng.normal(size=(E, k, H)).astype(np.float32)

    def loss(p, e, a):
        re_, ra = jax_blocks.edge_mp(p, e, a, jnp.asarray(angle_src),
                                     out_activation="selu",
                                     skip_a_out=skip_a)
        out = (re_ * ge).sum()
        return out if skip_a else out + (ra * ga).sum()

    rp, rde, rda = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(e), jnp.asarray(a))
    assert g4c_config.fast_path_report().get("edge_mp:fused")
    block = _edge_block(params)
    et = _t(e).requires_grad_()
    at = _t(a.reshape(E * k, H)).requires_grad_()
    got_e, got_a = blocks.edge_mp(block, et, at, torch.from_numpy(angle_src),
                                  out_selu=True, skip_a_out=skip_a,
                                  angle_sort=_host_sort(angle_src))
    out = (got_e * _t(ge)).sum()
    (out if skip_a else out + (got_a * _t(ga.reshape(E * k, H))).sum()
     ).backward()
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(rde), **TOL)
    np.testing.assert_allclose(at.grad.numpy(),
                               np.asarray(rda).reshape(E * k, H), **TOL)
    _assert_block_grads(block, rp)
    assert block.angle_mlp.weights[0].grad[H:2 * H].abs().max() > 0


def test_down_edge_mp_autograd_matches_jax_block_grads(rng, pallas_on):
    """256 coarse edges fed by 700 fine edges, 100 of them never read."""
    Ec, Ef, k, H = 256, 700, K, 128
    e_fine = rng.normal(size=(Ef, H)).astype(np.float32)
    e_coarse = rng.normal(size=(Ec, H)).astype(np.float32)
    a12 = rng.normal(size=(Ec, k, H)).astype(np.float32)
    xsrc = rng.integers(0, Ef - 100, size=(Ec, k)).astype(np.int32)
    params = {"angle_mlp": init_mlp(jax.random.key(11), 3 * H, (H, H), True),
              "edge_mlp": init_mlp(jax.random.key(12), 2 * H, (H, H), True)}
    gc = rng.normal(size=(Ec, H)).astype(np.float32)

    def loss(p, ef, ec, a):
        return (jax_blocks.down_edge_mp(p, ef, ec, a, jnp.asarray(xsrc),
                                        out_activation="selu") * gc).sum()

    rp, rdf, rdc, rda = jax.grad(loss, argnums=(0, 1, 2, 3))(
        params, jnp.asarray(e_fine), jnp.asarray(e_coarse), jnp.asarray(a12))
    block = _edge_block(params)
    ft, ct = _t(e_fine).requires_grad_(), _t(e_coarse).requires_grad_()
    at = _t(a12.reshape(Ec * k, H)).requires_grad_()
    got = blocks.down_edge_mp(block, ft, ct, at, torch.from_numpy(xsrc),
                              out_selu=True, angle_sort=_host_sort(xsrc))
    (got * _t(gc)).sum().backward()
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(rdf), **TOL)
    np.testing.assert_allclose(ct.grad.numpy(), np.asarray(rdc), **TOL)
    np.testing.assert_allclose(at.grad.numpy(),
                               np.asarray(rda).reshape(Ec * k, H), **TOL)
    assert not ft.grad[Ef - 100:].any()
    _assert_block_grads(block, rp)


# ------------------------------------------------------------- host sorts
def _source_keys(graph):
    return [key for key in graph.data
            if re.sub(r"_\d$", "", key) in ("angle_src", "xangle_src")]


def test_attach_angle_sorts_are_stable_argsorts(remus_batch):
    keys = set(remus_batch.data)
    got = attach_angle_sorts(remus_batch)
    assert set(remus_batch.data) == keys           # collate's output as it was
    sources = _source_keys(remus_batch)
    assert sorted(sources) == ["angle_src", "angle_src_2", "angle_src_3",
                               "xangle_src_2", "xangle_src_3"]
    added = {s.replace("_src", tag) for s in sources
             for tag in ("_perm", "_sorted")}
    assert set(got.data) - keys == added
    for key in sources:
        flat = remus_batch.data[key].reshape(-1)
        perm = got.data[key.replace("_src", "_perm")]
        srt = got.data[key.replace("_src", "_sorted")]
        assert perm.dtype == srt.dtype == np.int32
        np.testing.assert_array_equal(perm, np.argsort(flat, kind="stable"))
        np.testing.assert_array_equal(srt, flat[perm])
        np.testing.assert_array_equal(got.data[key], remus_batch.data[key])


def test_gn_block_backward_with_host_sort_matches_device_sort(remus_batch,
                                                              rng):
    """The level-1 angle sources of a collated batch: the attached sort is
    the one the backward makes on the device when none is given, and the
    gradients through it agree.  (On the CPU ``index_put_(accumulate=True)``
    adds with atomics across threads, so two runs of the same sums may
    differ in their last bits: the gradients are compared at 1e-6.)"""
    angle_src = remus_batch.angle_src
    E, k = angle_src.shape
    H = 16
    t = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).requires_grad_()
    a, es, e = t(E * k, H), t(E, H), t(E, H)
    angle = ([t(3 * H, H), t(H, H)], [t(H), t(H)], (t(H), t(H)))
    edge = ([t(2 * H, H), t(H, H)], [t(H), t(H)], (t(H), t(H)))
    leaves = [a, es, e, *angle[0], *angle[1], *edge[0], *edge[1]]
    sorts = attach_angle_sorts(remus_batch)
    host = (torch.from_numpy(sorts.angle_perm),
            torch.from_numpy(sorts.angle_sorted))
    g_e, g_a = torch.randn(E, H), torch.randn(E * k, H)

    def grads(sort):
        e_new, a_new = port_gn.gn_block(
            a, es, e, torch.from_numpy(angle_src.reshape(-1)), k, angle,
            edge, out_selu=True, sender_sort=sort)
        return torch.autograd.grad((e_new * g_e).sum()
                                   + (a_new * g_a).sum(), leaves)

    device = port_gn._sender_sort(torch.from_numpy(angle_src.reshape(-1)),
                                  None)
    assert all(torch.equal(x, y) for x, y in zip(host, device))
    for x, y in zip(grads(host), grads(None)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_remus_layers_get_the_host_sorts(remus_batch, monkeypatch):
    """``remus_apply`` hands every EdgeMP and DownEdgeMP layer the sort of
    its own angle sources."""
    graph = Graph.from_numpy(attach_angle_sorts(remus_batch), "cpu")
    seen = []
    real = port_gn.gn_block

    def spy(*args, **kw):
        if "sender_sort" in kw:      # the blocks' calls, not GnBlockFn's
            seen.append((args[3], kw["sender_sort"]))
        return real(*args, **kw)

    monkeypatch.setattr(port_gn, "gn_block", spy)
    model = NsRotEquiThreeScaleGNN(arch=small_remus_arch(w=16), device="cpu")
    model(graph)
    assert len(seen) == 10
    for senders, (perm, srt) in seen:
        assert torch.equal(senders[perm.long()], srt)
        assert bool((srt[1:] >= srt[:-1]).all())


# ---------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def remus_step_case(remus_batch):
    """One JAX run of everything the training-step tests compare with."""
    arch = small_remus_arch()
    tree = init_params_numpy(arch, seed=3)
    jgraph = JaxGraph(data=dict(remus_batch.data)).to_device()
    jmodel = g4c.nn.NsRotEquiThreeScaleGNN(arch=arch)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, tree)
    crit = JaxGraphLoss(0.25)
    jstep = jax_trainer.make_train_step(jmodel.apply, crit, NUM_FIELDS,
                                        N_OUT, 1.0)
    s0 = jax_trainer._adam_opt().init(jmodel.params)
    p1, s1, l1, g1 = jstep(jmodel.params, s0, jgraph, LR, True)
    p2, _, l2, g2 = jstep(p1, s1, jgraph, LR, True)
    val = jax_trainer.make_val_step(jmodel.apply, crit, NUM_FIELDS, 3)(
        p1, jgraph)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(arch=arch, tree=tree,
                graph=attach_angle_sorts(remus_batch),
                steps=[(to_np(p1), s1, float(l1), float(g1)),
                       (to_np(p2), float(l2), float(g2))],
                grads=_jax_grads_f64(arch, tree, remus_batch, crit),
                val=float(val))


def _jax_grads_f64(arch, tree, batch, crit):
    """The JAX package's gradient of the first step's loss, with float64
    inputs, weights and products (its activations stay f32, by its
    policy).  At some parameters of this 32-wide model the JAX package's
    own f32 gradients on the CPU lie further than 2e-4 of the tensor's max
    abs from these, where the port's f32 gradients lie well within: the
    first-step gradients are held against these at 2e-4."""
    f64 = lambda x: (x.astype(np.float64) if isinstance(x, np.ndarray)
                     and x.dtype == np.float32 else x)
    with jax.enable_x64(True):
        jgraph = JaxGraph(data={k: f64(v) for k, v in batch.data.items()}
                          ).to_device()
        jmodel = g4c.nn.NsRotEquiThreeScaleGNN(arch=arch,
                                               compute_dtype=jnp.float64)
        params = jax.tree_util.tree_map(lambda x: jnp.asarray(f64(x)), tree)
        grads = jax.grad(lambda p: crit(jgraph, jmodel.apply(p, jgraph),
                                        jgraph.target[:, :NUM_FIELDS]))(
            params)
        return params_from_jax(jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64), grads))


def _port_model(case, tree):
    model = NsRotEquiThreeScaleGNN(arch=case["arch"], seed=0, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


def _assert_params(model, tree):
    ref = params_from_jax(tree)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=5e-3, atol=2 * LR, err_msg=name)


def test_remus_first_step_gradients_match_jax(remus_step_case):
    model = _port_model(remus_step_case, remus_step_case["tree"])
    g = Graph.from_numpy(remus_step_case["graph"], "cpu")
    loss = GraphLoss(0.25)(g, model(g), g.target[:, :NUM_FIELDS])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert set(names) == set(remus_step_case["grads"])
    for name, got in zip(names, grads):
        _close_to_max(got.numpy().astype(np.float64),
                      remus_step_case["grads"][name].numpy(), 2e-4)


def test_remus_train_step_matches_jax(remus_step_case):
    model = _port_model(remus_step_case, remus_step_case["tree"])
    state = adam_init(model.parameters())
    step = make_train_step(model, GraphLoss(0.25), NUM_FIELDS, N_OUT, 1.0)
    loss, gnorm = step(state, Graph.from_numpy(remus_step_case["graph"],
                                               "cpu"), LR, True)
    p1, s1, l1, g1 = remus_step_case["steps"][0]
    np.testing.assert_allclose(float(loss), l1, rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), g1, rtol=1e-4)
    assert state.count == int(s1.count) == N_OUT
    _assert_params(model, p1)


def test_remus_train_step_carries_jax_adam_state(remus_step_case):
    """A second step from the JAX package's parameters and Adam state."""
    p1, s1, _, _ = remus_step_case["steps"][0]
    p2, l2, g2 = remus_step_case["steps"][1]
    model = _port_model(remus_step_case, p1)
    state = adam_state_from_jax(model, s1.count, jax.tree_util.tree_map(
        np.asarray, s1.mu), jax.tree_util.tree_map(np.asarray, s1.nu))
    step = make_train_step(model, GraphLoss(0.25), NUM_FIELDS, N_OUT, 1.0)
    loss, gnorm = step(state, Graph.from_numpy(remus_step_case["graph"],
                                               "cpu"), LR, True)
    np.testing.assert_allclose(float(loss), l2, rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), g2, rtol=1e-4)
    _assert_params(model, p2)


def test_remus_val_step_matches_jax(remus_step_case):
    model = _port_model(remus_step_case, remus_step_case["steps"][0][0])
    got = make_val_step(model, GraphLoss(0.25), NUM_FIELDS, 3)(
        Graph.from_numpy(remus_step_case["graph"], "cpu"))
    np.testing.assert_allclose(float(got), remus_step_case["val"], rtol=1e-4)


def test_bundled_checkpoint_train_step_matches_jax(remus_batch):
    """One training step from the bundled 128-wide REMuS weights: the
    port's first-step gradients at 2e-4 of each tensor's max abs against
    the JAX package's gradient of the same loss, and ``train_step``'s loss
    and gradient norm against it at rtol 1e-4."""
    jmodel = g4c.nn.NsRotEquiThreeScaleGNN(checkpoint=CHK)
    jgraph = JaxGraph(data=dict(remus_batch.data)).to_device()
    crit = JaxGraphLoss(0.25)
    ref_loss, ref = jax.jit(jax.value_and_grad(
        lambda p: crit(jgraph, jmodel.apply(p, jgraph),
                       jgraph.target[:, :NUM_FIELDS])))(jmodel.params)
    ref_norm = float(jax_grad_norm2(ref))
    ref = params_from_jax(jax.tree_util.tree_map(np.asarray, ref))
    model = NsRotEquiThreeScaleGNN(checkpoint=CHK, device="cpu")
    assert model.layers["mp111"].angle_mlp.weights[1].shape == (128, 128)
    g = Graph.from_numpy(attach_angle_sorts(remus_batch), "cpu")
    loss = GraphLoss(0.25)(g, model(g), g.target[:, :NUM_FIELDS])
    names = [n for n, _ in model.named_parameters()]
    for name, got in zip(names, torch.autograd.grad(
            loss, list(model.parameters()))):
        _close_to_max(got.numpy(), ref[name].numpy(), 2e-4)
    step = make_train_step(model, GraphLoss(0.25), NUM_FIELDS, 1, 1.0)
    loss, gnorm = step(adam_init(model.parameters()), g, LR, True)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), ref_norm, rtol=1e-4)
