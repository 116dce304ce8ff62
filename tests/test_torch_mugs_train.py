"""The port's gMuS-GNN training slice against the JAX package, on the CPU.

* ``gn_block_bwd_plain`` at gMuS's node inputs (``fv`` = 128, and 256
  after an up step) against ``jax.vjp`` of the JAX package's GN kernels in
  Pallas interpret mode, at 2e-4 of each output's max abs: the
  window-gather kernel (``gn_block_fused_wg``, level 1; its ``dvs`` is the
  port's) and the kernel fed gathered sender rows (``gn_block_fused``, the
  coarse levels with pad nodes; its ``dvsg`` summed per sender is the
  port's ``dvs``);
* the port's autograd through ``blocks.gn_block`` with a 256-wide node
  input against ``jax.grad`` of the JAX block on its Pallas route
  (interpret mode), the first edge layer's ``Ws`` rows included;
* every level's sender sort reaches its layers (``attach_sender_sorts``);
* ``make_train_step`` and ``make_val_step`` on a 32-wide 3-scale gMuS
  model with the same numpy-seeded weights and the Adam state carried
  across: mean loss and gradient norm at rtol 1e-4, first-step gradients
  at 2e-4 of each tensor's max abs, parameters after a step at rtol 5e-3
  and atol 2 lr (the tolerances of ``test_torch_train.py``);
* one training step from the bundled 128-wide 3-scale gMuS checkpoint: its
  gradients at 2e-4 of each tensor's max abs (against the JAX package's
  float64 gradients, see ``_jax_grads_f64``), loss and gradient norm at
  rtol 1e-4.

Sizes are small: 2 clouds of 300 nodes, k = 6, 3 levels.  On the CPU
every wrapper takes its plain version; ``test_torch_cuda.py`` and
``chip_smoke.py`` hold the kernels against those on a card.
"""
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
from graphs4cfd_tpu.nn.model import grad_norm2 as jax_grad_norm2
from graphs4cfd_tpu.ops import pallas_gnblock as pg
from graphs4cfd_tpu.training import trainer as jax_trainer
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import attach_sender_sorts
from graphs4cfd_tpu_torch.nn import (GraphLoss, NsThreeGuillardScaleGNN,
                                     blocks, init_params_numpy,
                                     params_from_jax)
from graphs4cfd_tpu_torch.ops import gn_block as port_gn
from graphs4cfd_tpu_torch.training import (adam_init, adam_state_from_jax,
                                           make_train_step, make_val_step)
from test_torch_kernels import _block_module, _chain, _t
from test_torch_mugs import (CHK3, K, coarse_case, gn_params, mugs_batch,
                             small_mugs_arch, wg_case)
from test_torch_remus_train import _host_sort, _jax_grads_f64
from test_torch_train import (_assert_chain_grads_to_max, _close_to_max,
                              _mlp_grads)
from test_window_gather import _device_plan

FRAC = 2e-4
LR = 1e-4
N_OUT = 2
NUM_FIELDS = 3


@pytest.fixture(scope="module")
def batch():
    return mugs_batch()


def _assert_bwd(got, refs, ref_em, ref_nm, H, fv):
    de, dv, dvs, dedge, dnode = got
    for a, b in zip((de, dv, dvs), refs):
        assert a.shape == b.shape
        _close_to_max(a.numpy(), b, FRAC)
    _assert_chain_grads_to_max(dedge, _mlp_grads(ref_em), frac=FRAC)
    _assert_chain_grads_to_max(dnode, _mlp_grads(ref_nm), frac=FRAC)
    assert not dedge[0][0][H:H + fv].any()      # the Ws rows
    assert dv.shape[1] == fv


# -------------------------------------------- row 6: the level-1 backward
@pytest.mark.parametrize("fv", [128, 256])
@pytest.mark.parametrize("skip_e", [False, True])
def test_gn_block_bwd_plain_matches_window_gather_kernel_vjp(rng, fv,
                                                             skip_e):
    """``mp12x`` (fv 128) and ``mp121`` (fv 256) at level 1: the port's
    backward against the window-gather kernel's custom VJP
    (``_gn_wg_vjp_bwd``), whose ``dvs`` is already summed per sender."""
    V, k, H = 192, K, 128
    v, e, vs, senders, plan, params = wg_case(rng, fv, V, k, H)

    def fwd(em, nm, e, vs, v):
        return pg.gn_block_fused_wg(em, nm, e, vs, v, k, _device_plan(plan),
                                    interpret=True, out_activation="selu",
                                    skip_e_out=skip_e)

    _, vjp = jax.vjp(fwd, params["edge_mlp"], params["node_mlp"],
                     jnp.asarray(e), jnp.asarray(vs), jnp.asarray(v))
    gv = rng.normal(size=(V, H)).astype(np.float32)
    ge = None if skip_e else rng.normal(size=(V * k, H)).astype(np.float32)
    r_em, r_nm, r_de, r_dvs, r_dv = vjp((None if skip_e else jnp.asarray(ge),
                                         jnp.asarray(gv)))
    got = port_gn.gn_block_bwd_plain(
        _t(e), _t(vs), _t(v), torch.from_numpy(senders), _host_sort(senders),
        k, _chain(params["edge_mlp"]), _chain(params["node_mlp"]), _t(gv),
        None if skip_e else _t(ge), out_selu=True)
    _assert_bwd(got, [np.asarray(x) for x in (r_de, r_dv, r_dvs)], r_em,
                r_nm, H, fv)


# ------------------------------------------ row 4: the coarse backward
@pytest.mark.parametrize("fv", [128, 256])
@pytest.mark.parametrize("out_selu", [False, True])
def test_gn_block_bwd_plain_matches_gn_block_fused_vjp_coarse_shapes(
        rng, fv, out_selu):
    """``mp2xx``/``mp3x`` (fv 128) and ``mp221`` (fv 256) at a coarse level
    with pad nodes.  JAX's ``dvsg`` is per edge; summed per sender in
    float64 it is the port's ``dvs``.  The pad rows' gradients stay
    finite."""
    V, k, H = 64, K, 128
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
    got = port_gn.gn_block_bwd_plain(
        _t(e), _t(vs), _t(v), torch.from_numpy(senders), _host_sort(senders),
        k, _chain(params["edge_mlp"]), _chain(params["node_mlp"]), _t(gv),
        _t(ge), out_selu=out_selu)
    _assert_bwd(got, [np.asarray(r_de), np.asarray(r_dv), ref_dvs], r_em,
                r_nm, H, fv)
    assert all(torch.isfinite(t).all() for t in got[:3])


# --------------------------------------------------------- block autograd
@pytest.fixture
def pallas_on(monkeypatch):
    """The JAX blocks take their Pallas route (interpret mode here)."""
    monkeypatch.setattr(g4c_config, "use_pallas", True)
    g4c_config.fast_path_report(reset=True)


def test_gn_block_autograd_with_a_wide_node_input_matches_jax(rng,
                                                             pallas_on):
    """Through ``blocks.gn_block`` with ``v`` 256 wide (``mp221`` at a
    coarse level, 256 nodes: the JAX kernel's node block): every parameter
    gradient, the ``Ws`` rows of the first edge layer (autograd gives them
    through ``vs = v @ Ws``) included, and ``dv``, ``de``."""
    V, k, H, fv = 256, K, 128, 256
    v = rng.normal(size=(V, fv)).astype(np.float32)
    e = rng.normal(size=(V * k, H)).astype(np.float32)
    senders = rng.integers(0, V, V * k).astype(np.int32)
    receivers = np.repeat(np.arange(V, dtype=np.int32), k)
    params = gn_params(21, fv, H)
    gv = rng.normal(size=(V, H)).astype(np.float32)
    ge = rng.normal(size=(V * k, H)).astype(np.float32)

    def loss(p, v, e):
        rv, re = jax_blocks.gn_block(p, v, e, jnp.asarray(senders),
                                     jnp.asarray(receivers), fixed_k=k,
                                     out_activation="selu")
        return (rv * gv).sum() + (re * ge).sum()

    rp, rdv, rde = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(v), jnp.asarray(e))
    assert g4c_config.fast_path_report().get("gn_block:fused")
    block = _block_module(params)
    vt, et = _t(v).requires_grad_(), _t(e).requires_grad_()
    gvn, gen = blocks.gn_block(block, vt, et, torch.from_numpy(senders),
                               torch.from_numpy(receivers), fixed_k=k,
                               out_selu=True, sender_sort=_host_sort(senders))
    ((gvn * _t(gv)).sum() + (gen * _t(ge)).sum()).backward()
    _close_to_max(vt.grad.numpy(), np.asarray(rdv), FRAC)
    _close_to_max(et.grad.numpy(), np.asarray(rde), FRAC)
    for name in ("edge_mlp", "node_mlp"):
        mlp = getattr(block, name)
        got = ([w.grad for w in mlp.weights], [b.grad for b in mlp.biases],
               (mlp.ln_scale.grad, mlp.ln_bias.grad))
        _assert_chain_grads_to_max(got, _mlp_grads(rp[name]), frac=FRAC)
    assert block.edge_mlp.weights[0].grad[H:H + fv].any()


def test_gmus_layers_get_the_host_sorts(batch, monkeypatch):
    """``mugs_apply`` hands every layer the sort of its own level's
    senders, and the backward sums ``dvs`` over it."""
    graph = Graph.from_numpy(attach_sender_sorts(batch), "cpu")
    seen, real = [], port_gn.gn_block_bwd

    def spy(e, vs, v, senders, sender_sort, *args, **kw):
        seen.append((v.shape[0], senders, sender_sort))
        return real(e, vs, v, senders, sender_sort, *args, **kw)

    monkeypatch.setattr(port_gn, "gn_block_bwd", spy)
    model = NsThreeGuillardScaleGNN(arch=small_mugs_arch(w=16), device="cpu")
    model(graph).sum().backward()
    assert len(seen) == 9
    sizes = {batch.num_nodes: "", batch.pos_2.shape[0]: "_2",
             batch.pos_3.shape[0]: "_3"}
    for V, senders, (perm, srt) in seen:
        s = sizes[V]
        assert torch.equal(perm, graph.data[f"sender_perm{s}"])
        assert torch.equal(srt, graph.data[f"sender_sorted{s}"])
        assert torch.equal(senders, graph.data[f"senders{s}"])


# ---------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def mugs_step_case(batch):
    """One JAX run of everything the training-step tests compare with."""
    arch = small_mugs_arch()
    tree = init_params_numpy(arch, seed=3)
    jgraph = JaxGraph(data=dict(batch.data)).to_device()
    jmodel = g4c.nn.NsThreeGuillardScaleGNN(arch=arch)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, tree)
    crit = JaxGraphLoss(0.25)
    jstep = jax_trainer.make_train_step(jmodel.apply, crit, NUM_FIELDS,
                                        N_OUT, 1.0)
    s0 = jax_trainer._adam_opt().init(jmodel.params)
    p1, s1, l1, g1 = jstep(jmodel.params, s0, jgraph, LR, True)
    p2, _, l2, g2 = jstep(p1, s1, jgraph, LR, True)
    grads = jax.grad(lambda p: crit(jgraph, jmodel.apply(p, jgraph),
                                    jgraph.target[:, :NUM_FIELDS]))(
        jmodel.params)
    val = jax_trainer.make_val_step(jmodel.apply, crit, NUM_FIELDS, 3)(
        p1, jgraph)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(arch=arch, tree=tree, graph=attach_sender_sorts(batch),
                steps=[(to_np(p1), s1, float(l1), float(g1)),
                       (to_np(p2), float(l2), float(g2))],
                grads=params_from_jax(to_np(grads)), val=float(val))


def _port_model(case, tree):
    model = NsThreeGuillardScaleGNN(arch=case["arch"], seed=0, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    return model


def _assert_params(model, tree):
    ref = params_from_jax(tree)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=5e-3, atol=2 * LR, err_msg=name)


def test_gmus_first_step_gradients_match_jax(mugs_step_case):
    model = _port_model(mugs_step_case, mugs_step_case["tree"])
    g = Graph.from_numpy(mugs_step_case["graph"], "cpu")
    loss = GraphLoss(0.25)(g, model(g), g.target[:, :NUM_FIELDS])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert set(names) == set(mugs_step_case["grads"])
    for name, got in zip(names, grads):
        _close_to_max(got.numpy(), mugs_step_case["grads"][name].numpy(),
                      FRAC)


def test_gmus_train_step_matches_jax(mugs_step_case):
    model = _port_model(mugs_step_case, mugs_step_case["tree"])
    state = adam_init(model.parameters())
    step = make_train_step(model, GraphLoss(0.25), NUM_FIELDS, N_OUT, 1.0)
    loss, gnorm = step(state, Graph.from_numpy(mugs_step_case["graph"],
                                               "cpu"), LR, True)
    p1, s1, l1, g1 = mugs_step_case["steps"][0]
    np.testing.assert_allclose(float(loss), l1, rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), g1, rtol=1e-4)
    assert state.count == int(s1.count) == N_OUT
    _assert_params(model, p1)


def test_gmus_train_step_carries_jax_adam_state(mugs_step_case):
    """A second step from the JAX package's parameters and Adam state."""
    p1, s1, _, _ = mugs_step_case["steps"][0]
    p2, l2, g2 = mugs_step_case["steps"][1]
    model = _port_model(mugs_step_case, p1)
    state = adam_state_from_jax(model, s1.count, jax.tree_util.tree_map(
        np.asarray, s1.mu), jax.tree_util.tree_map(np.asarray, s1.nu))
    step = make_train_step(model, GraphLoss(0.25), NUM_FIELDS, N_OUT, 1.0)
    loss, gnorm = step(state, Graph.from_numpy(mugs_step_case["graph"],
                                               "cpu"), LR, True)
    np.testing.assert_allclose(float(loss), l2, rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), g2, rtol=1e-4)
    _assert_params(model, p2)


def test_gmus_val_step_matches_jax(mugs_step_case):
    model = _port_model(mugs_step_case, mugs_step_case["steps"][0][0])
    got = make_val_step(model, GraphLoss(0.25), NUM_FIELDS, 3)(
        Graph.from_numpy(mugs_step_case["graph"], "cpu"))
    np.testing.assert_allclose(float(got), mugs_step_case["val"], rtol=1e-4)


def test_bundled_checkpoint_train_step_matches_jax(batch):
    """One training step from the bundled 128-wide 3-scale gMuS weights:
    the port's first-step gradients at 2e-4 of each tensor's max abs
    against the JAX package's gradient of the same loss, and
    ``train_step``'s loss and gradient norm against the JAX package's at
    rtol 1e-4.  The bundled weights leave ``edge_encoder2``'s gradients
    near 1e-9, the sum of much larger terms that cancel: there the JAX
    package's own f32 gradients on the CPU lie further than 2e-4 of the
    tensor's max abs from its float64 ones, where the port's lie well
    within, so the gradients are held against the float64 ones
    (``_jax_grads_f64``)."""
    jmodel = g4c.nn.NsThreeGuillardScaleGNN(checkpoint=CHK3)
    jgraph = JaxGraph(data=dict(batch.data)).to_device()
    crit = JaxGraphLoss(0.25)
    ref_loss, ref = jax.jit(jax.value_and_grad(
        lambda p: crit(jgraph, jmodel.apply(p, jgraph),
                       jgraph.target[:, :NUM_FIELDS])))(jmodel.params)
    ref_norm = float(jax_grad_norm2(ref))
    ref = _jax_grads_f64(jmodel.arch, jmodel.params, batch, crit,
                         model_cls=g4c.nn.NsThreeGuillardScaleGNN,
                         nf=NUM_FIELDS)
    model = NsThreeGuillardScaleGNN(checkpoint=CHK3, device="cpu")
    assert model.layers["mp121"].edge_mlp.weights[0].shape == (640, 128)
    g = Graph.from_numpy(attach_sender_sorts(batch), "cpu")
    loss = GraphLoss(0.25)(g, model(g), g.target[:, :NUM_FIELDS])
    names = [n for n, _ in model.named_parameters()]
    for name, got in zip(names, torch.autograd.grad(
            loss, list(model.parameters()))):
        _close_to_max(got.numpy().astype(np.float64), ref[name].numpy(),
                      FRAC)
    step = make_train_step(model, GraphLoss(0.25), NUM_FIELDS, 1, 1.0)
    loss, gnorm = step(adam_init(model.parameters()), g, LR, True)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), ref_norm, rtol=1e-4)
