"""The port's training slice against the JAX package, on the CPU.

* ``mlp_chain_bwd_plain`` against ``jax.vjp`` of the Pallas MLP chain in
  interpret mode (and of the XLA chain for the narrow widths), at 2e-4;
* ``gn_block_bwd_plain`` against ``jax.vjp`` of the GN block with the
  window-gather kernel in interpret mode, at 2e-4; the port's autograd
  through ``blocks.gn_block`` against ``jax.grad`` of the JAX block (the
  ``Ws`` rows of the first edge layer included);
* ``gather_sorted`` against ``gather_sorted_bwd``; ``GraphLoss`` and
  ``grad_norm2`` against the JAX ones;
* ``make_train_step`` and ``make_val_step`` on a 32-wide 3-scale model,
  with the same numpy-seeded weights and the Adam state carried across:
  mean loss and gradient norm at rtol 1e-4, first-step gradients at 2e-4
  of each tensor's max abs, parameters after a step at rtol 5e-3 and atol
  2 lr.

On the CPU every wrapper takes its plain version, so the gradients go
through the plain backwards; ``test_torch_cuda.py`` holds the kernels
against them on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu.loader import collate as jax_collate
from graphs4cfd_tpu.nn import blocks as jax_blocks
from graphs4cfd_tpu.nn.losses import GraphLoss as JaxGraphLoss
from graphs4cfd_tpu.nn.mlp import apply_mlp_tail as jax_apply_mlp_tail
from graphs4cfd_tpu.nn.mlp import init_mlp
from graphs4cfd_tpu.nn.model import grad_norm2 as jax_grad_norm2
from graphs4cfd_tpu.ops import pallas_gnblock as pg
from graphs4cfd_tpu.ops import segment as jax_segment
from graphs4cfd_tpu.ops.pallas_mlp import fused_mlp
from graphs4cfd_tpu.training import trainer as jax_trainer
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import collate
from graphs4cfd_tpu_torch.nn import (GraphLoss, NsThreeScaleGNN, blocks,
                                     grad_norm2, init_params_numpy,
                                     params_from_jax)
from graphs4cfd_tpu_torch.nn.mlp import apply_mlp_tail
from graphs4cfd_tpu_torch.ops import fused_mlp as port_mlp
from graphs4cfd_tpu_torch.ops import gn_block as port_gn
from graphs4cfd_tpu_torch.ops import segment
from graphs4cfd_tpu_torch.training import (adam_init, adam_state_from_jax,
                                           make_train_step, make_val_step)
from test_torch_host import port_samples
from test_torch_kernels import _block_module, _chain, _mlp_module, _t
from test_torch_mus import _jax_model, small_arch
from test_window_gather import _device_plan, _mk

TOL = dict(rtol=2e-4, atol=2e-4)
LR = 1e-4


def _close_to_max(got, ref, frac):
    """Every element within ``frac`` of the reference tensor's max abs."""
    ref = np.asarray(ref)
    scale = max(float(np.abs(ref).max()), 1e-30)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0,
                               atol=frac * scale)


def _mlp_grads(tree):
    """A JAX MLP cotangent tree as ``([dW], [db], (dscale, dbias))``."""
    ln = tree.get("ln")
    return ([l["w"] for l in tree["layers"]], [l["b"] for l in tree["layers"]],
            (ln["scale"], ln["bias"]) if ln is not None else None)


def _assert_chain_grads(got, ref, skip=0, **tol):
    (gw, gb, gln), (rw, rb, rln) = got, ref
    assert len(gw) == len(rw) - skip and len(gb) == len(rb) - skip
    for a, b in zip(list(gw) + list(gb), list(rw[skip:]) + list(rb[skip:])):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)
    assert (gln is None) == (rln is None)
    for a, b in zip(gln or (), rln or ()):
        np.testing.assert_allclose(_np(a), np.asarray(b), **tol)


def _assert_chain_grads_to_max(got, ref, skip=0, frac=2e-4):
    """``_assert_chain_grads`` with each tensor held at ``frac`` of its
    reference's max abs (``_close_to_max``)."""
    (gw, gb, gln), (rw, rb, rln) = got, ref
    assert len(gw) == len(rw) - skip and len(gb) == len(rb) - skip
    assert (gln is None) == (rln is None)
    for a, b in zip(list(gw) + list(gb) + list(gln or ()),
                    list(rw[skip:]) + list(rb[skip:]) + list(rln or ())):
        _close_to_max(_np(a), b, frac)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else x


@pytest.mark.parametrize("start,ln", [(0, True), (0, False), (1, True),
                                      (1, False)])
def test_mlp_chain_bwd_plain_matches_pallas_vjp(rng, start, ln):
    params = init_mlp(jax.random.key(1), 256, (128, 128, 128), ln)
    fin = 256 if start == 0 else 128
    x = rng.normal(size=(512, fin)).astype(np.float32)
    g = rng.normal(size=(512, 128)).astype(np.float32)
    out, vjp = jax.vjp(lambda x, p: fused_mlp(p, x, start=start, block=256,
                                              interpret=True),
                       jnp.asarray(x), params)
    rdx, rparams = vjp(jnp.asarray(g))
    ws, bs, lns = _chain(params)
    dx, dws, dbs, dln = port_mlp.mlp_chain_bwd(
        _t(x), _t(g), ws[start:], bs[start:], lns[0] if lns else None,
        preact_input=start > 0)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), **TOL)
    # each weight, bias and LayerNorm gradient sums 512 rows, and f32
    # rounds such a sum in proportion to the tensor's largest entries (up
    # to about 180 here): each tensor is held at 2e-4 of its max abs, as
    # every other gradient check of the port is, not entry by entry
    _assert_chain_grads_to_max((dws, dbs, dln), _mlp_grads(rparams),
                               skip=start, frac=2e-4)
    # the autograd route through the module reaches the same backward
    mod = _mlp_module(params)
    xt = _t(x).requires_grad_()
    apply_mlp_tail(mod, xt, start=start).backward(_t(g))
    np.testing.assert_array_equal(xt.grad.numpy(), dx.numpy())
    for p, ref in zip(list(mod.weights)[start:], dws):
        np.testing.assert_array_equal(p.grad.numpy(), ref.numpy())


@pytest.mark.parametrize("in_dim,widths", [(2, (32, 32, 32)),
                                           (130, (64, 64, 3)),
                                           (5, (128, 128, 128))])
def test_mlp_chain_bwd_plain_matches_xla_narrow(rng, in_dim, widths):
    """The encoder, decoder and pooling widths of the MuS models."""
    params = init_mlp(jax.random.key(2), in_dim, widths, False)
    x = rng.normal(size=(77, in_dim)).astype(np.float32)
    g = rng.normal(size=(77, widths[-1])).astype(np.float32)
    _, vjp = jax.vjp(lambda x, p: jax_apply_mlp_tail(p, x, start=0),
                     jnp.asarray(x), params)
    rdx, rparams = vjp(jnp.asarray(g))
    ws, bs, _ = _chain(params)
    dx, dws, dbs, dln = port_mlp.mlp_chain_bwd(_t(x), _t(g), ws, bs)
    np.testing.assert_allclose(dx.numpy(), np.asarray(rdx), **TOL)
    _assert_chain_grads((dws, dbs, dln), _mlp_grads(rparams), **TOL)
    # an encoder's input needs no gradient: dx is skipped
    assert port_mlp.mlp_chain_bwd(_t(x), _t(g), ws, bs,
                                  need_dx=False)[0] is None


def _wg_case(rng, V=256, k=4, H=32):
    """A GN block's inputs with a window plan for the JAX kernel, as
    ``test_window_gather.py`` builds one."""
    _, senders, plan = _mk(rng, N=V, M=V * k, H=H, block_rows=128,
                           window=128, spread=40)
    v = rng.normal(size=(V, H)).astype(np.float32)
    e = rng.normal(size=(V * k, H)).astype(np.float32)
    params = {"edge_mlp": init_mlp(jax.random.key(0), 3 * H, (H, H, H), True),
              "node_mlp": init_mlp(jax.random.key(1), 2 * H, (H, H, H), True)}
    return v, e, senders, plan, params


@pytest.mark.parametrize("skip_e", [False, True])
def test_gn_block_bwd_plain_matches_window_gather_kernel(rng, skip_e):
    V, k, H = 256, 4, 32
    v, e, senders, plan, params = _wg_case(rng, V, k, H)
    w1 = params["edge_mlp"]["layers"][0]["w"]
    vs = np.asarray(jnp.asarray(v) @ w1[H:2 * H])
    assert pg.supports_wg(_device_plan(plan), V, k)

    def fwd(em, nm, e, vs, v):
        return pg.gn_block_fused_wg(em, nm, e, vs, v, k, _device_plan(plan),
                                    interpret=True, out_activation="selu",
                                    skip_e_out=skip_e)

    (re, rv), vjp = jax.vjp(fwd, params["edge_mlp"], params["node_mlp"],
                            jnp.asarray(e), jnp.asarray(vs), jnp.asarray(v))
    gv = rng.normal(size=(V, H)).astype(np.float32)
    ge = None if skip_e else rng.normal(size=(V * k, H)).astype(np.float32)
    r_em, r_nm, r_de, r_dvs, r_dv = vjp((None if skip_e else jnp.asarray(ge),
                                         jnp.asarray(gv)))
    de, dv, dvs, dedge, dnode = port_gn.gn_block_bwd(
        _t(e), _t(vs), _t(v), torch.from_numpy(senders), None, k,
        _chain(params["edge_mlp"]), _chain(params["node_mlp"]), _t(gv),
        None if skip_e else _t(ge), out_selu=True)
    for got, ref in ((de, r_de), (dv, r_dv), (dvs, r_dvs)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    _assert_chain_grads(dedge, _mlp_grads(r_em), **TOL)
    _assert_chain_grads(dnode, _mlp_grads(r_nm), **TOL)
    # the Ws rows: neither kernel gives them a gradient (autograd does)
    assert not dedge[0][0][H:2 * H].any()


@pytest.mark.parametrize("skip_e", [False, True])
def test_gn_block_autograd_matches_jax_block_grads(rng, skip_e):
    """Through ``blocks.gn_block`` at level 1: every parameter gradient,
    the Ws rows of the first edge layer included, and ``dv``, ``de``."""
    V, k, H = 96, 6, 32
    v = rng.normal(size=(V, H)).astype(np.float32)
    e = rng.normal(size=(V * k, H)).astype(np.float32)
    senders = rng.integers(0, V, V * k).astype(np.int32)
    receivers = np.repeat(np.arange(V, dtype=np.int32), k)
    params = {"edge_mlp": init_mlp(jax.random.key(5), 3 * H, (H, H, H), True),
              "node_mlp": init_mlp(jax.random.key(6), 2 * H, (H, H, H), True)}
    gv = rng.normal(size=(V, H)).astype(np.float32)
    ge = rng.normal(size=(V * k, H)).astype(np.float32)

    def loss(p, v, e):
        rv, re = jax_blocks.gn_block(p, v, e, jnp.asarray(senders),
                                     jnp.asarray(receivers), fixed_k=k,
                                     out_activation="selu", skip_e_out=skip_e)
        out = (rv * gv).sum()
        return out if skip_e else out + (re * ge).sum()

    rp, rdv, rde = jax.grad(loss, argnums=(0, 1, 2))(
        params, jnp.asarray(v), jnp.asarray(e))
    block = _block_module(params)
    vt, et = _t(v).requires_grad_(), _t(e).requires_grad_()
    perm = np.argsort(senders, kind="stable").astype(np.int32)
    sort = (torch.from_numpy(perm), torch.from_numpy(senders[perm]))
    gvn, gen = blocks.gn_block(block, vt, et, torch.from_numpy(senders),
                               torch.from_numpy(receivers), fixed_k=k,
                               out_selu=True, skip_e_out=skip_e,
                               sender_sort=sort)
    out = (gvn * _t(gv)).sum()
    (out if skip_e else out + (gen * _t(ge)).sum()).backward()
    np.testing.assert_allclose(vt.grad.numpy(), np.asarray(rdv), **TOL)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(rde), **TOL)
    for name in ("edge_mlp", "node_mlp"):
        mlp = getattr(block, name)
        got = ([w.grad for w in mlp.weights], [b.grad for b in mlp.biases],
               (mlp.ln_scale.grad, mlp.ln_bias.grad))
        _assert_chain_grads(got, _mlp_grads(rp[name]), **TOL)


def test_gather_sorted_backward_matches_jax(rng):
    N, E, F = 50, 300, 8
    x = rng.normal(size=(N, F)).astype(np.float32)
    idx = rng.integers(0, N - 5, E).astype(np.int32)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    ct = rng.normal(size=(E, F)).astype(np.float32)
    out, vjp = jax.vjp(lambda x: jax_segment.gather_sorted_bwd(
        x, jnp.asarray(idx), jnp.asarray(perm), jnp.asarray(idx[perm])),
        jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(ct))
    xt = _t(x).requires_grad_()
    got = segment.gather_sorted(xt, torch.from_numpy(idx),
                                torch.from_numpy(perm),
                                torch.from_numpy(idx[perm]))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(_t(ct))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    assert not xt.grad[N - 5:].any()   # rows no edge reads get zeros


@pytest.mark.parametrize("lambda_d", [0.0, 0.25])
def test_graph_loss_and_grad_norm_match_jax(rng, lambda_d):
    V, nf = 200, 3
    mask = np.ones(V, bool)
    mask[-37:] = False
    data = {"node_mask": mask,
            "omega": (rng.random((V, 1)) < 0.2).astype(np.float32)}
    pred = rng.normal(size=(V, nf)).astype(np.float32)
    target = rng.normal(size=(V, nf)).astype(np.float32)
    pred[~mask] = 1e6                  # pad rows must not count
    ref_terms = JaxGraphLoss(lambda_d).local_terms(
        g4c.graph.Graph(data=data), jnp.asarray(pred), jnp.asarray(target))
    ref = JaxGraphLoss(lambda_d)(g4c.graph.Graph(data=data),
                                 jnp.asarray(pred), jnp.asarray(target))
    graph = Graph.from_numpy(data, "cpu")
    terms = GraphLoss(lambda_d).local_terms(graph, _t(pred), _t(target))
    got = GraphLoss(lambda_d)(graph, _t(pred), _t(target))
    np.testing.assert_allclose(terms.numpy(), np.asarray(ref_terms),
                               rtol=1e-6)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)
    grads = [rng.normal(size=s).astype(np.float32)
             for s in ((7, 5), (5,), (128, 128))]
    np.testing.assert_allclose(float(grad_norm2([_t(g) for g in grads])),
                               float(jax_grad_norm2(grads)), rtol=1e-6)


N_OUT = 2


@pytest.fixture(scope="module")
def step_case():
    """One JAX run of everything the training-step tests compare with."""
    arch = small_arch()
    tree = init_params_numpy(arch, seed=3)
    samples = port_samples(2, 400, seed=5)
    jgraph = jax_collate(samples, node_bucket=64,
                         edge_bucket=128).to_device()
    jmodel = _jax_model(arch, tree)
    crit = JaxGraphLoss(0.25)
    jstep = jax_trainer.make_train_step(jmodel.apply, crit, 3, N_OUT, 1.0)
    s0 = jax_trainer._adam_opt().init(jmodel.params)
    p1, s1, l1, g1 = jstep(jmodel.params, s0, jgraph, LR, True)
    p2, s2, l2, g2 = jstep(p1, s1, jgraph, LR, True)
    grads = jax.grad(lambda p: crit(jgraph, jmodel.apply(p, jgraph),
                                    jgraph.target[:, :3]))(jmodel.params)
    val = jax_trainer.make_val_step(jmodel.apply, crit, 3, 3)(p1, jgraph)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    return dict(arch=arch, graph=collate(samples, node_bucket=64,
                                         edge_bucket=128),
                steps=[(to_np(p1), s1, float(l1), float(g1)),
                       (to_np(p2), s2, float(l2), float(g2))],
                grads=params_from_jax(to_np(grads)), val=float(val))


def _port_model(case, tree=None):
    model = NsThreeScaleGNN(arch=case["arch"], seed=3, device="cpu")
    if tree is not None:
        model.load_state_dict(params_from_jax(tree))
    return model


def _assert_params(model, tree):
    ref = params_from_jax(tree)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=5e-3, atol=2 * LR, err_msg=name)


def test_first_step_gradients_match_jax(step_case):
    model = _port_model(step_case)
    g = Graph.from_numpy(step_case["graph"], "cpu")
    loss = GraphLoss(0.25)(g, model(g), g.target[:, :3])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert set(names) == set(step_case["grads"])
    for name, got in zip(names, grads):
        _close_to_max(got.numpy(), step_case["grads"][name].numpy(), 2e-4)


def test_train_step_matches_jax(step_case):
    model = _port_model(step_case)
    state = adam_init(model.parameters())
    step = make_train_step(model, GraphLoss(0.25), 3, N_OUT, 1.0)
    loss, gnorm = step(state, Graph.from_numpy(step_case["graph"], "cpu"),
                       LR, True)
    p1, s1, l1, g1 = step_case["steps"][0]
    np.testing.assert_allclose(float(loss), l1, rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), g1, rtol=1e-4)
    assert state.count == int(s1.count) == N_OUT
    _assert_params(model, p1)


def test_train_step_carries_jax_adam_state(step_case):
    """A second step from the JAX package's parameters and Adam state."""
    p1, s1, _, _ = step_case["steps"][0]
    p2, _, l2, g2 = step_case["steps"][1]
    model = _port_model(step_case, p1)
    state = adam_state_from_jax(model, s1.count, jax.tree_util.tree_map(
        np.asarray, s1.mu), jax.tree_util.tree_map(np.asarray, s1.nu))
    step = make_train_step(model, GraphLoss(0.25), 3, N_OUT, 1.0)
    loss, gnorm = step(state, Graph.from_numpy(step_case["graph"], "cpu"),
                       LR, True)
    np.testing.assert_allclose(float(loss), l2, rtol=1e-4)
    np.testing.assert_allclose(float(gnorm), g2, rtol=1e-4)
    _assert_params(model, p2)


def test_val_step_matches_jax(step_case):
    model = _port_model(step_case, step_case["steps"][0][0])
    got = make_val_step(model, GraphLoss(0.25), 3, 3)(
        Graph.from_numpy(step_case["graph"], "cpu"))
    np.testing.assert_allclose(float(got), step_case["val"], rtol=1e-4)
