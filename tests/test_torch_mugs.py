"""The port's gMuS-GNN slice against the JAX package, on the CPU.

* the host pipeline (SpatialSort -> GuillardCoarseningAndConnectKNN ->
  BuildKnnInterpWeights -> collate) gives arrays byte-equal to the JAX
  package's; ``attach_sender_sorts`` adds stable argsorts of every level's
  senders;
* the GN block's plain version at gMuS's node inputs (``fv`` = 128, and
  256 after an up step) against the JAX package's GN kernels in Pallas
  interpret mode, at 2e-4: the window-gather kernel
  (``gn_block_fused_wg``, level 1, with a window plan as
  ``tests/test_window_gather.py`` builds one) and the kernel fed gathered
  sender rows (``gn_block_fused``, the coarse levels, pad nodes included);
* the bundled gMuS checkpoints (2 and 3 scales, 128 wide): one step at
  2e-4, ``solve(n_out=3)`` at 1e-3; a random-weight arch carried across;
  the weight round trip; the execution plan; which layers run the kernel's
  route, with which sorts and which dead edge outputs.

Sizes are small: 2 clouds of 300 nodes, k = 6, 3 levels.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu import transforms as JT
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.loader import collate as jax_collate
from graphs4cfd_tpu.nn.mlp import init_mlp
from graphs4cfd_tpu.nn.mugs_gnn import build_mugs_plan as jax_plan
from graphs4cfd_tpu.ops import pallas_gnblock as pg
from graphs4cfd_tpu.training.rollout import solve as jax_solve
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import attach_sender_sorts, collate
from graphs4cfd_tpu_torch.nn import (MuGSGNN, NsThreeGuillardScaleGNN,
                                     NsTwoGuillardScaleGNN, build_mugs_plan,
                                     init_params_numpy, params_from_jax,
                                     params_to_numpy)
from graphs4cfd_tpu_torch.ops import gn_block as port_gn
from graphs4cfd_tpu_torch.training import load_checkpoint
from test_torch_host import _assert_byte_equal
from test_torch_kernels import _chain, _t
from test_torch_remus import _clouds
from test_window_gather import _device_plan, _mk

TOL = dict(rtol=2e-4, atol=2e-4)
K = 6
WEIGHTS = os.path.join(os.path.dirname(g4c.__file__), "nn", "weights",
                       "NsMuGSGNN")
CHK3 = os.path.join(WEIGHTS, "NsThreeGuillardScaleGNN_taylor_green_tpu.chk")
CHK2 = os.path.join(WEIGHTS, "NsTwoGuillardScaleGNN_taylor_green_tpu.chk")


def _pipeline(tf, graphs, levels=3):
    steps = [tf.SpatialSort(),
             tf.GuillardCoarseningAndConnectKNN(
                 k=[K] * levels,
                 scale_edge_attr=(0.1, 0.25, 0.5)[:levels]),
             tf.BuildKnnInterpWeights(K)]
    for t in steps:
        graphs = [t(g) for g in graphs]
    return graphs


def port_mugs_samples(num=2, n_nodes=300, seed=1, levels=3):
    return _pipeline(T, _clouds(Graph, num, n_nodes, seed, nf=3), levels)


def mugs_batch(levels=3, seed=1):
    return collate(port_mugs_samples(seed=seed, levels=levels),
                   node_bucket=64, edge_bucket=128)


@pytest.fixture(scope="module")
def batch():
    return mugs_batch()


# ------------------------------------------------------------ host pipeline
@pytest.mark.parametrize("seed,n_nodes,levels", [(1, 300, 3), (4, 283, 3),
                                                 (2, 300, 2)])
def test_collated_mugs_batch_byte_equal(seed, n_nodes, levels):
    ref = jax_collate(_pipeline(JT, _clouds(JaxGraph, 2, n_nodes, seed,
                                            nf=3), levels),
                      node_bucket=64, edge_bucket=128)
    got = collate(port_mugs_samples(2, n_nodes, seed, levels),
                  node_bucket=64, edge_bucket=128)
    # the JAX package adds only its TPU window-gather plan
    extra = set(ref.data) - set(got.data)
    assert extra and all(k.startswith("wg") for k in extra), extra
    assert not set(got.data) - set(ref.data)
    for l in range(2, levels + 1):
        for key in ("down_idx", "node_origin", "senders", "receivers",
                    "edge_attr", "pos", "fixed_k", "up_idx", "up_w"):
            assert f"{key}_{l}" in got.data, (key, l)
    _assert_byte_equal(ref.data, got.data)
    assert got.num_levels == levels and got.fixed_k == K


def test_per_sample_transform_byte_equal():
    ref = _pipeline(JT, _clouds(JaxGraph, 1, 300, 9, nf=3))[0]
    got = port_mugs_samples(1, 300, 9)[0]
    assert set(ref.data) == set(got.data)
    _assert_byte_equal(ref.data, got.data)


@pytest.mark.parametrize("k", [[6], [6, 6, 6, 6, 6]])
def test_transform_refuses_level_counts(k):
    with pytest.raises(ValueError):
        T.GuillardCoarseningAndConnectKNN(k=k)


def test_attach_sender_sorts_are_stable_argsorts(batch):
    keys = set(batch.data)
    got = attach_sender_sorts(batch)
    assert set(batch.data) == keys            # collate's output as it was
    assert set(got.data) - keys == {
        "sender_perm", "sender_sorted", "sender_perm_2", "sender_sorted_2",
        "sender_perm_3", "sender_sorted_3"}
    for s in ("", "_2", "_3"):
        senders = batch.data[f"senders{s}"]
        perm, srt = got.data[f"sender_perm{s}"], got.data[f"sender_sorted{s}"]
        assert perm.dtype == srt.dtype == np.int32
        np.testing.assert_array_equal(perm,
                                      np.argsort(senders, kind="stable"))
        np.testing.assert_array_equal(srt, senders[perm])
        assert (np.diff(srt) >= 0).all()


# ------------------------------------- the kernel's module at gMuS's widths
def gn_params(seed, fv, H=128):
    """A gMuS block: the edge MLP sees ``[e, v_s, v_r]``, the node MLP
    ``[aggr, v]``; ``fv`` is 256 after an up step."""
    return {"edge_mlp": init_mlp(jax.random.key(seed), H + 2 * fv,
                                 (H, H, H), True),
            "node_mlp": init_mlp(jax.random.key(seed + 1), H + fv,
                                 (H, H, H), True)}


def wg_case(rng, fv, V=192, k=K, H=128):
    """Level 1: a GN block's inputs with a window plan for the JAX kernel
    (16 receivers, 96 edge rows per block)."""
    _, senders, plan = _mk(rng, N=V, M=V * k, H=H, block_rows=16 * k,
                           window=128, spread=30)
    v = rng.normal(size=(V, fv)).astype(np.float32)
    e = rng.normal(size=(V * k, H)).astype(np.float32)
    params = gn_params(7, fv, H)
    w1 = params["edge_mlp"]["layers"][0]["w"]
    vs = np.asarray(jnp.asarray(v) @ w1[H:H + fv])
    assert pg.supports_wg(_device_plan(plan), V, k)
    return v, e, vs, senders, plan, params


def coarse_case(rng, fv, V=64, valid=53, k=K, H=128):
    """A coarse level as ``collate`` pads it: ``valid`` nodes with k-NN
    senders among themselves, then pad nodes whose edges are self-loops."""
    senders = np.concatenate([
        rng.integers(0, valid, valid * k),
        np.arange(valid * k, V * k) // k]).astype(np.int32)
    v = rng.normal(size=(V, fv)).astype(np.float32)
    v[valid:] = 0.0
    e = rng.normal(size=(V * k, H)).astype(np.float32)
    e[valid * k:] = 0.0
    params = gn_params(11, fv, H)
    w1 = params["edge_mlp"]["layers"][0]["w"]
    vs = np.asarray(jnp.asarray(v) @ w1[H:H + fv])
    return v, e, vs, senders, params


@pytest.mark.parametrize("fv", [128, 256])
@pytest.mark.parametrize("skip_e", [False, True])
def test_gn_block_plain_matches_window_gather_kernel(rng, fv, skip_e):
    """Row 5: ``mp12x`` (fv 128) and ``mp121`` (fv 256) at level 1."""
    V, k = 192, K
    v, e, vs, senders, plan, params = wg_case(rng, fv, V, k)
    ref_e, ref_v = pg.gn_block_fused_wg(
        params["edge_mlp"], params["node_mlp"], jnp.asarray(e),
        jnp.asarray(vs), jnp.asarray(v), k, _device_plan(plan),
        interpret=True, out_activation="selu", skip_e_out=skip_e)
    got_v, got_e = port_gn.gn_block_plain(
        _t(e), _t(vs), _t(v), torch.from_numpy(senders), k,
        _chain(params["edge_mlp"]), _chain(params["node_mlp"]),
        out_selu=True, skip_e_out=skip_e)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), **TOL)
    if skip_e:
        assert got_e is None and ref_e is None
    else:
        np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e), **TOL)


@pytest.mark.parametrize("fv", [128, 256])
@pytest.mark.parametrize("out_selu", [False, True])
def test_gn_block_plain_matches_gn_block_fused_coarse_shapes(rng, fv,
                                                             out_selu):
    """Row 3: ``mp2xx``/``mp3x`` (fv 128) and ``mp221`` (fv 256) at a
    coarse level with pad nodes; the pad rows stay finite."""
    V, k = 64, K
    v, e, vs, senders, params = coarse_case(rng, fv, V)
    ref_e, ref_v = pg.gn_block_fused(
        params["edge_mlp"], params["node_mlp"], jnp.asarray(e),
        jnp.asarray(vs)[jnp.asarray(senders)], jnp.asarray(v), k, block=32,
        interpret=True, out_activation="selu" if out_selu else None)
    got_v, got_e = port_gn.gn_block_plain(
        _t(e), _t(vs), _t(v), torch.from_numpy(senders), k,
        _chain(params["edge_mlp"]), _chain(params["node_mlp"]),
        out_selu=out_selu)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), **TOL)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e), **TOL)
    assert torch.isfinite(got_v).all() and torch.isfinite(got_e).all()


def test_gn_block_check_takes_a_256_wide_node_input():
    """The kernel's gate: a node input up to 256 wide, every other width
    up to 128."""
    V, k, H = 16, K, 128

    def args(fv, h=H, fe=H):
        edge = ([torch.zeros(fe + 2 * fv, h), torch.zeros(h, h)],
                [torch.zeros(h), torch.zeros(h)], None)
        node = ([torch.zeros(h + fv, h), torch.zeros(h, h)],
                [torch.zeros(h), torch.zeros(h)], None)
        return dict(e=torch.zeros(V * k, fe), vs=torch.zeros(V, h),
                    v=torch.zeros(V, fv),
                    senders=torch.zeros(V * k, dtype=torch.int32), k=k,
                    edge=edge, node=node)

    ed, nd = port_gn._check(**args(256))
    assert ed == [H + 512, H, H] and nd == [H + 256, H, H]
    for bad in (args(257), args(128, h=129), args(128, fe=129)):
        with pytest.raises(ValueError):
            port_gn._check(**bad)


# ---------------------------------------------------------------- the slice
def _jax_graph(batch):
    return JaxGraph(data=dict(batch.data)).to_device()


@pytest.fixture(scope="module", params=[(CHK3, 3), (CHK2, 2)],
                ids=["three_scales", "two_scales"])
def checkpoint_models(request):
    chk, levels = request.param
    cls = (g4c.nn.NsThreeGuillardScaleGNN if levels == 3
           else g4c.nn.NsTwoGuillardScaleGNN)
    port_cls = (NsThreeGuillardScaleGNN if levels == 3
                else NsTwoGuillardScaleGNN)
    b = mugs_batch(levels)
    return (cls(checkpoint=chk), b, port_cls(checkpoint=chk, device="cpu"))


def test_bundled_checkpoint_forward_matches_jax(checkpoint_models):
    jax_model, b, model = checkpoint_models
    assert model.arch["mp121"][0][0] == 640
    assert model.layers["mp121"].node_mlp.weights[0].shape == (384, 128)
    ref = np.asarray(jax.jit(jax_model.apply)(jax_model.params,
                                              _jax_graph(b)))
    with torch.no_grad():
        got = model(Graph.from_numpy(b, "cpu")).numpy()
    mask = b.node_mask
    assert model.num_fields == jax_model.num_fields == 3
    assert got.shape == ref.shape == (b.num_nodes, 3)
    np.testing.assert_allclose(got[mask], ref[mask], **TOL)


def test_bundled_checkpoint_solve_matches_jax(checkpoint_models):
    jax_model, b, model = checkpoint_models
    ref = np.asarray(jax_solve(jax_model, _jax_graph(b), 3))
    got = model.solve(Graph.from_numpy(b, "cpu"), 3).numpy()
    mask = b.node_mask
    assert got.shape == ref.shape == (b.num_nodes, 9)
    np.testing.assert_allclose(got[mask], ref[mask], rtol=1e-3, atol=1e-3)
    assert np.isfinite(got).all()


def small_mugs_arch(w=32, nf=3, n_in=5):
    """3 scales; the layers after each up step (``mp221``, ``mp121``) take
    the interpolated state and the skip, ``2 w`` wide."""
    mp = ((3 * w, (w, w, w), True), (2 * w, (w, w, w), True))
    up = ((w + 4 * w, (w, w, w), True), (3 * w, (w, w, w), True))
    enc = lambda n: (n, (w, w, w), False)
    return {
        "edge_encoder": enc(2), "edge_encoder2": enc(2),
        "edge_encoder3": enc(2), "node_encoder": enc(n_in),
        "mp111": mp, "mp112": mp, "mp211": mp, "mp31": mp, "mp32": mp,
        "mp221": up, "mp222": mp, "mp121": up, "mp122": mp,
        "decoder": (w, (w, w, nf), False),
    }


def test_random_arch_carried_across_matches_jax(batch):
    arch = small_mugs_arch()
    tree = init_params_numpy(arch, seed=3)
    assert set(tree["mp121"]) == {"edge_mlp", "node_mlp"}
    jax_model = g4c.nn.NsThreeGuillardScaleGNN(arch=arch)
    assert set(jax_model.params) == set(tree)
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    ref = np.asarray(jax_model.apply(jax_model.params, _jax_graph(batch)))
    model = NsThreeGuillardScaleGNN(arch=arch, seed=0, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        got = model(Graph.from_numpy(batch, "cpu")).numpy()
    mask = batch.node_mask
    np.testing.assert_allclose(got[mask], ref[mask], **TOL)
    seeded = MuGSGNN(arch=arch, seed=3, device="cpu").state_dict()
    assert all(torch.equal(seeded[k], v)
               for k, v in model.state_dict().items())


def test_params_round_trip():
    state = load_checkpoint(CHK3)
    model = NsThreeGuillardScaleGNN(arch=state["arch"], seed=1, device="cpu")
    model.load_state_dict(params_from_jax(state["weights"]))
    back = params_to_numpy(model)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    ref, got = flat(state["weights"]), flat(back)
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (_, a), (_, b) in zip(ref, got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert model.num_params == sum(a.size for _, a in ref)


@pytest.mark.parametrize("arch", [small_mugs_arch(),
                                  load_checkpoint(CHK3)["arch"],
                                  load_checkpoint(CHK2)["arch"]])
def test_plan_matches_jax(arch):
    assert build_mugs_plan(arch) == jax_plan(arch)


def test_plan_refuses_unknown_keys():
    with pytest.raises(ValueError):
        build_mugs_plan({**small_mugs_arch(), "down_mp12": (34, (32,), True)})


def test_every_layer_runs_the_kernel_route(batch, monkeypatch):
    """Every MP layer calls ``ops.gn_block`` with its level's fixed k, its
    senders' host sort and its node width; the edge output is skipped at
    the last layer of each level's final group (``mp32``, ``mp222``,
    ``mp122``)."""
    graph = Graph.from_numpy(attach_sender_sorts(batch), "cpu")
    calls = []
    real = port_gn.gn_block

    def spy(e, vs, v, senders, k, *args, **kw):
        if "sender_sort" in kw:      # the blocks' calls, not GnBlockFn's
            perm, srt = kw["sender_sort"]
            assert torch.equal(senders[perm.long()], srt)
            calls.append((v.shape[0], v.shape[1], k, kw["skip_e_out"]))
        return real(e, vs, v, senders, k, *args, **kw)

    monkeypatch.setattr(port_gn, "gn_block", spy)
    w = 16
    model = NsThreeGuillardScaleGNN(arch=small_mugs_arch(w), device="cpu")
    model(graph)
    V1, V2, V3 = (batch.num_nodes, batch.pos_2.shape[0],
                  batch.pos_3.shape[0])
    # mp111, mp112, mp211, mp31, mp32, mp221, mp222, mp121, mp122
    assert calls == [
        (V1, w, K, False), (V1, w, K, False), (V2, w, K, False),
        (V3, w, K, False), (V3, w, K, True), (V2, 2 * w, K, False),
        (V2, w, K, True), (V1, 2 * w, K, False), (V1, w, K, True)]
