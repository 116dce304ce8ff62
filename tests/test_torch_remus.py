"""The port's REMuS-GNN slice against the JAX package, on the CPU.

* the host pipeline (SpatialSort -> BuildRemusGraph -> BuildKnnInterpWeights
  -> collate) gives arrays byte-equal to the JAX package's;
* the GN block's plain version, with the angle sources as its sender map,
  against the JAX package's folded EdgeMP kernel (``edge_mp_folded``) and
  its GN-block kernel (``gn_block_fused``) at the ``down_edge_mp`` shapes,
  both in Pallas interpret mode, at 2e-4;
* the REMuS blocks against the JAX blocks (XLA path), at 2e-4;
* the bundled REMuS checkpoint: one step at 2e-4, ``solve(n_out=3)`` at
  1e-3; a random-weight arch carried across; the weight round trip.

Sizes are small: 2 clouds of 300 nodes, k = 5, 3 levels.
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
from graphs4cfd_tpu.nn import blocks as jax_blocks
from graphs4cfd_tpu.nn.mlp import init_mlp
from graphs4cfd_tpu.nn.remus_gnn import build_remus_plan as jax_plan
from graphs4cfd_tpu.ops import coarsen as jax_coarsen
from graphs4cfd_tpu.ops import pallas_edgemp
from graphs4cfd_tpu.ops.pallas_gnblock import gn_block_fused
from graphs4cfd_tpu.ops.window_plan import build_window_gather_plan
from graphs4cfd_tpu.training.rollout import solve as jax_solve
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import collate
from graphs4cfd_tpu_torch.nn import (NsRotEquiThreeScaleGNN,
                                     NsRotEquiTreeScaleGNN, REMuSGNN,
                                     build_remus_plan, init_params_numpy,
                                     params_from_jax, params_to_numpy)
from graphs4cfd_tpu_torch.nn import blocks
from graphs4cfd_tpu_torch.ops import coarsen
from graphs4cfd_tpu_torch.ops import gn_block as port_gn
from graphs4cfd_tpu_torch.training import load_checkpoint
from test_torch_host import _assert_byte_equal
from test_torch_kernels import _chain, _mlp_module, _t

TOL = dict(rtol=2e-4, atol=2e-4)
CHK = os.path.join(os.path.dirname(g4c.__file__), "nn", "weights",
                   "NsREMuSGNN", "NsRotEquiThreeScaleGNN_taylor_green_tpu.chk")
K = 5


def _clouds(graph_cls, num, n_nodes, seed, nf=2):
    """Point clouds drawn as ``tools/bench_families.py:cloud`` draws them
    (``nf`` fields, one time step)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        g = graph_cls()
        g.pos = (rng.random((n_nodes, 2)) * np.array([4.0, 2.0])).astype(
            np.float32)
        g.glob = np.full((n_nodes, 1), 0.5, np.float32)
        g.field = rng.normal(size=(n_nodes, nf)).astype(np.float32)
        g.target = rng.normal(size=(n_nodes, 10 * nf)).astype(np.float32)
        g.omega = (rng.random((n_nodes, 1)) < 0.1).astype(np.float32)
        g.bound = np.zeros(n_nodes, np.uint8)
        out.append(g)
    return out


def _pipeline(tf, graphs):
    steps = [tf.SpatialSort(),
             tf.BuildRemusGraph(num_levels=3, k=K,
                                scale_edge_length=(0.1, 0.2, 0.4)),
             tf.BuildKnnInterpWeights(K)]
    for t in steps:
        graphs = [t(g) for g in graphs]
    return graphs


def port_remus_samples(num=2, n_nodes=300, seed=1):
    return _pipeline(T, _clouds(Graph, num, n_nodes, seed))


@pytest.fixture(scope="module")
def batch():
    return collate(port_remus_samples(), node_bucket=64, edge_bucket=128)


# ------------------------------------------------------------ host pipeline
@pytest.mark.parametrize("seed,n_nodes", [(1, 300), (4, 283)])
def test_collated_remus_batch_byte_equal(seed, n_nodes):
    ref = jax_collate(_pipeline(JT, _clouds(JaxGraph, 2, n_nodes, seed)),
                      node_bucket=64, edge_bucket=128)
    got = collate(port_remus_samples(2, n_nodes, seed), node_bucket=64,
                  edge_bucket=128)
    # the JAX package adds only its TPU gather plans and their preference
    extra = set(ref.data) - set(got.data)
    assert extra and all(k.startswith("wg") for k in extra), extra
    assert not set(got.data) - set(ref.data)
    for key in ("angle_src", "xangle_src_2", "xangle_src_3", "unit_pinv_3",
                "up_w_2", "up_idx_3", "node_origin_3", "down_idx_2"):
        assert key in got.data, key
    _assert_byte_equal(ref.data, got.data)
    assert got.interp_k == K and got.num_levels == 3


def test_guillard_coarsening_matches_jax(rng):
    pos = (rng.random((700, 2)) * np.array([4.0, 2.0])).astype(np.float32)
    from graphs4cfd_tpu_torch.ops.knn import connect_knn
    senders, _, _ = connect_knn(pos, K)
    got = coarsen.guillard_coarsening(senders, 700, K)
    ref = jax_coarsen.guillard_coarsening(senders, 700, K)
    assert got.dtype == np.bool_ and got.shape == (700,)
    np.testing.assert_array_equal(got, np.asarray(ref, dtype=bool))
    assert 0 < got.sum() < 700


# ------------------------------------------------ the kernel's module, row 9
def _line_graph_case(rng, V=64, k=K, H=128):
    """A canonical line graph as ``tests/test_pallas_edgemp.py`` builds it:
    ``angle_src[e] = senders[e]*k + arange(k)``."""
    E = V * k
    senders = rng.integers(0, V, size=E).astype(np.int32)
    angle_src = (senders[:, None] * k + np.arange(k)[None, :]).astype(
        np.int32)
    a = rng.normal(size=(E, k, H)).astype(np.float32)
    e = rng.normal(size=(E, H)).astype(np.float32)
    params = {"angle_mlp": init_mlp(jax.random.key(0), 3 * H, (H, H), True),
              "edge_mlp": init_mlp(jax.random.key(1), 2 * H, (H, H), True)}
    plan = build_window_gather_plan(senders, V, block_rows=k * 8, window=32,
                                    max_miss_frac=1.0)
    assert plan is not None
    return a, e, senders, angle_src, params, plan


@pytest.mark.parametrize("out_selu,skip_a", [(False, False), (True, False),
                                             (True, True), (False, True)])
def test_gn_block_plain_matches_folded_edgemp(rng, out_selu, skip_a):
    V, k, H = 64, K, 128
    a, e, _, angle_src, params, plan = _line_graph_case(rng, V, k, H)
    E = V * k
    w1 = params["angle_mlp"]["layers"][0]["w"]
    es = jnp.asarray(e) @ w1[H:2 * H]
    ref_e, ref_a = pallas_edgemp.edge_mp_folded(
        params["angle_mlp"], params["edge_mlp"], jnp.asarray(a),
        es.reshape(V, k * H), jnp.asarray(e), k, plan, interpret=True,
        out_activation="selu" if out_selu else None, skip_a_out=skip_a)
    got_e, got_a = port_gn.gn_block_plain(
        _t(a.reshape(E * k, H)), _t(es), _t(e),
        torch.from_numpy(angle_src.reshape(-1)), k,
        _chain(params["angle_mlp"]), _chain(params["edge_mlp"]),
        out_selu=out_selu, skip_e_out=skip_a)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e), **TOL)
    if skip_a:
        assert got_a is None
    else:
        np.testing.assert_allclose(got_a.numpy().reshape(E, k, H),
                                   np.asarray(ref_a), **TOL)


# ------------------------------------------------ the kernel's module, row 3
@pytest.mark.parametrize("out_selu", [False, True])
def test_gn_block_plain_matches_gn_block_fused_down_shapes(rng, out_selu):
    """``down_edge_mp``: 128 coarse edges fed through k inter-level angles
    by a table of 640 fine edges; the angles' output is never stored."""
    Ec, Ef, k, H = 128, 640, K, 128
    a12 = rng.normal(size=(Ec * k, H)).astype(np.float32)
    e_fine = rng.normal(size=(Ef, H)).astype(np.float32)
    e_coarse = rng.normal(size=(Ec, H)).astype(np.float32)
    xsrc = rng.integers(0, Ef, size=Ec * k).astype(np.int32)
    params = {"angle_mlp": init_mlp(jax.random.key(2), 3 * H, (H, H), True),
              "edge_mlp": init_mlp(jax.random.key(3), 2 * H, (H, H), True)}
    w1 = params["angle_mlp"]["layers"][0]["w"]
    es = jnp.asarray(e_fine) @ w1[H:2 * H]
    none, ref = gn_block_fused(
        params["angle_mlp"], params["edge_mlp"], jnp.asarray(a12),
        es[jnp.asarray(xsrc)], jnp.asarray(e_coarse), k, block=64,
        interpret=True, out_activation="selu" if out_selu else None,
        skip_e_out=True)
    got, got_a = port_gn.gn_block_plain(
        _t(a12), _t(es), _t(e_coarse), torch.from_numpy(xsrc), k,
        _chain(params["angle_mlp"]), _chain(params["edge_mlp"]),
        out_selu=out_selu, skip_e_out=True)
    assert none is None and got_a is None
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_gn_block_check_takes_a_foreign_table(rng):
    """The kernel's checks take a table of S != V rows and a source width
    fs != fv: the first edge layer is [fe + fs + fv, H]."""
    V, S, k, fe, fs, fv, H = 40, 300, K, 16, 48, 32, 64
    edge = ([torch.zeros(fe + fs + fv, H), torch.zeros(H, H)],
            [torch.zeros(H), torch.zeros(H)], None)
    node = ([torch.zeros(H + fv, H), torch.zeros(H, H)],
            [torch.zeros(H), torch.zeros(H)], None)
    args = dict(e=torch.zeros(V * k, fe), vs=torch.zeros(S, H),
                v=torch.zeros(V, fv), senders=torch.zeros(V * k,
                                                          dtype=torch.int32),
                k=k, edge=edge, node=node)
    ed, nd = port_gn._check(**args)
    assert ed == [fe + fs + fv, H, H] and nd == [H + fv, H, H]
    with pytest.raises(ValueError):
        port_gn._check(**{**args, "vs": torch.zeros(S, H + 1)})
    with pytest.raises(ValueError):
        port_gn._check(**{**args, "e": torch.zeros(V * k, fe + fs + fv + 1)})
    # the plain version refuses a sender outside the table
    bad = torch.full((V * k,), S, dtype=torch.int32)
    with pytest.raises(IndexError):
        port_gn.gn_block_plain(args["e"], args["vs"], args["v"], bad, k,
                               edge, node)


def test_gn_block_backward_takes_a_foreign_table(rng):
    """``gn_block``'s backward (the plain one on the CPU) against autograd
    through the plain forward, with S != V and fs != fv: ``dvs`` has the
    table's rows, and the Ws rows of the first layer's gradient are
    zero."""
    V, S, k, fe, fs, fv, H = 30, 70, K, 16, 24, 8, 32
    t = lambda *shape: torch.from_numpy(
        rng.normal(size=shape).astype(np.float32)).requires_grad_()
    e, vs, v = t(V * k, fe), t(S, H), t(V, fv)
    senders = torch.from_numpy(rng.integers(0, S, V * k).astype(np.int32))
    edge = ([t(fe + fs + fv, H), t(H, H)], [t(H), t(H)], (t(H), t(H)))
    node = ([t(H + fv, H), t(H, H)], [t(H), t(H)], (t(H), t(H)))
    leaves = [e, vs, v, *edge[0], *edge[1], *edge[2], *node[0], *node[1],
              *node[2]]
    gv, ge = torch.randn(V, H), torch.randn(V * k, H)

    def grads(fn):
        v_new, e_new = fn(e, vs, v, senders, k, edge, node, out_selu=True)
        return torch.autograd.grad((v_new * gv).sum() + (e_new * ge).sum(),
                                   leaves)
    got, ref = grads(port_gn.gn_block), grads(port_gn.gn_block_plain)
    assert got[1].shape == (S, H)
    assert not got[3][fe:fe + fs].any()
    # autograd of the plain forward gives Ws's rows their share directly
    ref = list(ref)
    ref[3] = torch.cat([ref[3][:fe], torch.zeros(fs, H), ref[3][fe + fs:]])
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-4,
                                   atol=2e-4)


# ------------------------------------------------------------------ blocks
def _edge_block(params):
    spec = lambda p: (p["layers"][0]["w"].shape[0],
                      [l["w"].shape[1] for l in p["layers"]], "ln" in p)
    b = blocks.EdgeMPBlock(spec(params["angle_mlp"]),
                           spec(params["edge_mlp"]), device="cpu")
    b.angle_mlp.load_state_dict(_mlp_module(params["angle_mlp"]).state_dict())
    b.edge_mlp.load_state_dict(_mlp_module(params["edge_mlp"]).state_dict())
    return b


@pytest.mark.parametrize("skip_a", [False, True])
def test_edge_mp_matches_jax_block(rng, skip_a):
    E, k, fa, fe, H = 90, K, 24, 40, 32
    a = rng.normal(size=(E, k, fa)).astype(np.float32)
    e = rng.normal(size=(E, fe)).astype(np.float32)
    angle_src = rng.integers(0, E, size=(E, k)).astype(np.int32)
    params = {"angle_mlp": init_mlp(jax.random.key(4), fa + 2 * fe, (H, H),
                                    True),
              "edge_mlp": init_mlp(jax.random.key(5), H + fe, (H, fe), True)}
    re_, ra = jax_blocks.edge_mp(params, jnp.asarray(e), jnp.asarray(a),
                                 jnp.asarray(angle_src),
                                 out_activation="selu", skip_a_out=skip_a)
    ge, ga = blocks.edge_mp(_edge_block(params), _t(e),
                            _t(a.reshape(E * k, fa)),
                            torch.from_numpy(angle_src), out_selu=True,
                            skip_a_out=skip_a)
    np.testing.assert_allclose(ge.detach().numpy(), np.asarray(re_), **TOL)
    assert (ga is None) == skip_a == (ra is None)
    if not skip_a:
        np.testing.assert_allclose(ga.detach().numpy().reshape(E, k, H),
                                   np.asarray(ra), **TOL)


def test_down_edge_mp_matches_jax_block(rng):
    """Fine and coarse edge widths differ (fs != fv), the table has more
    rows than there are coarse edges."""
    Ef, Ec, k, fa, ff, fc, H = 300, 70, K, 16, 48, 32, 32
    e_fine = rng.normal(size=(Ef, ff)).astype(np.float32)
    e_coarse = rng.normal(size=(Ec, fc)).astype(np.float32)
    a12 = rng.normal(size=(Ec, k, fa)).astype(np.float32)
    xsrc = rng.integers(0, Ef, size=(Ec, k)).astype(np.int32)
    params = {"angle_mlp": init_mlp(jax.random.key(6), fa + ff + fc, (H, H),
                                    True),
              "edge_mlp": init_mlp(jax.random.key(7), H + fc, (H, fc), True)}
    ref = jax_blocks.down_edge_mp(params, jnp.asarray(e_fine),
                                  jnp.asarray(e_coarse), jnp.asarray(a12),
                                  jnp.asarray(xsrc), out_activation="selu")
    got = blocks.down_edge_mp(_edge_block(params), _t(e_fine), _t(e_coarse),
                              _t(a12.reshape(Ec * k, fa)),
                              torch.from_numpy(xsrc), out_selu=True)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def _unit_and_pinv(rng, V, k):
    from graphs4cfd_tpu_torch.ops.linalg import pinv_k2_np
    ang = rng.random((V * k,)) * 2 * np.pi
    unit = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    return unit, pinv_k2_np(unit.reshape(V, k, 2))


def test_edge_scalar_to_node_vector_matches_jax(rng):
    V, k, F = 50, K, 7
    _, pinv = _unit_and_pinv(rng, V, k)
    x = rng.normal(size=(V * k, F)).astype(np.float32)
    ref = jax_blocks.edge_scalar_to_node_vector(jnp.asarray(x),
                                                jnp.asarray(pinv))
    got = blocks.edge_scalar_to_node_vector(_t(x), _t(pinv))
    assert blocks.edgeScalarToNodeVector is blocks.edge_scalar_to_node_vector
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_up_edge_mp_matches_jax_block(rng):
    Vc, Vf, k, F = 30, 80, K, 32
    unit_c, pinv_c = _unit_and_pinv(rng, Vc, k)
    unit_f, _ = _unit_and_pinv(rng, Vf, k)
    e_coarse = rng.normal(size=(Vc * k, F)).astype(np.float32)
    skip = rng.normal(size=(Vf * k, F)).astype(np.float32)
    idx = rng.integers(0, Vc, size=(Vf, k)).astype(np.int32)
    w = rng.uniform(0.5, 2.0, size=(Vf, k)).astype(np.float32)
    recv = np.repeat(np.arange(Vf, dtype=np.int32), k)
    params = init_mlp(jax.random.key(8), 2 * F, (F, F, F), True)
    ref = jax_blocks.up_edge_mp(params, jnp.asarray(e_coarse),
                                jnp.asarray(pinv_c), jnp.asarray(idx),
                                jnp.asarray(w), jnp.asarray(recv),
                                jnp.asarray(unit_f), jnp.asarray(skip))
    got = blocks.up_edge_mp(_mlp_module(params), _t(e_coarse), _t(pinv_c),
                            torch.from_numpy(idx), _t(w), _t(unit_f),
                            _t(skip))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def test_project_node_vectors_matches_jax(rng):
    """Canonical receivers: a broadcast; any other layout is refused."""
    V, k, F = 40, K, 3
    unit, _ = _unit_and_pinv(rng, V, k)
    nv = rng.normal(size=(V, F, 2)).astype(np.float32)
    recv = np.repeat(np.arange(V, dtype=np.int32), k)
    ref = jax_blocks.project_node_vectors_to_edges(
        jnp.asarray(nv), jnp.asarray(recv), jnp.asarray(unit))
    got = blocks.project_node_vectors_to_edges(_t(nv), _t(unit))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    with pytest.raises(ValueError):
        blocks.project_node_vectors_to_edges(_t(nv), _t(unit[:-3]))


# --------------------------------------------------------------- the slice
@pytest.fixture(scope="module")
def checkpoint_models(batch):
    jax_model = g4c.nn.NsRotEquiThreeScaleGNN(checkpoint=CHK)
    jax_graph = JaxGraph(data=dict(batch.data)).to_device()
    return jax_model, jax_graph, NsRotEquiThreeScaleGNN(checkpoint=CHK,
                                                       device="cpu")


def test_bundled_checkpoint_forward_matches_jax(batch, checkpoint_models):
    jax_model, jax_graph, model = checkpoint_models
    assert load_checkpoint(CHK)["arch"]["mp111"][0][1][0] == 128
    ref = np.asarray(jax.jit(jax_model.apply)(jax_model.params, jax_graph))
    with torch.no_grad():
        got = model(Graph.from_numpy(batch, "cpu")).numpy()
    mask = batch.node_mask
    assert model.num_fields == jax_model.num_fields == 2
    assert got.shape == ref.shape == (batch.num_nodes, 2)
    np.testing.assert_allclose(got[mask], ref[mask], **TOL)


def test_bundled_checkpoint_solve_matches_jax(batch, checkpoint_models):
    jax_model, jax_graph, model = checkpoint_models
    ref = np.asarray(jax_solve(jax_model, jax_graph, 3))
    got = model.solve(Graph.from_numpy(batch, "cpu"), 3).numpy()
    mask = batch.node_mask
    assert got.shape == ref.shape == (batch.num_nodes, 6)
    np.testing.assert_allclose(got[mask], ref[mask], rtol=1e-3, atol=1e-3)
    assert np.isfinite(got).all()


def small_remus_arch(w=32):
    """3 scales, two EdgeMP layers per visit of level 1."""
    emp = ((3 * w, (w, w), True), (2 * w, (w, w), True))
    enc = lambda n: (n, (w, w), True)
    return {
        "angle_encoder": enc(4), "angle_encoder12": enc(4),
        "angle_encoder2": enc(4), "angle_encoder23": enc(4),
        "angle_encoder3": enc(4), "edge_encoder": enc(3),
        "edge_encoder2": enc(3), "edge_encoder3": enc(3),
        "mp111": emp, "mp112": emp, "down_mp12": emp, "mp211": emp,
        "down_mp23": emp, "mp31": emp, "mp32": emp,
        "up_mp32": (2 * w, (w, w, w), True), "mp221": emp,
        "up_mp21": (2 * w, (w, w, w), True), "mp121": emp, "mp122": emp,
        "decoder": (w, (w, 1), False),
    }


def test_random_arch_carried_across_matches_jax(batch):
    arch = small_remus_arch()
    tree = init_params_numpy(arch, seed=3)
    assert set(tree["mp111"]) == {"angle_mlp", "edge_mlp"}
    jax_model = g4c.nn.NsRotEquiThreeScaleGNN(arch=arch)
    assert set(jax_model.params) == set(tree)
    jax_model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jax_graph = JaxGraph(data=dict(batch.data)).to_device()
    ref = np.asarray(jax_model.apply(jax_model.params, jax_graph))
    model = NsRotEquiTreeScaleGNN(arch=arch, seed=0, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    with torch.no_grad():
        got = model(Graph.from_numpy(batch, "cpu")).numpy()
    mask = batch.node_mask
    np.testing.assert_allclose(got[mask], ref[mask], **TOL)
    seeded = REMuSGNN(arch=arch, seed=3, device="cpu").state_dict()
    assert all(torch.equal(seeded[k], v) for k, v in model.state_dict().items())


def test_params_round_trip():
    state = load_checkpoint(CHK)
    model = NsRotEquiThreeScaleGNN(arch=state["arch"], seed=1, device="cpu")
    model.load_state_dict(params_from_jax(state["weights"]))
    back = params_to_numpy(model)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    ref, got = flat(state["weights"]), flat(back)
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (_, a), (_, b) in zip(ref, got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert model.num_params == sum(a.size for _, a in ref)


@pytest.mark.parametrize("arch", [small_remus_arch(),
                                  load_checkpoint(CHK)["arch"]])
def test_plan_matches_jax(arch):
    assert build_remus_plan(arch) == jax_plan(arch)


def test_angle_output_skipped_only_at_a_level_s_last_layer(batch,
                                                           monkeypatch):
    """Every EdgeMP and DownEdgeMP runs the kernel's route; the angle
    output is skipped at the last layer of each level's final group, and
    always in ``down_edge_mp``."""
    calls = []
    real = port_gn.gn_block

    def spy(*args, **kw):
        calls.append((args[3].shape[0] == args[2].shape[0] * args[4],
                      args[1].shape[0] == args[2].shape[0],
                      kw["skip_e_out"]))
        return real(*args, **kw)

    monkeypatch.setattr(port_gn, "gn_block", spy)
    model = NsRotEquiThreeScaleGNN(arch=small_remus_arch(w=16), device="cpu")
    model.solve(Graph.from_numpy(batch, "cpu"), 1)
    assert all(fixed_k for fixed_k, _, _ in calls)
    # (table is the node set, skip): mp111, mp112, down_mp12, mp211,
    # down_mp23, mp31, mp32 (last at level 3), mp221 (last at level 2),
    # mp121, mp122 (last at level 1)
    assert [c[1:] for c in calls] == [
        (True, False), (True, False), (False, True), (True, False),
        (False, True), (True, False), (True, True), (True, True),
        (True, False), (True, True)]


def test_rotation_equivariance():
    """Rotating the point cloud and its velocity field rotates the output
    (the torch counterpart of ``tests/test_models.py``'s REMuS test)."""
    model = REMuSGNN(arch=small_remus_arch(w=32), seed=13, device="cpu")
    th = np.deg2rad(117.0)
    R = np.array([[np.cos(th), np.sin(th)], [-np.sin(th), np.cos(th)]])
    rng = np.random.default_rng(21)
    pos = rng.random((110, 2))
    field = rng.normal(size=(110, 2))
    glob = rng.random((110, 1)).astype(np.float32)
    omega = (rng.random((110, 1)) < 0.1).astype(np.float32)

    def run(rot):
        g = Graph()
        g.pos = (pos @ R if rot else pos).astype(np.float32)
        g.field = (field @ R if rot else field).astype(np.float32)
        g.glob, g.omega = glob, omega
        g = T.BuildRemusGraph(num_levels=3, k=4,
                              scale_edge_length=(0.02, 0.04, 0.08))(g)
        g = T.BuildKnnInterpWeights(3)(g)
        batch = collate([g], node_bucket=1, edge_bucket=1)
        with torch.no_grad():
            return model(Graph.from_numpy(batch, "cpu")).numpy()

    out, out_rot = run(False), run(True)
    assert np.abs(out).max() > 0.1
    np.testing.assert_allclose(out_rot, out @ R, rtol=5e-3, atol=5e-3)
