"""The bf16 policy (``compute_dtype=torch.bfloat16``) against the JAX
package's (``compute_dtype=jnp.bfloat16``), on the CPU.

* Each kernel module's bf16 plain version, forward and VJP, against the
  JAX kernel run in bf16 in Pallas interpret mode, on the same numpy
  inputs (rounded to bf16 once, so both sides start from the same bits):
  rows 1-2 (``fused_mlp``), 3-4 (``gn_block_fused``), 5-6
  (``gn_block_fused_wg``) and 9-10 (``edge_mp_folded``).  bf16 outputs
  within ``ACT_TOL`` = 8e-3 of max(1, max |ref|), about one bf16 ulp: both
  sides round the same f32 values to bf16, but their f32 sums run in
  another order, so a value near a rounding boundary may land one ulp
  apart.  Activation cotangents within ``COT_L2`` = 1e-2 in relative L2
  (about 2.5 bf16 ulps): an operand rounded one ulp apart moves a
  pre-activation by about 2^-8 of itself, which can put a SELU input on
  the other side of 0 in one of the two, and SELU's derivative jumps
  there, so a few elements differ by O(1) and no elementwise bound holds
  (measured: 1.3e-3 to 4.2e-3).  The f32 parameter gradients within
  ``GRAD_L2`` = 2e-2 in relative L2, for the same reason (measured: at
  most 6.8e-3; a bias or LayerNorm gradient sums a few rows' cotangents,
  where one flipped element weighs more).
* The bf16 sorted segment sum, the autograd types of ``MlpChainFn``,
  ``TrainConfig(mixed_precision=True)``, the refusal of bf16 graph
  parallelism, the REMuS rotation equivariance in bf16 (the bound of
  ``tests/test_parallel_families.py:62``), and the bundled MuS weights'
  ``solve`` of a list in bf16 (its step increment within 5e-2 in
  relative L2 of the f32 run's).  The models against the JAX package in bf16 and ``fit`` are in
  ``test_torch_bf16_train.py``.

Sizes are small; every test runs with one torch thread (see
``test_torch_runtime.one_thread``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphs4cfd_tpu.nn.mlp import init_mlp
from graphs4cfd_tpu.ops import pallas_edgemp
from graphs4cfd_tpu.ops import pallas_gnblock as pg
from graphs4cfd_tpu.ops.pallas_mlp import fused_mlp
from graphs4cfd_tpu_torch.ops import fused_mlp as port_mlp
from graphs4cfd_tpu_torch.ops import gn_block as port_gn
from graphs4cfd_tpu_torch.ops import segment as port_seg
from test_torch_kernels import _chain
from test_torch_mugs import coarse_case, wg_case
from test_torch_remus import K as REMUS_K
from test_torch_remus import _line_graph_case
from test_torch_remus_train import _host_sort
from test_window_gather import _device_plan

BF = jnp.bfloat16
ACT_TOL = 8e-3
COT_L2 = 1e-2
GRAD_L2 = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bf(x):
    """numpy -> the same values rounded to bf16, as a JAX bf16 array and a
    torch bf16 tensor."""
    j = jnp.asarray(x).astype(BF)
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(
        torch.bfloat16)
    return j, t


def _f(x):
    """A JAX or torch array as f32 numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _act_close(got, ref):
    """bf16 outputs or activation cotangents: within ACT_TOL of max(1,
    max |ref|)."""
    got, ref = _f(got), _f(ref)
    assert got.shape == ref.shape
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(got - ref).max())
    assert err <= ACT_TOL * scale, (err, scale)


def _l2_gap(got, ref) -> float:
    got, ref = _f(got).astype(np.float64), _f(ref).astype(np.float64)
    assert got.shape == ref.shape
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def _cot_close(got, ref):
    """Activation cotangents: within COT_L2 in relative L2."""
    gap = _l2_gap(got, ref)
    assert gap <= COT_L2, gap


def _grad_close(got, ref):
    """f32 parameter gradients: within GRAD_L2 in relative L2."""
    gap = _l2_gap(got, ref)
    assert gap <= GRAD_L2, gap


def _chain_grads_close(got, ref_tree, skip_rows=None):
    """``(dW, db, dLN)`` of the port against a JAX MLP cotangent tree."""
    dws, dbs, dln = got
    for i, (w, b, lyr) in enumerate(zip(dws, dbs, ref_tree["layers"])):
        rw = np.asarray(lyr["w"])
        if i == 0 and skip_rows is not None:
            w = w.clone()
            w[skip_rows] = 0
            rw = rw.copy()
            rw[skip_rows] = 0
        _grad_close(w, rw)
        _grad_close(b, lyr["b"])
    assert (dln is None) == ("ln" not in ref_tree)
    if dln is not None:
        _grad_close(dln[0], ref_tree["ln"]["scale"])
        _grad_close(dln[1], ref_tree["ln"]["bias"])


# ------------------------------------------------- rows 1-2: the MLP chain
@pytest.mark.parametrize("start,ln", [(0, True), (0, False), (1, True),
                                      (1, False)])
def test_bf16_mlp_chain_matches_pallas(rng, start, ln):
    """``fused_mlp(compute_dtype=bf16)`` and its VJP against the port's
    bf16 plain versions: x, the output, g and dx bf16; dW, db, dLN f32."""
    params = init_mlp(jax.random.key(1), 130, (128, 128, 128), ln)
    fin = 130 if start == 0 else 128
    xj, xt = _bf(rng.normal(size=(256, fin)).astype(np.float32))

    def f(p, x):
        return fused_mlp(p, x, start=start, compute_dtype=BF, interpret=True,
                         block=128)

    out, vjp = jax.vjp(f, params, xj)
    gj, gt = _bf(rng.normal(size=out.shape).astype(np.float32))
    dp, dx = vjp(gj)
    assert out.dtype == BF and dx.dtype == BF
    ws, bs, lns = _chain(params)
    got = port_mlp.mlp_chain(xt, ws[start:], bs[start:],
                             *(lns or (None, None)), preact_input=start > 0)
    assert got.dtype == torch.bfloat16
    _act_close(got, out)
    gdx, gws, gbs, gln = port_mlp.mlp_chain_bwd_plain(
        xt, gt, ws[start:], bs[start:], lns[0] if lns else None,
        preact_input=start > 0)
    assert gdx.dtype == torch.bfloat16
    assert all(t.dtype == torch.float32 for t in gws + gbs + list(gln or ()))
    _cot_close(gdx, dx)
    ref = {"layers": dp["layers"][start:], **({"ln": dp["ln"]} if ln else {})}
    _chain_grads_close((gws, gbs, gln), ref)


def test_bf16_mlp_chain_autograd_types():
    """Through ``MlpChainFn``: a bf16 input's gradient is bf16, the f32
    parameters' gradients f32, and the f32 path stays f32."""
    gen = torch.Generator().manual_seed(0)
    w = [torch.randn(5, 16, generator=gen, requires_grad=True),
         torch.randn(16, 3, generator=gen, requires_grad=True)]
    b = [torch.zeros(16, requires_grad=True), torch.zeros(3,
                                                          requires_grad=True)]
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(40, 5, generator=gen).to(dtype).requires_grad_()
        out = port_mlp.mlp_chain(x, w, b)
        assert out.dtype == dtype
        out.float().square().sum().backward()
        assert x.grad.dtype == dtype
        assert all(p.grad.dtype == torch.float32 for p in w + b)


# ------------------------------------------ rows 3-4: the GN block, coarse
@pytest.mark.parametrize("fv,out_selu", [(128, True), (256, False)])
def test_bf16_gn_block_matches_gn_block_fused(rng, fv, out_selu):
    """``gn_block_fused(compute_dtype=bf16)`` (gMuS ``mp2xx``/``mp221``,
    REMuS ``down_edge_mp``) and its VJP: the per-edge ``dvsg`` (bf16),
    summed per sender in f32, is the port's ``dvs``."""
    V, k, H = 64, 6, 128
    v, e, vs, senders, params = coarse_case(rng, fv, V)
    ej, et = _bf(e)
    vj, vt = _bf(v)
    vsj, vst = _bf(vs)

    def fwd(em, nm, e, vsg, v):
        return pg.gn_block_fused(em, nm, e, vsg, v, k, block=32,
                                 compute_dtype=BF, interpret=True,
                                 out_activation="selu" if out_selu else None)

    (re_, rv), vjp = jax.vjp(fwd, params["edge_mlp"], params["node_mlp"],
                             ej, vsj[jnp.asarray(senders)], vj)
    gej, get_ = _bf(rng.normal(size=(V * k, H)).astype(np.float32))
    gvj, gvt = _bf(rng.normal(size=(V, H)).astype(np.float32))
    r_em, r_nm, r_de, r_dvsg, r_dv = vjp((gej, gvj))
    edge, node = _chain(params["edge_mlp"]), _chain(params["node_mlp"])
    st = torch.from_numpy(senders)
    gv, ge = port_gn.gn_block_plain(et, vst, vt, st, k, edge, node,
                                    out_selu=out_selu)
    assert gv.dtype == ge.dtype == torch.bfloat16
    _act_close(gv, rv)
    _act_close(ge, re_)
    de, dv, dvs, dedge, dnode = port_gn.gn_block_bwd_plain(
        et, vst, vt, st, _host_sort(senders), k, edge, node, gvt, get_,
        out_selu=out_selu)
    assert de.dtype == dv.dtype == torch.bfloat16
    assert dvs.dtype == torch.float32
    ref_dvs = np.zeros((V, H), np.float64)
    np.add.at(ref_dvs, senders, _f(r_dvsg).astype(np.float64))
    _cot_close(de, r_de)
    _cot_close(dv, r_dv)
    _cot_close(dvs, ref_dvs)
    _chain_grads_close(dedge, r_em, skip_rows=slice(H, H + fv))
    _chain_grads_close(dnode, r_nm)


# ------------------------------------ rows 5-6: the GN block, MuS level 1
@pytest.mark.parametrize("fv,skip_e", [(128, False), (256, True)])
def test_bf16_gn_block_matches_window_gather_kernel(rng, fv, skip_e):
    """``gn_block_fused_wg(compute_dtype=bf16)`` (MuS level 1, gMuS
    ``mp121``) and its VJP, whose ``dvs`` sums the bf16 per-edge cotangents
    in f32 and hands them back in the table's bf16."""
    V, k, H = 192, 6, 128
    v, e, vs, senders, plan, params = wg_case(rng, fv, V, k, H)
    ej, et = _bf(e)
    vj, vt = _bf(v)
    vsj, vst = _bf(vs)

    def fwd(em, nm, e, vs, v):
        return pg.gn_block_fused_wg(em, nm, e, vs, v, k, _device_plan(plan),
                                    compute_dtype=BF, interpret=True,
                                    out_activation="selu",
                                    skip_e_out=skip_e)

    (re_, rv), vjp = jax.vjp(fwd, params["edge_mlp"], params["node_mlp"],
                             ej, vsj, vj)
    gvj, gvt = _bf(rng.normal(size=(V, H)).astype(np.float32))
    gej, get_ = ((None, None) if skip_e else
                 _bf(rng.normal(size=(V * k, H)).astype(np.float32)))
    r_em, r_nm, r_de, r_dvs, r_dv = vjp((gej, gvj))
    edge, node = _chain(params["edge_mlp"]), _chain(params["node_mlp"])
    st = torch.from_numpy(senders)
    gv, ge = port_gn.gn_block_plain(et, vst, vt, st, k, edge, node,
                                    out_selu=True, skip_e_out=skip_e)
    _act_close(gv, rv)
    assert (ge is None) == skip_e == (re_ is None)
    if not skip_e:
        _act_close(ge, re_)
    de, dv, dvs, dedge, dnode = port_gn.gn_block_bwd_plain(
        et, vst, vt, st, _host_sort(senders), k, edge, node, gvt, get_,
        out_selu=True)
    _cot_close(de, r_de)
    _cot_close(dv, r_dv)
    _cot_close(dvs, r_dvs)
    _chain_grads_close(dedge, r_em, skip_rows=slice(H, H + fv))
    _chain_grads_close(dnode, r_nm)


# -------------------------------------------- rows 9-10: one REMuS EdgeMP
@pytest.mark.parametrize("skip_a", [False, True])
def test_bf16_gn_block_matches_folded_edgemp(rng, skip_a):
    """``edge_mp_folded(compute_dtype=bf16)`` and its VJP, the angle-source
    table's cotangent summed per source row (bf16 rows added in f32)."""
    V, k, H = 64, REMUS_K, 128
    a, e, _, angle_src, params, plan = _line_graph_case(rng, V, k, H)
    E = V * k
    w1 = params["angle_mlp"]["layers"][0]["w"]
    es = np.asarray(jnp.asarray(e) @ w1[H:2 * H])
    aj, at = _bf(a)
    ej, et = _bf(e)
    esj, est = _bf(es)

    def fwd(am, em, a, tab, e):
        return pallas_edgemp.edge_mp_folded(
            am, em, a, tab, e, k, plan, compute_dtype=BF, interpret=True,
            out_activation="selu", skip_a_out=skip_a)

    (r_e, r_a), vjp = jax.vjp(fwd, params["angle_mlp"], params["edge_mlp"],
                              aj, esj.reshape(V, k * H), ej)
    gej, get_ = _bf(rng.normal(size=(E, H)).astype(np.float32))
    gaj, gat = ((None, None) if skip_a else
                _bf(rng.normal(size=(E, k, H)).astype(np.float32)))
    r_am, r_em, r_da, r_dtab, r_de = vjp((gej, gaj))
    angle, edge = _chain(params["angle_mlp"]), _chain(params["edge_mlp"])
    src = torch.from_numpy(angle_src.reshape(-1))
    ge, ga = port_gn.gn_block_plain(at.reshape(E * k, H), est, et, src, k,
                                    angle, edge, out_selu=True,
                                    skip_e_out=skip_a)
    _act_close(ge, r_e)
    if not skip_a:
        _act_close(ga.reshape(E, k, H), r_a)
    da, de, dtab, dang, dedge = port_gn.gn_block_bwd_plain(
        at.reshape(E * k, H), est, et, src, _host_sort(angle_src), k, angle,
        edge, get_, None if skip_a else gat.reshape(E * k, H), out_selu=True)
    _cot_close(da, _f(r_da).reshape(E * k, H))
    _cot_close(de, r_de)
    _cot_close(dtab, _f(r_dtab).reshape(E, H))
    _chain_grads_close(dang, r_am, skip_rows=slice(H, 2 * H))
    _chain_grads_close(dedge, r_em)


# ------------------------------------------- row 8: the sorted segment sum
def test_bf16_sorted_segment_sum_adds_bf16_rows_in_f32(rng):
    """bf16 rows added in f32, in sorted order, into an f32 table: the f32
    rounding of the exact sums of the bf16 values."""
    idx = rng.integers(0, 40, size=500).astype(np.int32)
    perm, srt = _host_sort(idx)
    _, src = _bf(rng.normal(size=(500, 24)).astype(np.float32))
    got = port_seg.sorted_segment_sum(src, perm, srt, 50)
    assert got.dtype == torch.float32
    ref = np.zeros((50, 24), np.float64)
    np.add.at(ref, idx, src.double().numpy())
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


# ------------------------------------------------------- models, refusals
def test_train_config_takes_mixed_precision():
    from graphs4cfd_tpu_torch.training import TrainConfig
    assert TrainConfig("x", mixed_precision=True).mixed_precision is True


def test_bf16_graph_parallelism_refuses():
    """Graph parallelism runs a bf16 model: the four GP entry points build
    for one; a compute dtype that is neither f32 nor bf16 is refused where
    the model is built, and by every GP entry point."""
    from graphs4cfd_tpu_torch.nn import NsThreeScaleGNN, GraphLoss
    from graphs4cfd_tpu_torch.parallel import graph_parallel as gp
    from test_torch_mus import small_arch
    model = NsThreeScaleGNN(arch=small_arch(), device="cpu",
                            compute_dtype=torch.bfloat16)
    makes = (lambda: gp.make_gp_forward(model),
             lambda: gp.make_gp_rollout(model, 2),
             lambda: gp.make_gp_train_step(model, GraphLoss(0.25), 1),
             lambda: gp.make_gp_val_step(model, GraphLoss(0.25), 1))
    for make in makes:
        assert callable(make())
    with pytest.raises(ValueError):
        NsThreeScaleGNN(arch=small_arch(), device="cpu",
                        compute_dtype=torch.float16)
    model.compute_dtype = torch.float16
    for make in makes:
        with pytest.raises(ValueError, match="compute_dtype"):
            make()


def test_bf16_remus_rotation_equivariance():
    """Rotating the cloud and its velocity field rotates the bf16 output
    (``tests/test_parallel_families.py:62``'s check, with its bound: a mean
    error under 5% of the output's mean size)."""
    from graphs4cfd_tpu_torch import transforms as T
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.nn import REMuSGNN
    from test_torch_remus import small_remus_arch
    model = REMuSGNN(arch=small_remus_arch(w=32), seed=13, device="cpu",
                     compute_dtype=torch.bfloat16)
    th = np.deg2rad(63.0)
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
        with torch.no_grad():
            return model(Graph.from_numpy(collate([g], node_bucket=1,
                                                  edge_bucket=1),
                                          "cpu")).numpy()

    out, out_rot = run(False), run(True)
    assert np.abs(out).max() > 0.1
    err = np.abs(out_rot - out @ R)
    assert err.mean() < 0.05 * (np.abs(out).mean() + 1e-3), err.mean()


def test_bf16_solve_of_a_list_and_the_bundled_weights():
    """``GNN(model=name, compute_dtype=bf16)``: the bundled MuS checkpoint
    runs ``solve`` of a list of graphs in bf16 (what its collated batch
    gives, f32 out), and its first step's increment over the field lies
    within 5e-2 in relative L2 of the f32 run's (measured: 1.6e-2; the
    increments are small against the O(1) activations whose products
    bf16 rounds)."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.nn import NsThreeScaleGNN
    from test_torch_host import port_samples
    samples = port_samples(2, 400, seed=5)
    name = "3S-GNN-TaylorGreen-TPU-v1"
    bf = NsThreeScaleGNN(model=name, device="cpu",
                         compute_dtype=torch.bfloat16)
    f32 = NsThreeScaleGNN(model=name, device="cpu")
    assert bf.compute_dtype == torch.bfloat16
    assert f32.compute_dtype == torch.float32
    got = bf.solve(samples, 2)
    batch = Graph.from_numpy(collate([s.numpy() for s in samples]), "cpu")
    torch.testing.assert_close(got, bf.solve(batch, 2), rtol=0, atol=0)
    assert got.dtype == torch.float32 and torch.isfinite(got).all()
    with torch.no_grad():
        base, mask = batch.field[:, -3:], batch.node_mask
        step_bf, step_f32 = bf(batch) - base, f32(batch) - base
    assert _l2_gap(step_bf[mask], step_f32[mask]) < 5e-2
