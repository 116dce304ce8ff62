"""The port's kernel modules against the JAX package's Pallas kernels.

On the CPU the wrappers take their plain PyTorch versions; these are held
against ``fused_mlp`` and ``gn_block_fused`` run in Pallas interpret mode,
and against the JAX blocks, in f32 at 2e-4.  ``test_torch_cuda.py`` holds
the CUDA kernels against the plain versions on a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphs4cfd_tpu.nn import blocks as jax_blocks
from graphs4cfd_tpu.nn.mlp import apply_mlp_tail as jax_apply_mlp_tail
from graphs4cfd_tpu.nn.mlp import init_mlp
from graphs4cfd_tpu.ops.pallas_gnblock import gn_block_fused
from graphs4cfd_tpu.ops.pallas_mlp import fused_mlp
from graphs4cfd_tpu_torch.nn import blocks
from graphs4cfd_tpu_torch.nn.mlp import MLP, apply_mlp_tail
from graphs4cfd_tpu_torch.nn.model import _mlp_items
from graphs4cfd_tpu_torch.ops import _build, fused_mlp as port_mlp
from graphs4cfd_tpu_torch.ops import gn_block as port_gn

TOL = dict(rtol=2e-4, atol=2e-4)


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _chain(p):
    """A JAX MLP param tree as the port's (weights, biases, ln)."""
    ws = [_t(l["w"]) for l in p["layers"]]
    bs = [_t(l["b"]) for l in p["layers"]]
    ln = (_t(p["ln"]["scale"]), _t(p["ln"]["bias"])) if "ln" in p else None
    return ws, bs, ln


def _mlp_module(p):
    spec = (p["layers"][0]["w"].shape[0],
            [l["w"].shape[1] for l in p["layers"]], "ln" in p)
    m = MLP(*spec, device="cpu")
    m.load_state_dict({k.split(".", 1)[1]: _t(v)
                       for k, v in _mlp_items("m", p)})
    return m


def _block_module(params):
    edge, node = params["edge_mlp"], params["node_mlp"]
    spec = lambda p: (p["layers"][0]["w"].shape[0],
                      [l["w"].shape[1] for l in p["layers"]], "ln" in p)
    b = blocks.GNBlock(spec(edge), spec(node), device="cpu")
    b.edge_mlp.load_state_dict(_mlp_module(edge).state_dict())
    b.node_mlp.load_state_dict(_mlp_module(node).state_dict())
    return b


@pytest.mark.parametrize("start,ln", [(0, True), (0, False), (1, True),
                                      (1, False)])
def test_mlp_chain_plain_matches_pallas(rng, start, ln):
    params = init_mlp(jax.random.key(1), 256, (128, 128, 128), ln)
    fin = 256 if start == 0 else 128
    x = rng.normal(size=(512, fin)).astype(np.float32)
    pallas = fused_mlp(params, jnp.asarray(x), start=start, interpret=True,
                       block=256)
    xla = jax_apply_mlp_tail(params, jnp.asarray(x), start=start)
    ws, bs, lns = _chain(params)
    got = port_mlp.mlp_chain(_t(x), ws[start:], bs[start:],
                             *(lns or (None, None)), preact_input=start > 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), **TOL)
    # the module path reaches the same function
    mod = apply_mlp_tail(_mlp_module(params), _t(x), start=start)
    np.testing.assert_array_equal(mod.detach().numpy(), got.numpy())


@pytest.mark.parametrize("in_dim,widths", [(2, (32, 32, 32)),
                                           (130, (64, 64, 3))])
def test_mlp_chain_plain_matches_xla_narrow(rng, in_dim, widths):
    """The encoder/decoder/pooling widths of the MuS models."""
    params = init_mlp(jax.random.key(2), in_dim, widths, False)
    x = rng.normal(size=(77, in_dim)).astype(np.float32)
    ref = jax_apply_mlp_tail(params, jnp.asarray(x), start=0)
    got = apply_mlp_tail(_mlp_module(params), _t(x), start=0)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **TOL)


def _gn_inputs(rng, V=512, k=4, H=128):
    v = rng.normal(size=(V, H)).astype(np.float32)
    e = rng.normal(size=(V * k, H)).astype(np.float32)
    senders = rng.integers(0, V, size=V * k).astype(np.int32)
    params = {"edge_mlp": init_mlp(jax.random.key(0), 3 * H, (H, H, H), True),
              "node_mlp": init_mlp(jax.random.key(1), 2 * H, (H, H, H), True)}
    return v, e, senders, params


@pytest.mark.parametrize("out_act,skip_e", [(None, False), ("selu", False),
                                            ("selu", True)])
def test_gn_block_plain_matches_pallas(rng, out_act, skip_e):
    V, k, H = 512, 4, 128
    v, e, senders, params = _gn_inputs(rng, V, k, H)
    w1 = params["edge_mlp"]["layers"][0]["w"]
    vs = jnp.asarray(v) @ w1[H:2 * H]
    ref_e, ref_v = gn_block_fused(
        params["edge_mlp"], params["node_mlp"], jnp.asarray(e),
        vs[jnp.asarray(senders)], jnp.asarray(v), k, block=256,
        interpret=True, out_activation=out_act, skip_e_out=skip_e)
    got_v, got_e = port_gn.gn_block(
        _t(e), _t(vs), _t(v), torch.from_numpy(senders), k,
        _chain(params["edge_mlp"]), _chain(params["node_mlp"]),
        out_selu=out_act == "selu", skip_e_out=skip_e)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(ref_v), **TOL)
    if skip_e:
        assert got_e is None and ref_e is None
    else:
        np.testing.assert_allclose(got_e.numpy(), np.asarray(ref_e), **TOL)


@pytest.mark.parametrize("skip_e", [False, True])
def test_gn_block_fixed_k_matches_jax_block(rng, skip_e):
    """blocks.gn_block at level 1 (fixed k, the kernel's route)."""
    V, k, H = 96, 6, 32
    v, e, senders, params = _gn_inputs(rng, V, k, H)
    receivers = np.repeat(np.arange(V, dtype=np.int32), k)
    rv, re = jax_blocks.gn_block(params, jnp.asarray(v), jnp.asarray(e),
                                 jnp.asarray(senders), jnp.asarray(receivers),
                                 fixed_k=k, out_activation="selu",
                                 skip_e_out=skip_e)
    gv, ge = blocks.gn_block(_block_module(params), _t(v), _t(e),
                             torch.from_numpy(senders),
                             torch.from_numpy(receivers), fixed_k=k,
                             out_selu=True, skip_e_out=skip_e)
    np.testing.assert_allclose(gv.detach().numpy(), np.asarray(rv), **TOL)
    assert (ge is None) == skip_e == (re is None)
    if not skip_e:
        np.testing.assert_allclose(ge.detach().numpy(), np.asarray(re), **TOL)


def test_gn_block_masked_segment_path_matches_jax_block(rng):
    """The coarse-level path: variable degree, padded edges masked."""
    V, E, H = 60, 300, 32
    v = rng.normal(size=(V, H)).astype(np.float32)
    e = rng.normal(size=(E, H)).astype(np.float32)
    receivers = np.sort(rng.integers(0, V - 4, E)).astype(np.int32)
    senders = rng.integers(0, V, E).astype(np.int32)
    mask = np.ones(E, bool)
    mask[-40:] = False
    receivers[-40:] = 0
    senders[-40:] = 0
    params = {"edge_mlp": init_mlp(jax.random.key(3), 3 * H, (H, H, H), True),
              "node_mlp": init_mlp(jax.random.key(4), 2 * H, (H, H, H), True)}
    rv, re = jax_blocks.gn_block(params, jnp.asarray(v), jnp.asarray(e),
                                 jnp.asarray(senders), jnp.asarray(receivers),
                                 edge_mask=jnp.asarray(mask),
                                 out_activation="selu")
    gv, ge = blocks.gn_block(_block_module(params), _t(v), _t(e),
                             torch.from_numpy(senders),
                             torch.from_numpy(receivers),
                             edge_mask=torch.from_numpy(mask), out_selu=True)
    np.testing.assert_allclose(gv.detach().numpy(), np.asarray(rv), **TOL)
    np.testing.assert_allclose(ge.detach().numpy(), np.asarray(re), **TOL)


def test_mlp_chain_kernel_checks_reject_bad_inputs():
    ws = [torch.zeros(8, 16), torch.zeros(16, 4)]
    bs = [torch.zeros(16), torch.zeros(4)]
    x = torch.zeros(10, 8)
    assert port_mlp._check(x, ws, bs, None, None) == [8, 16, 4]
    with pytest.raises(ValueError):
        port_mlp._check(torch.zeros(10, 9), ws, bs, None, None)
    with pytest.raises(ValueError):
        port_mlp._check(x.double(), ws, bs, None, None)
    with pytest.raises(ValueError):
        port_mlp._check(x, [ws[0], torch.zeros(4, 16).t()], bs, None, None)
    with pytest.raises(ValueError):
        port_mlp._check(x, ws, bs, torch.ones(4), None)
    with pytest.raises(ValueError):
        port_mlp._check(torch.zeros(10, 8), [torch.zeros(8, 300)],
                        [torch.zeros(300)], None, None)
    # a gradient is no refusal: on the CPU it runs through the autograd
    # Function whose backward is the plain backward
    xg = torch.randn(10, 8).requires_grad_()
    wg = [w.clone().normal_().requires_grad_() for w in ws]
    out = port_mlp.mlp_chain(xg, wg, bs)
    assert type(out.grad_fn).__name__ == "MlpChainFnBackward"
    g = torch.randn(10, 4)
    out.backward(g)
    dx, dws, _, _ = port_mlp.mlp_chain_bwd_plain(xg.detach(), g, wg, bs)
    assert torch.equal(xg.grad, dx) and torch.equal(wg[0].grad, dws[0])


def test_gn_block_kernel_checks_reject_bad_inputs(rng):
    V, k, H = 32, 6, 16
    v, e, senders, params = _gn_inputs(rng, V, k, H)
    edge, node = _chain(params["edge_mlp"]), _chain(params["node_mlp"])
    args = lambda **kw: {**dict(e=_t(e), vs=_t(v), v=_t(v),
                                senders=torch.from_numpy(senders), k=k,
                                edge=edge, node=node), **kw}
    ed, nd = port_gn._check(**args())
    assert ed == [3 * H, H, H, H] and nd == [2 * H, H, H, H]
    bad = [dict(k=1), dict(e=_t(e[:-6])), dict(vs=_t(v[:, :8])),
           dict(senders=torch.from_numpy(senders).long())]
    for kw in bad:
        with pytest.raises(ValueError):
            port_gn._check(**args(**kw))


def test_wrappers_refuse_other_devices():
    with pytest.raises(ValueError):
        port_mlp.mlp_chain(torch.zeros(4, 4, device="meta"),
                           [torch.zeros(4, 4)], [torch.zeros(4)])


def test_build_locates_nvcc_or_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    # the library path depends only on the sources and the flags
    assert _build.library_path() == _build.library_path()
    assert _build.library_path().parent.parent == _build.BUILD_ROOT
