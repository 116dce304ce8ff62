"""The port's MuS-GNN slice against the JAX package, end to end on the CPU.

* ``solve`` of a 3-scale MuS model, 32 wide, on 2 graphs of about 400
  nodes: the first step at 2e-4, three steps at 1e-3 (errors feed back);
* the forward pass of the bundled 64-wide 3-scale checkpoint, read by the
  port's own ``load_checkpoint``, at 2e-4;
* the weight converters and the execution plan.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu.loader import collate as jax_collate
from graphs4cfd_tpu.nn.mus_gnn import build_mus_plan as jax_plan
from graphs4cfd_tpu.training.rollout import solve as jax_solve
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import collate
from graphs4cfd_tpu_torch.nn import (NsThreeScaleGNN, build_mus_plan,
                                     init_params_numpy, params_from_jax,
                                     params_to_numpy)
from graphs4cfd_tpu_torch.ops import gn_block as gn_op
from graphs4cfd_tpu_torch.training import load_checkpoint
from test_torch_host import port_samples

CHK = os.path.join(os.path.dirname(g4c.__file__), "nn", "weights",
                   "NsMuSGNN", "NsThreeScaleGNN_taylor_green_tpu.chk")


def small_arch(w=32, nf=3, n_in=5):
    """3 scales, one MP layer per visit of a level, plus a second level-1
    layer before the decoder (its e' is dead)."""
    mp = ((3 * w, (w, w, w), True), (2 * w, (w, w, w), True))
    return {
        "edge_encoder": (2, (w, w, w), False),
        "node_encoder": (n_in, (w, w, w), False),
        "mp111": mp, "down_mp12": (2 + w, (w, w, w), True),
        "mp211": mp, "down_mp23": (2 + w, (w, w, w), True),
        "mp31": mp, "mp32": mp, "up_mp32": (2 + 2 * w, (w, w, w), True),
        "mp221": mp, "up_mp21": (2 + 2 * w, (w, w, w), True),
        "mp121": mp, "mp122": mp,
        "decoder": (w, (w, w, nf), False),
    }


@pytest.fixture(scope="module")
def batch():
    return collate(port_samples(2, 400, seed=5), node_bucket=64,
                   edge_bucket=128)


def _jax_model(arch, tree):
    model = g4c.nn.NsThreeScaleGNN(arch=arch)
    model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    return model


def test_solve_matches_jax(batch):
    arch = small_arch()
    tree = init_params_numpy(arch, seed=3)
    jax_graph = jax_collate([g for g in port_samples(2, 400, seed=5)],
                            node_bucket=64, edge_bucket=128).to_device()
    ref = np.asarray(jax_solve(_jax_model(arch, tree), jax_graph, 3))
    model = NsThreeScaleGNN(arch=arch, seed=3, device="cpu")
    got = model.solve(Graph.from_numpy(batch, "cpu"), 3).numpy()
    mask = batch.node_mask
    assert got.shape == ref.shape == (batch.num_nodes, 9)
    np.testing.assert_allclose(got[mask, :3], ref[mask, :3], rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(got[mask], ref[mask], rtol=1e-3, atol=1e-3)
    assert np.isfinite(got).all()


def test_bundled_checkpoint_forward_matches_jax(batch):
    state = load_checkpoint(CHK)
    assert state["optimiser"] is None and state["arch"]["mp111"][0][1][0] == 64
    ref_model = g4c.nn.NsThreeScaleGNN(checkpoint=CHK)
    jax_graph = g4c.graph.Graph(data=dict(batch.data)).to_device()
    ref = np.asarray(jax.jit(ref_model.apply)(ref_model.params, jax_graph))
    model = NsThreeScaleGNN(checkpoint=CHK, device="cpu")
    with torch.no_grad():
        got = model(Graph.from_numpy(batch, "cpu")).numpy()
    mask = batch.node_mask
    np.testing.assert_allclose(got[mask], ref[mask], rtol=2e-4, atol=2e-4)


def test_params_round_trip():
    state = load_checkpoint(CHK)
    model = NsThreeScaleGNN(arch=state["arch"], seed=1, device="cpu")
    model.load_state_dict(params_from_jax(state["weights"]))
    back = params_to_numpy(model)
    flat = lambda t: jax.tree_util.tree_flatten_with_path(t)[0]
    ref, got = flat(state["weights"]), flat(back)
    assert [p for p, _ in ref] == [p for p, _ in got]
    for (_, a), (_, b) in zip(ref, got):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert model.num_params == sum(a.size for _, a in ref)


def test_seeded_init_is_reproducible():
    arch = small_arch(w=16)
    a = NsThreeScaleGNN(arch=arch, seed=4, device="cpu").state_dict()
    b = NsThreeScaleGNN(arch=arch, seed=4, device="cpu").state_dict()
    c = NsThreeScaleGNN(arch=arch, seed=5, device="cpu").state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


@pytest.mark.parametrize("arch", [small_arch(), load_checkpoint(CHK)["arch"]])
def test_plan_matches_jax(arch):
    assert build_mus_plan(arch) == jax_plan(arch)


def test_dead_edge_output_only_before_decoder(batch, monkeypatch):
    """Level-1 layers run the fused kernel's route; only the last one
    before the decoder (or an up) skips e', not the one before a down."""
    calls = []
    real = gn_op.gn_block

    def spy(*args, **kw):
        calls.append(kw["skip_e_out"])
        return real(*args, **kw)

    monkeypatch.setattr(gn_op, "gn_block", spy)
    model = NsThreeScaleGNN(arch=small_arch(w=16), device="cpu")
    model.solve(Graph.from_numpy(batch, "cpu"), 1)
    # mp111 (before down_mp12), mp121, mp122 (before the decoder)
    assert calls == [False, False, True]


def test_constructor_needs_one_source():
    with pytest.raises(ValueError):
        NsThreeScaleGNN(device="cpu")
    with pytest.raises(ValueError):
        NsThreeScaleGNN(arch=small_arch(), checkpoint=CHK, device="cpu")
