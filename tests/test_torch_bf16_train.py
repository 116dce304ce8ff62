"""The bf16 policy's models and ``fit`` against the JAX package's, on the
CPU (the kernel modules are in ``test_torch_bf16.py``).

* MuS-, REMuS- and gMuS-GNN (the 32-wide 3-scale archs of their CPU
  tests) with ``compute_dtype=torch.bfloat16``: a first forward and the
  first training step's gradients against the JAX model with
  ``compute_dtype=jnp.bfloat16`` on the same batch and weights.  The
  port's relative L2 gap to JAX's bf16 run must be at most twice JAX's own
  gap between its bf16 and f32 runs, plus ``GAP_FLOOR`` = 2e-3: the two
  frameworks round to bf16 at other places (the port runs every MLP chain
  through its kernel's rounding points, f32 between the products; JAX's
  plain path at these widths rounds after each product and bias add),
  so neither is nearer the f32 answer by construction, and the bound says
  the port's bf16 is no further from JAX's than JAX's bf16 is from f32.
  The step's output and loss are f32 (the f32 field plus the bf16
  decoder output), the parameters' gradients f32.
* ``fit(mixed_precision=True)`` against the JAX ``fit`` over 2 epochs:
  the per-epoch training losses within ``FIT_TOL`` = 2e-3 relative
  (measured: 1.9e-4; the two bf16 forwards differ by the gap above, and
  Adam's steps follow gradients that differ by it too), the model left in
  bf16, and the saved checkpoint's weights and Adam state f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.loader import DataLoader as JaxDataLoader
from graphs4cfd_tpu.nn.losses import GraphLoss as JaxGraphLoss
from graphs4cfd_tpu.training import trainer as jax_trainer
from graphs4cfd_tpu.training.config import TrainConfig as JaxTrainConfig
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import (DataLoader, attach_angle_sorts,
                                         attach_sender_sorts, collate)
from graphs4cfd_tpu_torch.nn import (GraphLoss, NsRotEquiThreeScaleGNN,
                                     NsThreeGuillardScaleGNN,
                                     NsThreeScaleGNN, init_params_numpy,
                                     params_from_jax)
from graphs4cfd_tpu_torch.training import (TrainConfig, adam_init,
                                           load_checkpoint, make_train_step,
                                           make_val_step)
from test_torch_host import port_samples
from test_torch_mugs import mugs_batch, small_mugs_arch
from test_torch_mus import _jax_model, small_arch
from test_torch_remus import port_remus_samples, small_remus_arch
from test_torch_runtime import _jax_steps_built_once, _jsonl

GAP_FLOOR = 2e-3
FIT_TOL = 2e-3

FAMILIES = {
    "mus": (small_arch, g4c.nn.NsThreeScaleGNN, NsThreeScaleGNN, 3,
            lambda: collate(port_samples(2, 400, seed=5), node_bucket=64,
                            edge_bucket=128)),
    "remus": (small_remus_arch, g4c.nn.NsRotEquiThreeScaleGNN,
              NsRotEquiThreeScaleGNN, 2,
              lambda: attach_angle_sorts(collate(
                  port_remus_samples(), node_bucket=64, edge_bucket=128))),
    "gmus": (small_mugs_arch, g4c.nn.NsThreeGuillardScaleGNN,
             NsThreeGuillardScaleGNN, 3,
             lambda: attach_sender_sorts(mugs_batch())),
}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _gap(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


@pytest.fixture(scope="module", params=list(FAMILIES))
def family_case(request):
    """The JAX model's first output and first-step gradients in f32 and in
    bf16 (one jit each), and the port's in bf16, from the same weights."""
    arch_fn, jax_cls, port_cls, nf, batch_fn = FAMILIES[request.param]
    arch = arch_fn()
    tree = init_params_numpy(arch, seed=3)
    batch = batch_fn()
    jgraph = JaxGraph(data=dict(batch.data)).to_device()
    crit = JaxGraphLoss(0.25)
    jax_runs = {}
    for cd in (jnp.float32, jnp.bfloat16):
        jm = jax_cls(arch=arch, compute_dtype=cd)

        def loss_fn(p, graph, jm=jm):
            out = jm.apply(p, graph)
            return crit(graph, out, graph.target[:, :nf]), out

        params = jax.tree_util.tree_map(jnp.asarray, tree)
        (loss, out), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params, jgraph)
        jax_runs[cd] = (np.asarray(out, np.float64), float(loss),
                        {k: v.numpy() for k, v in params_from_jax(
                            jax.tree_util.tree_map(np.asarray,
                                                   grads)).items()})
    model = port_cls(arch=arch, seed=0, device="cpu",
                     compute_dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(tree))
    g = Graph.from_numpy(batch, "cpu")
    pred = model(g)
    loss = GraphLoss(0.25)(g, pred, g.target[:, :nf])
    names = [n for n, _ in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return dict(name=request.param, arch=arch, tree=tree, batch=batch,
                nf=nf, port_cls=port_cls, jax32=jax_runs[jnp.float32],
                jax16=jax_runs[jnp.bfloat16], pred=pred.detach(), loss=loss,
                grads=dict(zip(names, grads)))


def test_bf16_first_forward_matches_jax(family_case):
    c = family_case
    mask = c["batch"].node_mask
    assert c["pred"].dtype == torch.float32
    got = c["pred"].double().numpy()[mask]
    ref16, ref32 = c["jax16"][0][mask], c["jax32"][0][mask]
    assert np.isfinite(got).all()
    jax_gap = _gap(ref16, ref32)
    assert 0 < jax_gap < 0.05
    assert _gap(got, ref16) <= 2 * jax_gap + GAP_FLOOR, (
        _gap(got, ref16), jax_gap)


def test_bf16_first_step_loss_and_gradients_match_jax(family_case):
    c = family_case
    assert c["loss"].dtype == torch.float32
    loss16, loss32 = c["jax16"][1], c["jax32"][1]
    assert abs(c["loss"].item() - loss16) <= (2 * abs(loss16 - loss32)
                                              + GAP_FLOOR * abs(loss32))
    names = sorted(c["grads"])
    assert set(names) == set(c["jax16"][2])
    assert all(g.dtype == torch.float32 for g in c["grads"].values())
    got = np.concatenate([c["grads"][n].double().numpy().ravel()
                          for n in names])
    ref16 = np.concatenate([c["jax16"][2][n].ravel() for n in names])
    ref32 = np.concatenate([c["jax32"][2][n].ravel() for n in names])
    jax_gap = _gap(ref16, ref32)
    assert _gap(got, ref16) <= 2 * jax_gap + GAP_FLOOR, (
        _gap(got, ref16), jax_gap)


def test_bf16_train_step_keeps_f32_parameters_and_state(family_case):
    """Two bf16 training steps: finite f32 losses, f32 parameters and Adam
    moments, the step counted once per rollout step; the validation step
    in bf16 gives an f32 loss."""
    c = family_case
    model = c["port_cls"](arch=c["arch"], seed=0, device="cpu",
                          compute_dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(c["tree"]))
    state = adam_init(model.parameters())
    step = make_train_step(model, GraphLoss(0.25), c["nf"], 2, 1.0)
    graph = Graph.from_numpy(c["batch"], "cpu")
    loss, gnorm = step(state, graph, 1e-4, True)
    assert loss.dtype == gnorm.dtype == torch.float32
    assert np.isfinite(float(loss)) and float(gnorm) > 0
    assert state.count == 2
    assert all(t.dtype == torch.float32 for t in
               list(model.parameters()) + state.mu + state.nu)
    val = make_val_step(model, GraphLoss(0.25), c["nf"], 2)(graph)
    assert val.dtype == torch.float32 and np.isfinite(float(val))


def test_bf16_solve_feeds_back_the_bf16_steps(family_case):
    """``solve``: each step is the model's bf16 time step fed back, f32
    out."""
    c = family_case
    model = c["port_cls"](arch=c["arch"], seed=0, device="cpu",
                          compute_dtype=torch.bfloat16)
    model.load_state_dict(params_from_jax(c["tree"]))
    graph = Graph.from_numpy(c["batch"], "cpu")
    got = model.solve(graph, 2)
    nf = c["nf"]
    with torch.no_grad():
        first = model(graph)
        second = model(graph.replace(field=torch.cat(
            [graph.field[:, nf:], first], dim=1)))
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, torch.cat([first, second], dim=1),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(first.numpy(), c["pred"].numpy())


def test_bf16_fit_matches_jax_fit(tmp_path):
    """``fit(mixed_precision=True)`` against the JAX ``fit``, 2 epochs."""
    arch = small_arch()
    tree = init_params_numpy(arch, seed=3)
    samples = port_samples(4, 300, seed=5)
    kw = dict(num_steps=[1], lr=1e-3, epochs=2, chk_interval=1,
              mixed_precision=True)
    model = NsThreeScaleGNN(arch=arch, seed=3, device="cpu")
    cfg = TrainConfig("port", folder=str(tmp_path),
                      tensor_board=str(tmp_path),
                      training_loss=GraphLoss(0.25), **kw)
    history = model.fit(cfg, DataLoader(samples, batch_size=2, shuffle=True,
                                        seed=0))
    assert model.compute_dtype == torch.bfloat16
    assert len(history) == 2
    jm = _jax_model(arch, tree)
    jcfg = JaxTrainConfig("jax", folder=str(tmp_path),
                          tensor_board=str(tmp_path),
                          training_loss=JaxGraphLoss(0.25), **kw)
    with _jax_steps_built_once():
        jax_trainer.fit(jm, jcfg, JaxDataLoader(
            [JaxGraph(data=dict(s.data)) for s in samples], batch_size=2,
            shuffle=True, seed=0))
    assert jm.compute_dtype == jnp.bfloat16
    got, want = _jsonl(tmp_path, "port"), _jsonl(tmp_path, "jax")
    for epoch in (1, 2):
        np.testing.assert_allclose(got["Loss/train"][epoch],
                                   want["Loss/train"][epoch], rtol=FIT_TOL,
                                   err_msg=epoch)
    state = load_checkpoint(str(tmp_path / "port.chk"))
    leaves = jax.tree_util.tree_leaves(state["weights"])
    count, mu, nu = state["optimiser"]
    moments = jax.tree_util.tree_leaves(mu) + jax.tree_util.tree_leaves(nu)
    assert leaves and all(np.asarray(x).dtype == np.float32 for x in leaves)
    assert moments and all(np.asarray(x).dtype == np.float32
                           for x in moments)
    assert int(np.asarray(count)) == 4
