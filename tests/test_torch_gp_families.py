"""The port's graph-parallel gMuS-GNN and REMuS-GNN over 4 spawned gloo
ranks on the CPU, against the JAX package on the unsplit batch.

One ``spawn_ranks`` run (``parallel.run.run_gp_tasks`` with one job a
family, one thread per rank) computes everything the tests compare, on
``tests/test_parallel.py``'s gMuS and REMuS GP batches (430 nodes, 3
levels, k = 4) with ``test_models.mugs_arch(6, 1)`` and ``remus_arch()``
and random weights carried across by ``params_from_jax``.  The JAX
package's own GP tests need an 8-device mesh; its reference here is the
single-device ``model.forward`` and ``make_train_step`` on the unsplit
batch, which ``tests/test_parallel.py`` holds equal to the JAX GP:

* the forward, un-permuted, at rtol and atol 2e-4, at ``halo_max_frac``
  0.5 and 1e9; the all-gather path (0) within 1e-6 of the halo path;
* ``make_gp_rollout(n_out=3)`` against the JAX ``solve`` at 1e-3;
* one ``make_gp_train_step`` (``GraphLoss(0.25)``, ``n_out=2``, clip 1.0,
  lr 1e-3): the loss at rtol 1e-4, the parameters at rtol 5e-3 and atol
  1e-4, the same bits on every rank and in a second run;
* the first-step gradients (summed over the ranks) within 1e-5 relative
  L2 of the port's single-device gradients, and for REMuS at 2e-4 of each
  tensor's max abs of the JAX package's float64 gradients
  (``tests/test_torch_remus_train.py:_jax_grads_f64``, here jitted).

The JAX references are computed in a thread while the ranks run; the
forward they are held against is the first step of the JAX ``solve``.

The REMuS weights come from seed 5.  From seed 4 a first-layer input of
``down_mp12`` lies next to a SELU kink: there the JAX package's own f32
gradient of ``down_mp12.angle_mlp.weights.0`` lies 8.6e-4 of the tensor's
max abs from its float64 one, as the port's single-device and GP f32
gradients do, so no f32 run meets the 2e-4 gate there.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.nn.losses import GraphLoss as JaxGraphLoss
from graphs4cfd_tpu.training import trainer as jax_trainer
from graphs4cfd_tpu.training.rollout import solve as jax_solve
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.nn import (GraphLoss, MuGSGNN, REMuSGNN,
                                     init_params_numpy, params_from_jax)
from graphs4cfd_tpu_torch.parallel import (attach_gp_sorts, partition_graph,
                                           spawn_ranks, unpermute)
from graphs4cfd_tpu_torch.parallel.run import run_gp_tasks
from test_models import mugs_arch, remus_arch
from test_torch_gp_host import P, jax_family_batch, port_family_batch
from test_torch_train import _close_to_max

LR = 1e-3
N_OUT = 2
SPAWN_LIMIT = 300          # seconds, for the 4 ranks together
FRACS = ("0.5", "1e9", "0.0")
TASKS = [("forward", f, {}) for f in FRACS] + [
    ("rollout", "0.5", {"n_out": 3}),
    ("grads", "0.5", {"lambda_d": 0.25}),
    ("train", "0.5", dict(lambda_d=0.25, n_out=N_OUT, lr=LR, clip=1.0,
                          steps=1)),
    ("train", "0.5", dict(lambda_d=0.25, n_out=N_OUT, lr=LR, clip=1.0,
                          steps=1))]
FAMILIES = {"mugs": ("gmus", lambda: mugs_arch(6, 1), MuGSGNN,
                     g4c.nn.MuGSGNN, 3),
            "remus": ("remus", remus_arch, REMuSGNN, g4c.nn.REMuSGNN, 5)}


def l2_gap(got: dict, ref: dict) -> float:
    num = sum(float(((torch.as_tensor(got[n]).double()
                      - torch.as_tensor(ref[n]).double()) ** 2).sum())
              for n in ref)
    den = sum(float((torch.as_tensor(ref[n]).double() ** 2).sum())
              for n in ref)
    return (num / den) ** 0.5


def _jax_grads_f64(arch, tree, batch, crit, nf):
    """``tests/test_torch_remus_train.py:_jax_grads_f64`` under ``jax.jit``
    (the same gradients, a third of its time on the CPU)."""
    f64 = lambda x: (x.astype(np.float64) if isinstance(x, np.ndarray)
                     and x.dtype == np.float32 else x)
    with jax.enable_x64(True):
        jgraph = JaxGraph(data={k: f64(v) for k, v in batch.data.items()}
                          ).to_device()
        jmodel = g4c.nn.REMuSGNN(arch=arch, compute_dtype=jnp.float64)
        params = jax.tree_util.tree_map(
            lambda x: jnp.asarray(f64(np.asarray(x))), tree)
        grads = jax.jit(jax.grad(lambda p, g: crit(
            g, jmodel.apply(p, g), g.target[:, :nf])))(params, jgraph)
        return params_from_jax(jax.tree_util.tree_map(
            lambda x: np.asarray(x, np.float64), grads))


def _reference(family, tree, batch, port_batch):
    """The JAX package's single-device forward, solve and train step on
    the unsplit batch, and the port's single-device gradients."""
    _, arch_of, cls, jax_cls, _ = FAMILIES[family]
    arch = arch_of()
    jmodel = jax_cls(arch=arch)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, tree)
    nf = jmodel.num_fields
    jg = batch.to_device()
    crit = JaxGraphLoss(0.25)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    jstep = jax_trainer.make_train_step(jmodel.apply, crit, nf, N_OUT, 1.0)
    p1, _, l1, _ = jstep(jmodel.params,
                         jax_trainer._adam_opt().init(jmodel.params), jg,
                         LR, True)
    model = cls(arch=arch, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    g = Graph.from_numpy(model.prepare_batch(port_batch), "cpu")
    loss = GraphLoss(0.25)(g, model(g), g.target[:, :nf])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    solve = np.asarray(jax_solve(jmodel, jg, 3))
    ref = {"forward": solve[:, :nf], "solve": solve,
           "loss": float(l1), "params": params_from_jax(to_np(p1)),
           "port_grads": dict(zip([n for n, _ in model.named_parameters()],
                                  grads))}
    if family == "remus":
        ref["grads_f64"] = _jax_grads_f64(arch, tree, batch, crit, nf)
    return ref


@pytest.fixture(scope="module")
def case():
    jobs, infos, batches = [], {}, {}
    for family, (name, arch_of, _, _, seed) in FAMILIES.items():
        batches[family] = port_family_batch(family)
        graphs = {}
        for frac in FRACS:
            sharded, infos[family, frac] = partition_graph(
                batches[family], P, float(frac))
            graphs[frac] = attach_gp_sorts(sharded).data
        jobs.append({"family": name, "arch": arch_of(),
                     "params": init_params_numpy(arch_of(), seed=seed),
                     "device": "cpu", "graphs": graphs, "tasks": TASKS})
    with ThreadPoolExecutor(1) as pool:
        refs = pool.submit(lambda: {
            family: _reference(family, job["params"],
                               jax_family_batch(family), batches[family])
            for family, job in zip(FAMILIES, jobs)})
        ranks = spawn_ranks(run_gp_tasks, P, "gloo", {"jobs": jobs},
                            timeout=SPAWN_LIMIT, num_threads=1)
        ref = refs.result()
    return dict(ranks={f: [r[i] for r in ranks]
                       for i, f in enumerate(FAMILIES)},
                infos=infos, ref=ref,
                mask={f: np.asarray(b.node_mask) for f, b in batches.items()})


def _rows(case, family, task, frac="0.5"):
    return unpermute([r[task] for r in case["ranks"][family]],
                     case["infos"][family, frac])


@pytest.mark.parametrize("family", list(FAMILIES))
@pytest.mark.parametrize("task,frac", [(0, "0.5"), (1, "1e9")])
def test_gp_family_forward_matches_jax(case, family, task, frac):
    mask = case["mask"][family]
    np.testing.assert_allclose(_rows(case, family, task, frac)[mask],
                               case["ref"][family]["forward"][mask],
                               rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gp_family_all_gather_path_matches_halo_path(case, family):
    np.testing.assert_allclose(_rows(case, family, 2, "0.0"),
                               _rows(case, family, 1, "1e9"), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gp_family_rollout_matches_jax_solve(case, family):
    got, mask = _rows(case, family, 3), case["mask"][family]
    want = case["ref"][family]["solve"]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gp_family_train_step_matches_jax(case, family):
    losses, gnorms, params = case["ranks"][family][0][5]
    ref = case["ref"][family]
    np.testing.assert_allclose(losses[0], ref["loss"], rtol=1e-4)
    assert np.isfinite(gnorms[0])
    for name, want in ref["params"].items():
        np.testing.assert_allclose(params[name], want.numpy(), rtol=5e-3,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gp_family_gradients_match_one_device(case, family):
    loss, grads = case["ranks"][family][0][4]
    ref = case["ref"][family]
    assert set(grads) == set(ref["port_grads"])
    assert l2_gap(grads, ref["port_grads"]) <= 1e-5
    for r in case["ranks"][family][1:]:           # every rank holds them
        assert r[4][0] == loss
        for name, got in r[4][1].items():
            np.testing.assert_array_equal(got, grads[name])
    if family == "remus":
        for name, got in grads.items():
            _close_to_max(got, ref["grads_f64"][name].numpy(), 2e-4)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gp_family_train_step_keeps_the_ranks_the_same_bits(case, family):
    ranks = case["ranks"][family]
    first = ranks[0][5]
    for r in ranks:
        for a in (r[5], r[6]):                    # every rank, two runs
            assert a[:2] == first[:2]
            for name, value in first[2].items():
                np.testing.assert_array_equal(a[2][name], value)
