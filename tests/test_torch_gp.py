"""The port's graph-parallel MuS-GNN over 4 spawned gloo ranks on the CPU,
against the JAX package on the unsplit batch.

One ``spawn_ranks`` run (``parallel.run.run_gp_tasks``, one thread per
rank) computes everything the tests compare, on ``tests/test_parallel.py``'s
430-node batch and 2-scale, 32-wide MuS model:

* the forward, un-permuted, against the JAX ``model.forward`` at rtol and
  atol 2e-4 (``tests/test_parallel.py``'s tolerance), at ``halo_max_frac``
  0.5 and 1e9; the all-gather path (0) against the halo path at 1e-6;
* ``make_gp_rollout(n_out=3)`` against the JAX ``solve`` at 1e-3;
* ``GraphLoss.distributed`` (``lambda_d`` 0 and 0.25) against the JAX
  ``GraphLoss`` on the unsplit rows;
* one ``make_gp_train_step`` (``GraphLoss(0.25)``, ``n_out=2``, clip 1.0,
  lr 1e-3) against the JAX ``make_train_step``: the loss at rtol 1e-4,
  the first step's gradients (summed over the ranks) at 2e-4 of each
  tensor's max abs, the parameters at rtol 5e-3 and atol 1e-4; the
  parameters the same bits on all 4 ranks, and a second run of the step
  the same bits as the first;
* ``make_gp_val_step`` against the JAX ``make_val_step``.

``spawn_ranks`` also has to name a rank that never reaches a collective,
and one that raises, within its time limit.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu.nn.losses import GraphLoss as JaxGraphLoss
from graphs4cfd_tpu.training import trainer as jax_trainer
from graphs4cfd_tpu.training.rollout import solve as jax_solve
from graphs4cfd_tpu_torch.nn import init_params_numpy, params_from_jax
from graphs4cfd_tpu_torch.parallel import (attach_gp_sorts, partition_graph,
                                           spawn_ranks, unpermute)
from graphs4cfd_tpu_torch.parallel.run import barrier_unless, run_gp_tasks
from test_models import mus_arch
from test_torch_gp_host import P, jax_batch, port_batch
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
                          steps=1)),
    ("val", "0.5", dict(lambda_d=0.25, max_n_out=2))]


@pytest.fixture(scope="module")
def case():
    arch = mus_arch(5, 1)
    tree = init_params_numpy(arch, seed=6)
    batch = port_batch()
    rng = np.random.default_rng(4)
    pred, target = (rng.normal(size=(batch.num_nodes, 1)).astype(np.float32)
                    for _ in range(2))
    graphs, infos = {}, {}
    for frac in FRACS:
        sharded, infos[frac] = partition_graph(batch, P, float(frac))
        graphs[frac] = attach_gp_sorts(sharded).data
    perm = infos["0.5"]["perms"][1]
    parts = lambda x: x[perm].reshape(P, -1, x.shape[1])
    tasks = TASKS + [("loss", "0.5", dict(lambda_d=lam, pred=parts(pred),
                                          target=parts(target)))
                     for lam in (0.0, 0.25)]
    ranks = spawn_ranks(run_gp_tasks, P, "gloo", {
        "arch": arch, "params": tree, "device": "cpu", "graphs": graphs,
        "tasks": tasks}, timeout=SPAWN_LIMIT, num_threads=1)

    # the JAX package on the unsplit batch, with the same weights
    jmodel = g4c.nn.MuSGNN(arch=arch)
    jmodel.params = jax.tree_util.tree_map(jnp.asarray, tree)
    jg = jax_batch().to_device()
    crit = JaxGraphLoss(0.25)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)
    jstep = jax_trainer.make_train_step(jmodel.apply, crit, 1, N_OUT, 1.0)
    p1, _, l1, _ = jstep(jmodel.params,
                         jax_trainer._adam_opt().init(jmodel.params), jg,
                         LR, True)
    grads = jax.grad(lambda p: crit(jg, jmodel.apply(p, jg),
                                    jg.target[:, :1]))(jmodel.params)
    ref = {"forward": np.asarray(jmodel.forward(jg)),
           "solve": np.asarray(jax_solve(jmodel, jg, 3)),
           "loss": float(l1), "params": params_from_jax(to_np(p1)),
           "grads": params_from_jax(to_np(grads)),
           "val": float(jax_trainer.make_val_step(jmodel.apply, crit, 1, 2)(
               jmodel.params, jg)),
           "losses": [float(JaxGraphLoss(lam)(jg, jnp.asarray(pred),
                                              jnp.asarray(target)))
                      for lam in (0.0, 0.25)]}
    return dict(ranks=ranks, infos=infos, ref=ref, n_tasks=len(tasks),
                mask=np.asarray(batch.node_mask))


def _rows(case, task, frac="0.5"):
    return unpermute([r[task] for r in case["ranks"]], case["infos"][frac])


def test_spawned_ranks_finish_well_inside_their_limit(case):
    # spawn_ranks raises once SPAWN_LIMIT seconds pass: every rank that
    # reached here returned a result for every task within it
    assert len(case["ranks"]) == P
    assert all(len(r) == case["n_tasks"] for r in case["ranks"])


@pytest.mark.parametrize("task,frac", [(0, "0.5"), (1, "1e9")])
def test_gp_forward_matches_jax(case, task, frac):
    mask = case["mask"]
    np.testing.assert_allclose(_rows(case, task, frac)[mask],
                               case["ref"]["forward"][mask], rtol=2e-4,
                               atol=2e-4)


def test_all_gather_path_matches_halo_path(case):
    np.testing.assert_allclose(_rows(case, 2, "0.0"), _rows(case, 1, "1e9"),
                               rtol=1e-6, atol=1e-6)


def test_gp_rollout_matches_jax_solve(case):
    got, mask = _rows(case, 3), case["mask"]
    assert got.shape == case["ref"]["solve"].shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[mask], case["ref"]["solve"][mask],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("which", [0, 1])
def test_distributed_loss_matches_jax(case, which):
    got = [r[len(TASKS) + which] for r in case["ranks"]]
    assert len(set(got)) == 1                     # the same on every rank
    np.testing.assert_allclose(got[0], case["ref"]["losses"][which],
                               rtol=1e-6)


def test_gp_first_step_gradients_match_jax(case):
    loss, grads = case["ranks"][0][4]
    assert set(grads) == set(case["ref"]["grads"])
    for name, got in grads.items():
        _close_to_max(got, case["ref"]["grads"][name].numpy(), 2e-4)
    for r in case["ranks"][1:]:                   # every rank holds them
        assert r[4][0] == loss
        for name, got in r[4][1].items():
            np.testing.assert_array_equal(got, grads[name])


def test_gp_train_step_matches_jax(case):
    losses, gnorms, params = case["ranks"][0][5]
    np.testing.assert_allclose(losses[0], case["ref"]["loss"], rtol=1e-4)
    assert np.isfinite(gnorms[0])
    for name, ref in case["ref"]["params"].items():
        np.testing.assert_allclose(params[name], ref.numpy(), rtol=5e-3,
                                   atol=1e-4, err_msg=name)


def test_gp_train_step_keeps_the_ranks_the_same_bits(case):
    first = case["ranks"][0][5]
    for r in case["ranks"][1:]:
        assert r[5][:2] == first[:2]
        for name, value in first[2].items():
            np.testing.assert_array_equal(r[5][2][name], value)


def test_two_gp_train_steps_give_the_same_bits(case):
    for r in case["ranks"]:
        a, b = r[5], r[6]
        assert a[:2] == b[:2]
        for name, value in a[2].items():
            np.testing.assert_array_equal(b[2][name], value)


def test_gp_val_step_matches_jax(case):
    got = [r[7] for r in case["ranks"]]
    assert len(set(got)) == 1
    np.testing.assert_allclose(got[0], case["ref"]["val"], rtol=1e-4)


def test_spawn_ranks_names_a_rank_that_never_reaches_a_collective():
    t = time.perf_counter()
    # rank 1 never reaches rank 0's barrier: both wait until the limit
    # (rank 0's barrier may fail first), and rank 1 is named
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] (had not "
                       r"finished|did not finish)"):
        spawn_ranks(barrier_unless, 2, "gloo", 1, 600.0, timeout=10)
    assert time.perf_counter() - t < 40


def test_spawn_ranks_reports_a_rank_that_raises():
    job = {"arch": mus_arch(5, 1), "params": init_params_numpy(
        mus_arch(5, 1)), "device": "cpu", "graphs": {},
        "tasks": [("forward", "missing", {})]}
    with pytest.raises(RuntimeError, match="(?s)rank [01] failed.*KeyError"):
        spawn_ranks(run_gp_tasks, 2, "gloo", job, timeout=60)
