"""Graph parallelism under the bf16 policy: the three families in bf16
over 2 spawned gloo ranks on the CPU.

One ``spawn_ranks`` run (``parallel.run.run_gp_tasks``, one job a
family, one thread per rank) on ``tests/test_torch_gp_host.py``'s MuS, gMuS
and REMuS GP batches, the JAX package's archs of ``tests/test_models.py``
and random weights carried across by ``params_from_jax``, with
``compute_dtype=torch.bfloat16``:

* the forward, un-permuted, and the first step's gradients (summed over
  the ranks) against the port's single-device bf16 path on the unsplit
  batch: the forward within ``GP_PATH`` of its max abs, the gradients
  within ``GP_GRAD_L2`` relative L2.  The two differ only in the order of
  f32 sums and in where a halo table's cotangent is rounded to bf16 (the
  exchange hands each rank its rows' cotangents in bf16, the single
  device rounds the whole sum once);
* one ``make_gp_train_step`` (``GraphLoss(0.25)``, ``n_out=1``, clip 1.0,
  lr 1e-3) against the single-device bf16 step: the loss at rtol
  ``GP_LOSS``, the parameters at rtol 5e-3 and atol 2 lr (a first Adam
  step moves a parameter by lr in its gradient's sign, so a gradient
  near 0 whose sign differs moves it 2 lr apart);
* the forward and the gradients against the JAX package's single-device
  bf16 run with ``tests/test_torch_bf16_train.py``'s bound on the relative
  L2 gap (at most twice JAX's own bf16-vs-f32 gap, plus ``GAP_FLOOR``).
  The forward is not held to ``tests/test_torch_bf16.py``'s ``ACT_TOL``
  of max(1, max |ref|), a kernel's gate: the two frameworks round whole
  models at other points, and on the MuS batch the port's single-device
  bf16 forward already lies 0.0327 from JAX's (ACT_TOL allows 0.0323);
* the same bits on both ranks and in a second run of the step;
* ``fit(TrainConfig(devices=1, graph_devices=2, mixed_precision=True))``
  of a 16-wide REMuS model on 2 ranks: the same history on both ranks,
  and the first epoch within the drift that ``tests/test_torch_dp_fit.py``
  allows of the port's single-device ``fit`` after its first epoch (the
  training loss at 1e-3, the validation loss at 2e-3; f32 runs are held
  to 1e-4 in the first epoch, where this bf16 run's validation loss lies
  3.6e-4 from the single device's).  The second epoch is held at
  ``BF16_FIT`` (5e-3, its validation loss at twice that): two
  single-device bf16 ``fit``s of this model that differ only in the CPU
  threads (1 and 8) end that epoch 2.2e-3 (training) and 3.4e-3
  (validation) apart, with gradient norms 5.4 % apart, where the f32
  ``fit`` on 2 ranks lies 1e-7 from the single device's.  The
  single-device ``fit`` here runs on one CPU thread.

The JAX references and the single-device runs are computed in a thread
while the ranks run.
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
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import DataLoader
from graphs4cfd_tpu_torch.nn import (GraphLoss, MuGSGNN, MuSGNN, REMuSGNN,
                                     init_params_numpy, params_from_jax)
from graphs4cfd_tpu_torch.parallel import (attach_gp_sorts, partition_graph,
                                           spawn_ranks, unpermute)
from graphs4cfd_tpu_torch.parallel.run import run_gp_tasks
from graphs4cfd_tpu_torch.training import TrainConfig, adam_init
from graphs4cfd_tpu_torch.training.trainer import make_train_step
from test_models import mugs_arch, mus_arch, remus_arch
from test_torch_bf16_train import GAP_FLOOR
from test_torch_dp_fit import FIT_TOL, LOSS_FIELDS
from test_torch_gp_families import l2_gap
from test_torch_gp_host import port_batch, port_family_batch
from test_torch_remus import _clouds, _pipeline, small_remus_arch

BF16 = torch.bfloat16
PARTS = 2
LR = 1e-3
N_OUT = 1
SPAWN_LIMIT = 300
GP_PATH = 1e-2             # forward: max abs difference / max abs
GP_GRAD_L2 = 1e-2          # first-step gradients, relative L2
GP_LOSS = 1e-3             # train-step loss, relative
BF16_FIT = 5e-3            # second-epoch training loss, relative
TASKS = [("forward", "b", {}), ("grads", "b", {"lambda_d": 0.25}),
         ("train", "b", dict(lambda_d=0.25, n_out=N_OUT, lr=LR, clip=1.0,
                             steps=1)),
         ("train", "b", dict(lambda_d=0.25, n_out=N_OUT, lr=LR, clip=1.0,
                             steps=1))]
FAMILIES = {
    "mus": ("mus", lambda: mus_arch(5, 1), MuSGNN, g4c.nn.MuSGNN, 6,
            port_batch),
    "gmus": ("gmus", lambda: mugs_arch(6, 1), MuGSGNN, g4c.nn.MuGSGNN, 3,
             lambda: port_family_batch("mugs")),
    "remus": ("remus", remus_arch, REMuSGNN, g4c.nn.REMuSGNN, 5,
              lambda: port_family_batch("remus"))}
LOADER = dict(batch_size=4, shuffle=True, seed=0, node_bucket=16,
              edge_bucket=64)


def _fit_samples():
    """8 REMuS clouds of 300 nodes (``tests/test_torch_remus.py``'s
    pipeline) for the ``fit`` of a 16-wide model."""
    return _pipeline(T, _clouds(Graph, 8, 300, seed=31))


def _fit_config(**kw):
    return dict(name="gp_fit", chk_interval=1,
                training_loss=GraphLoss(lambda_d=0.25),
                validation_loss=GraphLoss(), epochs=2, num_steps=[1, 2],
                add_steps={"tolerance": 1e9, "loss": "training"}, lr=1e-3,
                grad_clip={"epoch": 0, "limit": 1},
                scheduler={"factor": 0.5, "patience": 5, "loss": "training"},
                stopping=1e-9, batch_size=4, mixed_precision=True,
                tensor_board=None, **kw)


def _one_device(family, tree, batch):
    """The port's single-device bf16 forward, first-step gradients and
    train step on the unsplit batch."""
    _, arch_of, cls, _, _, _ = FAMILIES[family]
    model = cls(arch=arch_of(), device="cpu", compute_dtype=BF16)
    model.load_state_dict(params_from_jax(tree))
    nf = model.num_fields
    g = Graph.from_numpy(model.prepare_batch(batch), "cpu")
    with torch.no_grad():
        fwd = model(g).numpy()
    loss = GraphLoss(0.25)(g, model(g), g.target[:, :nf])
    names = [n for n, _ in model.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss,
                                                list(model.parameters()))))
    step = make_train_step(model, GraphLoss(0.25), nf, N_OUT, 1.0)
    step_loss, _ = step(adam_init(model.parameters()), g, LR)
    return {"forward": fwd, "grads": grads, "loss": float(step_loss),
            "params": {n: p.detach().numpy().copy()
                       for n, p in model.named_parameters()}}


def _jax(family, tree, batch):
    """The JAX package's single-device first output and first-step
    gradients, in bf16 and in f32, from the same weights."""
    _, arch_of, _, jax_cls, _, _ = FAMILIES[family]
    jgraph = JaxGraph(data=dict(batch.data)).to_device()
    crit = JaxGraphLoss(0.25)
    out = {}
    for cd in (jnp.float32, jnp.bfloat16):
        jm = jax_cls(arch=arch_of(), compute_dtype=cd)
        nf = jm.num_fields

        def loss_fn(p, graph, jm=jm, nf=nf):
            pred = jm.apply(p, graph)
            return crit(graph, pred, graph.target[:, :nf]), pred

        (_, pred), grads = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(jax.tree_util.tree_map(jnp.asarray,
                                                           tree), jgraph)
        out[cd] = (np.asarray(pred, np.float64), {
            k: v.numpy() for k, v in params_from_jax(
                jax.tree_util.tree_map(np.asarray, grads)).items()})
    return out[jnp.bfloat16], out[jnp.float32]


def _one_device_fit(arch, tree, samples, folder):
    model = REMuSGNN(arch=arch, device="cpu")
    model.load_state_dict(params_from_jax(tree))
    val = {k: v for k, v in LOADER.items() if k not in ("shuffle", "seed")}
    return model.fit(TrainConfig(folder=folder, **_fit_config()),
                     DataLoader(samples, **LOADER),
                     DataLoader(samples[:4], **val))


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _case(tmp_path_factory)
    finally:
        torch.set_num_threads(threads)


def _case(tmp_path_factory):
    jobs, infos, batches = [], {}, {}
    for family, (name, arch_of, _, _, seed, batch_of) in FAMILIES.items():
        batches[family] = batch_of()
        sharded, infos[family] = partition_graph(batches[family], PARTS)
        jobs.append({"family": name, "arch": arch_of(),
                     "params": init_params_numpy(arch_of(), seed=seed),
                     "compute_dtype": BF16, "device": "cpu",
                     "graphs": {"b": attach_gp_sorts(sharded).data},
                     "tasks": TASKS})
    fit_arch = small_remus_arch(w=16)
    fit_tree = init_params_numpy(fit_arch, seed=11)
    samples = _fit_samples()
    folder = tmp_path_factory.mktemp("gp_fit")
    for sub in ("gp", "one"):
        (folder / sub).mkdir()
    jobs.append({"family": "remus", "arch": fit_arch, "params": fit_tree,
                 "device": "cpu", "graphs": {}, "tasks": [("fit", None, dict(
                     samples=[s.data for s in samples],
                     val=[s.data for s in samples[:4]], loader=LOADER,
                     config=_fit_config(devices=1, graph_devices=PARTS),
                     folder=str(folder / "gp"), resume_epochs=3,
                     resume_seed=2))]})

    def references():
        out = {f: (_one_device(f, j["params"], batches[f]),
                   _jax(f, j["params"], batches[f]))
               for f, j in zip(FAMILIES, jobs)}
        out["fit"] = _one_device_fit(fit_arch, fit_tree, samples,
                                     str(folder / "one"))
        return out

    with ThreadPoolExecutor(1) as pool:
        refs = pool.submit(references)
        ranks = spawn_ranks(run_gp_tasks, PARTS, "gloo", {"jobs": jobs},
                            timeout=SPAWN_LIMIT, num_threads=1)
        ref = refs.result()
    return dict(ranks={f: [r[i] for r in ranks]
                       for i, f in enumerate(list(FAMILIES) + ["fit"])},
                infos=infos, ref=ref,
                mask={f: np.asarray(b.node_mask) for f, b in batches.items()})


def _forward(case, family):
    return unpermute([r[0] for r in case["ranks"][family]],
                     case["infos"][family])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_gp_forward_matches_one_device(case, family):
    got, mask = _forward(case, family), case["mask"][family]
    want = case["ref"][family][0]["forward"]
    assert got.dtype == np.float32 and np.isfinite(got[mask]).all()
    assert np.abs(got - want)[mask].max() <= GP_PATH * np.abs(
        want[mask]).max()


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_gp_forward_matches_jax_bf16(case, family):
    got, mask = _forward(case, family), case["mask"][family]
    (jax16, _), (jax32, _) = case["ref"][family][1]
    gap = lambda a, b: float(np.linalg.norm(a[mask] - b[mask])
                             / np.linalg.norm(b[mask]))
    assert gap(got, jax16) <= 2 * gap(jax16, jax32) + GAP_FLOOR


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_gp_gradients_match_one_device_and_jax(case, family):
    ranks = case["ranks"][family]
    loss, grads = ranks[0][1]
    one, (jax16, jax32) = case["ref"][family]
    assert all(g.dtype == np.float32 for g in grads.values())
    assert l2_gap(grads, one["grads"]) <= GP_GRAD_L2
    jax_gap = l2_gap(jax16[1], jax32[1])
    assert l2_gap(grads, jax16[1]) <= 2 * jax_gap + GAP_FLOOR
    for r in ranks[1:]:
        assert r[1][0] == loss
        for name, got in r[1][1].items():
            np.testing.assert_array_equal(got, grads[name])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_gp_train_step_matches_one_device(case, family):
    losses, gnorms, params = case["ranks"][family][0][2]
    one = case["ref"][family][0]
    np.testing.assert_allclose(losses[0], one["loss"], rtol=GP_LOSS)
    assert np.isfinite(gnorms[0])
    for name, want in one["params"].items():
        assert params[name].dtype == np.float32
        np.testing.assert_allclose(params[name], want, rtol=5e-3,
                                   atol=2 * LR, err_msg=name)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_bf16_gp_train_step_keeps_the_ranks_the_same_bits(case, family):
    ranks = case["ranks"][family]
    first = ranks[0][2]
    for r in ranks:
        for a in (r[2], r[3]):
            assert a[:2] == first[:2]
            for name, value in first[2].items():
                np.testing.assert_array_equal(a[2][name], value)


def test_bf16_gp_fit_matches_the_one_device_fit(case):
    ranks = [r[0] for r in case["ranks"]["fit"]]
    fields = lambda h: [{k: r[k] for k in LOSS_FIELDS} for r in h]
    first = ranks[0]
    assert [r["epoch"] for r in first["history"]] == [1, 2]
    assert [r["epoch"] for r in first["resumed"]] == [3]
    for r in ranks[1:]:
        assert fields(r["history"]) == fields(first["history"])
        assert fields(r["resumed"]) == fields(first["resumed"])
        for name, value in first["params"].items():
            np.testing.assert_array_equal(r["params"][name], value)
    assert first["files"] == ["gp_fit.chk"]
    assert len(case["ref"]["fit"]) == 2
    for got, want in zip(first["history"], case["ref"]["fit"]):
        assert got["epoch"] == want["epoch"] and got["lr"] == want["lr"]
        tol = FIT_TOL if got["epoch"] == 1 else BF16_FIT
        for key, rtol in (("train_loss", tol), ("val_loss", 2 * tol)):
            np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                       err_msg=(key, got["epoch"]))
