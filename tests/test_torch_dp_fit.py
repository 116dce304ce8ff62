"""``fit`` on spawned gloo ranks on the CPU: ``TrainConfig(devices=2)``
(data parallelism), ``graph_devices=2`` (graph parallelism) and 2 x 2
(both), as ``tests/test_parallel.py::test_fit_on_mesh`` runs the JAX
``fit`` on a device mesh.

Each case is one ``spawn_ranks(run_dp_tasks, ...)`` with one thread a rank:
a 32-wide 2-scale MuS model (``tests/test_models.py``), 8 samples of
80-82 nodes, batches of 4, 2 epochs with the curriculum ``[1, 2]`` (its
tolerance passes, so epoch 2 runs 2 rollout steps on a new Adam state),
the clip, the plateau schedule and a validation loader; then a model
built from another seed resumes from the checkpoint for epoch 3.  Checked:

* every rank's history is the same on every loss field, to the bit, and
  so is every rank's resumed run (whose first epoch is 3);
* after the first ``fit`` the folder holds one checkpoint and, in the
  ``dp`` case (the only one that logs: ``torch.utils.tensorboard`` takes
  seconds to import), the metrics of one writer (rank 0's: one line a
  scalar an epoch);
* the ``dp`` case's epoch losses against the JAX ``fit(devices=2)`` on
  the same data: epoch 1 (two Adam steps) at rtol 1e-4; epoch 2's
  training loss at ``FIT_TOL`` = 1e-3 (``tests/test_torch_runtime.py``'s
  tolerance for ``fit``) and its validation loss (a 2-step rollout) at
  twice that.  f32 training drifts by a fraction of an Adam step between
  two summation orders: on this data the JAX package's own
  ``fit(devices=2)`` ends epoch 2 1.3e-4 (training) and 1.0e-3
  (validation) away from its ``fit(devices=1)``, where the port's DP run
  lies 1.5e-5 and 2.2e-4 from that one-device run;
* before the first case's fit, ``fit`` with ``devices=4`` on the 2 ranks
  raises on every rank; and on one device, ``graph_devices > 1`` for a
  model of no family of the port's raises before anything is written.

The 2 x 2 ranks join their group through ``initialize_distributed`` and
the JAX package's ``GRAPHS4CFD_*`` variables, as the distributed example
script does under a launcher; with none of its variables set it joins
nothing and returns 1, and with some of them it raises.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.loader import DataLoader as JaxDataLoader
from graphs4cfd_tpu.nn.losses import GraphLoss as JaxGraphLoss
from graphs4cfd_tpu.training import trainer as jax_trainer
from graphs4cfd_tpu.training.config import TrainConfig as JaxTrainConfig
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.nn import (GraphLoss, NsRotEquiThreeScaleGNN,
                                     init_params_numpy)
from graphs4cfd_tpu_torch.parallel import initialize_distributed, spawn_ranks
from graphs4cfd_tpu_torch.parallel.run import run_dp_tasks
from graphs4cfd_tpu_torch.training import TrainConfig
from test_models import make_cloud, mus_arch
from test_torch_remus import small_remus_arch

SPAWN_LIMIT = 300
FIT_TOL = 1e-3
LOSS_FIELDS = ("epoch", "n_out", "lr", "train_loss", "grad_norm",
               "val_loss", "steps")
MESHES = {"dp": (2, 1), "gp": (1, 2), "dpgp": (2, 2)}
LOADER = dict(batch_size=4, shuffle=True, seed=0, node_bucket=16,
              edge_bucket=64)


def _samples(n=8):
    """``test_fit_on_mesh``'s dataset, through the port's transforms."""
    out = []
    for i in range(n):
        g = Graph(dict(make_cloud(np.random.default_rng(100 + i),
                                  80 + (i % 3)).data))
        for t in (T.ConnectKNN(k=4), T.ScaleEdgeAttr(0.02),
                  T.GridClustering([0.3])):
            g = t(g)
        out.append(g)
    return out


def _config(**kw):
    out = dict(name="mesh_fit", chk_interval=1,
               training_loss=GraphLoss(lambda_d=0.25),
               validation_loss=GraphLoss(), epochs=2, num_steps=[1, 2],
               add_steps={"tolerance": 1e9, "loss": "training"}, lr=1e-3,
               grad_clip={"epoch": 0, "limit": 1},
               scheduler={"factor": 0.5, "patience": 5, "loss": "training"},
               stopping=1e-9, batch_size=4)
    out.update(kw)
    return out


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_fit(request, tmp_path_factory):
    dp, gpd = MESHES[request.param]
    folder = tmp_path_factory.mktemp(request.param)
    samples = [s.data for s in _samples()]
    logs = str(folder) if request.param == "dp" else None
    kw = dict(samples=samples, val=samples[:4], loader=LOADER,
              config=_config(devices=dp, graph_devices=gpd,
                             tensor_board=logs),
              folder=str(folder), resume_epochs=3, resume_seed=2)
    if request.param == "dp":
        kw["refuse"] = {"devices": 4}
    arch = mus_arch(5, 1)
    # the 2 x 2 ranks join their group as under a launcher
    ranks = spawn_ranks(run_dp_tasks, dp * gpd, "gloo", dict(
        family="mus", arch=arch, params=init_params_numpy(arch, seed=9),
        device="cpu", devices=dp, graph_devices=gpd, graphs={},
        tasks=[("fit", None, kw)]), timeout=SPAWN_LIMIT, num_threads=1,
        by_env=request.param == "dpgp")
    return dict(name=request.param, folder=folder,
                ranks=[r[0] for r in ranks])


def _fields(history):
    return [{k: r[k] for k in LOSS_FIELDS} for r in history]


def test_fit_on_ranks_keeps_every_rank_in_lockstep(mesh_fit):
    ranks = mesh_fit["ranks"]
    first = ranks[0]
    assert [r["epoch"] for r in first["history"]] == [1, 2]
    assert [r["n_out"] for r in first["history"]] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in first["history"])
    assert [r["epoch"] for r in first["resumed"]] == [3]
    for r in ranks[1:]:
        assert _fields(r["history"]) == _fields(first["history"])
        assert _fields(r["resumed"]) == _fields(first["resumed"])
        for name, value in first["params"].items():
            np.testing.assert_array_equal(r["params"][name], value)


def test_fit_on_ranks_writes_one_checkpoint_and_one_log(mesh_fit):
    logs = ["mesh_fit"] if mesh_fit["name"] == "dp" else []
    for r in mesh_fit["ranks"]:
        assert r["files"] == logs + ["mesh_fit.chk"]
    # the resume renamed it and wrote its own
    assert (mesh_fit["folder"] / "mesh_fit.chk.bck").exists()
    if not logs:
        return
    with open(mesh_fit["folder"] / "mesh_fit" / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    # 4 scalars an epoch, epochs 1-2 and the resumed 3: one writer
    assert sorted((x["step"], x["tag"]) for x in lines) == sorted(
        (e, t) for e in (1, 2, 3)
        for t in ("Loss/train", "Loss/test", "lr", "edges_per_s"))


class _Scalars:
    """The JAX ``fit``'s metric writer, in memory (the JAX package's
    writer imports tensorboard, which takes seconds)."""
    last = None

    def __init__(self, log_dir):
        self.values = {}
        _Scalars.last = self

    def add_scalar(self, tag, value, step):
        self.values.setdefault(tag, {})[step] = value

    def close(self):
        pass


@pytest.mark.parametrize("mesh_fit", ["dp"], indirect=True)
def test_fit_matches_the_jax_fit_on_a_mesh(mesh_fit, tmp_path, monkeypatch):
    monkeypatch.setattr(jax_trainer, "MetricsWriter", _Scalars)
    arch = mus_arch(5, 1)
    model = g4c.nn.MuSGNN(arch=arch)
    model.params = jax.tree_util.tree_map(
        jnp.asarray, init_params_numpy(arch, seed=9))
    jax_samples = [JaxGraph(data=dict(s.data)) for s in _samples()]
    cfg = JaxTrainConfig(folder=str(tmp_path), **{
        **_config(devices=2, graph_devices=1),
        "training_loss": JaxGraphLoss(lambda_d=0.25),
        "validation_loss": JaxGraphLoss()})
    val = {k: v for k, v in LOADER.items() if k not in ("shuffle", "seed")}
    jax_trainer.fit(model, cfg, JaxDataLoader(jax_samples, **LOADER),
                    JaxDataLoader(jax_samples[:4], **val))
    want = _Scalars.last.values
    got = mesh_fit["ranks"][0]["history"]
    assert sorted(want["Loss/train"]) == [r["epoch"] for r in got] == [1, 2]
    for rec in got:
        first = rec["epoch"] == 1
        for mine, theirs, tol in (("train_loss", "Loss/train", FIT_TOL),
                                  ("val_loss", "Loss/test", 2 * FIT_TOL)):
            np.testing.assert_allclose(rec[mine],
                                       want[theirs][rec["epoch"]],
                                       rtol=1e-4 if first else tol,
                                       err_msg=(mine, rec["epoch"]))
        assert rec["lr"] == want["lr"][rec["epoch"]]


@pytest.mark.parametrize("mesh_fit", ["dp"], indirect=True)
def test_a_mismatched_mesh_raises_on_every_rank(mesh_fit):
    for r in mesh_fit["ranks"]:
        assert r["refused"].startswith(
            "RuntimeError: TrainConfig(devices=4, graph_devices=1) trains "
            "on 4 ranks"), r["refused"]
        assert "the default process group has 2" in r["refused"]


def test_graph_parallel_fit_refuses_another_family(tmp_path):
    """Graph parallelism runs the three families of the port; ``fit`` with
    ``graph_devices > 1`` refuses a model of no family of theirs before
    it writes anything (a REMuS model gets as far as the process group)."""
    from graphs4cfd_tpu_torch.nn.model import GNN

    class Other(GNN):
        def build_plan(self, arch):
            return []

    cfg = TrainConfig("gp", folder=str(tmp_path), graph_devices=2,
                      training_loss=GraphLoss())
    with pytest.raises(TypeError, match="MuSGNN, MuGSGNN and REMuSGNN"):
        Other(arch={"decoder": (4, (4, 1), False)},
              device="cpu").fit(cfg, [])
    with pytest.raises(RuntimeError, match="default process group"):
        NsRotEquiThreeScaleGNN(arch=small_remus_arch(w=16),
                               device="cpu").fit(cfg, [])
    assert os.listdir(tmp_path) == []


LAUNCH_VARS = ("GRAPHS4CFD_COORDINATOR", "GRAPHS4CFD_NUM_PROCESSES",
               "GRAPHS4CFD_PROCESS_ID", "MASTER_ADDR", "MASTER_PORT",
               "WORLD_SIZE", "RANK")


def test_initialize_distributed_off_a_cluster_joins_nothing(monkeypatch):
    for var in LAUNCH_VARS:
        monkeypatch.delenv(var, raising=False)
    assert initialize_distributed() == 1
    monkeypatch.setenv("GRAPHS4CFD_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed()
