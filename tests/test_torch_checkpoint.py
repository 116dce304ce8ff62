"""The port's checkpoints, pretrained tables and long rollout against the
JAX package, on the CPU.

* every ``tests/fixtures/*_model.chk`` (10) and every bundled checkpoint
  (9) reads with the port's unpickler; each fixture's Adam state
  (``optax.ScaleByAdamState``, read through the local stub) has exactly
  the leaves the JAX package reads, and goes through the port's
  ``AdamState`` and back unchanged;
* ``GNN(model=name)`` for every bundled name: one forward step on a small
  graph against the JAX package's model of the same name at 2e-4;
* a checkpoint the port writes loads in the JAX package: the forward of
  ``GNN(checkpoint=)`` at 2e-4, and its optimiser leaves, in
  ``jax.tree_util.tree_leaves`` order, against the JAX Adam state after
  the same two Adam steps (each moment within 1e-3 of its tensor's max
  abs: the two packages' f32 gradients agree at 2e-4 of it, and ``nu``
  squares them);
* the pretrained tables of all 12 class names with the JAX package's
  names and paths, and its errors;
* the 100-step rollouts of the 1-scale advection and 2-scale wave
  fixtures meet their pins (``tests/test_rollout_regression.py``), data
  from ``tools/train_synthetic_adv.py``.
"""
import glob
import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.loader import collate as jax_collate
from graphs4cfd_tpu.nn.losses import GraphLoss as JaxGraphLoss
from graphs4cfd_tpu.nn.model import GNN as JaxGNN
from graphs4cfd_tpu.nn.model import bundled_checkpoint_path as jax_bundled
from graphs4cfd_tpu.training import trainer as jax_trainer
from graphs4cfd_tpu_torch import nn as port_nn
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import collate
from graphs4cfd_tpu_torch.metrics import r2, rollout_rmse
from graphs4cfd_tpu_torch.nn import (GNN, GraphLoss, MuGSGNN, MuSGNN,
                                     NsThreeScaleGNN, REMuSGNN,
                                     bundled_checkpoint_path,
                                     init_params_numpy, params_to_numpy)
from graphs4cfd_tpu_torch.nn.model import tree_leaves
from graphs4cfd_tpu_torch.training import (adam_init,
                                           adam_state_from_checkpoint,
                                           load_checkpoint, load_weights,
                                           make_train_step)
from graphs4cfd_tpu_torch.training.checkpoint import (ScaleByAdamState,
                                                      adam_state_to_numpy)
from graphs4cfd_tpu_torch.utils import Compose
from test_torch_host import port_samples
from test_torch_mugs import mugs_batch
from test_torch_mus import _jax_model, small_arch
from test_torch_remus import port_remus_samples

TOL = dict(rtol=2e-4, atol=2e-4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXDIR = os.path.join(ROOT, "tests", "fixtures")
FIXTURES = sorted(glob.glob(os.path.join(FIXDIR, "*_model.chk")))
CLASS_NAMES = ("NsOneScaleGNN", "NsTwoScaleGNN", "NsThreeScaleGNN",
               "NsFourScaleGNN", "AdvOneScaleGNN", "AdvTwoScaleGNN",
               "AdvThreeScaleGNN", "AdvFourScaleGNN",
               "NsTwoGuillardScaleGNN", "NsThreeGuillardScaleGNN",
               "NsFourGuillardScaleGNN", "NsRotEquiThreeScaleGNN")
REGISTRY = [(cls, name, rel) for cls in CLASS_NAMES
            for name, rel in getattr(g4c.nn, cls).PRETRAINED.items()]
BUNDLED = [e for e in REGISTRY if os.path.exists(jax_bundled(e[2]))]



@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's CPU forward and training loops run hundreds of small ops
    a step, each across torch's thread pool; with the test workers' pools
    oversubscribing the cores, every op waits on threads that are not
    running (a 100-step rollout took 850 s beside five other workers
    against 5 s alone).  One thread each keeps these tests at their
    single-process time; what they check does not change."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

def _family(arch):
    """The port's family class of an arch dict."""
    if any(k.startswith("angle_encoder") for k in arch):
        return REMuSGNN
    if "edge_encoder2" in arch:
        return MuGSGNN
    return MuSGNN


def _jax_load(path):
    """The JAX package's own reader (``pickle.load``; optax importable)."""
    with open(path, "rb") as f:
        return pickle.load(f)


# ---------------------------------------------------------------- reading
def test_every_checkpoint_is_found():
    assert len(FIXTURES) == 10 and len(BUNDLED) == 9


@pytest.mark.parametrize("path", FIXTURES,
                         ids=[os.path.basename(p) for p in FIXTURES])
def test_fixture_adam_state_reads_as_the_jax_package_reads_it(path):
    state = load_checkpoint(path)
    ref = _jax_load(path)
    assert isinstance(state["optimiser"], ScaleByAdamState)
    assert type(ref["optimiser"]).__name__ == "ScaleByAdamState"
    got_leaves = tree_leaves(tuple(state["optimiser"]))
    ref_leaves = jax.tree_util.tree_leaves(ref["optimiser"])
    assert len(got_leaves) == len(ref_leaves)
    for a, b in zip(got_leaves, ref_leaves):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    for key in ("n_out", "lr", "epoch", "scheduler"):
        assert state.get(key) == ref.get(key), key
    # through the port's AdamState and back, bit for bit
    model = _family(state["arch"])(checkpoint=path, device="cpu")
    adam = adam_state_from_checkpoint(model, state)
    assert adam.count == int(ref["optimiser"].count)
    back = tree_leaves(adam_state_to_numpy(model, adam))
    for a, b in zip(back, ref_leaves):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_unpickler_refuses_other_globals(tmp_path):
    path = str(tmp_path / "bad.chk")
    with open(path, "wb") as f:
        pickle.dump({"weights": {}, "when": np.datetime64("2020-01-01"),
                     "fn": os.getcwd}, f)
    with pytest.raises(pickle.UnpicklingError, match="posix.getcwd|only"):
        load_checkpoint(path)


def _bundle_batch(arch):
    """A small collated batch the bundle's arch takes."""
    cls = _family(arch)
    if cls is REMuSGNN:
        return collate(port_remus_samples(), node_bucket=64,
                       edge_bucket=128)
    if cls is MuGSGNN:
        return mugs_batch(levels=3 if "edge_encoder3" in arch else 2)
    downs = sum(k.startswith("down_mp") for k in arch)
    nf = arch["node_encoder"][0] - 2          # field + glob + omega
    pipeline = [T.SpatialSort(), T.ConnectKNN(k=6), T.ScaleEdgeAttr(0.15)]
    if downs:
        pipeline.append(T.GridClustering([0.15, 0.30][:downs]))
    rng = np.random.default_rng(5)
    samples = []
    for _ in range(2):
        g = Graph()
        g.pos = (rng.random((300, 2)) * np.array([4.0, 2.0])).astype(
            np.float32)
        g.glob = np.full((300, 1), 0.5, np.float32)
        g.field = rng.normal(size=(300, nf)).astype(np.float32)
        g.omega = (rng.random((300, 1)) < 0.1).astype(np.float32)
        samples.append(Compose(pipeline)(g))
    return collate(samples, node_bucket=64, edge_bucket=128)


@pytest.mark.parametrize("cls,name,rel", BUNDLED,
                         ids=[n for _, n, _ in BUNDLED])
def test_bundled_model_forward_matches_jax(cls, name, rel):
    model = getattr(port_nn, cls)(model=name, device="cpu")
    ref_model = getattr(g4c.nn, cls)(model=name)
    assert load_checkpoint(bundled_checkpoint_path(rel))["optimiser"] is None
    batch = _bundle_batch(model.arch)
    ref = np.asarray(jax.jit(ref_model.apply)(
        ref_model.params, JaxGraph(data=dict(batch.data)).to_device()))
    with torch.no_grad():
        got = model(Graph.from_numpy(batch, "cpu")).numpy()
    mask = batch.node_mask
    assert got.shape == ref.shape
    np.testing.assert_allclose(got[mask], ref[mask], **TOL)


# ---------------------------------------------------------------- writing
@pytest.fixture(scope="module")
def saved_case(tmp_path_factory):
    """A 32-wide 3-scale model after one ``train_step(n_out=2)`` (two Adam
    steps) in each package, from the same weights, and the port's
    checkpoint of it."""
    arch = small_arch()
    tree = init_params_numpy(arch, seed=3)
    samples = port_samples(2, 400, seed=5)
    batch = collate(samples, node_bucket=64, edge_bucket=128)
    jgraph = jax_collate(samples, node_bucket=64, edge_bucket=128).to_device()
    jmodel = _jax_model(arch, tree)
    jstep = jax_trainer.make_train_step(jmodel.apply, JaxGraphLoss(0.25), 3,
                                        2, 1.0)
    s0 = jax_trainer._adam_opt().init(jmodel.params)
    _, s1, _, _ = jstep(jmodel.params, s0, jgraph, 1e-4, True)
    model = NsThreeScaleGNN(arch=arch, seed=3, device="cpu")
    state = adam_init(model.parameters())
    make_train_step(model, GraphLoss(0.25), 3, 2, 1.0)(
        state, Graph.from_numpy(batch, "cpu"), 1e-4, True)
    path = str(tmp_path_factory.mktemp("chk") / "port.chk")
    model.save_checkpoint(path, n_out=2, epoch=7, opt_state=state, lr=1e-4,
                          scheduler_state={"lr": 1e-4, "best": 0.5})
    return dict(model=model, batch=batch, jax_state=s1, path=path,
                adam=state)


def test_port_checkpoint_loads_in_the_jax_package(saved_case):
    path, batch, model = (saved_case["path"], saved_case["batch"],
                          saved_case["model"])
    ref = _jax_load(path)
    assert ref["n_out"] == 2 and ref["epoch"] == 7 and ref["lr"] == 1e-4
    assert ref["scheduler"] == {"lr": 1e-4, "best": 0.5}
    assert not os.path.exists(path + ".tmp")
    jmodel = g4c.nn.NsThreeScaleGNN(checkpoint=path)
    jgraph = JaxGraph(data=dict(batch.data)).to_device()
    want = np.asarray(jax.jit(jmodel.apply)(jmodel.params, jgraph))
    with torch.no_grad():
        got = model(Graph.from_numpy(batch, "cpu")).numpy()
    mask = batch.node_mask
    np.testing.assert_allclose(got[mask], want[mask], **TOL)
    # the parameters themselves, bit for bit
    for a, b in zip(jax.tree_util.tree_leaves(ref["weights"]),
                    tree_leaves(params_to_numpy(model))):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_port_optimiser_leaves_match_jax_adam_state(saved_case):
    got = jax.tree_util.tree_leaves(_jax_load(saved_case["path"])
                                    ["optimiser"])
    want = jax.tree_util.tree_leaves(saved_case["jax_state"])
    assert len(got) == len(want)
    assert got[0].dtype == np.int32 and int(got[0]) == int(want[0]) == 2
    for a, b in zip(got[1:], want[1:]):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3 * scale)
    # and the JAX structure takes them, as its fit's resume does
    s0 = jax_trainer._adam_opt().init(g4c.nn.NsThreeScaleGNN(
        arch=small_arch()).params)
    jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(s0),
                                 [jnp.asarray(x) for x in got])


def test_port_checkpoint_reads_back_in_the_port(saved_case):
    path, model, adam = (saved_case["path"], saved_case["model"],
                         saved_case["adam"])
    again = NsThreeScaleGNN(checkpoint=path, device="cpu")
    for a, b in zip(again.parameters(), model.parameters()):
        assert torch.equal(a, b)
    back = adam_state_from_checkpoint(again, load_checkpoint(path))
    assert back.count == adam.count == 2
    for a, b in zip(back.mu + back.nu, adam.mu + adam.nu):
        assert torch.equal(a, b)


@pytest.mark.parametrize("wrapped", [False, True])
def test_arch_with_a_weights_file(saved_case, tmp_path, wrapped):
    """``GNN(arch, weights=)``: a bare parameter tree or a checkpoint dict
    with ``"weights"`` (``load_weights``)."""
    model = saved_case["model"]
    tree = params_to_numpy(model)
    path = str(tmp_path / "w.pkl")
    with open(path, "wb") as f:
        pickle.dump({"weights": tree} if wrapped else tree, f)
    assert tree_leaves(load_weights(path))[0].tobytes() == \
        tree_leaves(tree)[0].tobytes()
    got = NsThreeScaleGNN(small_arch(), weights=path, device="cpu")
    for a, b in zip(got.parameters(), model.parameters()):
        assert torch.equal(a, b)


# --------------------------------------------------------------- registry
def test_registry_covers_the_jax_package_letter_for_letter():
    for cls in CLASS_NAMES:
        assert getattr(port_nn, cls).PRETRAINED == \
            getattr(g4c.nn, cls).PRETRAINED, cls
    assert port_nn.NsRotEquiTreeScaleGNN is port_nn.NsRotEquiThreeScaleGNN
    assert GNN.PRETRAINED == JaxGNN.PRETRAINED == {}
    for _, _, rel in REGISTRY:
        assert bundled_checkpoint_path(rel) == os.path.abspath(
            jax_bundled(rel))


def test_registry_errors_are_the_jax_package_s():
    with pytest.raises(ValueError, match="not recognized") as port_err:
        port_nn.NsThreeScaleGNN(model="no-such-version", device="cpu")
    with pytest.raises(ValueError, match="not recognized") as jax_err:
        g4c.nn.NsThreeScaleGNN(model="no-such-version")
    assert str(port_err.value) == str(jax_err.value)
    missing = [e for e in REGISTRY if e not in BUNDLED]
    assert len(missing) == 12
    for cls, name, _ in missing:
        with pytest.raises(FileNotFoundError, match="not bundled"):
            getattr(port_nn, cls)(model=name, device="cpu")
        with pytest.raises(FileNotFoundError, match="not bundled"):
            getattr(g4c.nn, cls)(model=name)


def test_constructor_refuses_ambiguous_sources(saved_case):
    with pytest.raises(ValueError):
        NsThreeScaleGNN(weights=saved_case["path"], device="cpu")
    with pytest.raises(ValueError):
        NsThreeScaleGNN(model="3S-GNN-TaylorGreen-TPU-v1",
                        checkpoint=saved_case["path"], device="cpu")


# ------------------------------------------------- the 100-step rollouts
# the 1-scale advection and the 2-scale wave fixtures (the JAX package's
# regression test holds all four MuS fixtures)
ADV_FIXTURES = ["synthadv", "synthwave_2s"]


@pytest.mark.parametrize("base", ADV_FIXTURES)
def test_100_step_rollout_meets_its_pins(base):
    """As ``tests/test_rollout_regression.py`` holds the JAX package: the
    pins' data (``SyntheticAdv``/``SyntheticWave``, seed 99) through the
    port's transforms, ``collate`` and ``solve(n_out=100)`` from the
    fixture, on the CPU."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from train_synthetic_adv import SyntheticAdv, SyntheticWave
    pins = json.load(open(os.path.join(FIXDIR, f"{base}_pins.json")))
    cells = pins.get("cells") or ([0.1] if pins.get("two_scale") else [])
    keep = lambda g: g                    # the raw fields; ours transform
    if pins.get("problem", "adv") == "wave":
        ds = SyntheticWave(4, pins["n_nodes"], 4, keep, seed=99,
                           dt=pins["dt"], wave_c=pins.get("wave_c", 2.4))
    else:
        ds = SyntheticAdv(4, pins["n_nodes"], 4, keep, seed=99,
                          dt=pins["dt"], vel_max=pins.get("vel_max", 0.3))
    tr = Compose([T.ConnectKNN(6, period=(1.0, 1.0)), T.ScaleEdgeAttr(0.04)]
                 + ([T.GridClustering(list(cells))] if cells else []))
    g = tr(Graph(dict(ds.graph_at(0, 0, 100).data)))
    batch = collate([g], node_bucket=64, edge_bucket=128)
    model = getattr(port_nn, pins["model_cls"])(
        checkpoint=os.path.join(FIXDIR, f"{base}_model.chk"), device="cpu")
    pred = model.solve(Graph.from_numpy(batch, "cpu"), 100).numpy()
    target, mask = batch.target, batch.node_mask
    nf = model.num_fields
    r2_50 = r2(pred[mask, 49 * nf:50 * nf], target[mask, 49 * nf:50 * nf])
    r2_100 = r2(pred[mask, 99 * nf:], target[mask, 99 * nf:])
    rmse = rollout_rmse(pred, target, node_mask=mask)
    assert r2_50 >= pins["r2_step50_min"], (r2_50, pins)
    assert rmse <= pins["rollout_rmse_max"], (rmse, pins)
    assert r2_100 >= pins["r2_step100_min"], (r2_100, pins)
