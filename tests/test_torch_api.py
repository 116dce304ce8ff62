"""The rest of the port's user API against the JAX package, on the CPU.

* ``import graphs4cfd_tpu_torch as gfd`` imports no submodule; ``gfd.nn``,
  ``gfd.transforms``, ``gfd.datasets`` ... and ``gfd.DataLoader`` resolve
  on first access, as the JAX package's lazy ``__getattr__`` gives them;
* ``"key" in graph`` and ``Graph.to_device``;
* ``GNN.load_model``, ``load_arch`` and ``shift_and_replace``;
* ``convert_reference_checkpoint`` and ``import_torch_state_dict`` on a
  module built as the original graphs4cfd builds its models
  (``tests/oracle_torch.py``): the port's model from its converted
  ``.chk`` within 2e-4 of the JAX model from the JAX-converted one.
"""
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphs4cfd_tpu as jgfd
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.training.checkpoint import (
    convert_reference_checkpoint as jax_convert,
    import_torch_state_dict as jax_import_state_dict,
    load_checkpoint as jax_load_checkpoint)
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import collate
from graphs4cfd_tpu_torch.nn import MuSGNN, NsThreeScaleGNN
from graphs4cfd_tpu_torch.nn.model import (init_params_numpy,
                                           params_to_numpy, tree_leaves)
from graphs4cfd_tpu_torch.training import (convert_reference_checkpoint,
                                           import_torch_state_dict,
                                           load_checkpoint, save_checkpoint)
from test_convert_checkpoint import RefOneScale

ROOT = Path(__file__).resolve().parent.parent
TOL = dict(rtol=2e-4, atol=2e-4)
W = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_bare_import_loads_no_submodule_and_names_resolve():
    code = ("import sys, graphs4cfd_tpu_torch as gfd; "
            "print(sorted(m for m in sys.modules "
            "if m.startswith('graphs4cfd_tpu_torch.')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
    import graphs4cfd_tpu_torch as gfd
    from graphs4cfd_tpu_torch import datasets, loader, nn, training
    assert gfd.nn.TrainConfig is training.TrainConfig
    assert gfd.nn.TrainConfig is nn.TrainConfig
    assert gfd.transforms.ScaleNs is T.ScaleNs
    assert gfd.datasets.NsCircle is datasets.NsCircle
    assert gfd.DataLoader is loader.DataLoader
    assert gfd.Graph is Graph
    for name in ("metrics", "training", "parallel", "utils", "loader"):
        assert getattr(gfd, name).__name__ == f"graphs4cfd_tpu_torch.{name}"
    assert gfd.plot.__name__ == "graphs4cfd_tpu_torch.plot"
    # every name the JAX package's transforms export
    assert set(T.__all__) == set(jgfd.transforms.__all__)


def test_contains_and_to_device(rng):
    g = Graph({"pos": rng.random((30, 2)).astype(np.float32),
               "field": None, "fixed_k": 6})
    jg = JaxGraph(data=dict(g.data))
    for key in ("pos", "field", "fixed_k", "target"):
        assert (key in g) == (key in jg)
    assert "field" in g and not g.has("field")
    t = g.to_device("cpu")
    assert isinstance(t.pos, torch.Tensor) and t.pos.device.type == "cpu"
    assert t.fixed_k == 6 and t.pos.numpy().tobytes() == g.pos.tobytes()


def arch_of(w=W, nf=3, node_in=5):
    mp = ((w + 2 * w, (w, w), True), (w + w, (w, w), True))
    return {"edge_encoder": (2, (w, w), False),
            "node_encoder": (node_in, (w, w), False),
            "mp111": mp, "down_mp12": (2 + w, (w, w), True), "mp21": mp,
            "up_mp21": (2 + w + w, (w, w), True), "mp121": mp,
            "decoder": (w, (w, nf), False)}


def _same_tree(port_tree, jax_tree):
    a, b = tree_leaves(port_tree), jax.tree_util.tree_leaves(jax_tree)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert x.shape == y.shape and x.tobytes() == y.tobytes()


def test_load_model_matches_jax(tmp_path):
    src = MuSGNN(arch=arch_of(nf=2, node_in=4), seed=7, device="cpu")
    path = str(tmp_path / "m.chk")
    src.save_checkpoint(path, n_out=1, epoch=1)
    wpath = str(tmp_path / "w.pkl")
    with open(wpath, "wb") as f:
        pickle.dump(params_to_numpy(src), f)

    model = MuSGNN(arch=arch_of(), seed=0, device="cpu",
                   compute_dtype=torch.bfloat16)
    ref = jgfd.nn.MuSGNN(arch=arch_of())
    assert model.load_model(checkpoint=path) is model
    ref.load_model(checkpoint=path)
    assert model.arch == ref.arch and model.num_fields == ref.num_fields == 2
    _same_tree(params_to_numpy(model), ref.params)
    assert model.compute_dtype == torch.bfloat16
    assert all(p.device.type == "cpu" for p in model.parameters())
    assert len(model.plan) == len(ref.plan)

    model.load_model(arch=arch_of(nf=2, node_in=4), weights=wpath)
    ref.load_model(arch=arch_of(nf=2, node_in=4), weights=wpath)
    _same_tree(params_to_numpy(model), ref.params)
    assert model.load_model() is model          # nothing given: unchanged
    _same_tree(params_to_numpy(model), ref.params)


def test_load_arch_matches_jax():
    model = MuSGNN(arch=arch_of(), seed=0, device="cpu")
    ref = jgfd.nn.MuSGNN(arch=arch_of())
    model.load_arch(arch_of(w=8, nf=1, node_in=3), seed=2)
    ref.load_arch(arch_of(w=8, nf=1, node_in=3), seed=2)
    assert model.arch == ref.arch and model.num_fields == ref.num_fields == 1
    assert model.plan == ref.plan
    # the same shapes; the port draws its weights with numpy
    got = tree_leaves(params_to_numpy(model))
    want = jax.tree_util.tree_leaves(ref.params)
    assert [x.shape for x in got] == [tuple(np.shape(y)) for y in want]
    for x, y in zip(got, tree_leaves(init_params_numpy(arch_of(w=8, nf=1,
                                                               node_in=3),
                                                       seed=2))):
        assert x.tobytes() == y.tobytes()


def test_shift_and_replace_matches_jax(rng):
    model = MuSGNN(arch=arch_of(), device="cpu")
    ref = jgfd.nn.MuSGNN(arch=arch_of())
    x = rng.normal(size=(20, 9)).astype(np.float32)
    y = rng.normal(size=(20, 3)).astype(np.float32)
    got = model.shift_and_replace(torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(ref.shift_and_replace(jnp.asarray(x), jnp.asarray(y)))
    assert got.numpy().tobytes() == want.tobytes()


def _one_scale_arch():
    return {"edge_encoder": (2, (W, W), False),
            "node_encoder": (5, (W, W), False),
            "mp111": ((W + 2 * W, (W, W), True), (W + W, (W, W), True)),
            "decoder": (W, (W, 1), False)}


def test_convert_reference_checkpoint_matches_jax(tmp_path):
    torch.manual_seed(0)
    ref_module = RefOneScale(_one_scale_arch())
    src = str(tmp_path / "ref.chk")
    torch.save({"arch": _one_scale_arch(),
                "weights": ref_module.state_dict(), "optimiser": None,
                "n_out": 3, "lr": 5e-5, "epoch": 17}, src)
    dst, jdst = str(tmp_path / "port.chk"), str(tmp_path / "jax.chk")
    out = convert_reference_checkpoint(src, dst)
    jax_convert(src, jdst)
    assert out["arch"] == _one_scale_arch()
    port_state, jax_state = load_checkpoint(dst), jax_load_checkpoint(jdst)
    for key in ("arch", "n_out", "lr", "epoch", "optimiser"):
        assert port_state[key] == jax_state[key], key
    _same_tree(port_state["weights"], jax_state["weights"])
    _same_tree(import_torch_state_dict(ref_module.state_dict()),
               jax_import_state_dict(ref_module.state_dict()))
    # each package reads the other's file
    _same_tree(jax_load_checkpoint(dst)["weights"], jax_state["weights"])

    rng = np.random.default_rng(3)
    g = Graph()
    g.pos = rng.random((60, 2)).astype(np.float32)
    g.loc = rng.normal(size=(60, 2)).astype(np.float32)
    g.field = rng.normal(size=(60, 2)).astype(np.float32)
    g.omega = (rng.random((60, 1)) < 0.2).astype(np.float32)
    g.bound = np.zeros(60, np.uint8)
    g = T.ScaleEdgeAttr(0.05)(T.ConnectKNN(k=4)(g))
    batch = collate([g], node_bucket=1, edge_bucket=1)
    model = MuSGNN(checkpoint=dst, device="cpu")
    jmodel = jgfd.nn.MuSGNN(checkpoint=jdst)
    want = np.asarray(jmodel.forward(JaxGraph(data=dict(batch.data))
                                     .to_device()))
    with torch.no_grad():
        got = model(batch.to_device("cpu")).numpy()
    assert got.shape == want.shape == (60, 1)
    np.testing.assert_allclose(got, want, **TOL)
