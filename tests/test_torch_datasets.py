"""The port's HDF5 datasets and the training scripts' pipelines against the
JAX package, on synthetic files in the three layouts that the test writes
(as ``tests/test_datasets_e2e.py`` writes them).

* ``get_sequence`` and seeded ``__getitem__`` graphs of ``NsCircle``,
  ``Adv`` and ``NsEllipse``, read from the file, preloaded or one
  simulation (``idx``), are byte-equal to the JAX package's;
* the collated batches of the transform chains of
  ``examples/training/NsMuSGNN/NsThreeScaleGNN.py:32-43``,
  ``NsMuGSGNN/NsThreeGuillardScaleGNN.py:33-44`` and
  ``NsREMuSGNN/NsRotEquiThreeScaleGNN.py:32-41`` (every random transform
  seeded) through both packages' ``random_split`` and
  ``DataLoader(shuffle=True, num_workers=0, seed=...)`` are byte-equal;
* a two-epoch ``fit`` of a 24-wide ``NsThreeScaleGNN`` from the
  ``NsCircle`` file on the CPU writes a ``.chk`` that the JAX package
  loads with the port's weights.
"""
import os

import numpy as np
import pytest
import torch

import graphs4cfd_tpu as jgfd
import graphs4cfd_tpu_torch as gfd
from graphs4cfd_tpu.training.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from graphs4cfd_tpu.utils import Compose as JaxCompose
from graphs4cfd_tpu.utils import random_split as jax_random_split
from graphs4cfd_tpu_torch.nn.model import params_to_numpy
from graphs4cfd_tpu_torch.utils import Compose, random_split

h5py = pytest.importorskip("h5py")

W = 24
SCALE_UVP = {"u": (-2.1, 2.6), "v": (-2.25, 2.1), "p": (-3.7, 2.35),
             "Re": (500, 1000)}
SCALE_UV = {"u": (-1.8, 1.8), "v": (-1.8, 1.8), "Re": (500, 1000)}


@pytest.fixture
def one_thread():
    """One torch thread while the test runs a model (the suite's workers
    share the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _store(n_sims, n, cols, make, pad=5):
    data = np.full((n_sims, n + pad, cols), np.nan, np.float32)
    for i in range(n_sims):
        data[i, :n] = make(np.random.default_rng(100 + i))
    return data


def ns_store(n_sims, n, T, per_frame):
    def make(r):
        pos = (r.random((n, 2)) * np.array([1.6, 0.8])).astype(np.float32)
        re = np.full((n, 1), r.uniform(500, 1000), np.float32)
        bound = r.integers(0, 5, size=(n, 1)).astype(np.float32)
        frames = r.normal(size=(n, T * per_frame)).astype(np.float32)
        return np.concatenate([pos, re, bound, frames], axis=1)
    return _store(n_sims, n, 4 + T * per_frame, make)


def adv_store(n_sims, n, T):
    def make(r):
        pos = r.random((n, 2)).astype(np.float32)
        loc = r.normal(size=(n, 2)).astype(np.float32)
        bound = r.integers(0, 4, size=(n, 1)).astype(np.float32)
        frames = r.normal(size=(n, T)).astype(np.float32)
        return np.concatenate([pos, loc, bound, frames], axis=1)
    return _store(n_sims, n, 5 + T, make)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("h5")
    out = {}
    for name, data in (("NsCircle", ns_store(6, 600, 12, 3)),
                       ("NsEllipse", ns_store(4, 600, 12, 6)),
                       ("Adv", adv_store(3, 200, 10))):
        out[name] = str(root / f"{name}.h5")
        with h5py.File(out[name], "w") as f:
            f.create_dataset("data", data=data)
    return out


def _make(pkg, layout, path, **kw):
    cls = getattr(pkg.datasets, layout)
    if layout != "Adv":
        kw["format"] = "uvp" if layout == "NsCircle" else "uv"
    return cls(path=path, **kw)


def assert_graphs_equal(got, ref, extra_prefix=None):
    keys = set(got.data)
    extra = set(ref.data) - keys
    assert all(extra_prefix and k.startswith(extra_prefix) for k in extra), \
        extra
    for key in keys:
        a, b = got.data[key], ref.data[key]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), key
        else:
            assert a == b, key


@pytest.mark.parametrize("load", ["file", "preload", "idx"])
@pytest.mark.parametrize("layout", ["NsCircle", "NsEllipse", "Adv"])
def test_dataset_graphs_match_jax(layout, load, files):
    T = 10 if layout == "Adv" else 12
    info = {"n_in": 2, "n_out": 3, "step": 2, "T": T}
    kw = dict(training_info=info, seed=4,
              preload=load != "file", idx=1 if load == "idx" else None)
    got = _make(gfd, layout, files[layout], **kw)
    ref = _make(jgfd, layout, files[layout], **kw)
    assert len(got) == len(ref) == (1 if load == "idx" else
                                    {"Adv": 3, "NsEllipse": 4}.get(layout, 6))
    for i in range(len(got)):
        assert_graphs_equal(got.get_sequence(i, 1, n_in=1, n_out=2),
                            ref.get_sequence(i, 1, n_in=1, n_out=2))
        for _ in range(2):                      # the seeded windows
            assert_graphs_equal(got[i], ref[i])
    g = got[0]
    assert g.pos.shape[0] == (200 if layout == "Adv" else 600)
    assert g.omega.shape == (g.pos.shape[0], 1)


def test_dataset_refuses_idx_without_preload(files):
    with pytest.raises(ValueError):
        gfd.datasets.NsCircle(format="uvp", path=files["NsCircle"], idx=0)
    with pytest.raises(ValueError):
        gfd.datasets.NsCircle(format="uvw", path=files["NsCircle"])


def _chain(tf, script):
    """The transform chain of a training script, its random transforms
    seeded."""
    if script == "NsThreeScaleGNN":
        return [tf.SpatialSort(), tf.ConnectKNN(6, period=[None, "auto"]),
                tf.ScaleNs(SCALE_UVP, format="uvp"), tf.ScaleEdgeAttr(0.1),
                tf.RandomGraphRotation(eq="ns", format="uvp", seed=1),
                tf.RandomGraphFlip(eq="ns", format="uvp", seed=2),
                tf.AddUniformNoise(0.01, seed=3),
                tf.GridClustering([0.15, 0.30])]
    if script == "NsThreeGuillardScaleGNN":
        return [tf.SpatialSort(),
                tf.GuillardCoarseningAndConnectKNN(
                    k=(6, 6, 6), period=(None, "auto"),
                    scale_edge_attr=(0.1, 0.25, 0.5)),
                tf.ScaleNs(SCALE_UVP, format="uvp"),
                tf.BuildKnnInterpWeights(6),
                tf.RandomGraphRotation(eq="ns", format="uvp", seed=1),
                tf.RandomGraphFlip(eq="ns", format="uvp", seed=2),
                tf.AddUniformNoise(0.01, seed=3)]
    return [tf.RandomNodeSubset(0.8, seed=4), tf.SpatialSort(),
            tf.ScaleNs(SCALE_UV, format="uv"),
            tf.BuildRemusGraph(num_levels=3, k=5,
                               scale_edge_length=(0.1, 0.2, 0.4)),
            tf.BuildKnnInterpWeights(5), tf.AddUniformNoise(0.01, seed=3)]


def script_loader(pkg, compose, split, script, path):
    layout = ("NsEllipse" if script == "NsRotEquiThreeScaleGNN"
              else "NsCircle")
    ds = _make(pkg, layout, path[layout],
               training_info={"n_in": 1, "n_out": 3, "step": 1, "T": 12},
               transform=compose(_chain(pkg.transforms, script)), seed=0)
    train, _ = split(ds, [len(ds) - 1, 1], seed=0)
    return pkg.DataLoader(train, batch_size=2, shuffle=True, seed=5,
                          num_workers=0)


@pytest.mark.parametrize("script", ["NsThreeScaleGNN",
                                    "NsThreeGuillardScaleGNN",
                                    "NsRotEquiThreeScaleGNN"])
def test_script_batches_match_jax(script, files):
    got = script_loader(gfd, Compose, random_split, script, files)
    ref = script_loader(jgfd, JaxCompose, jax_random_split, script, files)
    n = 0
    for _ in range(2):                                   # two epochs
        for a, b in zip(got, ref, strict=True):
            assert_graphs_equal(a, b, extra_prefix="wg")
            n += 1
    assert n == 2 * len(got) >= 4


def small_three_scale_arch():
    mp = ((W + 2 * W, (W, W), True), (W + W, (W, W), True))
    return {"edge_encoder": (2, (W, W), False),
            "node_encoder": (5, (W, W), False),
            "mp111": mp, "mp112": mp, "down_mp12": (2 + W, (W, W), True),
            "mp211": mp, "down_mp23": (2 + W, (W, W), True),
            "mp31": mp, "up_mp32": (2 + W + W, (W, W), True),
            "mp221": mp, "up_mp21": (2 + W + W, (W, W), True),
            "mp121": mp, "decoder": (W, (W, 3), False)}


def test_script_fit_writes_a_checkpoint_jax_loads(files, tmp_path,
                                                  one_thread):
    loader = script_loader(gfd, Compose, random_split, "NsThreeScaleGNN",
                           files)
    cfg = gfd.nn.TrainConfig(
        name="NsThreeScaleGNN", folder=str(tmp_path),
        tensor_board=str(tmp_path), chk_interval=1,
        training_loss=gfd.nn.GraphLoss(lambda_d=0.25),
        validation_loss=gfd.nn.GraphLoss(), epochs=2, num_steps=[1, 2],
        add_steps={"tolerance": 1e9, "loss": "training"}, batch_size=2,
        lr=1e-5, grad_clip={"epoch": 0, "limit": 1},
        scheduler={"factor": 0.5, "patience": 5, "loss": "training"},
        stopping=1e-8)
    model = gfd.nn.NsThreeScaleGNN(arch=small_three_scale_arch(),
                                   device="cpu")
    history = model.fit(cfg, loader)
    assert [r["n_out"] for r in history] == [1, 2]
    assert all(np.isfinite(r["train_loss"]) for r in history)
    chk = os.path.join(str(tmp_path), "NsThreeScaleGNN.chk")
    jmodel = jgfd.nn.NsThreeScaleGNN(checkpoint=chk)
    ref = jax_leaves(jmodel.params)
    got = jax_leaves(params_to_numpy(model))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, np.asarray(b))
    state = jax_load_checkpoint(chk)
    assert state["n_out"] == 2 and state["epoch"] == 2


def jax_leaves(tree):
    import jax
    return jax.tree_util.tree_leaves(tree)
