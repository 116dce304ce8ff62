"""The port's runtime against the JAX package's, on the CPU.

* ``fit`` against the JAX ``fit``: a 32-wide 3-scale MuS model from the
  same weights on the same batches, 4 epochs with the rollout curriculum
  (``num_steps=[1, 2]``, Adam and the scheduler started again after epoch
  1), the clip from epoch 2 and the plateau schedule on the validation
  loss (the validation targets repeat the input field, which the model
  learns to move away from: that loss rises and the lr halves before
  epoch 4 and after it): the per-epoch losses from
  the JSONL metrics at rtol 1e-3, the lr of every epoch, the checkpoints'
  ``epoch``/``n_out``/``lr``/scheduler, and the final weights, each within
  half an Adam step (``WEIGHT_TOL``);
* the JAX ``fit`` resumes from a checkpoint the port's ``fit`` wrote;
* ``fit``'s own behaviour: a resumed run gives the same bits as a
  straight one; REMuS and gMuS batches reach the backward with their
  host sorts; the ``.chk.bck`` rename; the lr-floor stop with its
  checkpoint; the NaN post-mortem; the arch-mismatch and ``n_out``
  errors; ``TrainConfig`` and ``fit`` refuse what the port does not run
  (Orbax; ranks without their process group; bf16 graph parallelism);
* the small pieces against their JAX copies: ``ReduceLROnPlateau``,
  ``r2``, ``rollout_rmse``, ``random_split`` and the dataset helpers,
  ``DataLoader`` batches byte-equal to the JAX loader's (data-parallel
  shards too), and ``solve`` of a list of graphs.
"""
import contextlib
import json
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from graphs4cfd_tpu import metrics as jax_metrics
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.loader import DataLoader as JaxDataLoader
from graphs4cfd_tpu.nn.losses import GraphLoss as JaxGraphLoss
from graphs4cfd_tpu.training import trainer as jax_trainer
from graphs4cfd_tpu.training.config import TrainConfig as JaxTrainConfig
from graphs4cfd_tpu.training.schedule import \
    ReduceLROnPlateau as JaxReduceLROnPlateau
from graphs4cfd_tpu.utils import data as jax_data
from graphs4cfd_tpu_torch import metrics, utils
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import (DataLoader, attach_angle_sorts,
                                         attach_sender_sorts, collate)
from graphs4cfd_tpu_torch.nn import (GraphLoss, NsRotEquiThreeScaleGNN,
                                     NsThreeGuillardScaleGNN,
                                     NsThreeScaleGNN, init_params_numpy,
                                     params_from_jax)
from graphs4cfd_tpu_torch.ops import gn_block as port_gn
from graphs4cfd_tpu_torch.training import (ReduceLROnPlateau, TrainConfig,
                                           adam_init, load_checkpoint,
                                           make_train_step)
from test_torch_host import _assert_byte_equal, port_samples
from test_torch_mus import _jax_model, small_arch

EPOCHS = 4
FIT_TOL = 1e-3      # relative: per-epoch losses, scheduler state
LR = 1e-3
# Final weights: every element within half an Adam step of the JAX run's.
# Adam moves a weight by about the lr a step whatever its gradient's size,
# so a last-bit difference in a small gradient (f32 products blocked for
# another thread count) moves it by a fraction of the lr: over this run's
# 14 steps the port lies 0.14 lr from the JAX package, and 0.19 lr from
# itself run with 3 threads in place of 8.  A wrong step, clip or lr moves
# weights by whole steps.
WEIGHT_TOL = 0.5 * LR



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

def _fit_kw(**kw):
    out = dict(num_steps=[1, 2],
               add_steps={"tolerance": 1e9, "loss": "training"}, lr=LR,
               grad_clip={"epoch": 1, "limit": 1.0},
               scheduler={"factor": 0.5, "patience": 0,
                          "loss": "validation"},
               epochs=EPOCHS, chk_interval=1)
    out.update(kw)
    return out


@contextlib.contextmanager
def _jax_steps_built_once():
    """The JAX ``fit`` builds (and jit-compiles) its steps anew on every
    call; within this block a step of the same shape is built once."""
    made = {}
    train, val = jax_trainer.make_train_step, jax_trainer.make_val_step

    def cached(fn, tag):
        def build(apply_fn, *args):
            if (tag,) + args[1:] not in made:
                made[(tag,) + args[1:]] = fn(apply_fn, *args)
            return made[(tag,) + args[1:]]
        return build

    jax_trainer.make_train_step = cached(train, "train")
    jax_trainer.make_val_step = cached(val, "val")
    try:
        yield
    finally:
        jax_trainer.make_train_step, jax_trainer.make_val_step = train, val


def _jsonl(log_dir, name):
    out = {}
    with open(os.path.join(log_dir, name, "metrics.jsonl")) as f:
        for line in f:
            rec = json.loads(line)
            out.setdefault(rec["tag"], {})[rec["step"]] = rec["value"]
    return out


def _data():
    samples = port_samples(4, 300, seed=5)
    val = [s.replace(target=np.tile(s.field, (1, 10))) for s in samples[:2]]
    return samples, val


def _port_loaders(samples, val):
    return (DataLoader(samples, batch_size=2, shuffle=True, seed=0),
            DataLoader(val, batch_size=2))


def _port_fit(tmp, name, model=None, loaders=None, **kw):
    arch = small_arch()
    if model is None:
        model = NsThreeScaleGNN(arch=arch, seed=3, device="cpu")
    train, val = loaders or _port_loaders(*_data())
    cfg = TrainConfig(name, folder=str(tmp), tensor_board=str(tmp),
                      training_loss=GraphLoss(0.25), **_fit_kw(**kw))
    return model, model.fit(cfg, train, val)


@pytest.fixture(scope="module")
def fit_case(tmp_path_factory):
    """The JAX ``fit`` straight through, and resumed after 2 epochs from a
    checkpoint of the port's ``fit``; the port's ``fit`` straight
    through."""
    tmp = tmp_path_factory.mktemp("fit")
    arch = small_arch()
    tree = init_params_numpy(arch, seed=3)
    samples, val = _data()
    jax_ds = lambda gs: [JaxGraph(data=dict(g.data)) for g in gs]

    def jax_fit(name, model, **kw):
        cfg = JaxTrainConfig(name, folder=str(tmp), tensor_board=str(tmp),
                             training_loss=JaxGraphLoss(0.25),
                             **_fit_kw(**kw))
        jax_trainer.fit(model, cfg, JaxDataLoader(jax_ds(samples),
                                                  batch_size=2, shuffle=True,
                                                  seed=0),
                        JaxDataLoader(jax_ds(val), batch_size=2))
        return model

    port_model, history = _port_fit(tmp, "port")
    _port_fit(tmp, "half", epochs=2)
    with _jax_steps_built_once():
        jax_model = jax_fit("jax", _jax_model(arch, tree))
        # the resumed run's loader must draw epochs 3-4's orders: its
        # first two shuffles are burnt by a 2-epoch run of its own
        resumed = _jax_model(arch, tree)
        cfg = JaxTrainConfig("resumed", folder=str(tmp),
                             tensor_board=str(tmp),
                             training_loss=JaxGraphLoss(0.25),
                             **_fit_kw(checkpoint=str(tmp / "half.chk")))
        loader = JaxDataLoader(jax_ds(samples), batch_size=2, shuffle=True,
                               seed=0)
        for _ in range(2):
            list(loader._index_batches())
        jax_trainer.fit(resumed, cfg, loader,
                        JaxDataLoader(jax_ds(val), batch_size=2))
    return dict(tmp=tmp, port=port_model, history=history,
                jax=jax_model, resumed=resumed)


def test_fit_matches_jax_fit(fit_case):
    tmp = fit_case["tmp"]
    got, want = _jsonl(tmp, "port"), _jsonl(tmp, "jax")
    assert sorted(got["Loss/train"]) == list(range(1, EPOCHS + 1))
    for tag in ("Loss/train", "Loss/test"):
        for epoch in range(1, EPOCHS + 1):
            np.testing.assert_allclose(got[tag][epoch], want[tag][epoch],
                                       rtol=FIT_TOL, err_msg=(tag, epoch))
    # the curriculum after epoch 1, the plateau halving before epoch 4
    assert got["lr"] == want["lr"] == {1: 1e-3, 2: 1e-3, 3: 1e-3, 4: 5e-4}
    assert [r["n_out"] for r in fit_case["history"]] == [1, 2, 2, 2]
    mine, ref = (load_checkpoint(str(tmp / f"{n}.chk"))
                 for n in ("port", "jax"))
    for key in ("epoch", "n_out", "lr"):
        assert mine[key] == ref[key], key
    assert mine["epoch"] == EPOCHS and mine["n_out"] == 2
    assert mine["scheduler"].keys() == ref["scheduler"].keys()
    for key, value in ref["scheduler"].items():
        np.testing.assert_allclose(mine["scheduler"][key], value,
                                   rtol=FIT_TOL, err_msg=key)
    want_p = params_from_jax(jax.tree_util.tree_map(
        np.asarray, fit_case["jax"].params))
    for name, p in fit_case["port"].named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_p[name].numpy(),
                                   rtol=0, atol=WEIGHT_TOL, err_msg=name)


def test_jax_fit_resumes_from_a_port_checkpoint(fit_case):
    tmp = fit_case["tmp"]
    straight, resumed = _jsonl(tmp, "jax"), _jsonl(tmp, "resumed")
    assert sorted(resumed["Loss/train"]) == [3, 4]
    for tag in ("Loss/train", "Loss/test"):
        for epoch in (3, 4):
            np.testing.assert_allclose(resumed[tag][epoch],
                                       straight[tag][epoch], rtol=FIT_TOL,
                                       err_msg=(tag, epoch))
    assert resumed["lr"] == {3: 1e-3, 4: 5e-4}


def test_fit_records_its_epochs(fit_case):
    history = fit_case["history"]
    assert [r["epoch"] for r in history] == list(range(1, EPOCHS + 1))
    assert all(r["steps"] == 2 and r["seconds"] > 0 and r["edges_per_s"] > 0
               for r in history)
    # on the CPU every wrapper runs its plain version: no launches
    assert set(history[0]["launches"].values()) == {0}
    assert "launches" not in history[1]
    got = _jsonl(fit_case["tmp"], "port")
    assert [got["Loss/train"][r["epoch"]] for r in history] == \
        [r["train_loss"] for r in history]


def test_resume_gives_the_same_bits_as_a_straight_run(tmp_path):
    loaders = _port_loaders(*_data())
    straight, _ = _port_fit(tmp_path, "straight")
    first, _ = _port_fit(tmp_path, "split", loaders=loaders, epochs=2)
    path = str(tmp_path / "split.chk")
    assert load_checkpoint(path)["epoch"] == 2
    again = NsThreeScaleGNN(arch=small_arch(), seed=11, device="cpu")
    _, history = _port_fit(tmp_path, "split", model=again, loaders=loaders,
                           checkpoint=path)
    assert [r["epoch"] for r in history] == [3, 4]
    assert os.path.exists(path + ".bck")
    for a, b in zip(again.parameters(), straight.parameters()):
        assert torch.equal(a, b)
    ends = [load_checkpoint(str(tmp_path / f"{n}.chk"))
            for n in ("split", "straight")]
    assert ends[0]["scheduler"] == ends[1]["scheduler"]
    for a, b in zip(jax.tree_util.tree_leaves(tuple(ends[0]["optimiser"])),
                    jax.tree_util.tree_leaves(tuple(ends[1]["optimiser"]))):
        assert a.tobytes() == b.tobytes()


def _family(family):
    """A small model class, arch and samples of the REMuS or gMuS family,
    with the host sort its backward walks."""
    if family == "remus":
        from test_torch_remus import port_remus_samples, small_remus_arch
        return (NsRotEquiThreeScaleGNN, small_remus_arch(w=16),
                port_remus_samples(num=4, seed=2), attach_angle_sorts)
    from test_torch_mugs import port_mugs_samples, small_mugs_arch
    return (NsThreeGuillardScaleGNN, small_mugs_arch(w=16),
            port_mugs_samples(num=4, seed=2), attach_sender_sorts)


@pytest.mark.parametrize("family", ["remus", "gmus"])
def test_fit_hands_the_backward_its_host_sorts(family, tmp_path,
                                               monkeypatch):
    """REMuS and gMuS through ``fit``: every batch goes through the
    family's ``prepare_batch``, so no GN-block backward sorts its senders
    itself, and epoch 1's loss has the bits of ``make_train_step`` called
    by hand on the same batches with their host sorts attached."""
    cls, arch, samples, attach = _family(family)
    loader = lambda: DataLoader(samples, batch_size=2, shuffle=True, seed=0,
                                node_bucket=64, edge_bucket=128)
    sorts = []                      # whether each backward had its sort
    real = port_gn._sender_sort

    def spy(senders, sender_sort):
        sorts.append(sender_sort is not None)
        return real(senders, sender_sort)

    monkeypatch.setattr(port_gn, "_sender_sort", spy)
    ref = cls(arch=arch, seed=3, device="cpu")
    step = make_train_step(ref, GraphLoss(0.25), ref.num_fields, 2, 1.0)
    state = adam_init(ref.parameters())
    hand = [step(state, Graph.from_numpy(attach(b), "cpu"), LR, True)[0]
            for b in loader()]
    hand_sorts, sorts[:] = list(sorts), []
    model = cls(arch=arch, seed=3, device="cpu")
    cfg = TrainConfig(family, folder=str(tmp_path), num_steps=[2], lr=LR,
                      training_loss=GraphLoss(0.25),
                      grad_clip={"epoch": 0, "limit": 1.0})
    (record,) = model.fit(cfg, loader())
    assert record["train_loss"] == (hand[0].item() + hand[1].item()) / 2
    assert sorts and all(sorts)
    assert hand_sorts == sorts
    for a, b in zip(model.parameters(), ref.parameters()):
        assert torch.equal(a, b)


def test_fit_renames_an_earlier_checkpoint(tmp_path):
    (tmp_path / "run.chk").write_bytes(b"earlier")
    _port_fit(tmp_path, "run", epochs=1)
    assert (tmp_path / "run.chk.bck").read_bytes() == b"earlier"
    assert load_checkpoint(str(tmp_path / "run.chk"))["epoch"] == 1


def test_fit_stops_at_the_lr_floor_after_saving(tmp_path):
    model = NsThreeScaleGNN(arch=small_arch(), seed=3, device="cpu")
    before = [p.detach().clone() for p in model.parameters()]
    _, history = _port_fit(tmp_path, "floor", model=model, stopping=1e-2)
    assert history == []
    state = load_checkpoint(str(tmp_path / "floor.chk"))
    assert state["epoch"] == 1 and state["lr"] == 1e-3
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_fit_saves_a_post_mortem_on_a_non_finite_loss(tmp_path):
    samples, val = _data()
    samples[1] = samples[1].replace(target=np.full_like(samples[1].target,
                                                        np.nan))
    _, history = _port_fit(tmp_path, "nan",
                           loaders=_port_loaders(samples, val))
    assert len(history) == 1 and np.isnan(history[0]["train_loss"])
    post = load_checkpoint(str(tmp_path / "nan.chk.nan_epoch1"))
    assert post["epoch"] == 1
    assert not (tmp_path / "nan.chk").exists()


def test_resume_refuses_another_arch(tmp_path):
    other = small_arch(w=16)
    NsThreeScaleGNN(arch=other, device="cpu").save_checkpoint(
        str(tmp_path / "other.chk"), n_out=1, epoch=1)
    with pytest.raises(ValueError, match="mismatched entries"):
        _port_fit(tmp_path, "a", checkpoint=str(tmp_path / "other.chk"))
    state = load_checkpoint(str(tmp_path / "other.chk"))
    del state["arch"]
    with open(tmp_path / "bare.chk", "wb") as f:
        pickle.dump(state, f)
    with pytest.raises(ValueError, match="first mismatch"):
        _port_fit(tmp_path, "b", checkpoint=str(tmp_path / "bare.chk"))


def test_resume_refuses_an_n_out_beyond_num_steps(tmp_path):
    NsThreeScaleGNN(arch=small_arch(), device="cpu").save_checkpoint(
        str(tmp_path / "far.chk"), n_out=4, epoch=1)
    with pytest.raises(ValueError, match="curriculum position n_out=4"):
        _port_fit(tmp_path, "c", checkpoint=str(tmp_path / "far.chk"))


@pytest.mark.parametrize("knob,error", [
    ({"checkpoint_format": "orbax"}, ValueError),
    ({"checkpoint_format": "zip"}, ValueError),
    ({"devices": 2}, RuntimeError),
    ({"graph_devices": 4}, RuntimeError),
    ({"graph_devices": 2, "mixed_precision": True}, RuntimeError)])
def test_train_config_refuses_what_the_port_does_not_run(knob, error,
                                                         tmp_path):
    """``TrainConfig`` refuses Orbax; ``fit`` refuses a mesh of ranks
    without a process group that holds it (none here), graph parallelism
    in bf16 included, before it writes anything."""
    with pytest.raises(error):
        _port_fit(tmp_path, "x", **knob)
    assert not any(tmp_path.iterdir())


def test_train_config_keeps_the_jax_fields_and_defaults():
    got, want = TrainConfig("x", num_steps=3), JaxTrainConfig("x",
                                                             num_steps=3)
    assert vars(got) == vars(want)
    assert got["num_steps"] == [3] and got["no_such_field"] is None


# ------------------------------------------------------- the small pieces
def test_plateau_schedule_matches_jax():
    seq = [1.0, 0.9, 0.95, 0.9, 0.89999, 0.5, 0.6, 0.7, 0.4, 0.4, 0.4]
    got, want = ReduceLROnPlateau(1e-3, 0.5, 1), JaxReduceLROnPlateau(
        1e-3, 0.5, 1)
    for i, m in enumerate(seq):
        assert got.step(m) == want.step(m)
        assert got.state_dict() == want.state_dict()
        if i == 5:      # a fresh one carries on from the state
            fresh = ReduceLROnPlateau(1.0, 0.1, 7)
            fresh.load_state_dict(got.state_dict())
            got = fresh


def test_r2_and_rollout_rmse_match_jax(rng):
    target = rng.normal(size=(40, 6)).astype(np.float32)
    target[3, 2] = target.mean()          # left out by the exact-mean quirk
    pred = target + 0.1 * rng.normal(size=target.shape).astype(np.float32)
    mask = rng.random(40) < 0.7
    assert metrics.r2(pred, target) == jax_metrics.r2(pred, target)
    assert metrics.r2(torch.from_numpy(pred[:, 0]), target[:, 0]) == \
        jax_metrics.r2(pred[:, 0], target[:, 0])
    assert metrics.rollout_rmse(pred, target, mask) == \
        jax_metrics.rollout_rmse(pred, target, mask)
    assert metrics.rollout_rmse(pred, target) == \
        jax_metrics.rollout_rmse(pred, target)
    with pytest.raises(RuntimeError):
        metrics.r2(pred[None], target[None])


def test_dataset_helpers_match_jax():
    data = list(range(23))
    for seed in (0, 5):
        got = utils.random_split(data, [10, 7, 4], seed=seed)
        want = jax_data.random_split(data, [10, 7, 4], seed=seed)
        assert [s.indices for s in got] == [s.indices for s in want]
        assert [list(s) for s in got] == [list(s) for s in want]
    with pytest.raises(ValueError):
        utils.random_split(data, [20, 4])
    cat = utils.ConcatDataset([data[:5], data[5:9], data[9:]])
    assert len(cat) == 23 and [cat[i] for i in range(23)] == data
    assert utils.Compose([lambda x: x + 1, lambda x: 2 * x])(3) == 8


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, shuffle=True, seed=3),
    dict(batch_size=2, shuffle=True, seed=3, drop_last=True),
    dict(batch_size=3, shuffle=False, num_workers=2, prefetch=1),
    dict(batch_size=2, shuffle=True, seed=1, transform="noise",
         batch_transform="scale")])
def test_data_loader_batches_are_byte_equal_to_jax(kw):
    samples = port_samples(5, 200, seed=2)
    jax_samples = [JaxGraph(data=dict(s.data)) for s in samples]

    def options():
        def noise(g):   # a per-sample transform: the same for both
            return g.replace(field=g.field + np.float32(0.5))

        def scale(b):   # a whole-batch transform
            return b.replace(edge_attr=b.edge_attr * np.float32(2.0))
        out = dict(kw)
        if kw.get("transform"):
            out["transform"], out["batch_transform"] = noise, scale
        return out

    got = DataLoader(samples, **options())
    want = JaxDataLoader(jax_samples, **options())
    assert len(got) == len(want)
    for _ in range(2):                    # two epochs: two shuffles
        batches = list(got)
        ref = list(want)
        assert len(batches) == len(ref) == len(got)
        for b, r in zip(batches, ref):
            assert isinstance(b.pos, np.ndarray)
            _assert_byte_equal(r.data, {k: v for k, v in b.data.items()})


def test_data_loader_refuses_data_parallel_shards():
    """``DataLoader(num_shards=2)`` yields ``collate_sharded`` batches
    byte-equal to the JAX loader's (but for the window plans), drops a
    last batch it cannot split, and refuses a whole-batch transform,
    whose cells would couple samples of different shards."""
    samples = port_samples(5, 200, seed=2)
    got = DataLoader(samples, batch_size=2, shuffle=True, seed=3,
                     num_shards=2)
    want = JaxDataLoader([JaxGraph(data=dict(s.data)) for s in samples],
                         batch_size=2, shuffle=True, seed=3, num_shards=2)
    batches, ref = list(got), list(want)
    assert len(batches) == len(ref) == len(got) == 2
    for b, r in zip(batches, ref):
        assert b.node_mask.shape[0] == 2
        _assert_byte_equal({k: v for k, v in r.data.items()
                            if not k.startswith("wg_")}, b.data)
    with pytest.raises(ValueError, match="batch_transform"):
        next(iter(DataLoader(samples, batch_size=2, num_shards=2,
                             batch_transform=lambda b: b)))


def test_solve_of_a_list_collates_first():
    model = NsThreeScaleGNN(arch=small_arch(w=16), seed=2, device="cpu")
    samples = port_samples(3, 200, seed=4)
    got = model.solve(samples, 2)
    want = model.solve(Graph.from_numpy(collate(samples), "cpu"), 2)
    assert torch.equal(got, want)
    assert got.shape == (collate(samples).num_nodes, 6)
