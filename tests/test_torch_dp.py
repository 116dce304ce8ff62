"""The port's data parallelism (all three families) and DP x GP (MuS) over
spawned gloo ranks on the CPU, against the JAX package's on a virtual
device mesh.

Host side, no ranks: ``collate_sharded`` byte-equal to the JAX package's
on every key but the window plans (``wg_*``), for each family and with
shards padded to each other; ``partition_batches(regroup_sharded(...))``
byte-equal on every key but ``wg_*``, with the same node permutations;
``shard_of`` and the refusal of a batch that does not split.

One ``spawn_ranks(run_dp_tasks, 2, "gloo", ...)`` (one thread a rank)
runs the DP checks, one with 4 ranks the DP x GP ones, on
``tests/test_parallel.py``'s samples and ``tests/test_models.py``'s
32-wide archs (``n_out=2``, ``GraphLoss(0.25)``, clip 1.0, lr 1e-3):

* MuS, gMuS and REMuS ``make_dp_train_step`` against the JAX
  ``make_dp_train_step`` on a 2-device mesh: the loss at rtol 1e-4, the
  parameters at rtol 5e-3 / atol 1e-4 (``tests/test_torch_gp.py``'s
  tolerances); the first step's gradients, reduced over the ranks, at
  2e-4 of each tensor's max abs against the JAX gradient of the loss of
  the unsplit batch;
* MuS ``make_dp_val_step`` and ``make_dp_rollout`` against theirs;
* MuS in bf16: the first step's loss and gradients within twice JAX's own
  bf16-vs-f32 gap plus 2e-3 of JAX's bf16 (``tests/test_torch_bf16_train.py``'s
  bound), and a finite train step that keeps the parameters f32;
* MuS ``make_dp_gp_train_step`` and ``make_dp_gp_val_step`` on a 2 x 2
  mesh against the JAX ones;
* every rank holds the same loss, gradients and parameters, to the bit,
  and a second run of a step gives the same bits.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphs4cfd_tpu as g4c
from graphs4cfd_tpu import transforms as JT
from graphs4cfd_tpu.loader import collate as jax_collate
from graphs4cfd_tpu.loader import collate_sharded as jax_collate_sharded
from graphs4cfd_tpu.nn.losses import GraphLoss as JaxGraphLoss
from graphs4cfd_tpu.parallel import make_mesh as jax_mesh
from graphs4cfd_tpu.parallel import dp as jax_dp
from graphs4cfd_tpu.parallel import graph_parallel as jax_gp
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import collate, collate_sharded, shard_of
from graphs4cfd_tpu_torch.nn import init_params_numpy, params_from_jax
from graphs4cfd_tpu_torch.parallel import (partition_batches,
                                           regroup_sharded, spawn_ranks)
from graphs4cfd_tpu_torch.parallel.run import run_dp_tasks
from test_models import make_cloud, mugs_arch, mus_arch, remus_arch
from test_torch_bf16_train import GAP_FLOOR, _gap
from test_torch_host import _assert_byte_equal
from test_torch_train import _close_to_max

LR = 1e-3
N_OUT = 2
SPAWN_LIMIT = 300          # seconds, for the ranks of one spawn together

# tests/test_parallel.py and tests/test_parallel_families.py's samples:
# (arch, JAX class, fields, sample sizes, numpy seed, make_cloud keywords,
# the pipeline from a transforms module)
FAMILIES = {
    "mus": (lambda: mus_arch(5, 1), g4c.nn.MuSGNN, 1, (70, 80, 75, 85), 0,
            {}, lambda t: [t.ConnectKNN(k=4), t.ScaleEdgeAttr(0.02),
                           t.GridClustering([0.3])]),
    "gmus": (lambda: mugs_arch(6, 1), g4c.nn.MuGSGNN, 1, (180, 200), 5,
             dict(with_glob=True),
             lambda t: [t.GuillardCoarseningAndConnectKNN(
                 k=[4, 4, 4], scale_edge_attr=(0.02, 0.04, 0.08)),
                 t.BuildKnnInterpWeights(3)]),
    "remus": (remus_arch, g4c.nn.REMuSGNN, 2, (110, 120), 6,
              dict(n_in=1, nf=2, with_loc=False, with_glob=True),
              lambda t: [t.BuildRemusGraph(num_levels=3, k=4,
                                           scale_edge_length=(0.02, 0.04,
                                                              0.08)),
                         t.BuildKnnInterpWeights(3)]),
}


def samples(family, port=True, sizes=None):
    """The family's samples through the port's transforms (``port``) or
    the JAX package's, from the same clouds."""
    _, _, _, default, seed, cloud, pipeline = FAMILIES[family]
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes or default:
        g = make_cloud(rng, n, **cloud)
        if port:
            g = Graph(dict(g.data))
        for t in pipeline(T if port else JT):
            g = t(g)
        out.append(g)
    return out


@functools.lru_cache(maxsize=None)
def _jax_sharded(family, sizes=None):
    return jax_collate_sharded(samples(family, False, sizes), 2,
                               node_bucket=64, edge_bucket=128)


# ------------------------------------------------------------ host side
@pytest.mark.parametrize("family,sizes", [
    ("mus", None), ("mus", (70, 80, 75, 130)), ("gmus", (180, 260)),
    ("remus", (110, 170))])
def test_collate_sharded_byte_equal_to_jax(family, sizes):
    ref = _jax_sharded(family, sizes)
    got = collate_sharded(samples(family, True, sizes), 2, 64, 128)
    _assert_byte_equal({k: v for k, v in ref.data.items()
                        if not k.startswith("wg_")}, got.data)


def test_collate_sharded_pads_shards_to_each_other():
    got = collate_sharded(samples("mus", True, (70, 80, 75, 130)), 2, 64,
                          128)
    assert got.node_mask.shape == (2, 256)
    assert got.node_mask[0].sum() == 145 and got.node_mask[1].sum() == 210
    k = got.fixed_k
    pad = np.arange(192 * k, 256 * k)
    # shard 0's new pad edges are self-loops on its new pad nodes
    np.testing.assert_array_equal(got.senders[0][pad], pad // k)
    np.testing.assert_array_equal(got.receivers[0][pad], pad // k)
    one = shard_of(got, 1)
    ref = collate(samples("mus", True, (70, 80, 75, 130))[1::2], 64, 128)
    _assert_byte_equal(ref.data, one.data)


def test_collate_sharded_refuses_an_uneven_batch():
    with pytest.raises(ValueError, match="not divisible by 2 shards"):
        collate_sharded(samples("mus", True, (70, 80, 75)), 2)


def test_partition_batches_byte_equal_to_jax():
    ref, ref_info = jax_gp.partition_batches(
        jax_gp.regroup_sharded(_jax_sharded("mus"), 2), 2)
    got, info = partition_batches(regroup_sharded(
        collate_sharded(samples("mus"), 2, 64, 128), 2), 2)
    _assert_byte_equal({k: v for k, v in ref.data.items()
                        if not k.startswith("wg_")}, got.data)
    assert info["pmax"] == ref_info["pmax"]
    for mine, theirs in zip(info["perms"], ref_info["perms"]):
        assert set(mine) == set(theirs)
        for level, perm in theirs.items():
            np.testing.assert_array_equal(mine[level], perm)


# ------------------------------------------------------------ the ranks
TASKS = [("grads", "b", {"lambda_d": 0.25}),
         ("train", "b", dict(lambda_d=0.25, n_out=N_OUT, lr=LR, clip=1.0,
                             steps=1)),
         ("train", "b", dict(lambda_d=0.25, n_out=N_OUT, lr=LR, clip=1.0,
                             steps=1)),
         ("val", "b", dict(lambda_d=0.25, max_n_out=2)),
         ("rollout", "b", dict(n_out=3))]


def _job(family, graph, tasks, **kw):
    arch = FAMILIES[family][0]()
    return dict(family=family, arch=arch,
                params=init_params_numpy(arch, seed=6), device="cpu",
                devices=2, graphs={"b": graph.data}, tasks=tasks, **kw)


@pytest.fixture(scope="module")
def dp_ranks():
    """Every DP task of every family in one spawn of 2 ranks."""
    jobs = [_job("mus", collate_sharded(samples("mus"), 2, 64, 128), TASKS),
            _job("mus", collate_sharded(samples("mus"), 2, 64, 128),
                 TASKS[:3], compute_dtype=torch.bfloat16)]
    jobs += [_job(f, collate_sharded(samples(f), 2, 64, 128), TASKS[:3])
             for f in ("gmus", "remus")]
    ranks = spawn_ranks(run_dp_tasks, 2, "gloo", {"jobs": jobs},
                        timeout=SPAWN_LIMIT, num_threads=1)
    return {name: [r[i] for r in ranks] for i, name in
            enumerate(("mus", "mus_bf16", "gmus", "remus"))}


@pytest.fixture(scope="module")
def dpgp_ranks():
    """The MuS DP x GP tasks on a 2 x 2 mesh of 4 ranks."""
    sharded, _ = partition_batches(regroup_sharded(
        collate_sharded(samples("mus"), 2, 64, 128), 2), 2)
    return spawn_ranks(run_dp_tasks, 4, "gloo",
                       _job("mus", sharded, TASKS[:4], graph_devices=2),
                       timeout=SPAWN_LIMIT, num_threads=1)


def _jax_model(family, compute_dtype=jnp.float32):
    arch_fn, cls = FAMILIES[family][:2]
    model = cls(arch=arch_fn(), compute_dtype=compute_dtype)
    model.params = jax.tree_util.tree_map(
        jnp.asarray, init_params_numpy(arch_fn(), seed=6))
    return model


def _to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_grads(family, compute_dtype=jnp.float32):
    """The loss of the unsplit batch and its gradients, JAX package."""
    nf = FAMILIES[family][2]
    model = _jax_model(family, compute_dtype)
    g = jax_collate(samples(family, False), 64, 128).to_device()
    crit = JaxGraphLoss(0.25)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: crit(g, model.apply(p, g), g.target[:, :nf])))(
        model.params)
    return float(loss), {k: v.numpy() for k, v in
                         params_from_jax(_to_np(grads)).items()}


def _jax_dp_step(family):
    nf = FAMILIES[family][2]
    model = _jax_model(family)
    step = jax_dp.make_dp_train_step(model.apply, JaxGraphLoss(0.25), nf,
                                     N_OUT, 1.0, jax_mesh(num_data=2))
    p1, _, loss, _ = step(model.params,
                          optax.scale_by_adam().init(model.params),
                          _jax_sharded(family).to_device(), jnp.float32(LR),
                          jnp.bool_(True))
    return float(loss), {k: v.numpy() for k, v in
                         params_from_jax(_to_np(p1)).items()}


def _assert_params(got, want):
    assert set(got) == set(want)
    for name, ref in want.items():
        np.testing.assert_allclose(got[name], ref, rtol=5e-3, atol=1e-4,
                                   err_msg=name)


def _assert_grads(got, want):
    assert set(got) == set(want)
    for name, ref in want.items():
        _close_to_max(got[name].astype(ref.dtype), ref, 2e-4)


def _assert_same_bits(ranks, task):
    """Every rank's result of ``task`` has the bits of rank 0's."""
    first = ranks[0][task]
    for r in ranks[1:]:
        got = r[task]
        if isinstance(first, tuple):
            assert got[:-1] == first[:-1]
            for name, value in first[-1].items():
                np.testing.assert_array_equal(got[-1][name], value)
        else:
            assert got == first


@pytest.mark.parametrize("family", ["mus", "gmus", "remus"])
def test_dp_train_step_matches_jax(dp_ranks, family):
    ranks = dp_ranks[family]
    losses, gnorms, params = ranks[0][1]
    loss, want = _jax_dp_step(family)
    np.testing.assert_allclose(losses[0], loss, rtol=1e-4)
    assert np.isfinite(gnorms[0])
    _assert_params(params, want)


@pytest.mark.parametrize("family", ["mus", "gmus", "remus"])
def test_dp_first_step_gradients_match_jax(dp_ranks, family):
    loss, grads = dp_ranks[family][0][0]
    ref_loss, want = _jax_grads(family)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    _assert_grads(grads, want)


@pytest.mark.parametrize("family", ["mus", "mus_bf16", "gmus", "remus"])
def test_dp_keeps_the_ranks_the_same_bits(dp_ranks, family):
    for task in (0, 1):
        _assert_same_bits(dp_ranks[family], task)


@pytest.mark.parametrize("family", ["mus", "mus_bf16"])
def test_two_dp_train_steps_give_the_same_bits(dp_ranks, family):
    for r in dp_ranks[family]:
        a, b = r[1], r[2]
        assert a[:2] == b[:2]
        for name, value in a[2].items():
            np.testing.assert_array_equal(b[2][name], value)


def test_dp_val_step_matches_jax(dp_ranks):
    got = [r[3] for r in dp_ranks["mus"]]
    assert len(set(got)) == 1
    model = _jax_model("mus")
    want = jax_dp.make_dp_val_step(model.apply, JaxGraphLoss(0.25), 1, 2,
                                   jax_mesh(num_data=2))(
        model.params, _jax_sharded("mus").to_device())
    np.testing.assert_allclose(got[0], float(want), rtol=1e-4)


def test_dp_rollout_matches_jax(dp_ranks):
    model = _jax_model("mus")
    sharded = _jax_sharded("mus")
    want = np.asarray(jax_dp.make_dp_rollout(model.apply, 1, 3, jax_mesh(
        num_data=2))(model.params, sharded.to_device()))
    for d, r in enumerate(dp_ranks["mus"]):
        got, mask = r[4], np.asarray(sharded.node_mask[d])
        assert got.shape == want[d].shape and np.isfinite(got).all()
        np.testing.assert_allclose(got[mask], want[d][mask], rtol=1e-3,
                                   atol=1e-3)


def test_bf16_dp_step_matches_jax(dp_ranks):
    ranks = dp_ranks["mus_bf16"]
    loss, grads = ranks[0][0]
    loss32, grads32 = _jax_grads("mus")
    loss16, grads16 = _jax_grads("mus", jnp.bfloat16)
    assert abs(loss - loss16) <= 2 * abs(loss16 - loss32) + \
        GAP_FLOOR * abs(loss32)
    names = sorted(grads16)
    assert set(grads) == set(names)
    assert all(grads[n].dtype == np.float32 for n in names)
    flat = lambda d: np.concatenate([d[n].ravel() for n in names])
    jax_gap = _gap(flat(grads16), flat(grads32))
    assert _gap(flat(grads), flat(grads16)) <= 2 * jax_gap + GAP_FLOOR
    losses, gnorms, params = ranks[0][1]
    assert np.isfinite(losses).all() and np.isfinite(gnorms).all()
    assert all(p.dtype == np.float32 for p in params.values())


def test_dp_gp_train_step_matches_jax(dpgp_ranks):
    model = _jax_model("mus")
    mesh = jax_mesh(num_data=2, num_graph=2)
    sharded, _ = jax_gp.partition_batches(
        jax_gp.regroup_sharded(_jax_sharded("mus"), 2), 2)
    p1, _, loss, _ = jax_gp.make_dp_gp_train_step(
        model, JaxGraphLoss(0.25), mesh, n_out=N_OUT, grad_clip_limit=1.0)(
        model.params, optax.scale_by_adam().init(model.params),
        sharded.to_device(), jnp.float32(LR), jnp.bool_(True))
    losses, gnorms, params = dpgp_ranks[0][1]
    np.testing.assert_allclose(losses[0], float(loss), rtol=1e-4)
    assert np.isfinite(gnorms[0])
    _assert_params(params, {k: v.numpy() for k, v in
                            params_from_jax(_to_np(p1)).items()})
    ref_loss, want = _jax_grads("mus")
    loss, grads = dpgp_ranks[0][0]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    _assert_grads(grads, want)


def test_dp_gp_keeps_the_ranks_the_same_bits(dpgp_ranks):
    for task in (0, 1, 3):
        _assert_same_bits(dpgp_ranks, task)
    for r in dpgp_ranks:
        assert r[1][:2] == r[2][:2]
        for name, value in r[1][2].items():
            np.testing.assert_array_equal(r[2][2][name], value)


def test_dp_gp_val_step_matches_jax(dpgp_ranks):
    model = _jax_model("mus")
    sharded, _ = jax_gp.partition_batches(
        jax_gp.regroup_sharded(_jax_sharded("mus"), 2), 2)
    want = jax_gp.make_dp_gp_val_step(
        model, JaxGraphLoss(0.25), jax_mesh(num_data=2, num_graph=2), 2)(
        model.params, sharded.to_device())
    np.testing.assert_allclose(dpgp_ranks[0][3], float(want), rtol=1e-4)
