"""The PyTorch port's host pipeline and device ops against the JAX package.

The port's SpatialSort -> ConnectKNN -> ScaleEdgeAttr -> GridClustering and
``collate`` must give arrays byte-equal to the JAX package's for the same
seed; its segment reductions must match the JAX ones.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _make_samples
from graphs4cfd_tpu.loader import collate as jax_collate
from graphs4cfd_tpu.ops import knn as jax_knn
from graphs4cfd_tpu.ops import segment as jax_segment
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import collate
from graphs4cfd_tpu_torch.ops import knn, segment


def port_samples(num, n_nodes, seed, nf=3, k=6, cells=(0.15, 0.30)):
    """``__graft_entry__._make_samples`` through the port's transforms."""
    pipeline = [T.SpatialSort(), T.ConnectKNN(k=k), T.ScaleEdgeAttr(0.15),
                T.GridClustering(list(cells))]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        g = Graph()
        g.pos = (rng.random((n_nodes, 2)) * np.array([4.0, 2.0])).astype(
            np.float32)
        g.glob = np.full((n_nodes, 1), 0.5, np.float32)
        g.field = rng.normal(size=(n_nodes, nf)).astype(np.float32)
        g.target = rng.normal(size=(n_nodes, nf * 10)).astype(np.float32)
        g.omega = (rng.random((n_nodes, 1)) < 0.1).astype(np.float32)
        g.bound = np.zeros(n_nodes, np.uint8)
        for t in pipeline:
            g = t(g)
        out.append(g)
    return out


def _assert_byte_equal(ref: dict, got: dict):
    for key, y in got.items():
        x = ref[key]
        if isinstance(y, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.tobytes() == y.tobytes(), key
        else:
            assert x == y, key


@pytest.mark.parametrize("seed,n_nodes", [(7, 400), (3, 413)])
def test_collated_batch_byte_equal(seed, n_nodes):
    ref = jax_collate(_make_samples(2, n_nodes, seed=seed), node_bucket=64,
                      edge_bucket=128)
    got = collate(port_samples(2, n_nodes, seed=seed), node_bucket=64,
                  edge_bucket=128)
    # the JAX package adds only its TPU window-gather plans on top
    extra = set(ref.data) - set(got.data)
    assert extra and all(k.startswith("wg_") for k in extra), extra
    assert not set(got.data) - set(ref.data)
    _assert_byte_equal(ref.data, got.data)


def test_per_sample_transforms_byte_equal():
    ref = _make_samples(1, 300, seed=11)[0]
    got = port_samples(1, 300, seed=11)[0]
    assert set(ref.data) == set(got.data)
    _assert_byte_equal(ref.data, got.data)


@pytest.mark.parametrize("period", [None, (4.0, None), ("auto", "auto")])
def test_connect_knn_matches_jax(rng, period):
    pos = (rng.random((257, 2)) * np.array([4.0, 2.0])).astype(np.float32)
    for a, b in zip(knn.connect_knn(pos, 5, period=period),
                    jax_knn.connect_knn(pos, 5, period=period)):
        np.testing.assert_array_equal(a, b)


def test_knn_rejects_too_few_points(rng):
    with pytest.raises(ValueError):
        knn.connect_knn(rng.random((4, 2)).astype(np.float32), k=6)


def test_spatial_sort_refuses_built_topology():
    g = port_samples(1, 50, seed=0, cells=(0.5,))[0]
    with pytest.raises(ValueError):
        T.SpatialSort()(g)


def test_graph_device_round_trip():
    batch = collate(port_samples(2, 120, seed=1), node_bucket=64,
                    edge_bucket=128)
    g = Graph.from_numpy(batch, "cpu")
    assert g.senders.dtype == torch.int32 and g.node_mask.dtype == torch.bool
    assert g.fixed_k == 6 and g.num_nodes == batch.num_nodes
    back = g.numpy()
    _assert_byte_equal(batch.data, back.data)


@pytest.mark.parametrize("with_mask,sorted_idx", [(False, False),
                                                  (True, False),
                                                  (True, True)])
def test_segment_mean_matches_jax(rng, with_mask, sorted_idx):
    E, n, F = 300, 40, 8
    src = rng.normal(size=(E, F)).astype(np.float32)
    idx = rng.integers(0, n - 5, E).astype(np.int32)   # empty tail segments
    if sorted_idx:
        idx = np.sort(idx)
    mask = None
    if with_mask:
        mask = np.ones(E, bool)
        mask[-37:] = False
        idx[-37:] = -1 if not sorted_idx else 0
    ref = jax_segment.segment_mean(
        jnp.asarray(src), jnp.asarray(idx), n,
        mask=None if mask is None else jnp.asarray(mask),
        indices_are_sorted=sorted_idx and not with_mask)
    got = segment.segment_mean(
        torch.from_numpy(src), torch.from_numpy(idx), n,
        mask=None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_aggregate_fixed_k_matches_jax(rng):
    e = rng.normal(size=(6 * 50, 16)).astype(np.float32)
    ref = jax_segment.aggregate_fixed_k(jnp.asarray(e), 6, 50)
    got = segment.aggregate_fixed_k(torch.from_numpy(e), 6, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    with pytest.raises(ValueError):
        segment.aggregate_fixed_k(torch.from_numpy(e), 5, 50)


def test_segment_sums_give_the_same_bits_on_every_cpu_run(rng):
    """The CPU segment sums add their rows in a fixed order: a sum whose
    last bits changed from run to run could move a SELU input across 0 and
    a gradient by O(1) (``index_put_(accumulate=True)`` on the CPU adds
    across threads in no fixed order)."""
    E, n, F = 20000, 700, 64
    src = torch.from_numpy(rng.normal(size=(E, F)).astype(np.float32))
    idx = torch.from_numpy(rng.integers(0, n, E).astype(np.int32))
    perm = torch.sort(idx, stable=True)[1].int()
    runs = [(segment.segment_mean(src, idx, n, mask=idx % 7 > 0),
             segment.sorted_segment_sum_plain(src, perm, idx[perm.long()],
                                              n))
            for _ in range(20)]
    for mean, total in runs[1:]:
        assert torch.equal(mean, runs[0][0])
        assert torch.equal(total, runs[0][1])


@pytest.mark.parametrize("rows,nseg,F,pile", [(3000, 400, 128, 0),
                                              (3000, 400, 130, 500),
                                              (0, 5, 8, 0)])
def test_sorted_segment_sum_plain_adds_each_segment_in_sorted_order(
        rng, rows, nseg, F, pile):
    """The order the CUDA kernel follows: each segment's rows added one by
    one in sorted order, starting from 0, in float32.  The plain version
    gives that loop's bits (the kernel gives them wherever one warp adds
    a segment, ``test_torch_cuda.py``)."""
    src = rng.normal(size=(rows, F)).astype(np.float32)
    idx = rng.integers(0, nseg, rows).astype(np.int32)
    idx[rows - pile:] = 0                 # a pile of pad rows
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    srt = idx[perm]
    want = np.zeros((nseg, F), np.float32)
    for j in range(rows):
        want[srt[j]] = want[srt[j]] + src[perm[j]]
    got = segment.sorted_segment_sum_plain(
        torch.from_numpy(src), torch.from_numpy(perm),
        torch.from_numpy(srt), nseg)
    assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32))
