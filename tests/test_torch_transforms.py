"""The port's augmentation and re-meshing transforms against the JAX
package's: the same numpy inputs and seeds give byte-equal graphs.

``ScaleNs``, ``AddUniformNoise``, ``RandomGraphRotation``,
``GraphRotation``, ``RandomGraphFlip`` (and ``rotate_graph``,
``flip_graph_dim``), ``NodeSubset``, ``RandomNodeSubset``,
``BatchGridClustering`` on a collated batch, and ``interpolate_nodes``
(``InterpolateNodes``, ``InterpolateNodesToXml``).
"""
import random

import numpy as np
import pytest

from graphs4cfd_tpu import transforms as JT
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.loader import collate as jax_collate
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import attach_sender_sorts, collate


def cloud(rng, n=120, dim=2, nf=3, steps=2, adv=False):
    d = {"pos": rng.random((n, dim)).astype(np.float32),
         "field": rng.normal(size=(n, nf * steps)).astype(np.float32),
         "target": rng.normal(size=(n, nf * 3)).astype(np.float32),
         "omega": (rng.random((n, 1)) < 0.2).astype(np.float32),
         "bound": rng.integers(0, 5, n).astype(np.uint8),
         "glob": rng.uniform(500, 1000, (n, 1)).astype(np.float32)}
    if adv:
        d["loc"] = rng.normal(size=(n, dim)).astype(np.float32)
    return d


def pair(d):
    """A port graph and a JAX graph of copies of the same arrays."""
    copy = lambda: {k: (v.copy() if isinstance(v, np.ndarray) else v)
                    for k, v in d.items()}
    return Graph(copy()), JaxGraph(data=copy())


def assert_same(got, ref, only=None):
    keys = set(got.data) if only is None else only
    assert keys <= set(ref.data), keys - set(ref.data)
    for key in keys:
        a, b = got.data[key], ref.data[key]
        if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape, key
            assert a.tobytes() == b.tobytes(), key
        else:
            assert a == b, key


def run_both(make, d, times=1):
    """``make(tf)`` for the port's and the JAX package's transforms, each
    applied ``times`` to its own copy of ``d``: the port's graphs and the
    JAX package's."""
    out = []
    for tf, g in zip((T, JT), pair(d)):
        t = make(tf)
        graphs = []
        for _ in range(times):
            g = t(g)
            graphs.append(Graph(dict(g.data)) if tf is T
                          else JaxGraph(data=dict(g.data)))
        out.append(graphs)
    return list(zip(*out))


SCALING = {"u": (-2.1, 2.6), "v": (-2.25, 2.1), "p": (-3.7, 2.35),
           "Re": (500, 1000)}


@pytest.mark.parametrize("fmt", ["uvp", "uv"])
def test_scale_ns_matches_jax(fmt, rng):
    nf = 3 if fmt == "uvp" else 2
    for got, ref in run_both(lambda tf: tf.ScaleNs(SCALING, format=fmt),
                             cloud(rng, nf=nf)):
        assert_same(got, ref)
    e = rng.normal(size=(40, 2)).astype(np.float32)
    np.testing.assert_array_equal(T.scale_edges(e, 0.1),
                                  JT.scale_edges(e, 0.1))
    with pytest.raises(ValueError):
        T.ScaleNs(SCALING, format="uvw")


def test_add_uniform_noise_matches_jax(rng):
    for got, ref in run_both(lambda tf: tf.AddUniformNoise(0.01, seed=5),
                             cloud(rng), times=3):
        assert_same(got, ref)


@pytest.mark.parametrize("dim,eq,fmt", [(2, "ns", "uvp"), (2, "ns", "uv"),
                                        (2, "adv", None), (3, None, None)])
def test_random_rotation_matches_jax(dim, eq, fmt, rng):
    nf = {"uvp": 3, "uv": 2}.get(fmt, 1)
    d = cloud(rng, dim=dim, nf=nf, adv=eq == "adv")
    d = T.ConnectKNN(5)(Graph(d)).data      # rotates edge_attr too
    make = lambda tf: tf.RandomGraphRotation(eq=eq, format=fmt, seed=3)
    for got, ref in run_both(make, d, times=2):
        assert_same(got, ref)
    for got, ref in run_both(
            lambda tf: tf.GraphRotation(33.0 if dim == 2 else
                                        (10.0, 20.0, 30.0), eq=eq,
                                        format=fmt), d):
        assert_same(got, ref)


def test_rotation_of_a_remus_graph_matches_jax(rng):
    d = cloud(rng, n=200, nf=2)
    made = []
    for tf, g in zip((T, JT), pair(d)):
        g = tf.BuildRemusGraph(num_levels=3, k=5,
                               scale_edge_length=(0.1, 0.2, 0.4))(g)
        made.append(tf.RandomGraphRotation(eq="ns", format="uv",
                                           seed=9)(g))
    got, ref = made
    assert got.has("unit_pinv_3") and got.has("angle_src")
    assert_same(got, ref)
    with pytest.raises(ValueError, match="angle"):
        T.flip_graph_dim(got, 0, eq="ns", format="uv")
    with pytest.raises(ValueError, match="angle"):
        JT.flip_graph_dim(ref, 0, eq="ns", format="uv")


@pytest.mark.parametrize("dim,eq,fmt", [(2, "ns", "uvp"), (2, "adv", None),
                                        (3, "ns", "uv")])
def test_random_flip_matches_jax(dim, eq, fmt, rng):
    nf = {"uvp": 3, "uv": 2}.get(fmt, 1)
    d = cloud(rng, dim=dim, nf=nf, adv=eq == "adv")
    d = T.ConnectKNN(4)(Graph(d)).data
    make = lambda tf: tf.RandomGraphFlip(eq=eq, format=fmt, seed=1)
    for got, ref in run_both(make, d, times=4):
        assert_same(got, ref)
    with pytest.raises(ValueError):
        T.flip_graph_dim(Graph(dict(d)), dim, eq=eq, format=fmt)


@pytest.mark.parametrize("num", [0.7, 50])
def test_node_subsets_match_jax(num, rng):
    d = cloud(rng)
    for got, ref in run_both(lambda tf: tf.RandomNodeSubset(num, seed=2), d,
                             times=2):
        assert_same(got, ref)
    idx = rng.permutation(120)[:30]
    for got, ref in run_both(lambda tf: tf.NodeSubset(idx), d):
        assert_same(got, ref)


def _batch_pair(rng, sizes=(150, 173), cells=None):
    port, jax = [], []
    for n in sizes:
        g, jg = pair(cloud(rng, n=n))
        port.append(T.ConnectKNN(6)(T.SpatialSort()(g)))
        jax.append(JT.ConnectKNN(6)(JT.SpatialSort()(jg)))
        if cells:
            port[-1] = T.GridClustering(cells)(port[-1])
    return (collate(port, node_bucket=64, edge_bucket=128),
            jax_collate(jax, node_bucket=64, edge_bucket=128))


def test_batch_grid_clustering_matches_jax(rng):
    batch, jbatch = _batch_pair(rng)
    got = T.BatchGridClustering([0.15, 0.3])(batch)
    ref = JT.BatchGridClustering([0.15, 0.3])(jbatch)
    assert got.num_levels == 3 and got.has("edge_mask_3")
    assert_same(got, ref, only={k for k in got.data if not k.startswith("wg")})


def test_batch_grid_clustering_recomputes_level_sorts(rng):
    batch, _ = _batch_pair(rng, cells=[0.15, 0.3])
    batch = attach_sender_sorts(batch)
    stale = batch.sender_perm_2.copy()
    got = T.BatchGridClustering([0.15, 0.3])(batch)
    want = attach_sender_sorts(Graph(dict(got.data)))
    for l in (2, 3):
        for key in (f"sender_perm_{l}", f"sender_sorted_{l}"):
            np.testing.assert_array_equal(got.data[key], want.data[key])
    assert got.sender_perm_2.shape != stale.shape or \
        not np.array_equal(got.sender_perm_2, stale)


def test_interpolate_nodes_matches_jax(rng):
    d = cloud(rng, n=80, adv=True)
    new = (0.1 + 0.8 * rng.random((40, 2))).astype(np.float32)
    for got, ref in run_both(lambda tf: tf.InterpolateNodes(new), d):
        assert_same(got, ref)
        assert got.pos.shape == (40, 2) and got.bound.dtype == np.uint8
    g, jg = pair(d)
    got = T.interpolate_nodes(g, new.astype(np.float64), method="linear")
    ref = JT.interpolate_nodes(jg, new.astype(np.float64), method="linear")
    assert_same(got, ref)
    with pytest.raises(ValueError):
        T.interpolate_nodes(T.ConnectKNN(4)(Graph(cloud(rng))), new)


def test_interpolate_nodes_to_xml_matches_jax(rng, tmp_path):
    verts = (0.3 + 0.4 * rng.random((30, 2))).astype(np.float32)
    lines = "".join(f'<V ID="{i}">{x:.6f} {y:.6f} 0.0</V>'
                    for i, (x, y) in enumerate(verts))
    xml = tmp_path / "mesh.xml"
    xml.write_text(f"<NEKTAR><GEOMETRY><VERTEX>{lines}</VERTEX></GEOMETRY>"
                   f"</NEKTAR>")
    random.seed(0)
    d = cloud(rng, n=80)
    for got, ref in run_both(lambda tf: tf.InterpolateNodesToXml(str(xml)),
                             d):
        assert_same(got, ref)
        assert got.pos.shape == (30, 2)
