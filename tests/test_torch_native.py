"""The port's C++ host helper (``graphs4cfd_tpu_torch/native``) against its
numpy plain versions and the JAX package.

Regular grids put many neighbours at equal distances.  The port's k-NN
must break those ties as the JAX package's helper does, by (distance,
index) with the distance summed one dimension at a time in float64, so
that ``connect_knn`` gives the JAX package's graph bit for bit.  (The JAX
package's helper is built with ``-march=native``, where g++ contracts
``d += t * t`` into a fused multiply-add; the port builds without it.  On
every cloud here both builds give the same neighbours.)
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from graphs4cfd_tpu import transforms as JT
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.ops import coarsen as jax_coarsen
from graphs4cfd_tpu.ops import knn as jax_knn
from graphs4cfd_tpu_torch import native
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.ops import coarsen, knn

ROOT = Path(__file__).resolve().parent.parent


def grid(n, spacing=0.01):
    a = (np.arange(n) * spacing).astype(np.float32)
    x, y = np.meshgrid(a, a, indexing="ij")
    return np.stack([x.ravel(), y.ravel()], axis=1).astype(np.float32)


def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("period", [None, [None, "auto"]])
@pytest.mark.parametrize("n", [40, 70])
def test_connect_knn_on_a_grid_matches_jax(n, period):
    """40 x 40 takes the brute-force search, 70 x 70 (4900 points) the
    grid search; the numpy version computes the same neighbours."""
    pos = grid(n)
    got = knn.connect_knn(pos, 6, period=period)
    ref = jax_knn.connect_knn(pos, 6, period=period)
    for a, b in zip(got, ref):
        _equal(a, b)
    lifted, _ = knn._periodic_lift(pos, period)
    plain = knn.knn_neighbors_plain(lifted, lifted, 6, exclude_self=True)
    _equal(plain.reshape(-1), got[0])
    assert native.uses_grid(*lifted.shape) == (n == 70)


@pytest.mark.parametrize("n", [40, 70])
def test_guillard_graph_on_a_grid_matches_jax(n):
    g = Graph({"pos": grid(n)})
    got = T.GuillardCoarseningAndConnectKNN([6, 6, 6])(g)
    ref = JT.GuillardCoarseningAndConnectKNN([6, 6, 6])(
        JaxGraph(data={"pos": grid(n)}))
    assert set(got.data) == set(ref.data)
    for key, value in got.data.items():
        if isinstance(value, np.ndarray):
            _equal(value, ref.data[key])
        else:
            assert value == ref.data[key], key


def _cloud(kind, n, rng):
    if kind == "3d":
        return rng.random((n, 3)).astype(np.float32), None
    pos = (rng.random((n, 2)) * np.array([4.0, 2.0])).astype(np.float32)
    return pos, ([None, "auto"] if kind == "periodic" else None)


@pytest.mark.parametrize("n", [500, 2500])
@pytest.mark.parametrize("kind", ["random", "periodic", "3d"])
def test_helper_matches_plain_and_jax(kind, n, rng):
    pos, period = _cloud(kind, n, rng)
    lifted, _ = knn._periodic_lift(pos, period)
    for exclude_self in (True, False):
        got = knn.knn_neighbors(lifted, lifted, 6, exclude_self)
        _equal(got, knn.knn_neighbors_plain(lifted, lifted, 6, exclude_self))
        _equal(got, jax_knn.knn_neighbors(lifted, lifted, 6, exclude_self))
    for a, b in zip(knn.connect_knn(pos, 6, period=period),
                    jax_knn.connect_knn(pos, 6, period=period)):
        _equal(a, b)


@pytest.mark.parametrize("n_src", [300, 2100])
def test_cross_knn_matches_plain_and_jax(n_src, rng):
    src = rng.random((n_src, 2)).astype(np.float32)
    query = rng.random((700, 2)).astype(np.float32)
    got = knn.cross_knn(src, query, 4)
    _equal(got, knn.knn_neighbors_plain(src.astype(np.float64),
                                        query.astype(np.float64), 4))
    _equal(got, jax_knn.cross_knn(src, query, 4))


@pytest.mark.parametrize("n,k", [(700, 6), (5000, 6), (400, 3)])
def test_guillard_matches_plain_and_jax(n, k, rng):
    senders, _, _ = knn.connect_knn(rng.random((n, 2)).astype(np.float32), k)
    got = coarsen.guillard_coarsening(senders, n, k)
    assert got.dtype == bool and got.shape == (n,) and 0 < got.sum() < n
    _equal(got, coarsen.guillard_coarsening_plain(senders, n, k))
    _equal(got, jax_coarsen.guillard_coarsening(senders, n, k))


def test_k_too_large_raises(rng):
    pos = rng.random((4, 2)).astype(np.float32)
    with pytest.raises(ValueError):
        knn.connect_knn(pos, k=6)
    x = pos.astype(np.float64)
    for fn in (knn.knn_neighbors, knn.knn_neighbors_plain):
        with pytest.raises(ValueError):
            fn(x, x, 4, exclude_self=True)
        fn(x, x, 4)                  # four points hold four neighbours
    with pytest.raises(ValueError):
        coarsen.guillard_coarsening(np.array([0, 5], np.int32), 2, 1)


def test_a_second_process_loads_the_cached_library():
    code = ("from graphs4cfd_tpu_torch import native; native.load(); "
            "print(native.build_info['built'], native.build_info['path'])")
    runs = [subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                           capture_output=True, text=True, timeout=120,
                           env={**os.environ, "PYTHONPATH": str(ROOT)})
            for _ in range(2)]
    assert all(r.returncode == 0 for r in runs), [r.stderr for r in runs]
    built, path = runs[1].stdout.split()
    assert built == "False"
    assert path == str(native.library_path())
    assert path.startswith(str(ROOT / "build" / "graphs4cfd_tpu_torch"))


def test_a_failed_build_raises_with_the_compiler_log(tmp_path, monkeypatch):
    bad = tmp_path / "graph_ops.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build()
    assert "error" in str(err.value)
    assert not list((tmp_path / "build").rglob("*.so"))


def test_threads_load_and_share_the_helper(rng, monkeypatch):
    """``DataLoader`` threads call the helper at once, the first of them
    while it loads: one library, and every thread's neighbours those of a
    call alone."""
    import threading
    from concurrent.futures import ThreadPoolExecutor
    clouds = [rng.random((n, 2)) for n in (300, 2200) * 6]
    want = [knn.knn_neighbors_plain(c, c, 6, True) for c in clouds]
    monkeypatch.setattr(native, "_lib", None)
    start = threading.Barrier(len(clouds), timeout=60)

    def run(c):
        start.wait()
        return native.load(), knn.knn_neighbors(c, c, 6, True)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with ThreadPoolExecutor(max_workers=len(clouds)) as pool:
            futures = [pool.submit(run, c) for c in clouds]
            got = [f.result(timeout=120) for f in futures]
    finally:
        sys.setswitchinterval(interval)
    assert len({id(lib) for lib, _ in got}) == 1
    for (_, g), w in zip(got, want):
        _equal(g, w)
