"""The PyTorch port stands alone: it and its scripts (``chip_smoke.py``,
``profile_torch_step.py``) import nothing of JAX or of the JAX package, a
small MuS ``solve``, a small training step, a small REMuS ``solve``, a
small REMuS training step, a small gMuS ``solve`` and a small gMuS
training step run with those imports made impossible, and
``chip_smoke.py`` refuses to run without CUDA.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "graphs4cfd_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "optax", "flax", "orbax", "graphs4cfd_tpu")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_imports_in_port_or_its_scripts():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                          ROOT / "profile_torch_step.py"]
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f))
                                            & set(FORBIDDEN))
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


_BLOCKED_SOLVE = r"""
import sys, importlib.abc
BLOCK = {"jax", "jaxlib", "optax", "flax", "orbax", "graphs4cfd_tpu"}

class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCK:
            raise ImportError(f"import of {name} refused")
        return None

for mod in [m for m in sys.modules if m.split(".")[0] in BLOCK]:
    del sys.modules[mod]
sys.meta_path.insert(0, Refuse())
try:
    import jax
except ImportError:
    pass
else:
    raise SystemExit("the import guard does not hold")

import numpy as np
import torch
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import collate
from graphs4cfd_tpu_torch.nn import NsThreeScaleGNN
from graphs4cfd_tpu_torch.ops import _build

rng = np.random.default_rng(0)
samples = []
for _ in range(2):
    g = Graph()
    g.pos = rng.random((150, 2)).astype(np.float32)
    g.field = rng.normal(size=(150, 3)).astype(np.float32)
    for t in (T.SpatialSort(), T.ConnectKNN(6), T.ScaleEdgeAttr(0.15),
              T.GridClustering([0.2, 0.4])):
        g = t(g)
    samples.append(g)
w = 16
mp = ((3 * w, (w, w), True), (2 * w, (w, w), True))
arch = {"edge_encoder": (2, (w, w), False), "node_encoder": (3, (w, w), False),
        "mp111": mp, "down_mp12": (2 + w, (w, w), True), "mp21": mp,
        "down_mp23": (2 + w, (w, w), True), "mp31": mp,
        "up_mp32": (2 + 2 * w, (w, w), True), "mp22": mp,
        "up_mp21": (2 + 2 * w, (w, w), True), "mp12": mp,
        "decoder": (w, (w, 3), False)}
model = NsThreeScaleGNN(arch=arch, device="cpu")
graph = Graph.from_numpy(collate(samples), "cpu")
#BODY
assert _build._lib is None            # nothing was built
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
print("RUN_OK")
"""

_SOLVE = """
out = model.solve(graph, 2)
assert out.shape[1] == 6 and bool(torch.isfinite(out).all())
"""

_TRAIN_STEP = """
from graphs4cfd_tpu_torch.nn import GraphLoss
from graphs4cfd_tpu_torch.training import adam_init, make_train_step
graph.target = torch.randn(graph.field.shape[0], 6)
before = [p.detach().clone() for p in model.parameters()]
state = adam_init(model.parameters())
step = make_train_step(model, GraphLoss(), 3, 2, 1.0)
loss, gnorm = step(state, graph, 1e-3)
assert bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm))
assert state.count == 2
assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))
"""


_REMUS_MODEL = """
from graphs4cfd_tpu_torch.nn import NsRotEquiThreeScaleGNN
samples = []
for _ in range(2):
    g = Graph()
    g.pos = rng.random((150, 2)).astype(np.float32)
    g.field = rng.normal(size=(150, 2)).astype(np.float32)
    g.glob = np.full((150, 1), 0.5, np.float32)
    g.omega = np.zeros((150, 1), np.float32)
    for t in (T.SpatialSort(), T.BuildRemusGraph(3, 5, scale_edge_length=(
            0.1, 0.2, 0.4)), T.BuildKnnInterpWeights(5)):
        g = t(g)
    samples.append(g)
emp = ((3 * w, (w, w), True), (2 * w, (w, w), True))
enc = lambda n: (n, (w, w), True)
arch = {"angle_encoder": enc(4), "angle_encoder12": enc(4),
        "angle_encoder2": enc(4), "angle_encoder23": enc(4),
        "angle_encoder3": enc(4), "edge_encoder": enc(3),
        "edge_encoder2": enc(3), "edge_encoder3": enc(3), "mp111": emp,
        "down_mp12": emp, "mp21": emp, "down_mp23": emp, "mp31": emp,
        "up_mp32": (2 * w, (w, w), True), "mp22": emp,
        "up_mp21": (2 * w, (w, w), True), "mp12": emp,
        "decoder": (w, (w, 1), False)}
remus = NsRotEquiThreeScaleGNN(arch=arch, device="cpu")
"""

_REMUS_SOLVE = _REMUS_MODEL + """
out = remus.solve(Graph.from_numpy(collate(samples), "cpu"), 2)
assert out.shape[1] == 4 and bool(torch.isfinite(out).all())
"""

_REMUS_TRAIN_STEP = _REMUS_MODEL + """
from graphs4cfd_tpu_torch.loader import attach_angle_sorts
from graphs4cfd_tpu_torch.nn import GraphLoss
from graphs4cfd_tpu_torch.training import adam_init, make_train_step
rgraph = Graph.from_numpy(attach_angle_sorts(collate(samples)), "cpu")
rgraph.target = torch.randn(rgraph.field.shape[0], 4)
before = [p.detach().clone() for p in remus.parameters()]
state = adam_init(remus.parameters())
step = make_train_step(remus, GraphLoss(), 2, 2, 1.0)
loss, gnorm = step(state, rgraph, 1e-3)
assert bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm))
assert state.count == 2
assert all(not torch.equal(a, b) for a, b in zip(before,
                                                 remus.parameters()))
"""


_GMUS_MODEL = """
from graphs4cfd_tpu_torch.loader import attach_sender_sorts
from graphs4cfd_tpu_torch.nn import NsThreeGuillardScaleGNN
samples = []
for _ in range(2):      # 400 nodes: level 3 keeps more than k of them
    g = Graph()
    g.pos = rng.random((400, 2)).astype(np.float32)
    g.field = rng.normal(size=(400, 3)).astype(np.float32)
    g.glob = np.full((400, 1), 0.5, np.float32)
    g.omega = np.zeros((400, 1), np.float32)
    for t in (T.SpatialSort(), T.GuillardCoarseningAndConnectKNN(
            [6, 6, 6], scale_edge_attr=(0.1, 0.25, 0.5)),
            T.BuildKnnInterpWeights(6)):
        g = t(g)
    samples.append(g)
up = ((5 * w, (w, w), True), (3 * w, (w, w), True))
enc = lambda n: (n, (w, w), False)
arch = {"edge_encoder": enc(2), "edge_encoder2": enc(2),
        "edge_encoder3": enc(2), "node_encoder": enc(5), "mp111": mp,
        "mp21": mp, "mp31": mp, "mp221": up, "mp121": up, "mp122": mp,
        "decoder": (w, (w, 3), False)}
gmus = NsThreeGuillardScaleGNN(arch=arch, device="cpu")
ggraph = Graph.from_numpy(attach_sender_sorts(collate(samples)), "cpu")
"""

_GMUS_SOLVE = _GMUS_MODEL + """
out = gmus.solve(ggraph, 2)
assert out.shape[1] == 6 and bool(torch.isfinite(out).all())
"""

_GMUS_TRAIN_STEP = _GMUS_MODEL + """
from graphs4cfd_tpu_torch.nn import GraphLoss
from graphs4cfd_tpu_torch.training import adam_init, make_train_step
ggraph.target = torch.randn(ggraph.field.shape[0], 6)
before = [p.detach().clone() for p in gmus.parameters()]
state = adam_init(gmus.parameters())
step = make_train_step(gmus, GraphLoss(), 3, 2, 1.0)
loss, gnorm = step(state, ggraph, 1e-3)
assert bool(torch.isfinite(loss)) and bool(torch.isfinite(gnorm))
assert state.count == 2
assert all(not torch.equal(a, b) for a, b in zip(before,
                                                 gmus.parameters()))
"""


def _run_blocked(body):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c",
                           _BLOCKED_SOLVE.replace("#BODY", body)], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RUN_OK" in proc.stdout


def test_solve_runs_with_jax_imports_refused():
    _run_blocked(_SOLVE)


def test_train_step_runs_with_jax_imports_refused():
    _run_blocked(_TRAIN_STEP)


def test_remus_solve_runs_with_jax_imports_refused():
    _run_blocked(_REMUS_SOLVE)


def test_remus_train_step_runs_with_jax_imports_refused():
    _run_blocked(_REMUS_TRAIN_STEP)


def test_gmus_solve_runs_with_jax_imports_refused():
    _run_blocked(_GMUS_SOLVE)


def test_gmus_train_step_runs_with_jax_imports_refused():
    _run_blocked(_GMUS_TRAIN_STEP)


def test_chip_smoke_refuses_without_cuda():
    """Here there is no CUDA: the script must fail and print no result."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_without_the_package(tmp_path):
    """In a directory that holds only the script, it must fail too."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
