"""The port's ``plot`` against the JAX package's, on the CPU (Agg).

* the triangulations (``triang_boundary_mask`` with an int and a list
  ``boundary_idx``, ``triang_small_tri_mask`` with and without ``box``):
  triangles and masks equal to the JAX module's, from tensors;
* each renderer writes a PNG from a CPU f32 tensor and from a bf16 tensor
  that requires grad, and closes its figures;
* ``import graphs4cfd_tpu_torch.plot`` imports no matplotlib, and without
  matplotlib a call raises ``ModuleNotFoundError`` naming it.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from graphs4cfd_tpu import plot as jax_plot  # noqa: E402
from graphs4cfd_tpu_torch import plot  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def mesh():
    rng = np.random.default_rng(7)
    pos = rng.random((120, 2)).astype(np.float32)
    u = (np.sin(4 * pos[:, 0]) * np.cos(3 * pos[:, 1])).astype(np.float32)
    # a disc of boundary 4 inside and a strip of boundary 2 on the left:
    # triangles with all three corners on one of them
    bound = np.zeros(120, np.uint8)
    bound[np.hypot(pos[:, 0] - 0.5, pos[:, 1] - 0.5) < 0.25] = 4
    bound[pos[:, 0] < 0.2] = 2
    return pos, u, bound


def _same_triangulation(a, b):
    assert a.triangles.tobytes() == b.triangles.tobytes()
    ma, mb = a.mask, b.mask
    assert (ma is None) == (mb is None)
    if ma is not None:
        assert ma.dtype == mb.dtype and ma.tobytes() == mb.tobytes()
        assert ma.any()


@pytest.mark.parametrize("boundary_idx", [None, 4, [4, 2]])
def test_boundary_mask_matches_jax(mesh, boundary_idx):
    pos, _, bound = mesh
    got = plot.triang_boundary_mask(torch.from_numpy(pos),
                                    torch.from_numpy(bound), boundary_idx)
    want = jax_plot.triang_boundary_mask(pos, bound, boundary_idx)
    _same_triangulation(got, want)


@pytest.mark.parametrize("box", [None, [0.2, 0.8, 0.1, 0.9]])
def test_small_triangle_mask_matches_jax(mesh, box):
    pos = mesh[0]
    got = plot.triang_small_tri_mask(torch.from_numpy(pos), 1.5, box=box)
    want = jax_plot.triang_small_tri_mask(pos, 1.5, box=box)
    _same_triangulation(got, want)
    plain = plot._triangulation(torch.from_numpy(pos), None, None, None,
                                None)
    assert plain.mask is None
    assert plain.triangles.tobytes() == got.triangles.tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_renderers_write_pngs_and_close_their_figures(mesh, tmp_path,
                                                      dtype):
    pos, u, bound = mesh
    tpos = torch.from_numpy(pos)
    tu = torch.from_numpy(u).to(dtype).requires_grad_()
    frames = torch.stack([tu, 2 * tu, tu - 1], dim=1)        # [V, 3]
    calls = {
        "pos": lambda f: plot.pos(tpos, file=f, show=False),
        "pos_field": lambda f: plot.pos_field(tpos, tu, file=f, show=False),
        "field": lambda f: plot.field(tpos, tu, file=f, show=False,
                                      bound=torch.from_numpy(bound)),
        "field_tri_ratio": lambda f: plot.field(tpos, tu, file=f, show=False,
                                                tri_ratio=2.0),
        "compare_fields": lambda f: plot.compare_fields(
            tpos, frames, frames + 0.1, file=f, show=False),
    }
    for name, call in calls.items():
        path = tmp_path / f"{name}.png"
        call(str(path))
        assert path.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n", name
        assert plt.get_fignums() == [], name


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_import_needs_no_matplotlib_and_a_call_names_it():
    assert _run("import sys, graphs4cfd_tpu_torch as gfd; "
                "m = gfd.plot; print(m.__name__, "
                "any(k.startswith('matplotlib') for k in sys.modules))"
                ).split() == ["graphs4cfd_tpu_torch.plot", "False"]
    code = r"""
import importlib.abc, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] == "matplotlib":
            raise ModuleNotFoundError(f"No module named {name!r}",
                                      name=name)
        return None
sys.meta_path.insert(0, Refuse())
import torch
from graphs4cfd_tpu_torch import plot
x = torch.zeros(10, 2)
try:
    plot.compare_fields(x, x, x, show=False)
except ModuleNotFoundError as err:
    print("REFUSED", err.name)
"""
    assert _run(code).split() == ["REFUSED", "matplotlib"]
