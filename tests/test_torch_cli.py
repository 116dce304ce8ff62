"""``python -m graphs4cfd_tpu_torch`` in subprocesses, on the CPU.

* ``info`` exits 0, names the versions and says "no CUDA device" (a card
  is named with its compute capability), and loads the C++ helper; it
  also runs with every import of JAX and of the JAX package refused;
* ``convert`` of a reference-format ``.chk`` (the original graphs4cfd's
  one-scale model, built as ``tests/test_convert_checkpoint.py`` builds
  it) writes the arch and weights of the JAX package's
  ``convert_reference_checkpoint`` and prints what the JAX CLI prints;
* ``train`` runs a script as ``__main__`` with its own arguments;
* ``bench`` and ``scaling`` exit non-zero: the port has no benchmark yet.
"""
import contextlib
import io
import os
import subprocess
import sys
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch

from graphs4cfd_tpu import __main__ as jax_cli
from graphs4cfd_tpu.training.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from graphs4cfd_tpu_torch.nn.model import tree_leaves
from graphs4cfd_tpu_torch.training import load_checkpoint
from test_convert_checkpoint import RefOneScale

ROOT = Path(__file__).resolve().parent.parent
W = 16


def _cli(*args, cwd=ROOT, code=None):
    cmd = ([sys.executable, "-c", code] if code is not None
           else [sys.executable, "-m", "graphs4cfd_tpu_torch", *args])
    return subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                          timeout=300,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})


def test_info_names_the_versions_and_devices():
    out = _cli("info")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0] == "graphs4cfd_tpu_torch 0.1.0"
    assert lines[1].startswith(f"torch {torch.__version__}, CUDA ")
    if torch.cuda.is_available():
        assert torch.cuda.get_device_name(0) in out.stdout
        assert "CUDA kernels: " in out.stdout
    else:
        assert "no CUDA device" in out.stdout
        assert "CUDA kernels: " not in out.stdout
    assert any(line.startswith("C++ helper: ") and "libgraph_ops.so" in line
               for line in lines)


_BLOCKED_INFO = r"""
import importlib.abc, runpy, sys
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
sys.argv = ["graphs4cfd_tpu_torch", "info"]
runpy.run_module("graphs4cfd_tpu_torch", run_name="__main__")
assert not [m for m in sys.modules if m.split(".")[0] in BLOCK]
print("RUN_OK")
"""


def test_info_runs_with_the_jax_imports_refused():
    out = _cli(code=_BLOCKED_INFO)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines()[-1] == "RUN_OK"
    assert "C++ helper: " in out.stdout


def _one_scale_arch():
    return {"edge_encoder": (2, (W, W), False),
            "node_encoder": (5, (W, W), False),
            "mp111": ((W + 2 * W, (W, W), True), (W + W, (W, W), True)),
            "decoder": (W, (W, 1), False)}


def test_convert_gives_the_jax_converters_file_and_line(tmp_path):
    torch.manual_seed(0)
    src = tmp_path / "ref.chk"
    torch.save({"arch": _one_scale_arch(),
                "weights": RefOneScale(_one_scale_arch()).state_dict(),
                "optimiser": None, "n_out": 3, "lr": 5e-5, "epoch": 17},
               str(src))
    dst, jdst = tmp_path / "port.chk", tmp_path / "jax.chk"
    out = _cli("convert", str(src), str(dst))
    assert out.returncode == 0, out.stderr
    said = io.StringIO()
    with contextlib.redirect_stdout(said):
        jax_cli.cmd_convert(Namespace(src=str(src), dst=str(jdst)))
    assert out.stdout == said.getvalue().replace(str(jdst), str(dst))
    assert out.stdout.strip().endswith("(4 arch entries)")
    port, ref = load_checkpoint(str(dst)), jax_load_checkpoint(str(jdst))
    for key in ("arch", "n_out", "lr", "epoch", "optimiser"):
        assert port[key] == ref[key], key
    a, b = tree_leaves(port["weights"]), tree_leaves(ref["weights"])
    assert len(a) == len(b) == 24
    for x, y in zip(a, b):
        y = np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes()


def test_train_runs_a_script_with_its_arguments(tmp_path):
    script = tmp_path / "train_me.py"
    script.write_text("import sys\n"
                      "print('RAN', __name__, *sys.argv[1:])\n")
    out = _cli("train", str(script), "--epochs", "2", "data.h5",
               cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["RAN", "__main__", "--epochs", "2",
                                  "data.h5"]


def test_bench_and_scaling_exit_non_zero():
    for args in (("bench",), ("scaling",)):
        out = _cli(*args)
        assert out.returncode != 0, args
        assert "no benchmark script yet" in out.stderr, out.stderr
        assert not out.stdout
