"""The benchmark loads no JAX: every module under ``benchmark/`` is
walked with ``ast`` and each import's top-level name (the part before the
first dot) is compared whole against the JAX package's and its
libraries' names, so ``graphs4cfd_tpu_torch`` passes and
``graphs4cfd_tpu`` does not.  The reference imports nothing of the
program; nothing reads the JAX benchmark's files; ``run.py`` gives no
result without a card."""
from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest

from .conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "optax", "flax", "graphs4cfd_tpu",
             "__graft_entry__", "bench"}
PROGRAM = {"graphs4cfd_tpu_torch", "chip_smoke"}


def modules(folder):
    for dirpath, _, files in os.walk(folder):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_check_compares_whole_top_level_names():
    assert "graphs4cfd_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "graphs4cfd_tpu.nn".split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", list(modules(BENCH)),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for path in modules(os.path.join(BENCH, "reference")):
        assert not set(top_level_imports(path)) & PROGRAM, path


def test_nothing_reads_the_jax_benchmark_files():
    for path in modules(BENCH):
        if os.path.dirname(path) == os.path.join(BENCH, "tests"):
            continue
        text = open(path).read()
        for name in ("BENCH_r", "BASELINE.", "MULTICHIP_", "bench.py"):
            assert name not in text, (path, name)


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "mus3.train.bf16",
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def _no_result(proc):
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    try:
        json.loads(last)
    except ValueError:
        return True
    return False


def test_run_gives_no_result_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = _run(ROOT, env)
    assert proc.returncode != 0 and _no_result(proc)


def test_run_gives_no_result_without_the_program(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-c", "import sys; sys.path.insert(0, '.');"
         "from benchmark import harness; sys.exit(harness.main())",
         "--workload", "mus3.train.bf16", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=""))
    assert proc.returncode != 0 and _no_result(proc)


def test_a_run_that_loaded_jax_names_it_and_gives_no_result(monkeypatch,
                                                           capsys):
    from benchmark import harness
    monkeypatch.setitem(sys.modules, "jax", sys)
    monkeypatch.setattr(harness, "run", lambda argv=None: {"checks": {}})
    assert harness.main([]) != 0
    out, err = capsys.readouterr()
    assert "jax" in err and _no_result(subprocess.CompletedProcess(
        [], 0, out, err))
