"""Fixtures of the benchmark's own tests: a copy of the benchmark in a
temporary directory with tiny cells added as files (16 wide, clouds of
300 nodes, batches of 2), which the port runs on the CPU through its
plain versions."""
from __future__ import annotations

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: (tiny cell, configuration, traffic mix, the cell whose limits and
#: metrics it takes, precision); the ``train32`` cells train in float32,
#: where the port's plain path matches the reference to rounding at any
#: width
TINY = (("tiny_mus3.train", "mus3", "train.bf16.b32", "mus3.train.bf16",
         "bf16"),
        ("tiny_remus3.train", "remus3", "train.bf16.b4", "remus3.train.bf16",
         "bf16"),
        ("tiny_mus3.train32", "mus3", "train.bf16.b32", "mus3.train.bf16",
         "f32"),
        ("tiny_remus3.train32", "remus3", "train.bf16.b4",
         "remus3.train.bf16", "f32"),
        ("tiny_mus3.rollout", "mus3", "rollout.f32.b16", "mus3.rollout.f32",
         "f32"),
        ("tiny_remus3.rollout", "remus3", "rollout.f32.b4",
         "remus3.rollout.f32", "f32"))


def _narrow(x, w):
    """A width of the published arch (a multiple of 128 plus a few input
    features) at ``w`` in place of 128."""
    if isinstance(x, list):
        return [_narrow(y, w) for y in x]
    if isinstance(x, int) and x >= 128:
        return x % 128 + w * (x // 128)
    return x


def add_tiny_cells(root: str, width: int = 16, nodes: int = 300):
    """Add the ``TINY`` cells to the benchmark copy at ``root`` as files
    and entries, the way a later change adds a cell."""
    path = os.path.join(root, "BENCHMARK.json")
    bench = json.load(open(path))
    here = os.path.join(root, "benchmark")
    for tiny, config, traffic, big, precision in TINY:
        conf = json.load(open(os.path.join(here, "configs", config + ".json")))
        conf["arch"] = {k: _narrow(v, width) for k, v in conf["arch"].items()}
        conf["n_nodes"] = nodes
        cname = "tiny_" + config
        json.dump(conf, open(os.path.join(here, "configs", cname + ".json"),
                             "w"))
        if cname not in {c["name"] for c in bench["configs"]}:
            bench["configs"].append({
                "name": cname, "source": "test", "reduced": [], "why": "test",
                "file": f"benchmark/configs/{cname}.json"})
        trf = json.load(open(os.path.join(here, "traffic", traffic + ".json")))
        trf.update(batch=2, pool=4, precision=precision)
        if trf["entry"] == "fit":
            trf["trace_batches"] = 1
        tname = f"tiny.{precision}.{traffic}"
        json.dump(trf, open(os.path.join(here, "traffic", tname + ".json"),
                            "w"))
        limits = json.load(open(os.path.join(here, "limits", big + ".json")))
        if trf["entry"] == "solve":
            # at 16 wide the TF32 control of a rollout drifts less than at
            # the published widths: its smallest reading over seeds 11-16
            # was 1.9e-4 against the program's largest 3.0e-6 (float32 on
            # the CPU), so the tiny cells' limit sits between those
            limits["rollout_gap"] = 2.5e-5
        json.dump(limits, open(os.path.join(here, "limits", tiny + ".json"),
                               "w"))
        bench["workloads"].append({"name": tiny, "config": cname,
                                   "traffic": tname, "chips": 1,
                                   "why": "test"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if big in m.get("workloads", ()):
                m["workloads"].append(tiny)
    json.dump(bench, open(path, "w"))


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bench"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    add_tiny_cells(root)
    return root


@pytest.fixture
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
