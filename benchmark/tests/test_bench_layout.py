"""Every cell of ``BENCHMARK.json`` is found by its names, a cell added as
files is found with no code edit, and the file keeps to the benchmark's
contract."""
from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from benchmark import counts, harness, reference, weights

from .conftest import ROOT, TINY

BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves_by_file_name(cell):
    c = harness.resolve(cell)
    importlib.import_module(f"benchmark.entries.{c.traffic['entry']}")
    reference.family(c.config["family"])
    counts.family(c.config["family"])
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer and all(m["moves"] in reported for m in c.per_layer)
    assert set(c.readers) == {m["name"] for m in c.per_layer}
    assert c.limits and all(v > 0 for v in c.limits.values())


def test_a_cell_added_as_files_is_found(tiny_root):
    for tiny, *_ in TINY:
        c = harness.resolve(tiny, tiny_root)
        assert c.config["n_nodes"] == 300 and c.traffic["batch"] == 2
        assert c.per_layer and set(c.readers) == {m["name"]
                                                  for m in c.per_layer}


def test_a_cell_not_yet_listed_resolves_from_its_names(tiny_root):
    c = harness.resolve("tiny_mus3.unlisted", tiny_root, "tiny_mus3",
                        "tiny.f32.rollout.f32.b16")
    assert c.config["n_nodes"] == 300 and c.traffic["entry"] == "solve"
    assert c.limits == {} and c.per_layer == []
    with pytest.raises(harness.RunError):
        harness.resolve("tiny_mus3.unlisted", tiny_root)


def test_the_file_keeps_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert 2 + 14 * 24 * (rs + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names)
    for k in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("benchmark/")
        assert not c["reduced"] and 1 <= len(c["why"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            assert cell in m["workloads"] and cell in CELLS
            assert cell in e2e[m["moves"]].get("workloads", [cell])
    assert len(json.dumps(BENCH)) < 64 * 1024


def _published_arch(script):
    src = open(os.path.join(ROOT, script)).read()
    i = src.index("arch = {")
    # the published dict's widths are sums such as 128+2*128
    return eval(src[i + len("arch = "):src.index("}\n", i) + 1],
                {"__builtins__": {}})


@pytest.mark.parametrize("config,script", [
    ("mus3", "examples/training/NsMuSGNN/NsThreeScaleGNN.py"),
    ("remus3", "examples/training/NsREMuSGNN/NsRotEquiThreeScaleGNN.py")])
def test_the_configurations_are_the_published_archs(config, script):
    conf = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                       config + ".json")))
    pub = json.loads(json.dumps(_published_arch(script)))
    assert conf["arch"] == pub and list(conf["arch"]) == list(pub)
    import math
    assert sum(math.prod(s) for _, s, _, _ in weights.layout(
        conf["arch"])) == conf["parameters"]
