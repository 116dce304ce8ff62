"""The window loops on the CPU at tiny sizes (the port's plain path): they
count work as the metrics define it, the readers read what they say, and
a run whose timed path is broken underneath comes out not correct."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness, readers, trace

from .conftest import TINY

ARGS = ["--seed", "2147483999", "--seconds", "2", "--trace"]


def run(root, cell, traced=0):
    return harness.run(["--workload", cell, *ARGS, str(traced)],
                       device="cpu", root=root)


def outcome(root, cell):
    """The entry's ``Outcome`` of a two-second window."""
    import importlib
    c = harness.resolve(cell, root)
    ctx = harness.Ctx(cell=c, seed=7, seconds=2, trace=False,
                      device=torch.device("cpu"), started=0.0)
    entry = importlib.import_module(f"benchmark.entries.{c.traffic['entry']}")
    return c, entry.run(ctx)


@pytest.mark.parametrize("cell,edges", [
    ("tiny_mus3.train32", 2 * 300 * 6), ("tiny_remus3.train32", 2 * 300 * 5),
    ("tiny_mus3.rollout", 2 * 300 * 6), ("tiny_remus3.rollout", 2 * 300 * 5)])
def test_the_window_counts_its_work(tiny_root, cell, edges, few_threads):
    c, out = outcome(tiny_root, cell)
    n_out = c.traffic["n_out"]
    rate = out.values.get("train_edges_per_s",
                          out.values.get("rollout_edges_per_s"))
    assert out.attempted >= 1 and out.failed == 0
    assert rate * out.window["seconds"] == pytest.approx(
        out.attempted * edges * n_out)
    assert out.window["steps"] == out.attempted * n_out
    assert out.window["seconds"] >= 2.0
    assert out.values["setup_s"] > 0
    if "loader_ms" in out.window:
        assert len(out.window["loader_ms"]) == out.attempted
        assert len(out.window["batch_ms"]) == out.attempted
    assert readers.mfu(out) > 0
    assert readers.launches_per_step(out) == 0   # plain path: no kernel
    assert all(v < 1e-3 for v in out.numbers.values()
               if not isinstance(v, float) or v == v), out.numbers


@pytest.mark.parametrize("cell", [t for t, *_, p in TINY if p == "f32"])
def test_a_sound_run_is_correct_and_has_every_key(tiny_root, cell,
                                                  few_threads):
    res = run(tiny_root, cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(res)
    assert "setup_s" in res["metrics"] and len(res["metrics"]) == 3
    res = run(tiny_root, cell, traced=1)
    assert res["correct"] and "busy_s" in res["device"]
    assert "breakdown" in res and "setup_s" not in res["metrics"]


def _keep_half(monkeypatch):
    from graphs4cfd_tpu_torch.nn import losses
    terms = losses.GraphLoss.local_terms

    def half(self, graph, pred, target):
        keep = graph.batch < graph.num_graphs // 2
        return terms(self, graph.replace(node_mask=graph.node_mask & keep),
                     pred, target)
    monkeypatch.setattr(losses.GraphLoss, "local_terms", half)


def _state_unchanged(monkeypatch):
    from graphs4cfd_tpu_torch.training import trainer
    monkeypatch.setattr(trainer, "adam_update_", lambda *a, **k: None)


def _answer_altered(monkeypatch):
    from graphs4cfd_tpu_torch import nn as PN
    for cls in (PN.MuSGNN, PN.REMuSGNN):
        fwd = cls.forward

        def altered(self, graph, fwd=fwd):
            out = fwd(self, graph).clone()
            out[0] += 1.0
            return out
        monkeypatch.setattr(cls, "forward", altered)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_mus3.train32", _state_unchanged),
    ("tiny_remus3.train32", _state_unchanged),
    ("tiny_mus3.train32", _keep_half), ("tiny_remus3.train32", _keep_half),
    ("tiny_mus3.rollout", _answer_altered),
    ("tiny_remus3.rollout", _answer_altered)])
def test_a_broken_timed_path_is_not_correct(tiny_root, cell, fault,
                                            monkeypatch, few_threads):
    fault(monkeypatch)
    assert not run(tiny_root, cell)["correct"]


def test_the_readers_read_a_trace():
    tr = trace.Trace(wall_s=125e-6)
    port = "void g4c::gn::gn_block_kernel<float>(int)"
    tr.device = [(port, 0.0, 40.0), ("at::native::vectorized", 50.0, 10.0),
                 ("Memcpy HtoD", 60.0, 20.0), (port, 92.0, 10.0)]
    tr.kernels = [tr.device[0], tr.device[1], tr.device[3]]
    tr.ranges = [("host_to_device", 55.0, 30.0), ("train_step", 0.0, 55.0)]
    tr.host_ops = [("aten::copy_", 56.0, 28.0)]
    out = harness.Outcome(values={}, attempted=1, failed=0, numbers={},
                          window={"kernel_names": ["gn_block_kernel"],
                                  "steps": 4, "launches": 12, "seconds": 2.0,
                                  "model_flops": 2 * 495e12 * 0.01,
                                  "precision": "f32", "loader_ms": [1, 3],
                                  "batch_ms": list(range(1, 11))},
                          trace=tr, traced={"steps": 2, "work_s": 25e-6})
    assert tr.union_s() == pytest.approx(80e-6)
    assert readers.idle_share(out) == pytest.approx(100 * 45 / 125)
    assert readers.kernel_roofline(out) == pytest.approx(50.0)
    assert readers.plain_torch_ms(out) == pytest.approx(0.005)
    assert readers.h2d_ms(out) == pytest.approx(0.03)
    assert readers.launches_per_step(out) == 3
    assert readers.loader_ms(out) == 2
    assert readers.mfu(out) == pytest.approx(1.0)
    assert readers.batch_p90_ms(out) == pytest.approx(
        np.percentile(range(1, 11), 90, method="weibull"))
    assert trace.idle_gaps(tr) == [
        ["aten::copy_ in host_to_device", pytest.approx(12e-6)],
        ["python in train_step", pytest.approx(10e-6)]]
    assert trace.top_device_ops(tr)[0] == ["g4c::gn::gn_block_kernel",
                                           pytest.approx(50e-6)]
