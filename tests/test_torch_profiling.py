"""The port's profiling module and ``fit``'s ranges against the JAX
package's, on the CPU.

* ``trace_annotation`` ranges land in a ``start_trace``/``stop_trace``
  trace (device ``cpu``), nested as written; an exception raised inside a
  range comes out as itself, traced or not;
* ``start_trace("cuda")`` without a card, a second ``start_trace`` and a
  ``stop_trace`` without a session raise;
* ``sync``, ``Timer`` and ``EdgeRateMeter`` give the JAX module's numbers
  on the same trees and updates;
* a 1-epoch ``fit`` of a small MuS (2 MP layers, 16 wide) over 2 batches
  holds one ``host_to_device`` and one ``train_step`` range per step, and
  gives the same losses, records and weights, bit for bit, traced and
  untraced;
* ``config.fast_path_report`` reports the nonzero launch counters sorted
  by name, then zeroes them with ``reset=True``; the port reads no
  ``GRAPHS4CFD_*`` switch of the JAX config.
"""
import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from graphs4cfd_tpu.utils import profiling as jax_profiling
from graphs4cfd_tpu_torch import config, ops
from graphs4cfd_tpu_torch.loader import DataLoader
from graphs4cfd_tpu_torch.nn import GraphLoss, MuSGNN, TrainConfig
from graphs4cfd_tpu_torch.utils import profiling
from test_torch_host import port_samples

PORT = Path(__file__).resolve().parent.parent / "graphs4cfd_tpu_torch"
W = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ranges(path, names):
    """The trace's ``user_annotation`` events whose name is in ``names``."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    return [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") in names]


def test_ranges_land_in_a_cpu_trace(tmp_path):
    profiling.start_trace(str(tmp_path), device="cpu")
    try:
        with profiling.trace_annotation("outer"):
            with profiling.trace_annotation("inner"):
                torch.randn(64, 64) @ torch.randn(64, 64)
            with profiling.trace_annotation("inner"):
                torch.randn(8)
    finally:
        path = profiling.stop_trace()
    assert Path(path).parent == tmp_path
    assert path.endswith(".pt.trace.json")
    got = _ranges(path, {"outer", "inner"})
    assert sorted(e["name"] for e in got) == ["inner", "inner", "outer"]
    (outer,) = [e for e in got if e["name"] == "outer"]
    for e in got:
        assert outer["ts"] <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"]


class Boom(Exception):
    pass


@pytest.mark.parametrize("traced", [False, True])
def test_an_exception_inside_a_range_propagates_as_itself(tmp_path, traced):
    err = Boom("inside the range")
    if traced:
        profiling.start_trace(str(tmp_path), device="cpu")
    try:
        with pytest.raises(Boom) as caught:
            with profiling.trace_annotation("failing"):
                raise err
    finally:
        if traced:
            assert _ranges(profiling.stop_trace(), {"failing"})
    assert caught.value is err


def test_trace_sessions_refuse_what_they_cannot_do(tmp_path):
    with pytest.raises(RuntimeError, match="no trace is running"):
        profiling.stop_trace()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            profiling.start_trace(str(tmp_path))
    profiling.start_trace(str(tmp_path), device="cpu")
    try:
        with pytest.raises(RuntimeError, match="already running"):
            profiling.start_trace(str(tmp_path), device="cpu")
    finally:
        profiling.stop_trace()
    with pytest.raises(ValueError, match="unsupported device"):
        profiling.start_trace(str(tmp_path), device="meta")


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_torch(v) for v in tree)
    return torch.from_numpy(tree) if isinstance(tree, np.ndarray) else tree


def test_sync_timer_and_meter_match_jax(monkeypatch):
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=5).astype(np.float32)
    for tree in ({"b": b, "a": a}, [None, (b, a)], a,
                 {"z": [a], "c": None, "d": b}):
        want = jax_profiling.sync(tree)
        assert profiling.sync(_to_torch(tree)) == want
        assert profiling.sync(tree) == want
    assert profiling.sync(torch.tensor([2.5], dtype=torch.bfloat16)) == 2.5

    # Timer: the same clock readings give the same elapsed seconds
    for timer, value in ((profiling.Timer(), torch.ones(2)),
                         (jax_profiling.Timer(), np.ones(2))):
        ticks = iter([100.0, 100.75, 200.0, 203.5])
        monkeypatch.setattr(time, "time", lambda: next(ticks))
        assert timer.start().stop() == 0.75
        assert timer.start().stop(value) == 3.5 and timer.elapsed == 3.5
        monkeypatch.undo()

    port, ref = profiling.EdgeRateMeter(), jax_profiling.EdgeRateMeter()
    assert port.rate == ref.rate == 0.0
    for edges, secs in ((242688, 0.0731), (242688, 0.0), (14336, 1e-3)):
        port.update(edges, secs)
        ref.update(edges, secs)
        assert (port.edges, port.seconds, port.rate) == (ref.edges,
                                                         ref.seconds,
                                                         ref.rate)


def _one_scale_arch(w=W, nf=3, n_in=5):
    mp = ((3 * w, (w, w), True), (2 * w, (w, w), True))
    return {"edge_encoder": (2, (w, w), False),
            "node_encoder": (n_in, (w, w), False),
            "mp111": mp, "mp112": mp, "decoder": (w, (w, nf), False)}


def _fit(samples, folder, name):
    model = MuSGNN(arch=_one_scale_arch(), seed=3, device="cpu")
    cfg = TrainConfig(name, folder=str(folder), lr=1e-3, epochs=1,
                      training_loss=GraphLoss(0.25), num_steps=[2],
                      grad_clip={"epoch": 0, "limit": 1.0})
    loader = DataLoader(samples, batch_size=2, shuffle=True, seed=0,
                        node_bucket=64, edge_bucket=128)
    return model, model.fit(cfg, loader)


def test_fit_ranges_once_per_step_and_the_same_bits(tmp_path):
    samples = port_samples(4, 120, seed=2)
    bare, bare_history = _fit(samples, tmp_path, "bare")
    profiling.start_trace(str(tmp_path / "trace"), device="cpu")
    try:
        traced, history = _fit(samples, tmp_path, "traced")
    finally:
        path = profiling.stop_trace()
    (record,) = history
    assert record["steps"] == 2
    names = sorted(e["name"] for e in _ranges(path, {"host_to_device",
                                                     "train_step"}))
    assert names == ["host_to_device"] * 2 + ["train_step"] * 2
    # the copy of a batch ends before its step starts
    ranges = sorted(_ranges(path, {"host_to_device", "train_step"}),
                    key=lambda e: e["ts"])
    assert [e["name"] for e in ranges] == ["host_to_device", "train_step"] * 2
    for a, b in zip(ranges, ranges[1:]):
        assert a["ts"] + a["dur"] <= b["ts"]
    for key in ("train_loss", "grad_norm", "n_out", "lr", "steps",
                "launches"):
        assert record[key] == bare_history[0][key], key
    assert np.isfinite(record["train_loss"])
    for a, b in zip(bare.parameters(), traced.parameters()):
        assert torch.equal(a, b)


def test_fast_path_report_reports_then_zeroes():
    counters = ops.launch_counters()
    saved = {k: fn.launches for k, fn in counters.items()}
    try:
        for fn in counters.values():
            fn.launches = 0
        assert config.fast_path_report() == {}
        counters["sorted_segment_sum"].launches = 4
        counters["gn_block_bf16"].launches = 2
        counters["mlp_chain"].launches = 7
        want = {"gn_block_bf16": 2, "mlp_chain": 7, "sorted_segment_sum": 4}
        got = config.fast_path_report()
        assert got == want and list(got) == sorted(want)
        assert config.fast_path_report(reset=True) == want
        assert set(ops.launch_counts().values()) == {0}
        assert config.fast_path_report() == {}
    finally:
        for k, fn in counters.items():
            fn.launches = saved[k]


def _docstrings(tree):
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.FunctionDef, ast.ClassDef,
                             ast.AsyncFunctionDef)):
            doc = node.body[0] if node.body else None
            if isinstance(doc, ast.Expr) and isinstance(doc.value,
                                                        ast.Constant):
                yield id(doc.value)


def test_port_reads_no_switch_of_the_jax_config():
    """``GRAPHS4CFD_ABLATE`` and ``GRAPHS4CFD_USE_PALLAS`` steer the JAX
    package's routes; no string of the port's code names them (its
    docstrings may)."""
    found = []
    for f in sorted(PORT.rglob("*.py")):
        tree = ast.parse(f.read_text())
        docs = set(_docstrings(tree))
        for node in ast.walk(tree):
            if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                    and id(node) not in docs
                    and ("GRAPHS4CFD_ABLATE" in node.value
                         or "GRAPHS4CFD_USE_PALLAS" in node.value)):
                found.append(f"{f.name}:{node.lineno}")
    assert not found


def test_the_card_phase_names_every_wrapper_by_its_global_function():
    """``ops.kernel_names()`` (the trace's kernel names per wrapper, which
    the card's profiling phase reads) covers every launch counter and names
    a ``__global__`` function of ``csrc/``."""
    import re
    import chip_smoke
    csrc = PORT / "csrc"
    text = "".join(f.read_text() for f in sorted(csrc.glob("*.cu")))
    globals_ = set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
        text))
    assert "gn_block_kernel" in globals_
    names = ops.kernel_names()
    assert set(names) == set(ops.launch_counters())
    assert set(names.values()) <= globals_
    assert set(chip_smoke.TRACE_MUST) <= set(names)
