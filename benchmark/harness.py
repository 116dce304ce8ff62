"""The benchmark of ``graphs4cfd_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything a run needs is found by name: the cell in ``BENCHMARK.json``,
its configuration in the file that ``configs`` names, its traffic mix in
``benchmark/traffic/<traffic>.json``, the limits of its comparison in
``benchmark/limits/<cell>.json``, the window loop in
``benchmark/entries/<entry>.py`` (the mix's ``entry``), and each per-layer
metric's reader in ``benchmark/metrics/<metric>.py``.  A cell, a mix, a
configuration or a metric is added by adding files.

A run: check the card; set up (inputs and weights from ``--seed``, the
program's graphs and model, its first steps or one request, which warm up
every kernel); the measured window of ``--seconds``; with ``--trace 1`` a
profiled segment after it; the program's state freed; the plain reference
(``benchmark/reference``) on what the window's path produced; then one
JSON line on stdout (the last), and the compared numbers with their
limits as the last lines of stderr.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: top-level module names that no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "graphs4cfd_tpu")
_PERF_OFFSET = time.time() - time.perf_counter()


class RunError(Exception):
    """A run that cannot give a result (no card, a missing file)."""


def process_start() -> float:
    """This process's start on the ``time.perf_counter`` clock (from
    ``/proc``; the harness's import time where that is not readable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK") - _PERF_OFFSET
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time() - _PERF_OFFSET


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One cell of ``BENCHMARK.json`` with everything found by its names."""
    spec: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list
    readers: dict


def _reader(path: str):
    spec = importlib.util.spec_from_file_location(
        "bench_metric_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve(name: str, root: str = ROOT, config: str = None,
            traffic: str = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` and its files under
    ``<root>/benchmark``.  A cell not yet there is resolved from the names
    of its ``config`` and ``traffic`` (its configuration in
    ``configs/<config>.json``), and may have no limits yet."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    here = os.path.join(root, "benchmark")
    if name in cells:
        cell = cells[name]
        conf_file = {c["name"]: c for c in bench["configs"]}[
            cell["config"]]["file"]
    elif config and traffic:
        cell = {"name": name, "config": config, "traffic": traffic,
                "chips": 1}
        conf_file = os.path.join("benchmark", "configs", config + ".json")
    else:
        raise RunError(f"no cell {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    limits = os.path.join(here, "limits", name + ".json")
    return Cell(
        spec=cell, config=load_json(os.path.join(root, conf_file)),
        traffic=load_json(os.path.join(here, "traffic",
                                       cell["traffic"] + ".json")),
        limits=load_json(limits) if name in cells or os.path.exists(limits)
        else {},
        end_to_end=e2e, per_layer=per_layer,
        readers={m["name"]: _reader(os.path.join(here, "metrics",
                                                 m["name"] + ".py"))
                 for m in per_layer})


@dataclass
class Ctx:
    """What an entry's ``run`` is given."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    started: float                      # process start, perf_counter clock

    @property
    def cuda(self) -> bool:
        return self.device.type == "cuda"

    def sync(self):
        if self.cuda:
            import torch
            torch.cuda.synchronize(self.device)

    def mark(self):
        """A point on the device's timeline: a recorded CUDA event (a host
        time off the card)."""
        if self.cuda:
            import torch
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def between_ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def reset_peak(self):
        if self.cuda:
            import torch
            torch.cuda.reset_peak_memory_stats(self.device)

    def peak_bytes(self) -> int:
        if self.cuda:
            import torch
            return int(torch.cuda.max_memory_allocated(self.device))
        return 0


@dataclass
class Outcome:
    """What an entry's ``run`` returns."""
    values: dict                        # end-to-end metric -> value
    attempted: int
    failed: int
    numbers: dict                       # compared-number name -> value
    window: dict = field(default_factory=dict)
    trace: object = None                # trace.Trace of the profiled segment
    traced: dict = field(default_factory=dict)
    peak_bytes: int = 0


def require_cuda(chips: int):
    import torch
    if not torch.cuda.is_available():
        raise RunError("no CUDA card: the benchmark measures the card and "
                       "has no CPU mode")
    if torch.cuda.device_count() < chips:
        raise RunError(f"the cell asks for {chips} cards, "
                       f"{torch.cuda.device_count()} are visible")
    return torch.device("cuda", 0)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def free_memory():
    gc.collect()
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def judge(numbers: dict, limits: dict):
    """``(correct, {name: {"value", "limit"}})``: every number the limits
    name is finite and at most its limit."""
    checks, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and math.isfinite(value) and value <= limit
        ok = ok and good
        checks[name] = {"value": value if good or value is None
                        or math.isfinite(value) else str(value),
                        "limit": limit}
    return ok, checks


def run(argv=None, device=None, root: str = ROOT) -> dict:
    """One run; returns the result's line as a dict.  ``device`` skips the
    look for a card (tests give the CPU)."""
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = resolve(args.workload, root)
    import torch
    if device is None:
        device = require_cuda(int(cell.spec["chips"]))
        torch.cuda.set_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    entry = importlib.import_module(f"benchmark.entries.{cell.traffic['entry']}")
    ctx = Ctx(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace), device=torch.device(device),
              started=started)
    out = entry.run(ctx)
    correct, checks = judge(out.numbers, cell.limits)
    print("compared: " + json.dumps(out.numbers), file=sys.stderr)
    units = {m["name"]: m["unit"] for m in cell.end_to_end + cell.per_layer}
    if args.trace:
        values = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](out)
            if v is not None:
                values[m["name"]] = v
    else:
        values = {m["name"]: out.values[m["name"]] for m in cell.end_to_end}
    result = {"correct": bool(correct) and out.failed == 0,
              "attempted": out.attempted, "failed": out.failed,
              "metrics": {k: {"value": v, "unit": units[k]}
                          for k, v in values.items()},
              "device": device_info(ctx, out)}
    if args.trace and out.trace is not None:
        from . import trace as tr
        result["breakdown"] = {"device_ops": tr.top_device_ops(out.trace),
                               "idle_gaps": tr.idle_gaps(out.trace)}
    result["checks"] = checks
    return result


def device_info(ctx: Ctx, out: Outcome) -> dict:
    import torch
    info = {"platform": "gpu" if ctx.cuda else ctx.device.type,
            "kind": (torch.cuda.get_device_name(ctx.device) if ctx.cuda
                     else "cpu"),
            "count": 1, "memory_peak_bytes": out.peak_bytes}
    if ctx.trace and out.trace is not None:
        info["busy_s"] = out.trace.union_s()
        info["window_s"] = out.trace.wall_s
    return info


def main(argv=None) -> int:
    try:
        result = run(argv)
    except RunError as exc:
        print(f"benchmark: {exc}", file=sys.stderr)
        return 2
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; the port's "
              "benchmark may load no JAX module", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
