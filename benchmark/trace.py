"""The profiled segment of a ``--trace 1`` run, and what is read from it.

``profile(fn)`` runs ``fn`` under ``torch.profiler`` (host and CUDA
activities), synchronises, writes the Chrome trace under ``TMPDIR``,
reads it back and deletes it.  The ``Trace`` it returns holds the device
intervals (kernels, copies, sets), the host ranges (``record_function``:
the program's ``host_to_device`` and ``train_step``, the harness's
``harness.*``) and host operations, on one clock, and the host's wall
time of the segment.
"""
from __future__ import annotations

import bisect
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start_us, dur_us)
    kernels: list = field(default_factory=list)  # the device's kernels
    ranges: list = field(default_factory=list)   # (name, start_us, dur_us)
    host_ops: list = field(default_factory=list)
    wall_s: float = 0.0

    def union_s(self) -> float:
        """Seconds in which some device operation ran."""
        return sum(b - a for a, b in merged(self.device)) * 1e-6

    def device_s(self, pick) -> float:
        """Device seconds of the kernels whose names ``pick`` accepts."""
        return sum(d for n, _, d in self.kernels if pick(n)) * 1e-6

    def range_ms(self, name: str):
        """Mean ms of the host ranges called ``name`` (None if none)."""
        durs = [d for n, _, d in self.ranges if n == name]
        return sum(durs) / len(durs) * 1e-3 if durs else None


def merged(intervals):
    """The union of ``(name, start, dur)`` intervals as sorted ``(a, b)``."""
    out = []
    for _, s, d in sorted(intervals, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], s + d)
        else:
            out.append([s, s + d])
    return out


def profile(fn, sync) -> Trace:
    """Run ``fn()`` under the profiler; ``sync()`` waits for the device."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    folder = tempfile.mkdtemp(prefix="bench_trace_")
    try:
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            sync()
            wall = time.perf_counter() - t0
        path = os.path.join(folder, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    tr = Trace(wall_s=wall)
    for ev in events.get("traceEvents", events) if isinstance(events, dict) \
            else events:
        if ev.get("ph") != "X":
            continue
        item = (ev.get("name", ""), float(ev["ts"]), float(ev.get("dur", 0)))
        cat = ev.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device.append(item)
            if cat == "kernel":
                tr.kernels.append(item)
        elif cat == "user_annotation":
            tr.ranges.append(item)
        elif cat in ("cpu_op", "cuda_runtime"):
            tr.host_ops.append(item)
    return tr


def _index(events):
    """Events sorted by start, with their starts, for ``_cover``."""
    ev = sorted(events, key=lambda x: x[1])
    return ev, [e[1] for e in ev]


def _cover(index, t, depth: int = 256):
    """The name of the latest-starting event that is open at ``t`` (the
    innermost of nested ones), looking back ``depth`` events."""
    ev, starts = index
    i = bisect.bisect_right(starts, t)
    for name, s, d in reversed(ev[max(0, i - depth):i]):
        if s + d >= t:
            return name
    return None


def short(name: str, width: int = 96) -> str:
    """A kernel's name without its template arguments and parameters."""
    for cut in ("<", "("):
        if cut in name:
            name = name[:name.index(cut)]
    return name.replace("void ", "")[:width]


def top_device_ops(tr: Trace, n: int = 10):
    """The ``n`` device operations (by short name) that took most time."""
    tot = {}
    for name, _, d in tr.device:
        key = short(name)
        tot[key] = tot.get(key, 0.0) + d * 1e-6
    return sorted(([k, v] for k, v in tot.items()),
                  key=lambda kv: -kv[1])[:n]


def idle_gaps(tr: Trace, n: int = 10):
    """The device's idle time between its first and last operation of the
    segment, summed by what the host was doing when each gap began: the
    innermost host operation or runtime call open then (or "python"), in
    the innermost host range open then (or "no range")."""
    busy = merged(tr.device)
    if not busy:
        return []
    gaps = [(a[1], b[0]) for a, b in zip(busy[:-1], busy[1:]) if b[0] > a[1]]

    ranges, ops = _index(tr.ranges), _index(tr.host_ops)

    def label(t):
        return (f"{_cover(ops, t) or 'python'} in "
                f"{_cover(ranges, t) or 'no range'}")

    tot = {}
    for a, b in gaps:
        key = label(a)
        tot[key] = tot.get(key, 0.0) + (b - a) * 1e-6
    return sorted(([k, v] for k, v in tot.items()),
                  key=lambda kv: -kv[1])[:n]
