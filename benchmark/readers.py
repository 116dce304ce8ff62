"""What the per-layer metrics' readers (``metrics/<name>.py``) compute from
a run's ``harness.Outcome``: its window's counters (``window``) and, in a
``--trace 1`` run, the profiled segment (``trace``, ``traced``).  Each
returns None where the run has nothing to read (no segment, no range)."""
from __future__ import annotations

import statistics

from . import counts


def _port(names):
    """Does a device kernel's name belong to the port's library: one of
    its ``__global__`` functions (``ops.kernel_names``), or anything else
    in its namespace ``g4c`` (the backwards' reductions and bounds
    passes)?"""
    return lambda n: "g4c::" in n or any(k in n for k in names)


def loader_ms(out):
    """Mean host ms of the loader's ``next()`` per batch (collation)."""
    v = out.window.get("loader_ms")
    return statistics.fmean(v) if v else None


def batch_p90_ms(out):
    """The 90th percentile of the intervals between the device marks
    recorded each time ``fit`` asks for a batch."""
    v = out.window.get("batch_ms")
    if not v:
        return None
    return statistics.quantiles(v, n=10)[-1] if len(v) > 1 else v[0]


def h2d_ms(out):
    """Mean ms of ``fit``'s ``host_to_device`` range in the segment."""
    return None if out.trace is None else out.trace.range_ms(
        "host_to_device")


def launches_per_step(out):
    """Kernel launches the port counted in the window, per rollout step."""
    steps = out.window.get("steps")
    return out.window["launches"] / steps if steps else None


def kernel_roofline(out):
    """The least time of the work the port's kernels stand for in the
    segment's steps (``counts``), over the device time of the port's
    kernels there, in %."""
    if out.trace is None:
        return None
    busy = out.trace.device_s(_port(out.window["kernel_names"]))
    return 100.0 * out.traced["work_s"] / busy if busy > 0 else None


def plain_torch_ms(out):
    """Device ms per rollout step of the kernels that are not the port's
    (PyTorch's own: gathers, segment means, matmuls, casts)."""
    if out.trace is None or not out.traced.get("steps"):
        return None
    port = _port(out.window["kernel_names"])
    ms = out.trace.device_s(lambda n: not port(n)) * 1e3
    return ms / out.traced["steps"]


def idle_share(out):
    """1 - the union of the device's kernel and copy intervals over the
    segment's wall time, in %."""
    if out.trace is None or out.trace.wall_s <= 0:
        return None
    return 100.0 * (1.0 - out.trace.union_s() / out.trace.wall_s)


def mfu(out):
    """The model's products over the window (three times the forward's in
    training) over the window's seconds times the peak, in %."""
    w = out.window
    if not w.get("seconds"):
        return None
    return 100.0 * w["model_flops"] / (w["seconds"]
                                       * counts.peak_flops(w["precision"]))
