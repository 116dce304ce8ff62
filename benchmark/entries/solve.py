"""Rollout cells: ``graphs4cfd_tpu_torch.training.rollout.solve``.

Requests as the inference scripts make them: ``model.solve(graphs,
n_out)`` of a list of ``batch`` simulations (collated on the host and
moved to the card inside ``solve``), then the prediction copied to the
host (``np.asarray``).  Each request's simulations are drawn from the
traffic's pool by the seed.  One client, closed loop: the next request
goes when the last has come back.

Set-up: the pool through the program's transforms, the model with the
benchmark's weights in the traffic's precision, and one request.  The
window: requests back to back until ``--seconds`` have passed; the one
in flight then is finished and counted.  Counted: requests, valid
level-1 edges x ``n_out``, kernel launches, the model's products, and
each prediction, kept on the host.  ``--trace 1`` adds one profiled
request after the window.  Then the program is freed and the reference
rolls out ``checked_requests`` of the window's requests, drawn by the
seed.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from .. import compare, counts, data, harness, reference, weights
from .. import trace as tr
from . import common


def run(ctx) -> harness.Outcome:
    cfg, trf = ctx.cell.config, ctx.cell.traffic
    B, n_out, prec = trf["batch"], trf["n_out"], trf["precision"]
    fam = counts.family(cfg["family"])
    raws = data.inputs(trf, cfg, ctx.seed)
    pool = common.program_graphs(raws, cfg)
    W = weights.make(cfg["arch"], ctx.seed, ctx.device)
    model = common.program_model(cfg, W, ctx.device, prec)
    request = requests(model, pool, data.stream(ctx.seed, "requests"), B,
                       n_out)
    request()
    ctx.sync()
    ctx.reset_peak()
    launched = common.launches()
    done = []
    t0 = time.perf_counter()
    while time.perf_counter() < t0 + ctx.seconds:
        done.append(request())
    t1 = time.perf_counter()
    peak = ctx.peak_bytes()
    launched = common.launches() - launched
    window_s = t1 - t0
    edges = sum(sz["E1"] for _, _, sz in done) * n_out
    flops = sum(counts.step_model_flops(fam, cfg["arch"], sz, False)
                for _, _, sz in done) * n_out
    failed = sum(not np.isfinite(h).all() for _, h, _ in done)
    out = harness.Outcome(
        values={"rollout_edges_per_s": edges / window_s,
                "peak_mem_gib": peak / 2 ** 30,
                "setup_s": t0 - ctx.started},
        attempted=len(done), failed=int(failed), numbers={},
        peak_bytes=peak,
        window={"seconds": window_s, "steps": len(done) * n_out,
                "launches": launched, "model_flops": flops,
                "precision": prec, "kernel_names": common.kernel_names()})
    print(f"window: {len(done)} requests, {window_s:.3f} s, peak "
          f"{peak / 2 ** 30:.3f} GiB", file=sys.stderr)
    if ctx.trace:
        traced = []
        out.trace = tr.profile(lambda: traced.append(request()), ctx.sync)
        out.traced = {"steps": n_out,
                      "work_s": counts.step_seconds(
                          fam, cfg["arch"], traced[0][2], False, prec)
                      * n_out}
    del model, pool
    harness.free_memory()
    pick = data.stream(ctx.seed, "sample").choice(
        len(done), min(trf["checked_requests"], len(done)), replace=False)
    pairs = [(done[i][1], reference_rollout(ctx, raws, W, done[i][0]))
             for i in sorted(pick)]
    out.numbers = compare.rollout_numbers(
        [(p[:r.shape[0]], r) for p, r in pairs], cfg["nf"])
    return out


def requests(model, pool, draws, batch, n_out):
    """``request() -> (indices, prediction on the host, sizes)``: one
    request of ``batch`` simulations of ``pool`` drawn by ``draws``."""
    from torch.autograd.profiler import record_function

    def request():
        idx = [int(i) for i in draws.choice(len(pool), batch, replace=False)]
        graphs = [pool[i] for i in idx]
        with record_function("harness.solve"):
            pred = model.solve(graphs, n_out)
        with record_function("harness.to_host"):
            host = np.asarray(pred.cpu())
        return idx, host, common.sizes(graphs)
    return request


def reference_rollout(ctx, raws, W, idx, precision="f32"):
    """The reference's rollout of one request's simulations, joined in the
    request's order (``[valid nodes, nf n_out]``, numpy)."""
    ref = reference.Model(ctx.cell.config, dict(W), precision)
    (t,) = ref.graphs([raws[i] for i in idx], ctx.device)
    return ref.rollout(t, ctx.cell.traffic["n_out"]).cpu().numpy()
