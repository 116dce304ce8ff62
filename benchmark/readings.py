"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 benchmark/readings.py --workload <cell> --seeds <n> [<n> ...] \
        [--config <config> --traffic <mix>]

For each seed, at the cell's own sizes: the program's numbers (its first
training steps, or one request of the window's kind) against the plain
reference; the control, the reference in the precision below the cell's
(fp8 for a bf16 cell, TF32 for an f32 one) put in the program's place;
and for training cells the planted fault "half of the batch left out,
the mean over the rest", its first half kept (``half_first``) or every
other sample (``half_alternate``), in the reference put in the program's
place (a state left unchanged reads 1 and needs no run).  With the worst
leaves of each number.  One JSON line a seed on stdout.  Set-up is
shared: one process reads every seed.  A cell that ``BENCHMARK.json``
does not hold yet is named with its ``--config`` and ``--traffic``.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from benchmark import compare, data, harness, weights  # noqa: E402
from benchmark.entries import common, fit, solve  # noqa: E402

CONTROL = {"bf16": "fp8", "f32": "tf32"}


def training(ctx, seed: int) -> dict:
    cfg, trf = ctx.cell.config, ctx.cell.traffic
    B, follow = trf["batch"], min(trf["check_steps"], trf["n_out"])
    raws = data.inputs(trf, cfg, seed)[:B]
    W = weights.make(cfg["arch"], seed, ctx.device)
    model = common.program_model(cfg, W, ctx.device, trf["precision"])
    with tempfile.TemporaryDirectory(prefix="bench_fit_") as folder:
        train_config, loss = fit.configs(trf, folder)
        checked = fit.first_steps(model, common.program_graphs(raws, cfg),
                                  train_config, loss(), follow, ctx.sync)
    del model
    harness.free_memory()
    ref = fit.reference_steps(ctx, raws, W, follow)

    ref_norms = compare._norms(ref[1])
    quiet = compare.QUIET_LEAF * compare._median(list(ref_norms.values()))
    keep = {k for k, v in ref_norms.items() if v >= quiet}
    looks = {}

    def against(name, steps):
        c = steps if isinstance(steps, dict) else fit.as_checked(steps)
        d_p = {k: float((c["after"][k].to(W[k].device) - W[k]).double()
                        .norm()) for k in W}
        d_r = {k: float((ref[2][k] - W[k]).double().norm()) for k in W}
        turns = compare.cos_gaps(c["grads"], ref[1], keep)
        looks[name] = {"grad": compare.worst_leaves(
                           compare._norms(c["grads"]), ref_norms),
                       "update": compare.worst_leaves(d_p, d_r),
                       "cos": [[k, turns[k]] for k in sorted(
                           turns, key=lambda k: -turns[k])[:3]]}
        return compare.training_numbers(c["losses"], ref[0], c["grads"],
                                        ref[1], W, c["after"], ref[2])
    ctl = CONTROL[trf["precision"]]
    return {"program": against("program", checked),
            "control": against("control", fit.reference_steps(
                ctx, raws, W, follow, ctl)),
            "half_first": against("half_first", fit.reference_steps(
                ctx, raws[:B // 2], W, follow)),
            "half_alternate": against("half_alternate", fit.reference_steps(
                ctx, raws[::2], W, follow)),
            "worst_leaves": looks}


def rollout(ctx, seed: int) -> dict:
    cfg, trf = ctx.cell.config, ctx.cell.traffic
    raws = data.inputs(trf, cfg, seed)
    W = weights.make(cfg["arch"], seed, ctx.device)
    model = common.program_model(cfg, W, ctx.device, trf["precision"])
    pool = common.program_graphs(raws, cfg)
    idx, pred, _ = solve.requests(model, pool, data.stream(seed, "requests"),
                                  trf["batch"], trf["n_out"])()
    del model, pool
    harness.free_memory()
    ref = solve.reference_rollout(ctx, raws, W, idx)
    ctl = solve.reference_rollout(ctx, raws, W, idx,
                                  CONTROL[trf["precision"]])
    nf = cfg["nf"]
    return {"program": compare.rollout_numbers([(pred[:ref.shape[0]], ref)],
                                               nf),
            "control": compare.rollout_numbers([(ctl, ref)], nf),
            "steps": {"program": step_gaps(pred[:ref.shape[0]], ref, nf),
                      "control": step_gaps(ctl, ref, nf)}}


def step_gaps(p, r, nf, every: int = 10) -> list:
    """The relative L2 gap of every ``every``-th step (the first too)."""
    steps = r.shape[1] // nf
    return [compare.rollout_numbers(
        [(p[:, t * nf:(t + 1) * nf], r[:, t * nf:(t + 1) * nf])], nf)[
            "rollout_gap"] for t in range(0, steps, every)]


def main(argv=None, device=None, root=harness.ROOT):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    args = ap.parse_args(argv)
    import torch
    cell = harness.resolve(args.workload, root, args.config, args.traffic)
    if device is None:
        device = harness.require_cuda(int(cell.spec["chips"]))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = harness.Ctx(cell=cell, seed=0, seconds=0, trace=False,
                      device=torch.device(device), started=0.0)
    read = training if cell.traffic["entry"] == "fit" else rollout
    out = []
    for seed in args.seeds:
        t = time.perf_counter()
        line = {"workload": args.workload, "seed": seed, **read(ctx, seed),
                "seconds": time.perf_counter() - t}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


if __name__ == "__main__":
    main()
