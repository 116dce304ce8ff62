"""Where a rollout step, or a training step, of the PyTorch port's
flagship MuS-GNN, of its REMuS-GNN or of its gMuS-GNN spends its time on
the card.

    python3 profile_torch_step.py [--steps 3] [--train | --remus |
                                   --remus-train | --gmus | --gmus-train]
    python3 profile_torch_step.py --gn-cases

Builds the same inputs and model as ``chip_smoke.py`` (8 graphs of 5000
nodes, 128-wide ``NsThreeScaleGNN``, random weights; with ``--remus`` the
REMuS workload: 4 graphs of 5000 nodes, k=5, 128-wide
``NsRotEquiThreeScaleGNN``; ``--remus-train`` its training step, with the
host sorts of ``loader.attach_angle_sorts``; with ``--gmus`` the gMuS
workload: 8 graphs of 5000 nodes, Guillard coarsening with k=6 on 3
levels, 128-wide ``NsThreeGuillardScaleGNN``; ``--gmus-train`` its
training step, with the host sorts of ``loader.attach_sender_sorts``),
warms up, then runs ``solve`` (or, with ``--train``, ``--remus-train`` and
``--gmus-train``, that many ``train_step(n_out=1)`` calls with
``GraphLoss(0.25)``, clip 1.0, lr 1e-4) under ``torch.profiler`` and
prints the device time per kernel name, the share of the hand-written
kernels, and the device busy share of the wall time (kernel time summed
over the profiled window).  ``--gn-cases`` instead times the GN-block
kernel at the level-1 REMuS EdgeMP shape (512,000 angle rows, H=128)
with its angle sources spread over the whole 52 MB table, taken from the
REMuS graph, or held inside its first 10 MB, and at k=6 with as many
angle rows: what the table's size and k=5's node tiles cost.  Needs a
CUDA card.
"""
import argparse
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (bound_ms, cuda_ms, flagship_arch, gmus_arch,
                        gn_flops, make_gmus_samples, make_remus_samples,
                        make_samples, remus_arch, uniform_chain)


def device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def gn_cases(dev):
    """The GN-block kernel at one level-1 EdgeMP's work, four ways."""
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    rng = np.random.default_rng(0)
    H = 128
    angle = uniform_chain(rng, [3 * H, H, H], True, dev)
    edge = uniform_chain(rng, [2 * H, H, H], True, dev)
    batch = collate(make_remus_samples(), node_bucket=512, edge_bucket=1024)

    def canonical(nodes, k):
        idx = (nodes[:, None] * k + np.arange(k)).reshape(-1)
        return torch.from_numpy(idx.astype(np.int32)).to(dev)

    cases = [
        ("k=5, sources random over the 52 MB table", 102400, 5,
         canonical(rng.integers(0, 20480, 102400), 5)),
        ("k=5, the REMuS graph's angle_src", 102400, 5,
         torch.from_numpy(batch.angle_src.reshape(-1)).to(dev)),
        ("k=5, sources random in the table's first 10 MB", 102400, 5,
         canonical(rng.integers(0, 4096, 102400), 5)),
        ("k=6, 512,004 angle rows, sources in the first 10 MB", 85334, 6,
         canonical(rng.integers(0, 3413, 85334), 6)),
    ]
    print(f"{torch.cuda.get_device_name(0)}: gn_block, H={H}, out_selu, "
          "angles stored")
    for name, V, k, senders in cases:
        a = torch.randn(V * k, H, device=dev)
        e = torch.randn(V, H, device=dev)
        vs = e @ angle[0][0][H:2 * H]
        run = lambda: gn_op.gn_block(a, vs, e, senders, k, angle, edge,
                                     out_selu=True)
        ms = cuda_ms(run)
        flops = gn_flops(V * k, V, H, H, [3 * H, H, H], [2 * H, H, H])
        nodes = 96 // k
        rows = 16 * -(-nodes // 16)
        bms, _ = bound_ms(flops, 0)
        print(f"  {name}: {ms:.4f} ms, {flops / 1e9:.2f} GFLOP, "
              f"{flops / ms / 1e9:.2f} TFLOP/s, bound {bms:.4f} ms; "
              f"{nodes} receivers per block in {rows} node-tile rows")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true")
    mode.add_argument("--remus", action="store_true")
    mode.add_argument("--remus-train", action="store_true")
    mode.add_argument("--gmus", action="store_true")
    mode.add_argument("--gmus-train", action="store_true")
    mode.add_argument("--gn-cases", action="store_true")
    args = ap.parse_args()
    steps = args.steps
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.gn_cases:
        gn_cases(torch.device("cuda", 0))
        return
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import (attach_angle_sorts,
                                             attach_sender_sorts, collate)
    from graphs4cfd_tpu_torch.nn import (NsRotEquiThreeScaleGNN,
                                         NsThreeGuillardScaleGNN,
                                         NsThreeScaleGNN)
    dev = torch.device("cuda", 0)
    remus = args.remus or args.remus_train
    if args.gmus or args.gmus_train:
        batch = attach_sender_sorts(collate(
            make_gmus_samples(), node_bucket=512, edge_bucket=1024))
        model = NsThreeGuillardScaleGNN(arch=gmus_arch(), seed=0,
                                        device=dev)
    elif remus:
        batch = attach_angle_sorts(collate(
            make_remus_samples(), node_bucket=512, edge_bucket=1024))
        model = NsRotEquiThreeScaleGNN(arch=remus_arch(), seed=0,
                                       device=dev)
    else:
        batch = collate(make_samples(8, 5000, seed=7), node_bucket=512,
                        edge_bucket=1024)
        model = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev)
    g = Graph.from_numpy(batch, dev)
    train = args.train or args.remus_train or args.gmus_train
    if train:
        from graphs4cfd_tpu_torch.nn import GraphLoss
        from graphs4cfd_tpu_torch.training import adam_init, make_train_step
        state = adam_init(model.parameters())
        train_step = make_train_step(model, GraphLoss(0.25),
                                     model.num_fields, 1, 1.0)

        def run(n):
            for _ in range(n):
                train_step(state, g, 1e-4)
    else:
        run = lambda n: model.solve(g, n)
    run(2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    if not rows:
        raise SystemExit("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    kind = ("REMuS training" if args.remus_train else
            "gMuS training" if args.gmus_train else
            "training" if args.train else
            "REMuS rollout" if args.remus else
            "gMuS rollout" if args.gmus else "rollout")
    print(f"{torch.cuda.get_device_name(0)}: {steps} {kind} steps, wall "
          f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
          f"({100 * busy / wall_us:.1f} % of wall)")
    for key, us, n in rows[:25]:
        print(f"{us / 1e3 / steps:10.4f} ms/step {100 * us / busy:6.2f} % "
              f"{n // steps:5d}/step  {key[:90]}")
    own = sum(us for key, us, _ in rows
              if "g4c::" in key)
    print(f"hand-written kernels: {100 * own / max(busy, 1e-9):.1f} % of "
          f"device time")


if __name__ == "__main__":
    main()
