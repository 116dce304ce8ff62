"""Where a rollout step, or a training step, of the PyTorch port's
flagship MuS-GNN spends its time on the card.

    python3 profile_torch_step.py [--steps 3] [--train]

Builds the same inputs and model as ``chip_smoke.py`` (8 graphs of 5000
nodes, 128-wide ``NsThreeScaleGNN``, random weights), warms up, then runs
``solve`` (or, with ``--train``, that many ``train_step(n_out=1)`` calls
with ``GraphLoss(0.25)``, clip 1.0, lr 1e-4) under ``torch.profiler`` and
prints the device time per kernel name, the share of the hand-written
kernels, and the device busy share of the wall time (kernel time summed
over the profiled window).  Needs a CUDA card.
"""
import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import flagship_arch, make_samples


def device_us(evt):
    return getattr(evt, "self_device_time_total",
                   getattr(evt, "self_cuda_time_total", 0.0))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--train", action="store_true")
    args = ap.parse_args()
    steps = args.steps
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.nn import NsThreeScaleGNN
    dev = torch.device("cuda", 0)
    batch = collate(make_samples(8, 5000, seed=7), node_bucket=512,
                    edge_bucket=1024)
    g = Graph.from_numpy(batch, dev)
    model = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev)
    if args.train:
        from graphs4cfd_tpu_torch.nn import GraphLoss
        from graphs4cfd_tpu_torch.training import adam_init, make_train_step
        state = adam_init(model.parameters())
        train_step = make_train_step(model, GraphLoss(0.25), 3, 1, 1.0)

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
    kind = "training" if args.train else "rollout"
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
