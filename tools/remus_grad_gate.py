"""How far the REMuS training gradients of the kernels lie from those of
their plain versions, over model seeds: the gradient gate of phase "remus
training" of ``chip_smoke.py``, with a float64 run of the plain versions
beside it.

    python3 tools/remus_grad_gate.py [--seeds 0 1 2 3 4 5 6 7]

For each seed, the REMuS workload of ``chip_smoke.py``
(``make_remus_samples``, ``remus_arch``, random weights from the seed)
takes two training steps on the kernels (``GraphLoss(0.25)``, clip 1.0,
lr ``chip_smoke.LR``), as that phase does before its gate.  Then one
rollout step's gradients are computed three ways: on the kernels, on the
plain versions in f32, and on the plain versions in float64 (a float64
copy of the model and of the graph's float arrays).  Each line gives the
gate's value (kernels against f32 plain; ``chip_smoke.worst_param``, held
to ``chip_smoke.GRAD_TOL``) and the distance of each f32 gradient from
the float64 one in the same measure.  ``tools/gn_variants.py
--remus-grads`` calls ``gate`` with a patched build's kernels.  Needs a
CUDA card.
"""
import argparse
import copy
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402


def gate(seeds):
    """The study over ``seeds`` on the kernels that ``_build.load()``
    gives; prints one line a seed and returns how many pass."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import attach_angle_sorts, collate
    from graphs4cfd_tpu_torch.nn import GraphLoss, NsRotEquiThreeScaleGNN
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    dev = torch.device("cuda", 0)
    batch = attach_angle_sorts(collate(cs.make_remus_samples(),
                                       node_bucket=512, edge_bucket=1024))
    g = Graph.from_numpy(batch, dev)
    g64 = Graph.from_numpy(type(batch)({
        k: v.astype(np.float64) if getattr(v, "dtype", None) == np.float32
        else v for k, v in batch.data.items()}), dev)
    crit = GraphLoss(lambda_d=0.25)
    passed = 0
    for seed in seeds:
        model = NsRotEquiThreeScaleGNN(arch=cs.remus_arch(), seed=seed,
                                       device=dev)
        nf = model.num_fields
        step = make_train_step(model, crit, nf, 1, 1.0)
        state = adam_init(list(model.parameters()))
        for _ in range(2):
            step(state, g, cs.LR)
        names = [n for n, _ in model.named_parameters()]

        def grads(m, graph):
            loss = crit(graph, m(graph), graph.target[:, :nf])
            return torch.autograd.grad(loss, list(m.parameters()))
        kern = grads(model, g)
        with cs.plain_kernels():
            plain = grads(model, g)
            exact = grads(copy.deepcopy(model).double(), g64)
        gate_r, at = cs.worst_param(names, kern, plain)
        k64, k64_at = cs.worst_param(names, kern, exact)
        p64, p64_at = cs.worst_param(names, plain, exact)
        ok = gate_r <= cs.GRAD_TOL
        passed += ok
        print(f"seed {seed}: gate {gate_r:.3e} ({at}) "
              f"{'passes' if ok else 'FAILS'}; kernels vs float64 "
              f"{k64:.3e} ({k64_at}); f32 plain vs float64 {p64:.3e} "
              f"({p64_at})", flush=True)
        del model, step, state, kern, plain, exact
        torch.cuda.empty_cache()
    print(f"{passed} of {len(seeds)} seeds pass the gate", flush=True)
    return passed


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"{torch.cuda.get_device_name(0)}: REMuS gradients after two "
          f"training steps; max over parameters of max abs difference / "
          f"max abs (gate {cs.GRAD_TOL})", flush=True)
    gate(args.seeds)


if __name__ == "__main__":
    main()
