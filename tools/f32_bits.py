"""The f32 outputs of the port's kernel wrappers and of one MuS training
step on fixed inputs (numpy seed 0; the flagship shapes on a card, small
ones on the CPU), written to a file; and the comparison of two such
files.  Run the first in two trees (a ``git archive`` of another commit
with this script copied into its ``tools/``) to show whether the f32
path gives the same bits in both:

    python3 tools/f32_bits.py write OUT.pt [cuda|cpu]
    python3 tools/f32_bits.py compare A.pt B.pt
"""
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def flat(o):
    """The tensors of a nested result, on the CPU."""
    if isinstance(o, torch.Tensor):
        return [o.detach().cpu()]
    if isinstance(o, (list, tuple)):
        return [x for y in o for x in flat(y)]
    return []


def write(out_path, devname):
    from chip_smoke import flagship_arch, make_samples
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.nn import GraphLoss, NsThreeScaleGNN
    from graphs4cfd_tpu_torch.ops import fused_mlp, gn_block as gn_op
    from graphs4cfd_tpu_torch.ops import segment
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    dev = torch.device(devname)
    big = dev.type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_num_threads(1)
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev)

    def chain(dims, ln):
        ws = [t(a, b) / np.float32(np.sqrt(a))
              for a, b in zip(dims[:-1], dims[1:])]
        bs = [t(b) * 0.1 for b in dims[1:]]
        return ws, bs, ((t(dims[-1]) * 0.1 + 1, t(dims[-1]) * 0.1)
                        if ln else None)

    res = {}
    rows = 242688 if big else 3000
    x, g = t(rows, 2), t(rows, 128)
    ws, bs, _ = chain([2, 128, 128, 128], False)
    res["chain_fwd"] = fused_mlp.mlp_chain(x, ws, bs)
    res["chain_bwd"] = fused_mlp.mlp_chain_bwd(x, g, ws, bs, need_dx=False)
    x, g = t(rows // 8, 128), t(rows // 8, 128)
    ws, bs, lns = chain([128, 128, 128], True)
    res["tail_fwd"] = fused_mlp.mlp_chain(x, ws, bs, *lns, preact_input=True)
    res["tail_bwd"] = fused_mlp.mlp_chain_bwd(x, g, ws, bs, lns[0],
                                              preact_input=True)
    V, k, H = (40448 if big else 500), 6, 128
    e, v = t(V * k, H), t(V, H)
    senders = torch.from_numpy(rng.integers(0, V, V * k).astype(
        np.int32)).to(dev)
    edge, node = chain([3 * H, H, H, H], True), chain([2 * H, H, H, H], True)
    vs = v @ edge[0][0][H:2 * H]
    res["gn_fwd"] = gn_op.gn_block(e, vs, v, senders, k, edge, node,
                                   out_selu=True)
    res["gn_bwd"] = gn_op.gn_block_bwd(e, vs, v, senders, None, k, edge,
                                       node, t(V, H), t(V * k, H),
                                       out_selu=True)
    srt, perm = torch.sort(senders, stable=True)
    res["seg"] = segment.sorted_segment_sum(e, perm.int(), srt.int(), V)
    model = NsThreeScaleGNN(arch=flagship_arch(w=128 if big else 32),
                            seed=0, device=dev)
    batch = collate(make_samples(8 if big else 2, 5000 if big else 400,
                                 seed=7),
                    node_bucket=512 if big else 64,
                    edge_bucket=1024 if big else 128)
    graph = Graph.from_numpy(batch, dev)
    with torch.no_grad():
        res["model_fwd"] = model(graph)
    step = make_train_step(model, GraphLoss(0.25), 3, 1, 1.0)
    res["step"] = step(adam_init(model.parameters()), graph, 1e-4)
    res["params"] = list(model.parameters())
    out = {key: flat(val) for key, val in res.items()}
    torch.save(out, out_path)
    print("wrote", out_path, {key: len(val) for key, val in out.items()})


def compare(path_a, path_b):
    a, b = torch.load(path_a), torch.load(path_b)
    for key in a:
        same = len(a[key]) == len(b[key]) and all(
            torch.equal(x, y) for x, y in zip(a[key], b[key]))
        print(f"{key}: {'same bits' if same else 'DIFFERENT'} "
              f"({len(a[key])} tensors)")


if __name__ == "__main__":
    if sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        write(sys.argv[2], sys.argv[3] if len(sys.argv) > 3 else "cuda")
