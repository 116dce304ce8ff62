"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one flushed line each with the elapsed seconds:

1. device: fails without CUDA (there is no CPU fallback); prints the card,
   its power limit (nvidia-smi), torch and nvcc versions;
2. build: compiles ``graphs4cfd_tpu_torch/csrc/*.cu`` with nvcc into
   ``build/`` (or finds the library of the same sources there);
3. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of the main path, f32 with TF32 off: error, time, bound;
4. graphs: 8 graphs of 5000 nodes (numpy seed 7) through the port's host
   pipeline and ``collate`` (buckets 512/1024);
5. main path: ``NsThreeScaleGNN`` at the flagship arch (128 wide, 16 MP
   layers, random weights from seed 0) runs ``solve(n_out=4)``; checks the
   output, the kernel launch counts, and one step against the same step
   with the plain versions; prints ms per step and level-1 edges/s;
6. training: ``make_train_step(model, GraphLoss(0.25), 3, 1, 1.0)`` with
   lr 1e-4, as the JAX package's ``bench.py`` runs it; checks the loss and
   gradient norm are finite, the launch counts of one rollout step, one
   step's gradients against the same with the plain versions, and that two
   steps from the same parameters and Adam state give the same bits;
   prints ms per training step, level-1 edges/s and peak device memory.

Then one JSON line of per-kernel numbers and, last, the result line
``{"ok": true, "device": {...}}``.  Any failure stops the run with a
non-zero exit before the result line.
"""
import contextlib
import json
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 on the CUDA cores
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
MLP_TOL = 1e-4             # max abs error on O(1) data, f32
GN_TOL = 2e-4
# backward outputs: max abs error over max(1, max |reference|), per output
# (weight gradients sum 10^4-10^5 rows: f32 keeps about 1e-7 of their size)
MLP_BWD_TOL = 1e-4
GN_BWD_TOL = 2e-4
SEG_TOL = 1e-5
# SELU's derivative jumps at 0 (1.0507 above, 1.7581 below).  A SELU input
# within KINK of 0 in the float64 forward may fall on either side in two
# f32 computations, and every cotangent that flows through it then differs
# by O(1).  The backward checks give the rows whose cotangents would flow
# through such an input a zero cotangent (and count them), so that what is
# compared is the kernels' arithmetic.
KINK = 1e-5
PATH_TOL = 1e-3            # max rel difference of one full step
GRAD_TOL = 1e-3            # per parameter: max abs difference / max abs
LR = 1e-4
BENCH_SIZES = {"V": 40448, "E": 242688, "V2": 3072, "E2": 14336,
               "V3": 1024, "E3": 4096}


def say(phase, msg):
    print(f"[{time.perf_counter() - T0:8.2f}s] {phase}: {msg}", flush=True)


def fail(phase, msg):
    say(phase, "FAILED: " + msg)
    sys.exit(1)


def flagship_arch(n_node_in=5, nf=3, w=128):
    mp = ((w + 2 * w, (w, w, w), True), (w + w, (w, w, w), True))
    return {
        "edge_encoder": (2, (w, w, w), False),
        "node_encoder": (n_node_in, (w, w, w), False),
        "mp111": mp, "mp112": mp, "mp113": mp, "mp114": mp,
        "down_mp12": (2 + w, (w, w, w), True),
        "mp211": mp, "mp212": mp,
        "down_mp23": (2 + w, (w, w, w), True),
        "mp31": mp, "mp32": mp, "mp33": mp, "mp34": mp,
        "up_mp32": (2 + w + w, (w, w, w), True),
        "mp221": mp, "mp222": mp,
        "up_mp21": (2 + w + w, (w, w, w), True),
        "mp121": mp, "mp122": mp, "mp123": mp, "mp124": mp,
        "decoder": (w, (w, w, nf), False),
    }


def make_samples(num, n_nodes, seed, nf=3, k=6, cells=(0.15, 0.30)):
    """Synthetic NsCircle-shaped samples, as the JAX package's benchmark
    builds them, through the port's own transforms."""
    from graphs4cfd_tpu_torch import transforms as T
    from graphs4cfd_tpu_torch.graph import Graph
    pipeline = [T.SpatialSort(), T.ConnectKNN(k=k), T.ScaleEdgeAttr(0.15),
                T.GridClustering(list(cells))]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        g = Graph()
        g.pos = (rng.random((n_nodes, 2)) * np.array([4.0, 2.0])).astype(
            np.float32)
        g.glob = np.full((n_nodes, 1), 0.5, np.float32)
        g.field = rng.normal(size=(n_nodes, nf)).astype(np.float32)
        g.target = rng.normal(size=(n_nodes, nf * 10)).astype(np.float32)
        g.omega = (rng.random((n_nodes, 1)) < 0.1).astype(np.float32)
        g.bound = np.zeros(n_nodes, np.uint8)
        for t in pipeline:
            g = t(g)
        out.append(g)
    return out


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(flops, nbytes):
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def uniform_chain(rng, dims, ln, dev):
    ws, bs = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = 1.0 / np.sqrt(a)
        ws.append(torch.from_numpy(rng.uniform(-bound, bound, (a, b)).astype(
            np.float32)).to(dev))
        bs.append(torch.from_numpy(rng.uniform(-bound, bound, b).astype(
            np.float32)).to(dev))
    lns = ((torch.from_numpy(rng.uniform(0.5, 1.5, dims[-1]).astype(
        np.float32)).to(dev),
            torch.from_numpy(rng.uniform(-0.1, 0.1, dims[-1]).astype(
                np.float32)).to(dev)) if ln else None)
    return ws, bs, lns


def errors(out, ref):
    err = (out - ref).abs().max().item()
    return err, err / max(ref.abs().max().item(), 1e-30)


def scaled_err(out, ref):
    """Max abs error over max(1, max |ref|)."""
    return (out - ref).abs().max().item() / max(1.0, ref.abs().max().item())


def check_mlp_chain(dev, rng):
    from graphs4cfd_tpu_torch.ops import fused_mlp
    rows, dims = 14336, [128, 128, 128]
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev)
    ws, bs, (s, b) = uniform_chain(rng, dims, True, dev)
    run = lambda: fused_mlp.mlp_chain(x, ws, bs, s, b, preact_input=True)
    plain = lambda: fused_mlp.mlp_chain_plain(x, ws, bs, s, b,
                                              preact_input=True)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err, rel = errors(out, ref)
    flops = sum(2 * rows * p * q for p, q in zip(dims[:-1], dims[1:]))
    bms, by = bound_ms(flops, nbytes(x, out, *ws, *bs, s, b))
    res = {"name": "mlp_chain", "route": "cuda",
           "source": "graphs4cfd_tpu_torch/csrc/mlp_chain.cu",
           "replaces": "graphs4cfd_tpu/ops/pallas_mlp.py:75",
           "max_abs_err": err, "ms": cuda_ms(run), "plain_ms": cuda_ms(plain),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    say("kernels", f"mlp_chain [{rows}, 128] start=1 LN: max abs err {err:.3e}"
        f" max rel {rel:.3e} (tol {MLP_TOL}); kernel {res['ms']:.4f} ms, "
        f"plain {res['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by}); "
        f"{fused_mlp.mlp_chain.launches} launches in this check")
    if not err <= MLP_TOL:
        fail("kernels", f"mlp_chain error {err} above {MLP_TOL}")
    return res


def check_gn_block(dev, rng):
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    V, k, H = 40448, 6, 128
    E = V * k
    e = torch.from_numpy(rng.normal(size=(E, H)).astype(np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(dev)
    senders = torch.from_numpy(
        rng.integers(0, V, E).astype(np.int32)).to(dev)
    edge = uniform_chain(rng, [3 * H, H, H, H], True, dev)
    node = uniform_chain(rng, [2 * H, H, H, H], True, dev)
    vs = v @ edge[0][0][H:2 * H]
    res = None
    for skip in (False, True):
        run = lambda: gn_op.gn_block(e, vs, v, senders, k, edge, node,
                                     out_selu=True, skip_e_out=skip)
        plain = lambda: gn_op.gn_block_plain(e, vs, v, senders, k, edge,
                                             node, out_selu=True,
                                             skip_e_out=skip)
        (vo, eo), (vr, er) = run(), plain()
        torch.cuda.synchronize()
        err, rel = errors(vo, vr)
        if skip:
            if eo is not None:
                fail("kernels", "gn_block with skip_e_out returned e'")
        else:
            err_e, rel_e = errors(eo, er)
            err, rel = max(err, err_e), max(rel, rel_e)
        params = [*edge[0], *edge[1], *edge[2], *node[0], *node[1], *node[2]]
        flops = 2 * E * H * H * 3 + 2 * V * H * H * 5
        bms, by = bound_ms(flops, nbytes(e, vs, v, senders, vo, eo, *params))
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("kernels", f"gn_block V={V} k={k} H={H} out_selu skip_e_out="
            f"{skip}: max abs err {err:.3e} max rel {rel:.3e} (tol {GN_TOL});"
            f" kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
            f"({by}); {gn_op.gn_block.launches} launches in these checks")
        if not err <= GN_TOL:
            fail("kernels", f"gn_block error {err} above {GN_TOL}")
        if not skip:
            res = {"name": "gn_block", "route": "cuda",
                   "source": "graphs4cfd_tpu_torch/csrc/gn_block.cu",
                   "replaces": "graphs4cfd_tpu/ops/pallas_gnblock.py:517",
                   "max_abs_err": err, "ms": ms, "plain_ms": pms,
                   "bound_ms": bms, "bound_by": by, "library_ms": None}
    return res


def selu64(a):
    from graphs4cfd_tpu_torch.ops.fused_mlp import selu
    return selu(a)


def chain_kinks(x, ws, bs, preact):
    """Float64 forward of a chain: ``(pre-LN output, rows with a SELU input
    within KINK of 0)``."""
    x = x.double()
    near = (x.abs() < KINK).any(dim=1) if preact else torch.zeros(
        x.shape[0], dtype=torch.bool, device=x.device)
    h = selu64(x) if preact else x
    for i, (w, b) in enumerate(zip(ws, bs)):
        a = torch.addmm(b.double(), h, w.double())
        if i < len(ws) - 1:
            near |= (a.abs() < KINK).any(dim=1)
            h = selu64(a)
    return a, near


def gn_kink_nodes(e, vs, v, senders, k, edge, node, out_selu):
    """Nodes with a SELU input within KINK of 0 in the float64 forward, in
    their own rows or in their k edges' rows.  Zero cotangents on these
    nodes and their edges keep every cotangent away from the kinks."""
    from graphs4cfd_tpu_torch.ops.fused_mlp import layer_norm
    (ew, eb, eln), (nw, nb, nln) = edge, node
    V, fe, fv = v.shape[0], e.shape[1], v.shape[1]
    d = lambda t: t.double()
    h1 = (d(e) @ d(ew[0][:fe]) + d(vs)[senders.long()]
          + (d(v) @ d(ew[0][fe + fv:])).repeat_interleave(k, 0) + d(eb[0]))
    e_pre, e_near = chain_kinks(h1, ew[1:], eb[1:], True)
    e_new = layer_norm(e_pre, d(eln[0]), d(eln[1])) if eln else e_pre
    aggr = e_new.reshape(V, k, -1).mean(1)
    fa = aggr.shape[1]
    hn = aggr @ d(nw[0][:fa]) + d(v) @ d(nw[0][fa:]) + d(nb[0])
    v_pre, n_near = chain_kinks(hn, nw[1:], nb[1:], True)
    if out_selu:
        v_new = layer_norm(v_pre, d(nln[0]), d(nln[1])) if nln else v_pre
        e_near |= (e_new.abs() < KINK).any(dim=1)
        n_near |= (v_new.abs() < KINK).any(dim=1)
    return n_near | e_near.reshape(V, k).any(dim=1)


def quiet(g, rows):
    """``g`` with the given rows zeroed (None stays None)."""
    return None if g is None else g.masked_fill(rows[:, None], 0.0)


def chain_flops(rows, dims):
    return sum(2 * rows * p * q for p, q in zip(dims[:-1], dims[1:]))


def check_mlp_chain_bwd(dev, rng):
    from graphs4cfd_tpu_torch.ops import fused_mlp
    rows, dims = 14336, [128, 128, 128]
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(rows, dims[-1])).astype(
        np.float32)).to(dev)
    ws, bs, (s, _) = uniform_chain(rng, dims, True, dev)
    _, kinked = chain_kinks(x, ws, bs, True)
    g = quiet(g, kinked)
    run = lambda: fused_mlp.mlp_chain_bwd(x, g, ws, bs, s, preact_input=True)
    plain = lambda: fused_mlp.mlp_chain_bwd_plain(x, g, ws, bs, s,
                                                  preact_input=True)
    (dx, dws, dbs, dln), (rdx, rws, rbs, rln) = run(), plain()
    torch.cuda.synchronize()
    pairs = list(zip([dx] + dws + dbs + list(dln),
                     [rdx] + rws + rbs + list(rln)))
    err = max(errors(a, b)[0] for a, b in pairs)
    rel = max(scaled_err(a, b) for a, b in pairs)
    # the recomputed forward and two products per layer
    flops = 3 * chain_flops(rows, dims)
    bms, by = bound_ms(flops, nbytes(x, g, dx, *ws, *bs, s, *dws, *dbs,
                                     *dln))
    res = {"name": "mlp_chain_bwd", "route": "cuda",
           "source": "graphs4cfd_tpu_torch/csrc/mlp_chain_bwd.cu",
           "replaces": "graphs4cfd_tpu/ops/pallas_mlp.py:88",
           "max_abs_err": err, "ms": cuda_ms(run), "plain_ms": cuda_ms(plain),
           "bound_ms": bms, "bound_by": by, "library_ms": None}
    say("kernels", f"mlp_chain_bwd [{rows}, 128] start=1 LN: max abs err "
        f"{err:.3e} over dx, dW, db, dLN, over max(1, max|ref|) {rel:.3e} "
        f"(tol {MLP_BWD_TOL}; {int(kinked.sum())} rows by a SELU kink given "
        f"a zero cotangent); kernel {res['ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
    if not rel <= MLP_BWD_TOL:
        fail("kernels", f"mlp_chain_bwd error {rel} above {MLP_BWD_TOL}")
    a, b = run(), run()
    if not all(torch.equal(p, q) for p, q in
               zip([a[0], *a[1], *a[2], *a[3]], [b[0], *b[1], *b[2], *b[3]])):
        fail("kernels", "mlp_chain_bwd: two launches differ")
    return res


def gn_case(dev, rng, V=40448, k=6, H=128):
    e = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev)
    v = torch.from_numpy(rng.normal(size=(V, H)).astype(np.float32)).to(dev)
    senders = torch.from_numpy(
        rng.integers(0, V, V * k).astype(np.int32)).to(dev)
    edge = uniform_chain(rng, [3 * H, H, H, H], True, dev)
    node = uniform_chain(rng, [2 * H, H, H, H], True, dev)
    vs = v @ edge[0][0][H:2 * H]
    srt, perm = torch.sort(senders, stable=True)
    return e, v, senders, edge, node, vs, (perm.int(), srt.int())


def check_gn_block_bwd(dev, rng):
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    V, k, H = 40448, 6, 128
    E = V * k
    e, v, senders, edge, node, vs, sort = gn_case(dev, rng, V, k, H)
    kinked = gn_kink_nodes(e, vs, v, senders, k, edge, node, True)
    gv = quiet(torch.from_numpy(rng.normal(size=(V, H)).astype(
        np.float32)).to(dev), kinked)
    ge_full = quiet(torch.from_numpy(rng.normal(size=(E, H)).astype(
        np.float32)).to(dev), kinked.repeat_interleave(k))
    params = [*edge[0], *edge[1], *edge[2], *node[0], *node[1], *node[2]]
    res = None
    for skip in (False, True):
        ge = None if skip else ge_full
        run = lambda: gn_op.gn_block_bwd(e, vs, v, senders, sort, k, edge,
                                         node, gv, ge, out_selu=True)
        plain = lambda: gn_op.gn_block_bwd_plain(e, vs, v, senders, sort, k,
                                                 edge, node, gv, ge,
                                                 out_selu=True)
        got, ref = run(), plain()
        torch.cuda.synchronize()

        def flat(out):
            de, dv, dvs, (ew, eb, eln), (nw, nb, nln) = out
            return [de, dv, dvs, *ew, *eb, *eln, *nw, *nb, *nln]
        pairs = list(zip(flat(got), flat(ref)))
        err = max(errors(a, b)[0] for a, b in pairs)
        rel = max(scaled_err(a, b) for a, b in pairs)
        flops = 3 * (2 * E * H * H * 3 + 2 * V * H * H * 5)
        bms, by = bound_ms(flops, nbytes(e, vs, v, senders, *sort, gv, ge,
                                         *params, *flat(got)))
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("kernels", f"gn_block_bwd V={V} k={k} H={H} out_selu skip_e_out="
            f"{skip}: max abs err {err:.3e}, over max(1, max|ref|) {rel:.3e} "
            f"(tol {GN_BWD_TOL}; {int(kinked.sum())} nodes by a SELU kink "
            f"and their edges given a zero cotangent); kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by})")
        if not rel <= GN_BWD_TOL:
            fail("kernels", f"gn_block_bwd error {rel} above {GN_BWD_TOL}")
        if not all(torch.equal(a, b) for a, b in zip(flat(run()),
                                                     flat(run()))):
            fail("kernels", "gn_block_bwd: two launches differ")
        if not skip:
            res = {"name": "gn_block_bwd", "route": "cuda",
                   "source": "graphs4cfd_tpu_torch/csrc/gn_block_bwd.cu",
                   "replaces": "graphs4cfd_tpu/ops/pallas_gnblock.py:556",
                   "max_abs_err": err, "ms": ms, "plain_ms": pms,
                   "bound_ms": bms, "bound_by": by, "library_ms": None}
    return res


def check_sorted_segment_sum(dev, rng):
    """The dvs sums of ``gn_block_bwd`` at the level-1 shapes: the per-edge
    first-layer cotangents summed per sender.  ``index_add_`` computes the
    same sums (with float atomics) and is timed as the library call."""
    from graphs4cfd_tpu_torch.ops import segment
    V, k, H = 40448, 6, 128
    src = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev)
    senders = torch.from_numpy(
        rng.integers(0, V, V * k).astype(np.int32)).to(dev)
    srt, perm = torch.sort(senders, stable=True)
    perm, srt = perm.int(), srt.int()
    run = lambda: segment.sorted_segment_sum(src, perm, srt, V)
    plain = lambda: segment.sorted_segment_sum_plain(src, perm, srt, V)
    idx = senders.long()
    lib = lambda: torch.zeros(V, H, device=dev).index_add_(0, idx, src)
    out, ref = run(), plain()
    torch.cuda.synchronize()
    err, rel = errors(out, ref)[0], scaled_err(out, ref)
    bms, by = bound_ms(V * k * H, nbytes(src, perm, srt, out))
    res = {"name": "sorted_segment_sum", "route": "cuda",
           "source": "graphs4cfd_tpu_torch/csrc/sorted_segment_sum.cu",
           "replaces": "graphs4cfd_tpu/ops/pallas_gnblock.py:719",
           "max_abs_err": err, "ms": cuda_ms(run), "plain_ms": cuda_ms(plain),
           "bound_ms": bms, "bound_by": by, "library_ms": cuda_ms(lib)}
    say("kernels", f"sorted_segment_sum [{V * k}, {H}] -> {V}: max abs err "
        f"{err:.3e} (tol {SEG_TOL} of max(1, max|ref|)); kernel "
        f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, index_add_ "
        f"{res['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
    if not rel <= SEG_TOL:
        fail("kernels", f"sorted_segment_sum error {rel} above {SEG_TOL}")
    if not torch.equal(run(), run()):
        fail("kernels", "sorted_segment_sum: two launches differ")
    return res


@contextlib.contextmanager
def plain_kernels():
    """Route the model through the kernels' plain versions (gradients then
    go through autograd of plain PyTorch ops)."""
    from graphs4cfd_tpu_torch.ops import fused_mlp, gn_block as gn_op
    from graphs4cfd_tpu_torch.ops import segment
    saved = (fused_mlp.mlp_chain, gn_op.gn_block,
             segment.sorted_segment_sum)
    fused_mlp.mlp_chain = fused_mlp.mlp_chain_plain
    gn_op.gn_block = gn_op.gn_block_plain
    segment.sorted_segment_sum = segment.sorted_segment_sum_plain
    try:
        yield
    finally:
        (fused_mlp.mlp_chain, gn_op.gn_block,
         segment.sorted_segment_sum) = saved


def counters():
    from graphs4cfd_tpu_torch.ops import fused_mlp, gn_block as gn_op
    from graphs4cfd_tpu_torch.ops import segment
    return {"mlp_chain": fused_mlp.mlp_chain,
            "gn_block": gn_op.gn_block,
            "mlp_chain_bwd": fused_mlp.mlp_chain_bwd,
            "gn_block_bwd": gn_op.gn_block_bwd,
            "sorted_segment_sum": segment.sorted_segment_sum}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def training_phase(model, g, smi):
    """The training step of the JAX package's ``bench.py`` on the port."""
    from graphs4cfd_tpu_torch.nn import GraphLoss
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    crit = GraphLoss(lambda_d=0.25)
    n_out = 1
    step = make_train_step(model, crit, 3, n_out, 1.0)
    params = list(model.parameters())
    state = adam_init(params)
    loss, gnorm = step(state, g, LR)                    # warm-up
    torch.cuda.synchronize()

    reset_counts()
    loss, gnorm = step(state, g, LR)
    torch.cuda.synchronize()
    launches = read_counts()
    loss, gnorm = loss.item(), gnorm.item()
    say("training", f"train_step(n_out={n_out}): loss {loss:.6f}, gradient "
        f"norm {gnorm:.6f}; launches {launches}")
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        fail("training", "non-finite loss or gradient norm")
    want = {"mlp_chain": 23 * n_out, "gn_block": 8 * n_out,
            "mlp_chain_bwd": 23 * n_out, "gn_block_bwd": 8 * n_out,
            "sorted_segment_sum": 8 * n_out}
    if launches != want:
        fail("training", f"launch counts {launches}, want {want}")

    # one rollout step's gradients: kernels against plain versions
    def grads():
        pred = model(g)
        return torch.autograd.grad(crit(g, pred, g.target[:, :3]), params)
    gk = grads()
    with plain_kernels():
        gp = grads()
    worst, name = 0.0, None
    for (n, _), a, b in zip(model.named_parameters(), gk, gp):
        r = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if r > worst:
            worst, name = r, n
    say("training", f"one step's gradients, kernels vs plain versions: max "
        f"over parameters of max abs difference / max abs {worst:.3e} "
        f"({name}; tol {GRAD_TOL})")
    if not worst <= GRAD_TOL:
        fail("training", f"gradients differ from plain by {worst} ({name})")

    # determinism: two steps from the same parameters and Adam state
    saved = [p.detach().clone() for p in params]
    saved_state = state.clone()
    ends = []
    for _ in range(2):
        with torch.no_grad():
            for p, s in zip(params, saved):
                p.copy_(s)
        st = saved_state.clone()
        step(st, g, LR)
        ends.append([p.detach().clone() for p in params] + st.mu + st.nu)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(*ends))
    say("training", f"two train_steps from the same parameters and Adam "
        f"state: {'bit-identical' if same else 'DIFFERENT'} "
        f"({len(params)} parameters, their Adam moments)")
    if not same:
        fail("training", "train_step is not deterministic")

    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, g, LR)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) / n_out)
    step_ms = 1e3 * float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    edges = int(g.edge_mask.sum().item())
    say("training", f"{step_ms:.3f} ms per training step (median of 3 "
        f"train_step(n_out={n_out})) on {smi}")
    say("training", f"{edges * n_out * 1e3 / step_ms:.4e} level-1 edges/s "
        f"({edges} valid edges x n_out={n_out}) on {smi}")
    say("training", f"peak device memory {peak:.3f} GiB "
        f"(torch.cuda.max_memory_allocated) on {smi}")
    return launches


def main():
    # 1. device
    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is False; this script "
             "runs only on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    from graphs4cfd_tpu_torch.ops import _build
    nvcc = subprocess.run([_build.find_nvcc(), "--version"],
                          capture_output=True, text=True, timeout=60)
    say("device", f"{name}; torch {torch.__version__} (CUDA "
        f"{torch.version.cuda}); {nvcc.stdout.strip().splitlines()[-1]}")
    print(smi, flush=True)

    # 2. build
    _build.load()
    info = _build.build_info
    say("build", f"{'built' if info['built'] else 'cached'} {info['path']} "
        f"in {info['seconds']:.1f} s")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("build", line.strip())

    # 3. kernels against their plain versions
    rng = np.random.default_rng(0)
    results = [check_mlp_chain(dev, rng), check_gn_block(dev, rng),
               check_mlp_chain_bwd(dev, rng), check_gn_block_bwd(dev, rng),
               check_sorted_segment_sum(dev, rng)]

    # 4. host graphs
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import collate
    t = time.perf_counter()
    batch = collate(make_samples(8, 5000, seed=7), node_bucket=512,
                    edge_bucket=1024)
    sizes = {"V": batch.num_nodes, "E": batch.num_edges,
             "V2": batch.pos_2.shape[0], "E2": batch.senders_2.shape[0],
             "V3": batch.pos_3.shape[0], "E3": batch.senders_3.shape[0]}
    say("graphs", f"{sizes} in {time.perf_counter() - t:.1f} s")
    if sizes != BENCH_SIZES:
        fail("graphs", f"sizes {sizes} differ from {BENCH_SIZES}")

    # 5. main path
    from graphs4cfd_tpu_torch.nn import NsThreeScaleGNN
    model = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev)
    if model.num_params != 2713347:
        fail("main path", f"{model.num_params} parameters, want 2713347")
    g = Graph.from_numpy(batch, dev)
    n_out = 4
    model.solve(g, 1)                                  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = model.solve(g, n_out)
    torch.cuda.synchronize()
    launches = read_counts()
    say("main path", f"NsThreeScaleGNN {model.num_params} params; "
        f"solve(n_out={n_out}) -> {tuple(out.shape)}; launches {launches}")
    mask = g.node_mask
    if tuple(out.shape) != (sizes["V"], 3 * n_out):
        fail("main path", f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out[mask]).all()):
        fail("main path", "non-finite values on valid rows")
    if launches["gn_block"] != 8 * n_out or launches["mlp_chain"] < 16 * n_out:
        fail("main path", f"launch counts {launches}: want gn_block == "
             f"{8 * n_out}, mlp_chain >= {16 * n_out}")

    with torch.inference_mode():
        step_k = model(g)
        with plain_kernels():
            step_p = model(g)
    _, rel = errors(step_k[mask], step_p[mask])
    say("main path", f"one step, kernels vs plain versions: max rel "
        f"difference {rel:.3e} (tol {PATH_TOL})")
    if not rel <= PATH_TOL:
        fail("main path", f"kernels differ from plain by {rel}")

    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.solve(g, n_out)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) / n_out)
    step_ms = 1e3 * float(np.median(times))
    edges = int(g.edge_mask.sum().item())
    say("main path", f"{step_ms:.3f} ms per rollout step (median of 3 "
        f"solve(n_out={n_out})), {edges * 1e3 / step_ms:.4e} level-1 "
        f"edges/s ({edges} valid edges) on {smi}")

    # 6. training
    train_launches = training_phase(model, g, smi)
    for r in results:
        r["launches"] = (launches if r["name"] in ("mlp_chain", "gn_block")
                         else train_launches)[r["name"]]

    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
