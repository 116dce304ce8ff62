"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one flushed line each with the elapsed seconds:

1. device: fails without CUDA (there is no CPU fallback); prints the card,
   its power limit (nvidia-smi), torch and nvcc versions;
2. build: compiles ``graphs4cfd_tpu_torch/csrc/*.cu`` with nvcc into
   ``build/`` (or finds the library of the same sources there);
3. remus graphs: the REMuS workload of the JAX package's
   ``tools/bench_families.py:_bench_remus`` (4 clouds of 5000 nodes drawn
   from numpy seed 0, k=5, 3 levels, buckets 512/1024) through the port's
   host pipeline; checks the level sizes;
4. kernels: each CUDA kernel against its plain PyTorch version on the card,
   at the shapes of the main paths, f32 with TF32 off: error, time, bound
   (the REMuS backward cases with that graph's angle sources);
5. graphs: 8 graphs of 5000 nodes (numpy seed 7) through the port's host
   pipeline and ``collate`` (buckets 512/1024);
6. main path: ``NsThreeScaleGNN`` at the flagship arch (128 wide, 16 MP
   layers, random weights from seed 0) runs ``solve(n_out=4)``; checks the
   output, the kernel launch counts, and one step against the same step
   with the plain versions; prints ms per step and level-1 edges/s;
7. training: ``make_train_step(model, GraphLoss(0.25), 3, 1, 1.0)`` with
   lr 1e-4, as the JAX package's ``bench.py`` runs it; checks the loss and
   gradient norm are finite, the launch counts of one rollout step, one
   step's gradients against the same with the plain versions, and that two
   steps from the same parameters and Adam state give the same bits;
   prints ms per training step, level-1 edges/s and peak device memory;
8. remus path: ``NsRotEquiThreeScaleGNN`` at that workload's arch (128
   wide, 16 EdgeMP layers, 2 down, 2 up, random weights from seed 0) runs
   ``solve(n_out=4)``; checks the output, the launch counts (the GN-block
   kernel runs every EdgeMP and DownEdgeMP layer), and one step against
   the plain versions; prints ms per step, level-1 edges/s and peak
   device memory;
9. remus training: that model's training step,
   ``make_train_step(model, GraphLoss(0.25), 2, 1, 1.0)`` with lr 1e-4
   over the batch with ``attach_angle_sorts``; checks as phase 7 (the
   backward kernels run every EdgeMP and DownEdgeMP layer, each with its
   sorted angle-source sum) and prints the same numbers;
10. gmus graphs: the gMuS workload of ``tools/bench_families.py:_bench_gmus``
   (8 clouds of 5000 nodes drawn from numpy seed 0, Guillard coarsening
   with k=6 on 3 levels, edge scales 0.1/0.25/0.5, interpolation weights
   k=6, buckets 512/1024) through the port's host pipeline, with the host
   sorts of every level's senders (``attach_sender_sorts``); checks the
   level sizes;
11. gmus kernels: the GN-block kernel and its backward at the shapes of
   the two layers that take a 256-wide node input (the skip concatenated
   after an up step): ``mp121`` (level 1, V=40448, k=6) and ``mp221``
   (level 2, V=8192 with its pad nodes), with that graph's senders and
   their host sorts, against their plain versions: error, time, bound;
12. gmus path: ``NsThreeGuillardScaleGNN`` at that workload's arch (128
   wide, 16 MP layers, random weights from seed 0) runs
   ``solve(n_out=4)``; checks as phase 8 (every MP layer runs the GN-block
   kernel) and prints the same numbers;
13. gmus training: that model's training step,
   ``make_train_step(model, GraphLoss(0.25), 3, 1, 1.0)`` with lr 1e-4;
   checks as phase 9 (every MP layer's backward runs the backward kernel
   and its sorted per-sender sum) and prints the same numbers.

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
REMUS_SIZES = {"V": 20480, "E": 102400, "V2": 4608, "E2": 23040,
               "V3": 1536, "E3": 7680}
REMUS_PARAMS = 2370689
GMUS_SIZES = {"V": 40448, "E": 242688, "V2": 8192, "E2": 49152,
              "V3": 2048, "E3": 12288}
GMUS_PARAMS = 2645507


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


def clouds(num, n_nodes, seed, nf, pipeline):
    """Point clouds as ``tools/bench_families.py:cloud(n, nf)`` and the JAX
    package's ``bench.py`` draw them, in turn from one generator, each
    through ``pipeline``."""
    from graphs4cfd_tpu_torch.graph import Graph
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


def make_samples(num, n_nodes, seed, nf=3, k=6, cells=(0.15, 0.30)):
    """Synthetic NsCircle-shaped samples, as the JAX package's benchmark
    builds them, through the port's own transforms."""
    from graphs4cfd_tpu_torch import transforms as T
    return clouds(num, n_nodes, seed, nf, [
        T.SpatialSort(), T.ConnectKNN(k=k), T.ScaleEdgeAttr(0.15),
        T.GridClustering(list(cells))])


def remus_arch(w=128):
    """``tools/bench_families.py:_bench_remus``'s arch."""
    emp = ((w + 2 * w, (w, w), True), (w + w, (w, w), True))
    enc = lambda n: (n, (w, w), True)
    return {
        "angle_encoder": enc(4), "angle_encoder12": enc(4),
        "angle_encoder2": enc(4), "angle_encoder23": enc(4),
        "angle_encoder3": enc(4), "edge_encoder": enc(3),
        "edge_encoder2": enc(3), "edge_encoder3": enc(3),
        "mp111": emp, "mp112": emp, "mp113": emp, "mp114": emp,
        "down_mp12": emp,
        "mp211": emp, "mp212": emp,
        "down_mp23": emp,
        "mp31": emp, "mp32": emp, "mp33": emp, "mp34": emp,
        "up_mp32": (w + w, (w, w, w), True),
        "mp221": emp, "mp222": emp,
        "up_mp21": (w + w, (w, w, w), True),
        "mp121": emp, "mp122": emp, "mp123": emp, "mp124": emp,
        "decoder": (w, (w, 1), False),
    }


def make_remus_samples(num=4, n_nodes=5000, seed=0):
    """The clouds of ``tools/bench_families.py:cloud(n, 2, n_in=1)``
    through the port's REMuS transforms."""
    from graphs4cfd_tpu_torch import transforms as T
    return clouds(num, n_nodes, seed, 2, [
        T.SpatialSort(),
        T.BuildRemusGraph(num_levels=3, k=5,
                          scale_edge_length=(0.1, 0.2, 0.4)),
        T.BuildKnnInterpWeights(5)])


def gmus_arch(w=128):
    """``tools/bench_families.py:_bench_gmus``'s arch: ``mp221`` and
    ``mp121`` take the interpolated state and the skip, ``2 w`` wide."""
    mp = ((w + 2 * w, (w, w, w), True), (w + w, (w, w, w), True))
    up = ((w + 2 * 2 * w, (w, w, w), True), (w + 2 * w, (w, w, w), True))
    enc = lambda n: (n, (w, w, w), False)
    return {
        "edge_encoder": enc(2), "edge_encoder2": enc(2),
        "edge_encoder3": enc(2), "node_encoder": enc(5),
        "mp111": mp, "mp112": mp, "mp113": mp, "mp114": mp,
        "mp211": mp, "mp212": mp,
        "mp31": mp, "mp32": mp, "mp33": mp, "mp34": mp,
        "mp221": up, "mp222": mp,
        "mp121": up, "mp122": mp, "mp123": mp, "mp124": mp,
        "decoder": (w, (w, w, 3), False),
    }


def make_gmus_samples(num=8, n_nodes=5000, seed=0):
    """The clouds of ``tools/bench_families.py:cloud(n, 3)`` through the
    port's gMuS transforms."""
    from graphs4cfd_tpu_torch import transforms as T
    return clouds(num, n_nodes, seed, 3, [
        T.SpatialSort(),
        T.GuillardCoarseningAndConnectKNN(k=[6, 6, 6],
                                          scale_edge_attr=(0.1, 0.25, 0.5)),
        T.BuildKnnInterpWeights(6)])


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


def gn_flops(E, V, fe, fv, ed, nd):
    """Products of one GN block: the edge chain over E rows (``We`` and the
    tail), the node side over V rows (``Wr``, ``[Wa; Wv]`` and the tail)."""
    edge = fe * ed[1] + sum(p * q for p, q in zip(ed[1:-1], ed[2:]))
    node = fv * ed[1] + sum(p * q for p, q in zip(nd[:-1], nd[1:]))
    return 2 * E * edge + 2 * V * node


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
        flops = gn_flops(E, V, H, H, [3 * H, H, H, H], [2 * H, H, H, H])
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


def check_remus_gn_block(dev, rng):
    """The GN-block kernel on REMuS's line graphs: one level-1 EdgeMP (the
    102,400 edges are the "nodes", their 512,000 angles the "edges", the
    table is the edge table itself) and ``down_mp12`` (23,040 coarse edges
    fed by a table of the 102,400 fine edges, angles not stored).  The
    angle sources have the canonical form ``node * k + arange(k)``."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    k, H, nodes1 = 5, 128, 20480
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    out = []
    for name, V, S, replaces in (
            ("edge_mp", 102400, 102400,
             "graphs4cfd_tpu/ops/pallas_edgemp.py:112"),
            ("down_edge_mp", 23040, 102400,
             "graphs4cfd_tpu/ops/pallas_gnblock.py:132")):
        a, src, e = t(V * k, H), t(S, H), t(V, H)
        nodes = rng.integers(0, nodes1, V)
        senders = torch.from_numpy((nodes[:, None] * k + np.arange(k)).reshape(
            -1).astype(np.int32)).to(dev)
        angle = uniform_chain(rng, [3 * H, H, H], True, dev)
        edge = uniform_chain(rng, [2 * H, H, H], True, dev)
        vs = src @ angle[0][0][H:2 * H]
        params = [*angle[0], *angle[1], *angle[2], *edge[0], *edge[1],
                  *edge[2]]
        res = None
        for skip in ((False, True) if name == "edge_mp" else (True,)):
            run = lambda: gn_op.gn_block(a, vs, e, senders, k, angle, edge,
                                         out_selu=True, skip_e_out=skip)
            plain = lambda: gn_op.gn_block_plain(a, vs, e, senders, k, angle,
                                                 edge, out_selu=True,
                                                 skip_e_out=skip)
            (eo, ao), (er, ar) = run(), plain()
            torch.cuda.synchronize()
            err, rel = errors(eo, er)
            if skip:
                if ao is not None:
                    fail("kernels", f"gn_block ({name}) with skip_e_out "
                         "returned the angles")
            else:
                err_a, rel_a = errors(ao, ar)
                err, rel = max(err, err_a), max(rel, rel_a)
            flops = gn_flops(V * k, V, H, H, [3 * H, H, H], [2 * H, H, H])
            bms, by = bound_ms(flops, nbytes(a, vs, e, senders, eo, ao,
                                             *params))
            ms, pms = cuda_ms(run), cuda_ms(plain)
            say("kernels", f"gn_block ({name}) {V} edges x k={k}, table "
                f"S={S}, H={H}, out_selu, skip angles={skip}: max abs err "
                f"{err:.3e} max rel {rel:.3e} (tol {GN_TOL}); kernel "
                f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
                f"({by}); {gn_op.gn_block.launches} launches in these "
                "checks")
            if not err <= GN_TOL:
                fail("kernels", f"gn_block ({name}) error {err} above "
                     f"{GN_TOL}")
            if res is None:
                res = {"name": f"gn_block[{name}]", "route": "cuda",
                       "source": "graphs4cfd_tpu_torch/csrc/gn_block.cu",
                       "replaces": replaces, "max_abs_err": err, "ms": ms,
                       "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                       "library_ms": None}
        out.append(res)
    return out


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
          + (d(v) @ d(ew[0][ew[0].shape[0] - fv:])).repeat_interleave(k, 0)
          + d(eb[0]))
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


def bwd_outputs(res):
    """The outputs of ``gn_block_bwd`` as one list of tensors."""
    de, dv, dvs, (ew, eb, eln), (nw, nb, nln) = res
    return [de, dv, dvs, *ew, *eb, *eln, *nw, *nb, *nln]


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
        pairs = list(zip(bwd_outputs(got), bwd_outputs(ref)))
        err = max(errors(a, b)[0] for a, b in pairs)
        rel = max(scaled_err(a, b) for a, b in pairs)
        flops = 3 * gn_flops(E, V, H, H, [3 * H, H, H, H], [2 * H, H, H, H])
        bms, by = bound_ms(flops, nbytes(e, vs, v, senders, *sort, gv, ge,
                                         *params, *bwd_outputs(got)))
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("kernels", f"gn_block_bwd V={V} k={k} H={H} out_selu skip_e_out="
            f"{skip}: max abs err {err:.3e}, over max(1, max|ref|) {rel:.3e} "
            f"(tol {GN_BWD_TOL}; {int(kinked.sum())} nodes by a SELU kink "
            f"and their edges given a zero cotangent); kernel {ms:.4f} ms, "
            f"plain {pms:.4f} ms, bound {bms:.4f} ms ({by})")
        if not rel <= GN_BWD_TOL:
            fail("kernels", f"gn_block_bwd error {rel} above {GN_BWD_TOL}")
        if not all(torch.equal(a, b) for a, b in zip(bwd_outputs(run()),
                                                     bwd_outputs(run()))):
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


def host_sort(idx, dev):
    """``(perm, sorted)`` of an int array, flattened, as
    ``attach_angle_sorts`` makes them, on ``dev``."""
    idx = np.asarray(idx).reshape(-1)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    return tuple(torch.from_numpy(x).to(dev) for x in (perm, idx[perm]))


def check_remus_gn_block_bwd(dev, rng, rbatch, smi):
    """The backward kernel at the REMuS line-graph shapes, with the REMuS
    graph's own angle sources and their host sorts: a level-1 EdgeMP layer
    (102,400 receiving edges x k=5, its 12,000 pad angle rows all reading
    edge 0; table S=102,400; angles stored) and ``down_mp12`` (23,040
    coarse edges x k=5 from the 102,400 fine edges, ``skip_e_out``).  The
    time per launch includes the ``dvs`` sum (``sorted_segment_sum``)."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    k, H = 5, 128
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    out = []
    for name, src_key, skip, replaces in (
            ("edge_mp", "angle_src", False,
             "graphs4cfd_tpu/ops/pallas_edgemp.py:151"),
            ("down_edge_mp", "xangle_src_2", True,
             "graphs4cfd_tpu/ops/pallas_gnblock.py:152")):
        src_idx = rbatch.data[src_key]
        V, S = src_idx.shape[0], rbatch.angle_src.shape[0]
        senders = torch.from_numpy(src_idx.reshape(-1)).to(dev)
        sort = host_sort(src_idx, dev)
        a, src, e = t(V * k, H), t(S, H), t(V, H)
        angle = uniform_chain(rng, [3 * H, H, H], True, dev)
        edge = uniform_chain(rng, [2 * H, H, H], True, dev)
        vs = src @ angle[0][0][H:2 * H]
        kinked = gn_kink_nodes(a, vs, e, senders, k, angle, edge, True)
        gv = quiet(t(V, H), kinked)
        ge = None if skip else quiet(t(V * k, H), kinked.repeat_interleave(k))
        run = lambda: gn_op.gn_block_bwd(a, vs, e, senders, sort, k, angle,
                                         edge, gv, ge, out_selu=True)
        plain = lambda: gn_op.gn_block_bwd_plain(a, vs, e, senders, sort, k,
                                                 angle, edge, gv, ge,
                                                 out_selu=True)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(bwd_outputs(got), bwd_outputs(ref)))
        err = max(errors(x, y)[0] for x, y in pairs)
        rel = max(scaled_err(x, y) for x, y in pairs)
        params = [*angle[0], *angle[1], *angle[2], *edge[0], *edge[1],
                  *edge[2]]
        flops = 3 * gn_flops(V * k, V, H, H, [3 * H, H, H], [2 * H, H, H])
        bms, by = bound_ms(flops, nbytes(a, vs, e, senders, *sort, gv, ge,
                                         *params, *bwd_outputs(got)))
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("kernels", f"gn_block_bwd ({name}) {V} edges x k={k}, table "
            f"S={S}, H={H}, out_selu, skip angles={skip}: max abs err "
            f"{err:.3e}, over max(1, max|ref|) {rel:.3e} (tol {GN_BWD_TOL}; "
            f"{int(kinked.sum())} receivers by a SELU kink and their angles "
            f"given a zero cotangent); kernel {ms:.4f} ms (with its dvs "
            f"sum), plain {pms:.4f} ms, bound {bms:.4f} ms ({by}) on {smi}")
        if not rel <= GN_BWD_TOL:
            fail("kernels", f"gn_block_bwd ({name}) error {rel} above "
                 f"{GN_BWD_TOL}")
        if not all(torch.equal(x, y) for x, y in zip(bwd_outputs(run()),
                                                     bwd_outputs(run()))):
            fail("kernels", f"gn_block_bwd ({name}): two launches differ")
        out.append({"name": f"gn_block_bwd[{name}]", "route": "cuda",
                    "source": "graphs4cfd_tpu_torch/csrc/gn_block_bwd.cu",
                    "replaces": replaces, "max_abs_err": err, "ms": ms,
                    "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                    "library_ms": None})
        del got, ref
    return out


def check_remus_segment_sum(dev, rng, rbatch, smi):
    """The angle-source transpose (the ``dvs`` sums of the REMuS backward)
    over the REMuS graph's sources and their host sorts: a level-1 EdgeMP
    (512,000 angle rows into the 102,400 edges; ``collate`` points the
    12,000 pad angle rows at edge 0) and ``down_mp12`` (115,200
    inter-level angle rows into the 102,400 fine edges, most of which no
    angle reads: empty segments, written as zero).  ``index_add_`` computes
    the same sums with float atomics and is timed as the library call.
    For the level-1 case the sum is also timed with the pad angles pointed
    at their own pad edges: what the pile in segment 0 costs."""
    from graphs4cfd_tpu_torch.ops import segment
    H, S = 128, rbatch.angle_src.shape[0]
    out = []
    for name, key in (("edge_mp", "angle_src"), ("down_edge_mp",
                                                  "xangle_src_2")):
        idx = rbatch.data[key]
        src = torch.from_numpy(rng.normal(size=(idx.size, H)).astype(
            np.float32)).to(dev)
        perm, srt = host_sort(idx, dev)
        run = lambda: segment.sorted_segment_sum(src, perm, srt, S)
        plain = lambda: segment.sorted_segment_sum_plain(src, perm, srt, S)
        lidx = torch.from_numpy(idx.reshape(-1).astype(np.int64)).to(dev)
        lib = lambda: torch.zeros(S, H, device=dev).index_add_(0, lidx, src)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        err, rel = errors(got, ref)[0], scaled_err(got, ref)
        empty = S - int(np.unique(idx).size)
        bms, by = bound_ms(idx.size * H, nbytes(src, perm, srt, got))
        res = {"name": f"sorted_segment_sum[{name}]", "route": "cuda",
               "source": "graphs4cfd_tpu_torch/csrc/sorted_segment_sum.cu",
               "replaces": "graphs4cfd_tpu/ops/pallas_gather.py:57",
               "max_abs_err": err, "ms": cuda_ms(run),
               "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
               "library_ms": cuda_ms(lib)}
        longest = int(np.bincount(idx.reshape(-1)).max())
        say("kernels", f"sorted_segment_sum ({name}) [{idx.size}, {H}] -> "
            f"{S} ({empty} empty segments, the longest {longest} rows): "
            f"max abs err {err:.3e} (tol {SEG_TOL} of max(1, max|ref|)); "
            f"kernel {res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"index_add_ {res['library_ms']:.4f} ms, bound {bms:.4f} ms "
            f"({by}) on {smi}")
        if not rel <= SEG_TOL:
            fail("kernels", f"sorted_segment_sum ({name}) error {rel} above "
                 f"{SEG_TOL}")
        if empty and got[~torch.isin(torch.arange(S, device=dev),
                                     lidx)].any():
            fail("kernels", f"sorted_segment_sum ({name}): an empty "
                 "segment is not zero")
        if not torch.equal(run(), run()):
            fail("kernels", f"sorted_segment_sum ({name}): two launches "
                 "differ")
        if name == "edge_mp":
            pads = ~rbatch.edge_mask
            own = idx.copy()
            own[pads] = np.nonzero(pads)[0][:, None]
            operm, osrt = host_sort(own, dev)
            oms = cuda_ms(lambda: segment.sorted_segment_sum(src, operm,
                                                             osrt, S))
            say("kernels", f"sorted_segment_sum ({name}) with the "
                f"{int(pads.sum()) * idx.shape[1]} pad angle rows pointed at "
                f"their own pad edges instead of edge 0: {oms:.4f} ms on "
                f"{smi}")
        out.append(res)
    return out


def check_gmus_gn_kernels(dev, rng, gbatch, smi):
    """The GN-block kernel and its backward at the two gMuS layers that
    take a 256-wide node input (the interpolated state and the skip):
    ``mp121`` (level 1: 40,448 nodes x k=6, row 5 and row 6) and ``mp221``
    (level 2: 8,192 nodes x k=6, 1,024 of them pad nodes whose edges are
    self-loops; rows 3 and 4), with the gMuS graph's senders and their
    host sorts.  Chains 128 wide with LayerNorm, ``out_selu``, e' stored
    (neither is the last layer of its level).  The backward's time includes
    its ``dvs`` sum."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    k, H, fv = 6, 128, 256
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    out = []
    for name, s, fwd_of, bwd_of in (
            ("mp121", "", "graphs4cfd_tpu/ops/pallas_gnblock.py:517",
             "graphs4cfd_tpu/ops/pallas_gnblock.py:556"),
            ("mp221", "_2", "graphs4cfd_tpu/ops/pallas_gnblock.py:132",
             "graphs4cfd_tpu/ops/pallas_gnblock.py:152")):
        senders = torch.from_numpy(gbatch.data[f"senders{s}"]).to(dev)
        sort = tuple(torch.from_numpy(gbatch.data[f"sender_{key}{s}"]).to(
            dev) for key in ("perm", "sorted"))
        V = senders.shape[0] // k
        e, v = t(V * k, H), t(V, fv)
        ed, nd = [H + 2 * fv, H, H, H], [H + fv, H, H, H]
        edge = uniform_chain(rng, ed, True, dev)
        node = uniform_chain(rng, nd, True, dev)
        vs = v @ edge[0][0][H:H + fv]
        params = [*edge[0], *edge[1], *edge[2], *node[0], *node[1], *node[2]]
        flops = gn_flops(V * k, V, H, fv, ed, nd)

        run = lambda: gn_op.gn_block(e, vs, v, senders, k, edge, node,
                                     out_selu=True)
        plain = lambda: gn_op.gn_block_plain(e, vs, v, senders, k, edge,
                                             node, out_selu=True)
        (vo, eo), (vr, er) = run(), plain()
        torch.cuda.synchronize()
        err = max(errors(vo, vr)[0], errors(eo, er)[0])
        bms, by = bound_ms(flops, nbytes(e, vs, v, senders, vo, eo, *params))
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("gmus kernels", f"gn_block ({name}) V={V} k={k} H={H} fv={fv} "
            f"out_selu: max abs err {err:.3e} (tol {GN_TOL}); kernel "
            f"{ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms ({by}) "
            f"on {smi}")
        if not err <= GN_TOL:
            fail("gmus kernels", f"gn_block ({name}) error {err} above "
                 f"{GN_TOL}")
        out.append({"name": f"gn_block[{name}]", "route": "cuda",
                    "source": "graphs4cfd_tpu_torch/csrc/gn_block.cu",
                    "replaces": fwd_of, "max_abs_err": err, "ms": ms,
                    "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                    "library_ms": None})
        del vo, eo, vr, er

        kinked = gn_kink_nodes(e, vs, v, senders, k, edge, node, True)
        gv = quiet(t(V, H), kinked)
        ge = quiet(t(V * k, H), kinked.repeat_interleave(k))
        run = lambda: gn_op.gn_block_bwd(e, vs, v, senders, sort, k, edge,
                                         node, gv, ge, out_selu=True)
        plain = lambda: gn_op.gn_block_bwd_plain(e, vs, v, senders, sort, k,
                                                 edge, node, gv, ge,
                                                 out_selu=True)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        pairs = list(zip(bwd_outputs(got), bwd_outputs(ref)))
        err = max(errors(a, b)[0] for a, b in pairs)
        rel = max(scaled_err(a, b) for a, b in pairs)
        bms, by = bound_ms(3 * flops, nbytes(e, vs, v, senders, *sort, gv, ge,
                                             *params, *bwd_outputs(got)))
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("gmus kernels", f"gn_block_bwd ({name}) V={V} k={k} H={H} "
            f"fv={fv} out_selu: max abs err {err:.3e}, over max(1, "
            f"max|ref|) {rel:.3e} (tol {GN_BWD_TOL}; {int(kinked.sum())} "
            f"nodes by a SELU kink and their edges given a zero cotangent); "
            f"kernel {ms:.4f} ms (with its dvs sum), plain {pms:.4f} ms, "
            f"bound {bms:.4f} ms ({by}) on {smi}")
        if not rel <= GN_BWD_TOL:
            fail("gmus kernels", f"gn_block_bwd ({name}) error {rel} above "
                 f"{GN_BWD_TOL}")
        if not all(torch.equal(a, b) for a, b in zip(bwd_outputs(run()),
                                                     bwd_outputs(run()))):
            fail("gmus kernels", f"gn_block_bwd ({name}): two launches "
                 "differ")
        if got[1].shape != (V, fv) or got[3][0][0][H:H + fv].any():
            fail("gmus kernels", f"gn_block_bwd ({name}): dv is not "
                 f"[{V}, {fv}] or the Ws rows of dW1 are not zero")
        out.append({"name": f"gn_block_bwd[{name}]", "route": "cuda",
                    "source": "graphs4cfd_tpu_torch/csrc/gn_block_bwd.cu",
                    "replaces": bwd_of, "max_abs_err": err, "ms": ms,
                    "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                    "library_ms": None})
        del got, ref
    return out


@contextlib.contextmanager
def gn_launch_shapes():
    """Tally the GN kernels' launches by direction and ``(V, fv)``: which
    launches ran the layers with a 256-wide node input."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    tally = {}
    fwd, bwd = gn_op._launch_fwd, gn_op._launch_bwd

    def counted(direction, launch):
        def run(e, vs, v, *args):
            key = (direction, tuple(v.shape))
            tally[key] = tally.get(key, 0) + 1
            return launch(e, vs, v, *args)
        return run

    gn_op._launch_fwd = counted("gn_block", fwd)
    gn_op._launch_bwd = counted("gn_block_bwd", bwd)
    try:
        yield tally
    finally:
        gn_op._launch_fwd, gn_op._launch_bwd = fwd, bwd


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


def step_against_plain(phase, model, g):
    """One rollout step, kernels against plain versions, on the valid
    rows: within PATH_TOL of the plain output's max abs."""
    mask = g.node_mask
    with torch.inference_mode():
        step_k = model(g)
        with plain_kernels():
            step_p = model(g)
    _, rel = errors(step_k[mask], step_p[mask])
    say(phase, f"one step, kernels vs plain versions: max rel difference "
        f"{rel:.3e} (tol {PATH_TOL})")
    if not rel <= PATH_TOL:
        fail(phase, f"kernels differ from plain by {rel}")


def grads_against_plain(phase, model, g, crit, nf):
    """One rollout step's gradients, kernels against plain versions: each
    parameter within GRAD_TOL of its max abs."""
    params = list(model.parameters())

    def grads():
        pred = model(g)
        return torch.autograd.grad(crit(g, pred, g.target[:, :nf]), params)
    gk = grads()
    with plain_kernels():
        gp = grads()
    worst, name = 0.0, None
    for (n, _), a, b in zip(model.named_parameters(), gk, gp):
        r = (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30)
        if r > worst:
            worst, name = r, n
    say(phase, f"one step's gradients, kernels vs plain versions: max over "
        f"parameters of max abs difference / max abs {worst:.3e} ({name}; "
        f"tol {GRAD_TOL})")
    if not worst <= GRAD_TOL:
        fail(phase, f"gradients differ from plain by {worst} ({name})")


def steps_deterministic(phase, model, step, state, g):
    """Two training steps from the same parameters and Adam state give the
    same bits."""
    params = list(model.parameters())
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
    say(phase, f"two train_steps from the same parameters and Adam state: "
        f"{'bit-identical' if same else 'DIFFERENT'} ({len(params)} "
        f"parameters, their Adam moments)")
    if not same:
        fail(phase, "train_step is not deterministic")


def time_steps(phase, run, n_out, g, smi, what):
    """Median of 3 host-clock times of ``run()`` (``n_out`` steps, ending
    in a synchronise): ms per step, level-1 edges/s, peak device memory."""
    times = []
    torch.cuda.reset_peak_memory_stats()
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) / n_out)
    step_ms = 1e3 * float(np.median(times))
    peak = torch.cuda.max_memory_allocated() / 2**30
    edges = int(g.edge_mask.sum().item())
    say(phase, f"{step_ms:.3f} ms per {what} step (median of 3, "
        f"n_out={n_out}) on {smi}")
    say(phase, f"{edges * 1e3 / step_ms:.4e} level-1 edges/s ({edges} "
        f"valid edges) on {smi}")
    say(phase, f"peak device memory {peak:.3f} GiB "
        f"(torch.cuda.max_memory_allocated) on {smi}")


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

    grads_against_plain("training", model, g, crit, 3)
    steps_deterministic("training", model, step, state, g)
    time_steps("training", lambda: step(state, g, LR), n_out, g, smi,
               "training")
    return launches


def remus_phase(batch, dev, smi):
    """``solve(n_out=4)`` of the REMuS workload; returns the launch counts
    and how many ``gn_block`` launches came from ``down_edge_mp``."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.nn import NsRotEquiThreeScaleGNN, remus_gnn
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    model = NsRotEquiThreeScaleGNN(arch=remus_arch(), seed=0, device=dev)
    if model.num_params != REMUS_PARAMS:
        fail("remus path", f"{model.num_params} parameters, want "
             f"{REMUS_PARAMS}")
    g = Graph.from_numpy(batch, dev)
    n_out = 4
    model.solve(g, 1)                                  # warm-up
    torch.cuda.synchronize()

    # which of the GN-block launches pool (the rest are EdgeMP layers)
    down, in_down = remus_gnn.down_edge_mp, [0]

    def counted_down(*args, **kw):
        before = gn_op.gn_block.launches
        out = down(*args, **kw)
        in_down[0] += gn_op.gn_block.launches - before
        return out

    remus_gnn.down_edge_mp = counted_down
    try:
        reset_counts()
        out = model.solve(g, n_out)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        remus_gnn.down_edge_mp = down
    say("remus path", f"NsRotEquiThreeScaleGNN {model.num_params} params; "
        f"solve(n_out={n_out}) -> {tuple(out.shape)}; launches {launches}, "
        f"{in_down[0]} of the gn_block launches in down_edge_mp")
    mask = g.node_mask
    if tuple(out.shape) != (REMUS_SIZES["V"], 2 * n_out):
        fail("remus path", f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out[mask]).all()):
        fail("remus path", "non-finite values on valid rows")
    # per step: 16 EdgeMP + 2 DownEdgeMP layers; 8 encoders, 2 unpooling
    # tails and the decoder through the MLP-chain kernel
    want = {"mlp_chain": 11 * n_out, "gn_block": 18 * n_out,
            "mlp_chain_bwd": 0, "gn_block_bwd": 0, "sorted_segment_sum": 0}
    if launches != want or in_down[0] != 2 * n_out:
        fail("remus path", f"launch counts {launches} ({in_down[0]} in "
             f"down_edge_mp), want {want} ({2 * n_out})")

    step_against_plain("remus path", model, g)

    time_steps("remus path", lambda: model.solve(g, n_out), n_out, g, smi,
               "rollout")
    return launches, in_down[0]


def remus_training_phase(batch, dev, smi):
    """The REMuS training step of ``tools/bench_families.py:_bench_remus``
    on the port: ``make_train_step(model, GraphLoss(0.25), 2, 1, 1.0)``,
    lr 1e-4, the host sorts of ``attach_angle_sorts``.  Returns the launch
    counts of one step and, of the GN-block launches of each direction and
    of the segment sums, how many belong to ``down_edge_mp``."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import attach_angle_sorts
    from graphs4cfd_tpu_torch.nn import (GraphLoss, NsRotEquiThreeScaleGNN,
                                         remus_gnn)
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    from graphs4cfd_tpu_torch.ops import segment
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    model = NsRotEquiThreeScaleGNN(arch=remus_arch(), seed=0, device=dev)
    g = Graph.from_numpy(attach_angle_sorts(batch), dev)
    crit = GraphLoss(lambda_d=0.25)
    n_out, nf = 1, model.num_fields
    step = make_train_step(model, crit, nf, n_out, 1.0)
    params = list(model.parameters())
    state = adam_init(params)
    step(state, g, LR)                                 # warm-up
    torch.cuda.synchronize()

    # which launches pool: down_edge_mp's forward, and the backwards whose
    # table is not the receivers' own (S != V only in down_edge_mp)
    down, launch_bwd = remus_gnn.down_edge_mp, gn_op._launch_bwd
    in_down = {"gn_block": 0, "gn_block_bwd": 0, "sorted_segment_sum": 0}

    def counted_down(*args, **kw):
        before = gn_op.gn_block.launches
        out = down(*args, **kw)
        in_down["gn_block"] += gn_op.gn_block.launches - before
        return out

    def counted_bwd(e, vs, v, *args):
        before = (gn_op.gn_block_bwd.launches,
                  segment.sorted_segment_sum.launches)
        out = launch_bwd(e, vs, v, *args)
        if vs.shape[0] != v.shape[0]:
            in_down["gn_block_bwd"] += gn_op.gn_block_bwd.launches - before[0]
            in_down["sorted_segment_sum"] += (
                segment.sorted_segment_sum.launches - before[1])
        return out

    remus_gnn.down_edge_mp, gn_op._launch_bwd = counted_down, counted_bwd
    try:
        reset_counts()
        loss, gnorm = step(state, g, LR)
        torch.cuda.synchronize()
        launches = read_counts()
    finally:
        remus_gnn.down_edge_mp, gn_op._launch_bwd = down, launch_bwd
    loss, gnorm = loss.item(), gnorm.item()
    say("remus training", f"NsRotEquiThreeScaleGNN {model.num_params} "
        f"params; train_step(n_out={n_out}): loss {loss:.6f}, gradient norm "
        f"{gnorm:.6f}; launches {launches}, in down_edge_mp {in_down}")
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        fail("remus training", "non-finite loss or gradient norm")
    # per step: 16 EdgeMP + 2 DownEdgeMP layers, forward and backward, each
    # backward with its dvs sum; 8 encoders, 2 unpooling tails and the
    # decoder through the MLP-chain kernel, forward and backward
    want = {"mlp_chain": 11 * n_out, "gn_block": 18 * n_out,
            "mlp_chain_bwd": 11 * n_out, "gn_block_bwd": 18 * n_out,
            "sorted_segment_sum": 18 * n_out}
    want_down = {key: 2 * n_out for key in in_down}
    if launches != want or in_down != want_down:
        fail("remus training", f"launch counts {launches} ({in_down} in "
             f"down_edge_mp), want {want} ({want_down})")

    grads_against_plain("remus training", model, g, crit, nf)
    steps_deterministic("remus training", model, step, state, g)
    time_steps("remus training", lambda: step(state, g, LR), n_out, g, smi,
               "training")
    return launches, in_down


def gmus_graphs():
    """The gMuS workload's batch with the host sorts of its senders."""
    from graphs4cfd_tpu_torch.loader import attach_sender_sorts, collate
    t = time.perf_counter()
    gbatch = attach_sender_sorts(collate(make_gmus_samples(),
                                         node_bucket=512, edge_bucket=1024))
    sizes = {"V": gbatch.num_nodes, "E": gbatch.num_edges,
             "V2": gbatch.pos_2.shape[0], "E2": gbatch.senders_2.shape[0],
             "V3": gbatch.pos_3.shape[0], "E3": gbatch.senders_3.shape[0]}
    valid = int(gbatch.edge_mask.sum())
    up = (gbatch.up_idx_2.shape, gbatch.up_idx_3.shape)
    say("gmus graphs", f"{sizes}, {valid} valid level-1 edges, up_idx "
        f"{up[0]} and {up[1]} in {time.perf_counter() - t:.1f} s")
    if sizes != GMUS_SIZES or valid != 240000 or up != ((40448, 6),
                                                        (8192, 6)):
        fail("gmus graphs", f"sizes {sizes}, {valid} valid edges, up_idx "
             f"{up} differ from {GMUS_SIZES}, 240000, (40448, 6), (8192, "
             "6)")
    return gbatch


def gmus_model(dev, phase):
    from graphs4cfd_tpu_torch.nn import NsThreeGuillardScaleGNN
    model = NsThreeGuillardScaleGNN(arch=gmus_arch(), seed=0, device=dev)
    if model.num_params != GMUS_PARAMS:
        fail(phase, f"{model.num_params} parameters, want {GMUS_PARAMS}")
    return model


def wide_launches(tally, direction):
    """Launches of ``direction`` whose node input is 256 wide, by level
    size."""
    return {V: n for (d, (V, fv)), n in tally.items()
            if d == direction and fv == 256}


def gmus_phase(gbatch, dev, smi):
    """``solve(n_out=4)`` of the gMuS workload; returns the launch counts
    and, per node count, the GN-block launches with a 256-wide node
    input."""
    from graphs4cfd_tpu_torch.graph import Graph
    model = gmus_model(dev, "gmus path")
    g = Graph.from_numpy(gbatch, dev)
    n_out = 4
    model.solve(g, 1)                                  # warm-up
    torch.cuda.synchronize()
    with gn_launch_shapes() as tally:
        reset_counts()
        out = model.solve(g, n_out)
        torch.cuda.synchronize()
        launches = read_counts()
    wide = wide_launches(tally, "gn_block")
    say("gmus path", f"NsThreeGuillardScaleGNN {model.num_params} params; "
        f"solve(n_out={n_out}) -> {tuple(out.shape)}; launches {launches}; "
        f"gn_block launches by (V, fv) {tally}")
    if tuple(out.shape) != (GMUS_SIZES["V"], 3 * n_out):
        fail("gmus path", f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out[g.node_mask]).all()):
        fail("gmus path", "non-finite values on valid rows")
    # per step: 16 MP layers (mp121 and mp221 with fv = 256); 4 encoders
    # and the decoder through the MLP-chain kernel
    want = {"mlp_chain": 5 * n_out, "gn_block": 16 * n_out,
            "mlp_chain_bwd": 0, "gn_block_bwd": 0, "sorted_segment_sum": 0}
    want_wide = {GMUS_SIZES["V"]: n_out, GMUS_SIZES["V2"]: n_out}
    if launches != want or wide != want_wide:
        fail("gmus path", f"launch counts {launches} (fv 256: {wide}), want "
             f"{want} ({want_wide})")
    step_against_plain("gmus path", model, g)
    time_steps("gmus path", lambda: model.solve(g, n_out), n_out, g, smi,
               "rollout")
    return launches, wide


def gmus_training_phase(gbatch, dev, smi):
    """The gMuS training step of ``tools/bench_families.py:_bench_gmus`` on
    the port: ``make_train_step(model, GraphLoss(0.25), 3, 1, 1.0)``, lr
    1e-4, over the batch with ``attach_sender_sorts``.  Returns the launch
    counts of one step and, per node count, the launches of each GN
    direction with a 256-wide node input."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.nn import GraphLoss
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    model = gmus_model(dev, "gmus training")
    g = Graph.from_numpy(gbatch, dev)
    crit = GraphLoss(lambda_d=0.25)
    n_out = 1
    step = make_train_step(model, crit, 3, n_out, 1.0)
    state = adam_init(list(model.parameters()))
    step(state, g, LR)                                 # warm-up
    torch.cuda.synchronize()
    with gn_launch_shapes() as tally:
        reset_counts()
        loss, gnorm = step(state, g, LR)
        torch.cuda.synchronize()
        launches = read_counts()
    wide = {d: wide_launches(tally, d) for d in ("gn_block", "gn_block_bwd")}
    loss, gnorm = loss.item(), gnorm.item()
    say("gmus training", f"NsThreeGuillardScaleGNN {model.num_params} "
        f"params; train_step(n_out={n_out}): loss {loss:.6f}, gradient norm "
        f"{gnorm:.6f}; launches {launches}; GN launches by (V, fv) {tally}")
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        fail("gmus training", "non-finite loss or gradient norm")
    # per step: 16 MP layers forward and backward, each backward with its
    # sorted per-sender dvs sum; 4 encoders and the decoder
    want = {"mlp_chain": 5 * n_out, "gn_block": 16 * n_out,
            "mlp_chain_bwd": 5 * n_out, "gn_block_bwd": 16 * n_out,
            "sorted_segment_sum": 16 * n_out}
    one = {GMUS_SIZES["V"]: n_out, GMUS_SIZES["V2"]: n_out}
    want_wide = {"gn_block": one, "gn_block_bwd": one}
    if launches != want or wide != want_wide:
        fail("gmus training", f"launch counts {launches} (fv 256: {wide}), "
             f"want {want} ({want_wide})")
    grads_against_plain("gmus training", model, g, crit, 3)
    steps_deterministic("gmus training", model, step, state, g)
    time_steps("gmus training", lambda: step(state, g, LR), n_out, g, smi,
               "training")
    return launches, wide


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

    # 3. REMuS host graphs (the REMuS kernel cases read their sources)
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import collate
    t = time.perf_counter()
    rbatch = collate(make_remus_samples(), node_bucket=512,
                     edge_bucket=1024)
    rsizes = {"V": rbatch.num_nodes, "E": rbatch.num_edges,
              "V2": rbatch.pos_2.shape[0], "E2": rbatch.senders_2.shape[0],
              "V3": rbatch.pos_3.shape[0], "E3": rbatch.senders_3.shape[0]}
    angles, valid = rbatch.angle_src.size, int(rbatch.edge_mask.sum())
    say("remus graphs", f"{rsizes}, {angles} level-1 angles, {valid} valid "
        f"level-1 edges in {time.perf_counter() - t:.1f} s")
    if rsizes != REMUS_SIZES or angles != 512000 or valid != 100000:
        fail("remus graphs", f"sizes {rsizes}, {angles} angles, {valid} "
             f"valid edges differ from {REMUS_SIZES}, 512000, 100000")

    # 4. kernels against their plain versions
    rng = np.random.default_rng(0)
    results = [check_mlp_chain(dev, rng), check_gn_block(dev, rng),
               check_mlp_chain_bwd(dev, rng), check_gn_block_bwd(dev, rng),
               check_sorted_segment_sum(dev, rng)]
    remus_results = check_remus_gn_block(dev, rng)
    remus_bwd_results = (check_remus_gn_block_bwd(dev, rng, rbatch, smi)
                         + check_remus_segment_sum(dev, rng, rbatch, smi))

    # 5. host graphs
    t = time.perf_counter()
    batch = collate(make_samples(8, 5000, seed=7), node_bucket=512,
                    edge_bucket=1024)
    sizes = {"V": batch.num_nodes, "E": batch.num_edges,
             "V2": batch.pos_2.shape[0], "E2": batch.senders_2.shape[0],
             "V3": batch.pos_3.shape[0], "E3": batch.senders_3.shape[0]}
    say("graphs", f"{sizes} in {time.perf_counter() - t:.1f} s")
    if sizes != BENCH_SIZES:
        fail("graphs", f"sizes {sizes} differ from {BENCH_SIZES}")

    # 6. main path
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

    step_against_plain("main path", model, g)

    time_steps("main path", lambda: model.solve(g, n_out), n_out, g, smi,
               "rollout")

    # 7. training
    train_launches = training_phase(model, g, smi)
    for r in results:
        r["launches"] = (launches if r["name"] in ("mlp_chain", "gn_block")
                         else train_launches)[r["name"]]
    del model, g

    # 8. REMuS path
    remus_launches, in_down = remus_phase(rbatch, dev, smi)
    for r in remus_results:
        r["launches"] = (in_down if r["name"] == "gn_block[down_edge_mp]"
                         else remus_launches["gn_block"] - in_down)

    # 9. REMuS training
    rt_launches, rt_down = remus_training_phase(rbatch, dev, smi)
    for r in remus_bwd_results:
        kernel, layer = r["name"][:-1].split("[")
        r["launches"] = (rt_down[kernel] if layer == "down_edge_mp"
                         else rt_launches[kernel] - rt_down[kernel])

    del rbatch

    # 10.-13. gMuS
    gbatch = gmus_graphs()
    gmus_results = check_gmus_gn_kernels(dev, rng, gbatch, smi)
    _, path_wide = gmus_phase(gbatch, dev, smi)
    _, train_wide = gmus_training_phase(gbatch, dev, smi)
    for r in gmus_results:
        kernel, layer = r["name"][:-1].split("[")
        V = GMUS_SIZES["V" if layer == "mp121" else "V2"]
        r["launches"] = (path_wide if kernel == "gn_block"
                         else train_wide["gn_block_bwd"])[V]

    print(json.dumps({"kernels": results + remus_results
                      + remus_bwd_results + gmus_results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
