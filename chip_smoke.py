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
   with the plain versions; prints ms per step and level-1 edges/s.

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
PATH_TOL = 1e-3            # max rel difference of one full step
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


@contextlib.contextmanager
def plain_kernels():
    """Route the model through the kernels' plain versions."""
    from graphs4cfd_tpu_torch.ops import fused_mlp, gn_block as gn_op
    saved = fused_mlp.mlp_chain, gn_op.gn_block
    fused_mlp.mlp_chain = fused_mlp.mlp_chain_plain
    gn_op.gn_block = gn_op.gn_block_plain
    try:
        yield
    finally:
        fused_mlp.mlp_chain, gn_op.gn_block = saved


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
    from graphs4cfd_tpu_torch.ops import _build, fused_mlp, gn_block as gn_op
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
    results = [check_mlp_chain(dev, rng), check_gn_block(dev, rng)]

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
    fused_mlp.mlp_chain.launches = 0
    gn_op.gn_block.launches = 0
    out = model.solve(g, n_out)
    torch.cuda.synchronize()
    launches = {"mlp_chain": fused_mlp.mlp_chain.launches,
                "gn_block": gn_op.gn_block.launches}
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
    for r in results:
        r["launches"] = launches[r["name"]]

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

    print(json.dumps({"kernels": results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
