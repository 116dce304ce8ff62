"""Where a rollout step, or a training step, of the PyTorch port's
flagship MuS-GNN, of its REMuS-GNN or of its gMuS-GNN spends its time on
the card.

    python3 profile_torch_step.py [--steps 3] [--bf16] [--train | --remus |
                                   --remus-train | --gmus | --gmus-train |
                                   --gp-train | --fit]
    python3 profile_torch_step.py --gn-cases [--bf16]
    python3 profile_torch_step.py --chain-cases [--bf16]
    python3 profile_torch_step.py --segment-cases

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
``GraphLoss(0.25)``, clip 1.0, lr 1e-4; with ``--bf16``, the model in
the bf16 policy, ``compute_dtype=torch.bfloat16``) under
``torch.profiler`` and
prints the device time per kernel name, the share of the hand-written
kernels, the device busy share of the wall time (kernel time summed
over the profiled window), and each backward's device time in all (its
tile kernel and the weight-gradient kernel and reduction, shared by the
chain and GN backwards, that ran after it).  ``--gn-cases`` instead times
the GN-block kernel at the level-1 REMuS EdgeMP shape (512,000 angle
rows, H=128) with its angle sources spread over the whole 52 MB table,
taken from the REMuS graph, or held inside its first 10 MB, and at k=6
with as many angle rows: what the table's size and the tile shape cost;
then the GN backward's parts (the tile kernel, the weight-gradient
kernel, the reduction, the ``dvs`` sum; CUDA events between them) at the
level-1 shapes of MuS (V=40448, k=6), REMuS (one EdgeMP, 102,400 edges x
k=5 over the graph's ``angle_src``) and gMuS (``mp121``, ``fv = 256``);
with ``--bf16`` the bf16 GN kernels at every bf16 GN case of PERF.md's
table (``bf16_gn_cases``).
``--chain-cases`` times both chain kernels at ``chip_smoke.CHAIN_CASES``;
with ``--bf16`` the bf16 ones on the same inputs rounded to bf16, the
backward's parts apart (the tile kernel, the weight-gradient kernel, the
reduction), beside the bf16 bound.
``--segment-cases`` times ``sorted_segment_sum``, its plain version and
``torch.zeros(...).index_add_`` at the uses of ``segment_cases``,
each as device time behind a spin of the card; where the tree's wrapper
takes ``long_rows`` (``ops.segment.LONG_ROWS``) it also times the kernel
at other values of it.  Both run on any tree, the parent commit included:
copy this script and ``chip_smoke.py`` into a ``git archive`` of the
parent to time the parent's kernels.
``--fit`` profiles one epoch of ``fit`` of the flagship model over a
``DataLoader`` of ``--steps`` batches of 8 graphs of 5000 nodes (seeds 7,
8, ...; shuffled, buckets 512/1024), ``train_step(n_out=1)`` a batch as in
``--train``, after a 1-epoch warm-up ``fit``: the host's batch work
(``collate``, the copy to the card) is inside the window.
``--gp-train`` profiles rank 0 of the MuS training step partitioned over
2 ranks (``partition_graph(batch, 2)``, ``make_gp_train_step``), two
processes sharing the card over gloo: the profiler sees rank 0's kernels
only, and its busy share is rank 0's kernel time over the wall time.
Needs a CUDA card.
"""
import argparse
import inspect
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from chip_smoke import (CHAIN_CASES, bound_bf16_ms, bound_ms, bound_tc_ms,
                        chain_bwd_flops, chain_bwd_parts, chain_case,
                        chain_flops, cuda_ms,
                        flagship_arch,
                        gmus_arch, gn_bwd_parts, gn_case, gn_flops,
                        host_sort,
                        make_gmus_samples, make_remus_samples, make_samples,
                        nbytes, parts_text, remus_arch, uniform_chain)


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
        bms, _ = bound_ms(flops, 0)
        print(f"  {name}: {ms:.4f} ms, {flops / 1e9:.2f} GFLOP, "
              f"{flops / ms / 1e9:.2f} TFLOP/s, bound {bms:.4f} ms (f32 "
              f"cores), {bound_tc_ms(flops, 0):.4f} ms (tensor cores); "
              f"{gn_op.tile_receivers(k)} receivers and "
              f"{gn_op.tile_receivers(k) * k} edge rows per tile")
    gn_bwd_cases(dev, rng, batch)


def gn_bwd_cases(dev, rng, rbatch):
    """The GN backward's parts at the three families' level-1 shapes."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    H = 128
    print(f"{torch.cuda.get_device_name(0)}: gn_block_bwd, H={H}, out_selu, "
          "e' stored, parts by CUDA events (10 launches after 2)")
    for name, V, k, fv, layers in (("MuS level 1", 40448, 6, 128, 3),
                                   ("REMuS level-1 EdgeMP", 102400, 5, 128,
                                    2),
                                   ("gMuS mp121", 40448, 6, 256, 3)):
        edge = uniform_chain(rng, [H + 2 * fv] + [H] * layers, True, dev)
        node = uniform_chain(rng, [H + fv] + [H] * layers, True, dev)
        if name.startswith("REMuS"):
            idx = rbatch.angle_src
            senders = torch.from_numpy(idx.reshape(-1)).to(dev)
            sort = host_sort(idx, dev)
        else:
            idx = rng.integers(0, V, V * k).astype(np.int32)
            senders = torch.from_numpy(idx).to(dev)
            sort = host_sort(idx, dev)
        e = torch.randn(V * k, H, device=dev)
        v = torch.randn(V, fv, device=dev)
        vs = v @ edge[0][0][H:H + fv]
        gv = torch.randn(V, H, device=dev)
        ge = torch.randn(V * k, H, device=dev)
        args = (e, vs, v, senders, sort, k, edge, node, gv, ge, True)
        ms = cuda_ms(lambda: gn_op._launch_bwd(*args))
        parts = gn_bwd_parts(args)
        flops = 3 * gn_flops(V * k, V, H, fv, [H + 2 * fv] + [H] * layers,
                             [H + fv] + [H] * layers)
        print(f"  {name} (V={V}, k={k}, fv={fv}, {layers}-layer chains): "
              f"{ms:.4f} ms with its dvs sum, {flops / 1e9:.2f} GFLOP, bound "
              f"{bound_ms(flops, 0)[0]:.4f} ms (f32 cores), "
              f"{bound_tc_ms(flops, 0):.4f} ms (tensor cores); parts "
              f"{parts_text(parts)}")


def bf16_gn_cases(dev):
    """``--gn-cases --bf16``: the bf16 GN kernels at every bf16 GN case of
    PERF.md's table (rows 3-6, 9, 10: MuS level 1, REMuS's level-1 EdgeMP
    and ``down_mp12`` over the REMuS graph's angle sources, gMuS ``mp121``
    and ``mp221`` at ``fv = 256``), the inputs of ``chip_smoke.py``'s
    "bf16 kernels" phase: the forward, the backward with its ``dvs`` sum
    and the backward's parts, device ms behind a spin, beside the bf16
    bound."""
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    rng = np.random.default_rng(0)
    H, bf = 128, torch.bfloat16
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev).to(bf)
    rbatch = collate(make_remus_samples(), node_bucket=512, edge_bucket=1024)
    print(f"{torch.cuda.get_device_name(0)}: bf16 gn_block and gn_block_bwd,"
          " out_selu, ms per launch (20 after 3; parts 10 after 2)")

    def cases():
        e, v, senders, edge, node, vs, sort = gn_case(dev, rng, 40448, 6, H)
        yield ("MuS level 1", e.to(bf), vs.to(bf), v.to(bf), senders, sort, 6,
               edge, node, False)
        for name, key, skip in (("REMuS EdgeMP", "angle_src", False),
                                ("REMuS down_mp12", "xangle_src_2", True)):
            idx = rbatch.data[key]
            V, S = idx.shape[0], rbatch.angle_src.shape[0]
            angle = uniform_chain(rng, [3 * H, H, H], True, dev)
            edge = uniform_chain(rng, [2 * H, H, H], True, dev)
            vs = (t(S, H).float() @ angle[0][0][H:2 * H]).to(bf)
            yield (name, t(V * 5, H), vs, t(V, H),
                   torch.from_numpy(idx.reshape(-1)).to(dev),
                   host_sort(idx, dev), 5, angle, edge, skip)
        for name, V in (("gMuS mp121", 40448), ("gMuS mp221", 8192)):
            fv = 256
            senders = torch.from_numpy(rng.integers(0, V, V * 6).astype(
                np.int32)).to(dev)
            srt, perm = torch.sort(senders, stable=True)
            edge = uniform_chain(rng, [H + 2 * fv, H, H, H], True, dev)
            node = uniform_chain(rng, [H + fv, H, H, H], True, dev)
            v = t(V, fv)
            vs = (v.float() @ edge[0][0][H:H + fv]).to(bf)
            yield (name, t(V * 6, H), vs, v, senders,
                   (perm.int(), srt.int()), 6, edge, node, False)

    def tiles(k, fv, ne):
        # the tile geometry by dtype since the bf16 tile; before, by k alone
        if "dtype" in inspect.signature(gn_op.tile_receivers).parameters:
            return gn_op.tile_receivers(k, bf, fv, ne)
        return gn_op.tile_receivers(k)

    for name, e, vs, v, senders, sort, k, edge, node, skip in cases():
        E, V, fe, fv = e.shape[0], v.shape[0], e.shape[1], v.shape[1]
        ed = [edge[0][0].shape[0]] + [w.shape[1] for w in edge[0]]
        nd = [node[0][0].shape[0]] + [w.shape[1] for w in node[0]]
        params = [*edge[0], *edge[1], *edge[2], *node[0], *node[1], *node[2]]
        flops = gn_flops(E, V, fe, fv, ed, nd)
        fwd = lambda: gn_op.gn_block(e, vs, v, senders, k, edge, node,
                                     out_selu=True, skip_e_out=skip)
        outs = [x for x in fwd() if x is not None]
        gv, ge = t(V, H), None if skip else t(E, H)
        args = (e, vs, v, senders, sort, k, edge, node, gv, ge, True)
        ms, bms = cuda_ms(fwd), cuda_ms(lambda: gn_op._launch_bwd(*args))
        parts = gn_bwd_parts(args)
        fb, _ = bound_bf16_ms(flops, nbytes(e, vs, v, senders, *params,
                                            *outs))
        bb, _ = bound_bf16_ms(3 * flops, nbytes(e, vs, v, senders, *sort, gv,
                                                ge, *params, e, v, vs))
        print(f"  {name} (V={V}, k={k}, fv={fv}{', skip_e' if skip else ''}"
              f"; {tiles(k, fv, len(edge[0]))} receivers a tile): forward "
              f"{ms:.4f} ms (bound {fb:.4f}), backward {bms:.4f} ms (bound "
              f"{bb:.4f}), parts {parts_text(parts)}", flush=True)


def chain_cases(dev, bf16=False):
    """Both chain kernels at ``chip_smoke.CHAIN_CASES``' shapes, through the
    wrappers alone: ms per launch against both bounds; with ``bf16`` the
    bf16 kernels on the same inputs rounded to bf16, against the bf16
    bound, with the backward's parts."""
    from graphs4cfd_tpu_torch.ops import fused_mlp
    rng = np.random.default_rng(0)
    print(f"{torch.cuda.get_device_name(0)}: {'bf16 ' if bf16 else ''}"
          "mlp_chain and mlp_chain_bwd, ms per launch (20 launches after 3"
          f"{'; parts 10 after 2' if bf16 else ''})")
    for name, rows, dims, ln, preact, need_dx, _ in CHAIN_CASES:
        x, g, ws, bs, lns = chain_case(dev, rng, rows, dims, ln)
        if bf16:
            x, g = x.to(torch.bfloat16), g.to(torch.bfloat16)
        lnp = lns or (None, None)
        fwd = lambda: fused_mlp.mlp_chain(x, ws, bs, *lnp,
                                          preact_input=preact)
        bwd = lambda: fused_mlp.mlp_chain_bwd(x, g, ws, bs, lnp[0],
                                              preact_input=preact,
                                              need_dx=need_dx)
        out, (dx, dws, dbs, dln) = fwd(), bwd()
        flops = chain_flops(rows, dims)
        bflops = chain_bwd_flops(rows, dims, ln, need_dx)
        fb = nbytes(x, out, *ws, *bs, *(lns or ()))
        bb = nbytes(x, g, dx, *ws, *bs, lnp[0], *dws, *dbs, *(dln or ()))
        if bf16:
            parts = chain_bwd_parts((x, g, ws, bs, lnp[0], preact, need_dx))
            print(f"  {name} [{rows}; {'->'.join(map(str, dims))}]"
                  f"{' LN' if ln else ''}{' preact' if preact else ''}"
                  f"{' dx' if need_dx else ''}: forward {cuda_ms(fwd):.4f} "
                  f"ms (bound {bound_bf16_ms(flops, fb)[0]:.4f}), backward "
                  f"{cuda_ms(bwd):.4f} ms (bound "
                  f"{bound_bf16_ms(bflops, bb)[0]:.4f}), parts "
                  f"{parts_text(parts)}", flush=True)
            continue
        print(f"  {name} [{rows}; {'->'.join(map(str, dims))}]"
              f"{' LN' if ln else ''}{' preact' if preact else ''}"
              f"{' dx' if need_dx else ''}: forward {cuda_ms(fwd):.4f} ms "
              f"(bound {bound_ms(flops, fb)[0]:.4f} f32, "
              f"{bound_tc_ms(flops, fb):.4f} TC), backward "
              f"{cuda_ms(bwd):.4f} ms (bound "
              f"{bound_ms(bflops, bb)[0]:.4f} f32, "
              f"{bound_tc_ms(bflops, bb):.4f} TC)")


def segment_cases(dev):
    """The five uses of ``sorted_segment_sum`` that PERF.md tracks, and four
    more, as
    ``(name, src, perm, sorted, segments, index)``: the MuS level-1 ``dvs``
    (242,688 rows into 40,448 segments, random senders as
    ``chip_smoke.check_sorted_segment_sum`` draws them); the REMuS level-1
    angle sources (512,000 rows into 102,400 edges, ``collate``'s 12,000
    pad angle rows on edge 0) and ``down_edge_mp``'s (115,200 into
    102,400), from the REMuS graph; part 0 of the MuS batch over 2 ranks:
    its level-1 ``dvs`` (121,344 rows into the 21,824-row sender table)
    and the transpose of its level-1 send gather (1,600 rows into 20,224);
    then the transposes of part 0's other halo gathers
    (``chip_smoke.GP_CASES``: runs of 50-600 rows).  F = 128 and ``src``
    normal from numpy seed 0."""
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.parallel import (attach_gp_sorts,
                                               partition_graph)
    from chip_smoke import GP_CASES, GP_PARTS, gp_case
    rng = np.random.default_rng(0)
    H = 128
    cases = []

    def add(name, idx, nseg, sort=None):
        if sort is None:
            sort = host_sort(idx, dev)
            idx = torch.from_numpy(idx.reshape(-1)).to(dev)
        perm, srt = sort
        src = torch.from_numpy(rng.normal(size=(idx.shape[0], H)).astype(
            np.float32)).to(dev)
        cases.append((name, src, perm, srt, nseg, idx.long()))

    V = 40448
    add("MuS level-1 dvs", rng.integers(0, V, 6 * V).astype(np.int32), V)
    rbatch = collate(make_remus_samples(), node_bucket=512,
                     edge_bucket=1024)
    S = rbatch.angle_src.shape[0]
    add("REMuS level-1 angle sources", rbatch.angle_src, S)
    add("REMuS down_edge_mp", rbatch.data["xangle_src_2"], S)
    del rbatch
    batch = collate(make_samples(8, 5000, seed=7), node_bucket=512,
                    edge_bucket=1024)
    sharded = attach_gp_sorts(partition_graph(batch, GP_PARTS)[0])
    S, idx, sort = gp_case(sharded, "halo_s", "senders", dev)
    add("GP dvs (part 0 of 2)", idx, S, sort)
    S, idx, sort = gp_case(sharded, "halo_s", None, dev)
    add("GP halo transpose (part 0's send gather)", idx, S, sort)
    for name, table, key in GP_CASES[1:]:
        S, idx, sort = gp_case(sharded, table, key, dev)
        add(f"GP halo transpose ({name})", idx, S, sort)
    return cases


def segment_times(dev):
    """``--segment-cases``: ms of the kernel, the plain version and
    ``index_add_`` at each of ``segment_cases``, with the bound."""
    from graphs4cfd_tpu_torch.ops import segment
    cases = segment_cases(dev)
    print(f"{torch.cuda.get_device_name(0)}: sorted_segment_sum, F=128, "
          "device ms per launch (20 launches after 3, behind a spin)")
    for name, src, perm, srt, nseg, idx in cases:
        run = lambda: segment.sorted_segment_sum(src, perm, srt, nseg)
        plain = lambda: segment.sorted_segment_sum_plain(src, perm, srt,
                                                         nseg)
        lib = lambda: torch.zeros(nseg, src.shape[1],
                                  device=dev).index_add_(0, idx, src)
        got, ref = run(), plain()
        err = ((got - ref).abs().max() / ref.abs().max().clamp_min(1)).item()
        counts = torch.bincount(srt.long(), minlength=nseg)
        nb = nbytes(src, perm, srt, got)
        print(f"  {name} [{src.shape[0]}, {src.shape[1]}] -> {nseg} "
              f"({int((counts == 0).sum())} empty, the longest "
              f"{int(counts.max())} rows): kernel {cuda_ms(run):.4f} ms, "
              f"plain {cuda_ms(plain):.4f} ms, index_add_ {cuda_ms(lib):.4f} "
              f"ms, bound {bound_ms(src.numel(), nb)[0]:.4f} ms (bytes); "
              f"error {err:.2e} of max(1, max|ref|)", flush=True)
    if not hasattr(segment, "LONG_ROWS"):
        return
    print(f"the kernel at other long_rows (the tree's LONG_ROWS is "
          f"{segment.LONG_ROWS}), ms:")
    for name, src, perm, srt, nseg, _ in cases:
        print(f"  {name}: " + ", ".join(
            f"{L} {cuda_ms(lambda: segment._launch(src, perm, srt, nseg, L)):.4f}"
            for L in (16, 32, 64, 128)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true")
    mode.add_argument("--remus", action="store_true")
    mode.add_argument("--remus-train", action="store_true")
    mode.add_argument("--gmus", action="store_true")
    mode.add_argument("--gmus-train", action="store_true")
    mode.add_argument("--gp-train", action="store_true")
    mode.add_argument("--fit", action="store_true")
    mode.add_argument("--gn-cases", action="store_true")
    mode.add_argument("--chain-cases", action="store_true")
    mode.add_argument("--segment-cases", action="store_true")
    ap.add_argument("--bf16", action="store_true",
                    help="the rollout or training step, or the kernel "
                    "cases, in the bf16 policy")
    args = ap.parse_args()
    steps = args.steps
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.gn_cases:
        (bf16_gn_cases if args.bf16 else gn_cases)(torch.device("cuda", 0))
        return
    if args.chain_cases:
        chain_cases(torch.device("cuda", 0), args.bf16)
        return
    if args.segment_cases:
        segment_times(torch.device("cuda", 0))
        return
    if args.gp_train:
        gp_train(steps)
        return
    if args.fit:
        fit_epoch(steps)
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
    if args.bf16:
        model.compute_dtype = torch.bfloat16
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
    kind = ("REMuS training" if args.remus_train else
            "gMuS training" if args.gmus_train else
            "training" if args.train else
            "REMuS rollout" if args.remus else
            "gMuS rollout" if args.gmus else "rollout")
    print(summary(prof, wall_us, steps,
                  f"bf16 {kind}" if args.bf16 else kind))


def summary(prof, wall_us, steps, kind):
    """Device time per kernel name, the hand-written kernels' share and
    the device busy share of the wall time, as text."""
    # device-side events only: a CPU op's self device time repeats the
    # time of the kernels it launched
    rows = [(e.key, device_us(e), e.count) for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and device_us(e) > 0]
    if not rows:
        raise SystemExit("torch.profiler recorded no device time")
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    lines = [f"{torch.cuda.get_device_name(0)}: {steps} {kind} steps, wall "
             f"{wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms "
             f"({100 * busy / wall_us:.1f} % of wall)"]
    for key, us, n in rows[:25]:
        lines.append(f"{us / 1e3 / steps:10.4f} ms/step "
                     f"{100 * us / busy:6.2f} % {n // steps:5d}/step  "
                     f"{key[:90]}")
    own = sum(us for key, us, _ in rows if "g4c::" in key)
    lines.append(f"hand-written kernels: {100 * own / max(busy, 1e-9):.1f} "
                 f"% of device time")
    lines.append("each backward in all (its tile kernel and the shared "
                 "weight-gradient kernel and reduction launched after it): "
                 + ", ".join(f"{k} {us / 1e3 / steps:.4f} ms/step"
                             for k, us in backward_totals(prof).items()))
    return "\n".join(lines)


#: tile kernel -> the backward it starts
BWD_TILES = {"mlp_chain_bwd_kernel": "chain backward",
             "mlp_chain_bwd_bf16_kernel": "chain backward",
             "gn_block_bwd_kernel": "GN backward",
             "gn_block_bwd_bf16_kernel": "GN backward"}
SHARED = ("gn_wgrad_kernel", "wgrad_bf16_kernel", "gn_reduce_kernel")


def backward_totals(prof):
    """Device us of each backward: its tile kernel, plus the shared
    kernels that follow it.  A backward's launches come from one C call,
    so on the one stream a shared kernel belongs to the tile kernel last
    started before it."""
    kernels = sorted((e for e in prof.events()
                      if str(e.device_type).endswith("CUDA")),
                     key=lambda e: e.time_range.start)
    totals, owner = dict.fromkeys(BWD_TILES.values(), 0.0), None
    for e in kernels:
        tile = [b for k, b in BWD_TILES.items() if k in e.name]
        if tile:
            owner = tile[0]
        elif owner is None or not any(k in e.name for k in SHARED):
            continue
        totals[owner] += e.time_range.elapsed_us()
    return totals


def fit_epoch(batches):
    """``--fit``: one profiled epoch of ``fit`` over ``batches`` batches."""
    import shutil
    import tempfile
    from graphs4cfd_tpu_torch.loader import DataLoader
    from graphs4cfd_tpu_torch.nn import (GraphLoss, NsThreeScaleGNN,
                                         TrainConfig)
    dev = torch.device("cuda", 0)
    samples = [g for seed in range(7, 7 + batches)
               for g in make_samples(8, 5000, seed=seed)]
    loader = DataLoader(samples, batch_size=8, shuffle=True, seed=0,
                        node_bucket=512, edge_bucket=1024)
    model = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev)
    folder = tempfile.mkdtemp(prefix="g4c_profile_fit_")
    try:
        cfg = TrainConfig("profile", folder=folder, lr=1e-4,
                          training_loss=GraphLoss(0.25),
                          grad_clip={"epoch": 0, "limit": 1.0},
                          chk_interval=10**6)          # no checkpoint
        model.fit(cfg, loader)                         # warm-up epoch
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            (record,) = model.fit(cfg, loader)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t) * 1e6
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    print(f"fit's own epoch time {record['seconds'] * 1e3:.3f} ms for "
          f"{record['steps']} steps")
    print(summary(prof, wall_us, batches, "fit training"))


def gp_train_rank(rank, world, model, parts, job):
    """One rank of ``--gp-train`` (the hook of ``run_gp_tasks``): warm-up,
    then ``job["steps"]`` training steps, profiled on rank 0."""
    import torch.distributed as dist
    from graphs4cfd_tpu_torch.nn import GraphLoss
    from graphs4cfd_tpu_torch.parallel import make_gp_train_step
    from graphs4cfd_tpu_torch.training import adam_init
    torch.backends.cuda.matmul.allow_tf32 = False
    steps, g = job["steps"], parts["part"]
    state = adam_init(model.parameters())
    step = make_gp_train_step(model, GraphLoss(0.25), 1, 1.0)

    def run(n):
        for _ in range(n):
            step(state, g, 1e-4)
    run(2)
    torch.cuda.synchronize()
    dist.barrier()
    if rank:
        run(steps)
        torch.cuda.synchronize()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    return summary(prof, wall_us, steps, f"GP training (rank 0 of {world} "
                   "gloo ranks sharing the card)")


def gp_train(steps):
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.ops import _build
    from graphs4cfd_tpu_torch.parallel import (attach_gp_sorts,
                                               partition_graph, spawn_ranks)
    from graphs4cfd_tpu_torch.parallel.run import run_gp_tasks
    _build.load()                  # before the ranks, which would race
    batch = collate(make_samples(8, 5000, seed=7), node_bucket=512,
                    edge_bucket=1024)
    sharded, _ = partition_graph(batch, 2)
    print(spawn_ranks(run_gp_tasks, 2, "gloo", {
        "arch": flagship_arch(), "seed": 0, "device": "cuda:0",
        "graphs": {"part": attach_gp_sorts(sharded).data},
        "hook": gp_train_rank, "steps": steps}, timeout=900)[0])

if __name__ == "__main__":
    main()
