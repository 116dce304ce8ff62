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
   (the REMuS backward cases with that graph's angle sources; both chain
   kernels at each of ``CHAIN_CASES``); for the chain and GN kernels also
   the tensor-core bound, the time before their redesign (``EARLIER_MS``)
   and the backward's parts (``chain_bwd_parts``, ``gn_bwd_parts``); each
   chain case's launches are counted by shape in the runs of phases 6,
   7, 13 and 14 (the bf16 ones in phases 8 and 15);
   every ``sorted_segment_sum`` case (``segment_record``) also against the
   plain version's bits in each segment one warp adds, with zeros in
   empty segments, its two parts (bounds pass, sums) and its time before
   the redesign;
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
8. bf16 mus: the flagship model of phase 6 with ``compute_dtype=
   torch.bfloat16`` (the bf16 policy) on phase 5's batch: ``solve(n_out=4)``
   and ``train_step(n_out=1)``; every launch a bf16 kernel's and none an
   f32 one's (``want_counts``), the output and loss f32, one step within
   ``BF16_PATH_TOL`` and its gradients within ``BF16_GRAD_L2`` (relative
   L2) of the same with the bf16 plain versions, two training steps the
   same bits, parameters and Adam state f32; ms per step and peak device
   memory of each, beside phases 6 and 7's f32 numbers;
9. pretrained: ``AdvThreeScaleGNN(model="3S-GNN-SynthAdv-TPU-v1")``, the
   bundled 128-wide 3-scale checkpoint read in place, on 8 advected-field
   clouds of 5000 nodes (``make_adv_samples``, numpy seed 11):
   ``solve`` of the list of graphs (collated on the host) and of the
   collated batch give the same bits; the launch counts the arch implies
   (``mus_launches``); one step against the plain versions; ms per step,
   level-1 edges/s and peak device memory;
10. fit: ``NsThreeScaleGNN(flagship_arch(), seed 0).fit`` over
   ``DataLoader`` batches of the 8 graphs of phase 5 and 8 more (seed 8),
   8 a batch, shuffled (seed 0); validation on phase 5's 8; GraphLoss
   0.25, lr 1e-4, clip from epoch 1, ``num_steps=[1, 2]`` (the curriculum
   and Adam's restart after epoch 1), the plateau schedule, 3 epochs, a
   checkpoint each: epoch 1's loss the same bits as two
   ``make_train_step`` calls by hand on the same batches; its launches
   twice phase 7's; the checkpoint read back the same parameters; a
   resumed ``fit(epochs=4, checkpoint=...)`` of a model built from seed 1
   runs epoch 4 only and ends with the bits of a straight 4-epoch run,
   and ``.chk.bck`` is there;
   prints ms per training step (epoch wall time / steps) beside phase 7's
   bare step, edges/s and peak device memory;
11. bf16 fit: ``fit`` with ``TrainConfig(mixed_precision=True)``, one
   epoch of the flagship model on phase 5's 8 graphs (``num_steps=[2]``):
   the model left in bf16, the epoch's launches the bf16 kernels' of two
   training steps and no f32 kernel's, its checkpoint's weights and Adam
   state f32;
12. scripts: ``examples/training/NsMuSGNN/NsThreeScaleGNN.py`` on the
   port at its full width in bf16: a synthetic store in the ``NsCircle``
   layout (24 simulations of 5000 nodes, ``T = 100`` frames of (u, v, p),
   numpy seed 21) given to ``datasets.NsCircle`` as its preloaded array
   (``h5_data``: no HDF5 file is read on the card), the script's
   transform chain, ``random_split(dataset, [16, 8])``, ``DataLoader``s of
   8, its arch (2,713,347 parameters) and ``TrainConfig`` with
   ``mixed_precision=True``, ``lr=1e-5``, ``epochs=2``, ``num_steps=[1,
   2]``: finite losses, the bf16 launches of a training step each step,
   ms per training step beside phase 8's bare step; the chain's host
   seconds per batch with the C++ helper and with the numpy plain k-NN
   (the same batch bits), the helper against its plain versions on a 70 x
   70 grid and Guillard's sweep on a 5000-node cloud; then
   ``examples/inference/mus_gnn/ns_mus_gnn.py``: the checkpoint ``fit``
   wrote, ``get_sequence(0, 0, n_in=1, n_out=10)`` through that script's
   chain, ``collate([g]).to_device()`` and ``solve(n_out=10)``: ``[V,
   30]``, finite on valid rows, the f32 launches of 10 steps;
13. remus path: ``NsRotEquiThreeScaleGNN`` at that workload's arch (128
   wide, 16 EdgeMP layers, 2 down, 2 up, random weights from seed 0) runs
   ``solve(n_out=4)``; checks the output, the launch counts (the GN-block
   kernel runs every EdgeMP and DownEdgeMP layer), and one step against
   the plain versions; prints ms per step, level-1 edges/s and peak
   device memory;
14. remus training: that model's training step,
   ``make_train_step(model, GraphLoss(0.25), 2, 1, 1.0)`` with lr 1e-4
   over the batch with ``attach_angle_sorts``; checks as phase 7 (the
   backward kernels run every EdgeMP and DownEdgeMP layer, each with its
   sorted angle-source sum) and prints the same numbers;
15. bf16 remus: phase 13's model in bf16, as phase 8 (with the
   launches inside ``down_edge_mp`` counted apart);
16. gmus graphs: the gMuS workload of ``tools/bench_families.py:_bench_gmus``
   (8 clouds of 5000 nodes drawn from numpy seed 0, Guillard coarsening
   with k=6 on 3 levels, edge scales 0.1/0.25/0.5, interpolation weights
   k=6, buckets 512/1024) through the port's host pipeline, with the host
   sorts of every level's senders (``attach_sender_sorts``); checks the
   level sizes;
17. gmus kernels: the GN-block kernel and its backward at the shapes of
   the two layers that take a 256-wide node input (the skip concatenated
   after an up step): ``mp121`` (level 1, V=40448, k=6) and ``mp221``
   (level 2, V=8192 with its pad nodes), with that graph's senders and
   their host sorts, against their plain versions: error, time, bound;
18. gmus path: ``NsThreeGuillardScaleGNN`` at that workload's arch (128
   wide, 16 MP layers, random weights from seed 0) runs
   ``solve(n_out=4)``; checks as phase 13 (every MP layer runs the GN-block
   kernel) and prints the same numbers;
19. gmus training: that model's training step,
   ``make_train_step(model, GraphLoss(0.25), 3, 1, 1.0)`` with lr 1e-4;
   checks as phase 14 (every MP layer's backward runs the backward kernel
   and its sorted per-sender sum) and prints the same numbers;
20. bf16 gmus: phase 18's model in bf16, as phase 8;
21. gp graphs: the MuS batch of phase 5 through ``partition_graph(batch,
   2)`` and ``attach_gp_sorts``; prints each halo table's ``pmax``, the
   local table sizes and the host seconds;
22. gp kernels: the row gather ``gather_rows`` (TPU row 7) and its
   transpose, ``sorted_segment_sum`` over the attached sorts (row 8's halo
   use), at part 0's shapes (the level-1 send gather, the coarse levels'
   shared tables, the up steps' parent tables) against their plain
   versions, on f32 tables and then on bf16 tables with bf16 cotangent
   rows (the bf16 policy's halo tables): the forward exact, the backward
   within 1e-5, two launches the same bits, a NaN row for an index
   outside the table; ms per launch against the bound (bf16 at 2 bytes an
   element), ``index_select`` and ``index_add_``, and the time of one
   empty launch (the launch floor); the bf16 cases' launches from phase
   32's MuS run;
23. gp path: ``make_gp_rollout(n_out=4)`` on 2 ranks over gloo, both on
   card 0 (``spawn_ranks``); un-permuted, within 1e-3 of phase 6's
   single-device ``solve``, every row finite, the launch counts per rank;
   one forward with every table dropped (the all-gather fallback) within
   1e-5 of the forward on the tables; ms per step (two processes sharing
   one card: not a scaling number);
24. gp training: one ``make_gp_train_step`` on the same 2 ranks: the loss
   within 1e-5 and the first-step gradients within 1e-3 (relative L2) of
   the single-device step's, the parameters the same bits on both ranks,
   two steps from the same state the same bits, the launch counts; ms per
   step, level-1 edges/s and peak memory per rank;
25. gp nccl: one rank over NCCL (``partition_graph(batch, 1)``), one
   forward within 2e-4 of the single-device forward.

26. dp training: data parallelism on 2 gloo ranks sharing card 0
   (``spawn_ranks(run_dp_tasks, ...)``): phase 5's 8 graphs split by
   ``collate_sharded`` (4 a rank), the flagship model (seed 0) in f32 and
   then in bf16, one ``make_dp_train_step`` (``GraphLoss(0.25)``, n_out=1,
   clip 1.0, lr 1e-4) against the single-device step on the unsplit
   batch: loss within ``GP_LOSS_TOL`` and first-step gradients within
   ``GP_GRAD_TOL`` (relative L2) in f32, within ``BF16_PATH_TOL`` and
   ``BF16_GRAD_L2`` in bf16; the loss, gradients, parameters and Adam
   moments the same bits on both ranks, two steps the same bits, each
   rank's launches those of the single-device step; ms per step of the
   slower rank and of its gradient all-reduce alone (two processes on one
   card: not a scaling number);
27. dp families: the same in bf16 for REMuS (phase 3's 4 clouds, 2 a
   rank) and gMuS (phase 16's 8 clouds, 4 a rank) at their cells' archs;
28. dp gp: MuS f32 and gMuS bf16 on a 2 x 2 mesh of 4 gloo ranks on
   card 0: the two shards of phases 26 and 27, each partitioned in two
   (``partition_batches(regroup_sharded(...))``), one
   ``make_dp_gp_train_step`` against the single-device step with GP's
   gates (bf16's for gMuS), the same bits on all 4 ranks, each rank's
   ``gather_rows`` and segment-sum launches (the single-device step's
   plus the halo gathers and their transposes, ``gp_want``);
29. dp script: ``examples/training/distributed/NsThreeScaleGNN_dp.py`` as
   written, at its full arch in bf16, through ``initialize_distributed``
   (the ranks find the ``GRAPHS4CFD_*`` variables, ``spawn_ranks(...,
   by_env=True)``) and ``fit``, cut as phase 12 cuts ``NsThreeScaleGNN.py``
   (``epochs=2``, ``num_steps=[1, 2]``, 24 simulations of the synthetic
   store) and from 8 ranks to 2 sharing card 0: finite losses, the same
   bits in every rank's history, one checkpoint, a resume into a model
   from another seed that runs epoch 3, the bf16 launches of a training
   step per rank; ms per step of the slower rank, and each rank's host
   seconds for the whole batch (what ``fit`` builds on every rank)
   against its own samples alone.

30. bf16 kernels: each bf16 kernel (TPU rows 1-6, 9, 10 and the bf16
   rows of the segment sum, row 8's angle-source use) against its bf16
   plain version at the main paths' shapes (the chain cases, MuS level 1,
   REMuS's level-1 EdgeMP and ``down_mp12`` with that graph's angle
   sources, gMuS ``mp121``/``mp221`` at their level sizes, the MuS and
   REMuS ``dvs`` sums): forward within ``BF16_TOL`` of max(1, max |ref|),
   backward within ``BF16_BWD_L2`` in relative L2, two launches the same
   bits; device ms beside the f32 kernel's at the same case, the plain
   version's, the bf16 bound (max(bytes / 3.35 TB/s, FLOPs / 989
   TFLOP/s), bf16 tensors at 2 bytes an element), the backward's parts;
   then the bf16 weight-gradient kernel (``ops.wgrad.weight_grads``) on
   the products of each of those backwards (``bf16_wgrad_record``):
   against its plain version and against ``torch.mm`` of bf16 copies
   within ``BF16_BWD_L2``, two launches the same bits, its ms beside the
   bound, the plain version's, the ``torch.mm`` calls', and the f32
   kernel's and f32 ``torch.mm``'s on f32 copies; the geometry of the bf16
   tiles (``bf16_tile_geometry``); launches from phases 8, 15 and 20.

31. gp families: REMuS at phase 13's workload (4 clouds of 5000 nodes,
   ``remus_arch``, 128 wide) and gMuS at phase 16's (8 clouds,
   ``gmus_arch``), f32, each through ``partition_graph(batch, 2)`` and
   ``attach_gp_sorts``, on 2 gloo ranks on card 0 (one ``spawn_ranks``,
   ``parallel.run.run_gp_tasks`` with ``gp_family_rank`` as the hook of
   each family's job): ``make_gp_rollout(n_out=4)``, un-permuted, within
   1e-3 of the family's single-device ``solve`` on the valid rows; one
   forward with every table dropped (the all-gather fallback) within
   1e-5 of the forward on the tables; the first step's loss within
   ``GP_LOSS_TOL`` and gradients within ``GP_GRAD_TOL`` (relative L2) of
   the single-device step's; one ``make_gp_train_step`` (``GraphLoss
   (0.25)``, n_out 1, clip 1.0, lr 1e-4) the same bits on both ranks and
   twice from one state; each rank's launches the single-device run's
   plus the halo gathers of the plan and the kept tables and their
   transposes (``gp_sites``, ``gp_want``), with the GN kernels' ``skip_*``
   flags of the single-device run (``gp_launch_shapes``); ms per rollout
   and training step of the slower rank and peak device memory per rank
   (two processes sharing one card: not a scaling number).  Before the
   ranks, the GN kernel and its backward at part 0's partitioned shapes
   against their plain versions (``check_gp_family_gn_kernels``): gMuS
   ``mp121`` (``fv = 256`` over a sender halo table of ``S > V`` rows),
   the REMuS level-1 EdgeMP over its folded edge table (``T*k`` rows),
   REMuS ``down_mp12`` over ``halo_x_2``; error, time, bounds, launches;
32. bf16 gp: MuS (phase 5's batch, the flagship arch), REMuS and gMuS at
   phase 31's workloads in bf16 on the same 2 ranks, as phase 31 with the
   bf16 gates (rollout and loss within ``BF16_PATH_TOL``, gradients within
   ``BF16_GRAD_L2``) and the bf16 launch counts, ``gather_rows_bf16``
   among them (REMuS also gathers f32 rows: its node inputs and the node
   vectors of its up steps).
Then one JSON line of per-kernel numbers and, last, the result line
``{"ok": true, "device": {...}}``.  Any failure stops the run with a
non-zero exit before the result line.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

T0 = time.perf_counter()
PEAK_F32_FLOPS = 67e12     # H100 SXM, f32 on the CUDA cores
PEAK_TF32_FLOPS = 495e12   # H100 SXM, TF32 on the tensor cores (dense)
PEAK_BYTES = 3.35e12       # H100 SXM HBM3
# The kernels' times before their redesign (the chain and GN kernels'
# before they moved to the tensor cores, the segment sum's before one warp
# took each segment, the bf16 chain forward's before it moved to wgmma),
# from PERF.md section 6: (ms, the commit whose kernels were measured: by
# chip_smoke.py for the GN kernels and the bf16 chain forward, by
# ``profile_torch_step.py --chain-cases`` for the f32 chain kernels and by
# ``--segment-cases`` for the segment sum), on an NVIDIA H100 80GB HBM3 at
# 700 W.
EARLIER_MS = {
    "mlp_chain": (0.0687, "5fd1fa6"), "mlp_chain_bwd": (0.2711, "5fd1fa6"),
    "mlp_chain[mus_edge_encoder]": (0.8121, "5fd1fa6"),
    "mlp_chain_bwd[mus_edge_encoder]": (3.5563, "5fd1fa6"),
    "mlp_chain[remus_angle_encoder]": (0.9775, "5fd1fa6"),
    "mlp_chain_bwd[remus_angle_encoder]": (4.4553, "5fd1fa6"),
    "gn_block": (2.8580, "6a2f867"), "gn_block_bwd": (11.8519, "6a2f867"),
    "gn_block[edge_mp]": (5.0357, "6a2f867"),
    "gn_block[down_edge_mp]": (1.1296, "6a2f867"),
    "gn_block_bwd[edge_mp]": (20.4919, "6a2f867"),
    "gn_block_bwd[down_edge_mp]": (4.8661, "6a2f867"),
    "gn_block[mp121]": (3.1542, "0724c89"),
    "gn_block[mp221]": (0.6437, "0724c89"),
    "gn_block_bwd[mp121]": (13.7014, "0724c89"),
    "gn_block_bwd[mp221]": (2.7985, "0724c89"),
    "gn_block[gp]": (1.3938, "a318bc0"),
    "gn_block_bwd[gp]": (5.9780, "a318bc0"),
    "sorted_segment_sum": (0.1245, "929fc01"),
    "sorted_segment_sum[edge_mp]": (0.3637, "929fc01"),
    "sorted_segment_sum[down_edge_mp]": (0.1618, "929fc01"),
    "sorted_segment_sum[gp_dvs]": (0.0687, "929fc01"),
    "sorted_segment_sum[send_s]": (0.0262, "929fc01"),
    "sorted_segment_sum[halo_sr_2]": (0.0095, "929fc01"),
    "sorted_segment_sum[halo_sr_3]": (0.0136, "929fc01"),
    "sorted_segment_sum[halo_p_2]": (0.0130, "929fc01"),
    "sorted_segment_sum[halo_p_3]": (0.0074, "929fc01"),
    "mlp_chain_bf16": (0.0333, "576896c"),
    "mlp_chain_bf16[mus_edge_encoder]": (0.3996, "576896c"),
    "mlp_chain_bf16[remus_angle_encoder]": (0.5046, "576896c")}
# The chain kernels' cases: (name, rows, dims, LayerNorm, preact_input,
# need_dx, the phases whose runs count its launches forward and
# backward): the coarse tail of MuS level 2 (a GN-block chain after its
# first layer), the MuS level-1 edge encoder and the REMuS level-1 angle
# encoder, whose inputs need no gradient.
CHAIN_CASES = (
    ("tail", 14336, (128, 128, 128), True, True, True,
     ("main path", "training")),
    ("mus_edge_encoder", 242688, (2, 128, 128, 128), False, False, False,
     ("main path", "training")),
    ("remus_angle_encoder", 512000, (4, 128, 128), True, False, False,
     ("remus path", "remus training")))
# The chain kernels' launches by shape in the counted run of each phase:
# {phase: {(direction, rows, dims, LayerNorm, preact_input): launches}}
CHAIN_SHAPES = {}
# Timed calls wait behind a spin of the card this long (ms), which covers
# the host's time to enqueue them (``cuda_ms``).
SPIN_MS = 20
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
PRETRAINED_NAME = "3S-GNN-SynthAdv-TPU-v1"
PRETRAINED_PARAMS = 2118017


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


def spin(ms):
    """Keep the card busy for about ``ms`` (at most 2 GHz) before what is
    enqueued next, so that the host can enqueue timed calls faster than the
    card runs them: a kernel's time then holds no host launch time."""
    torch.cuda._sleep(int(ms * 2e6))


def cuda_ms(fn, iters=20, warmup=3):
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    enqueued behind a spin of the card (``spin``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    spin(SPIN_MS)
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


def bound_tc_ms(flops, nbytes):
    """The bound of the same work with its products on the tensor cores as
    3xTF32, three TF32 operations per f32 one (the GN kernels)."""
    return max(3 * flops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES) * 1e3


def gn_record(res, flops, nb):
    """Add a GN kernel's tensor-core bound, computed from this run's
    inputs."""
    res["bound_tc_ms"] = bound_tc_ms(flops, nb)
    return res


def earlier_text(name):
    """The kernel's pre-redesign time from ``EARLIER_MS``, for the printed
    text only: it is not this run's measurement, so it stays out of the
    ``kernels`` JSON line."""
    if name not in EARLIER_MS:
        return "no earlier kernel"
    ms, commit = EARLIER_MS[name]
    return f"earlier {ms} ms (at {commit})"


def chain_name(kernel, case):
    """The ``kernels`` entry's name of a chain case (the coarse tail keeps
    the kernel's own name)."""
    return kernel if case == "tail" else f"{kernel}[{case}]"


def case_text(rows, dims, ln, preact, need_dx=None):
    return (f"[{rows}; {'->'.join(map(str, dims))}]{' LN' if ln else ''}"
            f"{' preact' if preact else ''}"
            + ("" if need_dx is None else " dx" if need_dx else " no dx"))


def bwd_parts(launch, args, keys, iters=10, warmup=2):
    """Mean ms of a backward's parts, CUDA events between them: ``launch(
    *args, events=...)`` records one event after each part; each call is
    enqueued behind a spin of the card (``spin``)."""
    tot = dict.fromkeys(keys, 0.0)
    for i in range(warmup + iters):
        start = torch.cuda.Event(enable_timing=True)
        evs = [torch.cuda.Event(enable_timing=True) for _ in keys]
        spin(SPIN_MS / 10)
        start.record()
        launch(*args, events=evs)
        torch.cuda.synchronize()
        if i >= warmup:
            for key, a, b in zip(keys, [start] + evs, evs):
                tot[key] += a.elapsed_time(b) / iters
    return tot


def gn_bwd_parts(args, iters=10, warmup=2):
    """The GN backward's parts (the tile kernel, the weight-gradient
    kernel, the reduction, the ``dvs`` sum); ``args`` as
    ``ops.gn_block._launch_bwd`` takes them."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    return bwd_parts(gn_op._launch_bwd, args,
                     ("tile", "wgrad", "reduce", "dvs"), iters, warmup)


def chain_bwd_parts(args, iters=10, warmup=2):
    """The chain backward's parts (the tile kernel, the weight-gradient
    kernel, the reduction); ``args`` as ``ops.fused_mlp._launch_bwd`` takes
    them."""
    from graphs4cfd_tpu_torch.ops import fused_mlp
    return bwd_parts(fused_mlp._launch_bwd, args, ("tile", "wgrad", "reduce"),
                     iters, warmup)


def parts_text(parts):
    return ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + " ms"


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
    """The forward chain kernel at each of ``CHAIN_CASES``."""
    from graphs4cfd_tpu_torch.ops import fused_mlp
    out = []
    for case, rows, dims, ln, preact, _, _ in CHAIN_CASES:
        x, _, ws, bs, lns = chain_case(dev, rng, rows, dims, ln)
        lnp = lns or (None, None)
        run = lambda: fused_mlp.mlp_chain(x, ws, bs, *lnp,
                                          preact_input=preact)
        plain = lambda: fused_mlp.mlp_chain_plain(x, ws, bs, *lnp,
                                                  preact_input=preact)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        err, rel = errors(got, ref)
        flops = chain_flops(rows, dims)
        nb = nbytes(x, got, *ws, *bs, *(lns or ()))
        bms, by = bound_ms(flops, nb)
        name = chain_name("mlp_chain", case)
        res = {"name": name, "route": "cuda",
               "source": "graphs4cfd_tpu_torch/csrc/mlp_chain.cu",
               "replaces": "graphs4cfd_tpu/ops/pallas_mlp.py:75",
               "max_abs_err": err, "ms": cuda_ms(run),
               "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
               "library_ms": None, "bound_tc_ms": bound_tc_ms(flops, nb)}
        say("kernels", f"{name} {case_text(rows, dims, ln, preact)}: max abs "
            f"err {err:.3e} max rel {rel:.3e} (tol {MLP_TOL}); kernel "
            f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), tensor-core bound "
            f"{res['bound_tc_ms']:.4f} ms, {earlier_text(name)}; "
            f"{fused_mlp.mlp_chain.launches} launches in these checks")
        if not err <= MLP_TOL:
            fail("kernels", f"{name} error {err} above {MLP_TOL}")
        out.append(res)
    return out


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
            res = gn_record({
                "name": "gn_block", "route": "cuda",
                "source": "graphs4cfd_tpu_torch/csrc/gn_block.cu",
                "replaces": "graphs4cfd_tpu/ops/pallas_gnblock.py:517",
                "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": None}, flops,
                nbytes(e, vs, v, senders, vo, eo, *params))
            say("kernels", f"gn_block: tensor-core bound "
                f"{res['bound_tc_ms']:.4f} ms, "
                f"{earlier_text(res['name'])}")
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
                res = gn_record({
                    "name": f"gn_block[{name}]", "route": "cuda",
                    "source": "graphs4cfd_tpu_torch/csrc/gn_block.cu",
                    "replaces": replaces, "max_abs_err": err, "ms": ms,
                    "plain_ms": pms, "bound_ms": bms, "bound_by": by,
                    "library_ms": None}, flops,
                    nbytes(a, vs, e, senders, eo, ao, *params))
                say("kernels", f"gn_block ({name}): tensor-core bound "
                    f"{res['bound_tc_ms']:.4f} ms, "
                    f"{earlier_text(res['name'])}")
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


def chain_bwd_flops(rows, dims, ln, need_dx):
    """FLOPs the chain's backward needs: the recomputed forward of layers
    0..n-2 (and of layer n-1 only for its LayerNorm), ``dh = da W^T`` of
    layers 1..n-1 (and of layer 0 only for ``dx``), and every ``dW``."""
    layer = [2 * rows * p * q for p, q in zip(dims[:-1], dims[1:])]
    remat = sum(layer[:-1]) + (layer[-1] if ln else 0)
    dh = sum(layer[1:]) + (layer[0] if need_dx else 0)
    return remat + dh + sum(layer)


def chain_case(dev, rng, rows, dims, ln):
    """Inputs of a chain case: ``x``, a cotangent ``g`` of the output, and
    the chain's weights, biases and LayerNorm (or None)."""
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(
        np.float32)).to(dev)
    g = torch.from_numpy(rng.normal(size=(rows, dims[-1])).astype(
        np.float32)).to(dev)
    return (x, g, *uniform_chain(rng, list(dims), ln, dev))


def check_mlp_chain_bwd(dev, rng):
    """The backward chain kernel at each of ``CHAIN_CASES``: errors, time,
    its parts, its work buffer, and two launches the same bits."""
    from graphs4cfd_tpu_torch.ops import _build, fused_mlp
    out = []
    for case, rows, dims, ln, preact, need_dx, _ in CHAIN_CASES:
        x, g, ws, bs, lns = chain_case(dev, rng, rows, dims, ln)
        s = lns[0] if lns else None
        _, kinked = chain_kinks(x, ws, bs, preact)
        g = quiet(g, kinked)
        args = (x, g, ws, bs, s, preact, need_dx)
        run = lambda: fused_mlp.mlp_chain_bwd(x, g, ws, bs, s,
                                              preact_input=preact,
                                              need_dx=need_dx)
        plain = lambda: fused_mlp.mlp_chain_bwd_plain(x, g, ws, bs, s,
                                                      preact_input=preact,
                                                      need_dx=need_dx)
        got, ref = run(), plain()
        torch.cuda.synchronize()
        flat = lambda r: [t for t in [r[0], *r[1], *r[2], *(r[3] or ())]
                          if t is not None]
        if got[0] is None and need_dx:
            fail("kernels", "mlp_chain_bwd returned no dx")
        pairs = list(zip(flat(got), flat(ref)))
        err = max(errors(a, b)[0] for a, b in pairs)
        rel = max(scaled_err(a, b) for a, b in pairs)
        flops = chain_bwd_flops(rows, dims, ln, need_dx)
        nb = nbytes(x, g, *ws, *bs, s, *flat(got))
        bms, by = bound_ms(flops, nb)
        name = chain_name("mlp_chain_bwd", case)
        res = {"name": name, "route": "cuda",
               "source": "graphs4cfd_tpu_torch/csrc/mlp_chain_bwd.cu",
               "replaces": "graphs4cfd_tpu/ops/pallas_mlp.py:88",
               "max_abs_err": err, "ms": cuda_ms(run),
               "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
               "library_ms": None, "bound_tc_ms": bound_tc_ms(flops, nb),
               "parts_ms": chain_bwd_parts(args)}
        work = 4 * _build.load().g4c_mlp_chain_bwd_work(
            len(dims) - 1, _build.int_array(dims), rows, int(ln),
            int(preact), 0) / 2**30
        say("kernels", f"{name} {case_text(rows, dims, ln, preact, need_dx)}"
            f": work buffer (the weight gradients' operands, partials and "
            f"column sums) {work:.3f} GiB; max abs err {err:.3e} over dx, "
            f"dW, db, dLN, over max(1, "
            f"max|ref|) {rel:.3e} (tol {MLP_BWD_TOL}; {int(kinked.sum())} "
            f"rows by a SELU kink given a zero cotangent); kernel "
            f"{res['ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, bound "
            f"{bms:.4f} ms ({by}), tensor-core bound "
            f"{res['bound_tc_ms']:.4f} ms, {earlier_text(name)}; parts "
            f"{parts_text(res['parts_ms'])}")
        if not rel <= MLP_BWD_TOL:
            fail("kernels", f"{name} error {rel} above {MLP_BWD_TOL}")
        if not all(torch.equal(a, b) for a, b in zip(flat(run()),
                                                     flat(run()))):
            fail("kernels", f"{name}: two launches differ")
        out.append(res)
    return out


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
            res = gn_record({
                "name": "gn_block_bwd", "route": "cuda",
                "source": "graphs4cfd_tpu_torch/csrc/gn_block_bwd.cu",
                "replaces": "graphs4cfd_tpu/ops/pallas_gnblock.py:556",
                "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": None}, flops,
                nbytes(e, vs, v, senders, *sort, gv, ge, *params,
                       *bwd_outputs(got)))
            res["parts_ms"] = gn_bwd_parts((e, vs, v, senders, sort, k, edge,
                                            node, gv, ge, True))
            say("kernels", f"gn_block_bwd: tensor-core bound "
                f"{res['bound_tc_ms']:.4f} ms, {earlier_text(res['name'])}; "
                f"parts {parts_text(res['parts_ms'])}")
    return res


def segment_record(phase, name, what, src, perm, srt, S, lidx, replaces,
                   smi):
    """``sorted_segment_sum`` of ``src`` over ``(perm, srt)`` into ``S``
    segments against its plain version: error within ``SEG_TOL`` of
    max(1, max |ref|), zeros in every segment no row reads, two launches
    the same bits, and the plain version's bits in every segment of at
    most ``segment.LONG_ROWS`` rows (one warp adds them in its order);
    device ms of the kernel, the plain version and ``index_add_`` (the
    same sums with float atomics, timed as the library call; on f32 copies
    of bf16 rows), the bound,
    and the kernel's two parts (``parts_ms``: the bounds pass, the
    sums).  ``lidx`` is the unsorted index, int64."""
    from graphs4cfd_tpu_torch.ops import segment
    H = src.shape[1]
    run = lambda: segment.sorted_segment_sum(src, perm, srt, S)
    plain = lambda: segment.sorted_segment_sum_plain(src, perm, srt, S)
    # bf16 rows into an f32 table: index_add_ of f32 copies of the rows
    # (made here, outside the timed window) adds the same values
    src32 = src.float()
    lib = lambda: torch.zeros(S, H, device=src.device).index_add_(0, lidx,
                                                                  src32)
    got, ref = run(), plain()
    torch.cuda.synchronize()
    err, rel = errors(got, ref)[0], scaled_err(got, ref)
    counts = torch.bincount(srt.long(), minlength=S)
    longest = int(counts.max()) if counts.numel() else 0
    short = counts <= segment.LONG_ROWS
    bits = torch.equal(got[short], ref[short])
    bms, by = bound_ms(src.numel(), nbytes(src, perm, srt, got))
    res = {"name": name, "route": "cuda",
           "source": "graphs4cfd_tpu_torch/csrc/sorted_segment_sum.cu",
           "replaces": replaces, "max_abs_err": err, "ms": cuda_ms(run),
           "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
           "library_ms": cuda_ms(lib),
           "parts_ms": bwd_parts(segment._launch, (src, perm, srt, S),
                                 ("bounds", "sums"))}
    say(phase, f"sorted_segment_sum ({what}) [{src.shape[0]}, {H}] -> {S} "
        f"({int((counts == 0).sum())} empty segments, the longest {longest} "
        f"rows): max abs err {err:.3e} (tol {SEG_TOL} of max(1, "
        f"max|ref|)), the plain version's bits in the {int(short.sum())} "
        f"segments of at most {segment.LONG_ROWS} rows: {bits}; kernel "
        f"{res['ms']:.4f} ms ({earlier_text(name)}; parts "
        f"{parts_text(res['parts_ms'])}), plain {res['plain_ms']:.4f} ms, "
        f"index_add_ {res['library_ms']:.4f} ms"
        f"{'' if src.dtype == torch.float32 else ' (on f32 copies)'}, bound "
        f"{bms:.4f} ms ({by}) "
        f"on {smi}")
    if not rel <= SEG_TOL:
        fail(phase, f"sorted_segment_sum ({what}) error {rel} above "
             f"{SEG_TOL}")
    if got[counts == 0].any():
        fail(phase, f"sorted_segment_sum ({what}): an empty segment is not "
             "zero")
    if not torch.equal(run(), run()):
        fail(phase, f"sorted_segment_sum ({what}): two launches differ")
    if not bits:
        fail(phase, f"sorted_segment_sum ({what}): not the plain version's "
             "bits in a segment that one warp adds")
    return res


def check_sorted_segment_sum(dev, rng, smi):
    """The dvs sums of ``gn_block_bwd`` at the level-1 shapes: the per-edge
    first-layer cotangents summed per sender."""
    V, k, H = 40448, 6, 128
    src = torch.from_numpy(rng.normal(size=(V * k, H)).astype(
        np.float32)).to(dev)
    senders = torch.from_numpy(
        rng.integers(0, V, V * k).astype(np.int32)).to(dev)
    srt, perm = torch.sort(senders, stable=True)
    return segment_record("kernels", "sorted_segment_sum", "MuS level-1 dvs",
                          src, perm.int(), srt.int(), V, senders.long(),
                          "graphs4cfd_tpu/ops/pallas_gnblock.py:719", smi)


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
        res = gn_record({
            "name": f"gn_block_bwd[{name}]", "route": "cuda",
            "source": "graphs4cfd_tpu_torch/csrc/gn_block_bwd.cu",
            "replaces": replaces, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}, flops,
            nbytes(a, vs, e, senders, *sort, gv, ge, *params,
                   *bwd_outputs(got)))
        del got, ref
        res["parts_ms"] = gn_bwd_parts((a, vs, e, senders, sort, k, angle,
                                        edge, gv, ge, True))
        say("kernels", f"gn_block_bwd ({name}): tensor-core bound "
            f"{res['bound_tc_ms']:.4f} ms, {earlier_text(res['name'])}; "
            f"parts {parts_text(res['parts_ms'])}")
        out.append(res)
    return out


def check_remus_segment_sum(dev, rng, rbatch, smi):
    """The angle-source transpose (the ``dvs`` sums of the REMuS backward)
    over the REMuS graph's sources and their host sorts: a level-1 EdgeMP
    (512,000 angle rows into the 102,400 edges; ``collate`` points the
    12,000 pad angle rows at edge 0) and ``down_mp12`` (115,200
    inter-level angle rows into the 102,400 fine edges, most of which no
    angle reads: empty segments, written as zero).  For the level-1 case
    the sum is also timed with the pad angles pointed at their own pad
    edges: what the pile in segment 0 costs."""
    from graphs4cfd_tpu_torch.ops import segment
    H, S = 128, rbatch.angle_src.shape[0]
    out = []
    for name, key in (("edge_mp", "angle_src"), ("down_edge_mp",
                                                  "xangle_src_2")):
        idx = rbatch.data[key]
        src = torch.from_numpy(rng.normal(size=(idx.size, H)).astype(
            np.float32)).to(dev)
        perm, srt = host_sort(idx, dev)
        lidx = torch.from_numpy(idx.reshape(-1).astype(np.int64)).to(dev)
        out.append(segment_record(
            "kernels", f"sorted_segment_sum[{name}]", f"REMuS {name}", src,
            perm, srt, S, lidx, "graphs4cfd_tpu/ops/pallas_gather.py:57",
            smi))
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
        out.append(gn_record({
            "name": f"gn_block[{name}]", "route": "cuda",
            "source": "graphs4cfd_tpu_torch/csrc/gn_block.cu",
            "replaces": fwd_of, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}, flops,
            nbytes(e, vs, v, senders, vo, eo, *params)))
        say("gmus kernels", f"gn_block ({name}): tensor-core bound "
            f"{out[-1]['bound_tc_ms']:.4f} ms, "
            f"{earlier_text(out[-1]['name'])}")
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
        res = gn_record({
            "name": f"gn_block_bwd[{name}]", "route": "cuda",
            "source": "graphs4cfd_tpu_torch/csrc/gn_block_bwd.cu",
            "replaces": bwd_of, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}, 3 * flops,
            nbytes(e, vs, v, senders, *sort, gv, ge, *params,
                   *bwd_outputs(got)))
        del got, ref
        res["parts_ms"] = gn_bwd_parts((e, vs, v, senders, sort, k, edge,
                                        node, gv, ge, True))
        say("gmus kernels", f"gn_block_bwd ({name}): tensor-core bound "
            f"{res['bound_tc_ms']:.4f} ms, {earlier_text(res['name'])}; "
            f"parts {parts_text(res['parts_ms'])}")
        out.append(res)
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
def chain_launch_shapes(phase):
    """Tally the chain kernels' launches by direction and shape into
    ``CHAIN_SHAPES[phase]``."""
    from graphs4cfd_tpu_torch.ops import fused_mlp
    tally = CHAIN_SHAPES.setdefault(phase, {})
    fwd, bwd = fused_mlp._launch_fwd, fused_mlp._launch_bwd

    def counted(direction, launch, at):
        # at: where the weights, the LayerNorm scale and preact_input are
        # among the launcher's arguments
        def run(*args, **kw):
            x, weights = args[0], args[at[0]]
            key = (direction, x.shape[0],
                   (x.shape[1],) + tuple(w.shape[1] for w in weights),
                   args[at[1]] is not None, bool(args[at[2]]))
            tally[key] = tally.get(key, 0) + 1
            return launch(*args, **kw)
        return run

    # _launch_fwd(x, weights, biases, ln_scale, ln_bias, preact_input)
    # _launch_bwd(x, g, weights, biases, ln_scale, preact_input, need_dx)
    fused_mlp._launch_fwd = counted("mlp_chain", fwd, (1, 3, 5))
    fused_mlp._launch_bwd = counted("mlp_chain_bwd", bwd, (2, 4, 5))
    try:
        yield tally
    finally:
        fused_mlp._launch_fwd, fused_mlp._launch_bwd = fwd, bwd


def chain_launches(results):
    """Each chain case's launches in its phases' counted runs; fails if a
    case was not launched there."""
    for case, rows, dims, ln, preact, _, phases in CHAIN_CASES:
        for kernel, phase in zip(("mlp_chain", "mlp_chain_bwd"), phases):
            n = CHAIN_SHAPES.get(phase, {}).get(
                (kernel, rows, dims, ln, preact), 0)
            for r in results:
                if r["name"] == chain_name(kernel, case):
                    r["launches"] = n
            say("kernels", f"{chain_name(kernel, case)}: {n} launches in "
                f"the counted run of phase {phase!r}")
            if n < 1:
                fail("kernels", f"{chain_name(kernel, case)} was not "
                     f"launched in phase {phase!r}: "
                     f"{CHAIN_SHAPES.get(phase)}")


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


def reset_counts():
    from graphs4cfd_tpu_torch.ops import launch_counters
    for fn in launch_counters().values():
        fn.launches = 0


def read_counts():
    from graphs4cfd_tpu_torch.ops import launch_counts
    return launch_counts()


def want_counts(**kw):
    """The launch counts a run should show: ``kw`` by counter name, every
    other counter 0 (an f32 run launches no bf16 kernel, a bf16 run no f32
    one), and the weight-gradient kernel's, unless ``kw`` gives them, one
    launch a backward."""
    from graphs4cfd_tpu_torch.ops import launch_counters
    out = dict.fromkeys(launch_counters(), 0)
    out.update(kw)
    for sfx in ("", "_bf16"):
        if "weight_grads" + sfx not in kw:
            out["weight_grads" + sfx] = (out["mlp_chain_bwd" + sfx]
                                         + out["gn_block_bwd" + sfx])
    return out


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


def worst_param(names, got, ref):
    """``(r, name)``: the largest over parameters of max |got - ref| /
    max |ref| (``got`` taken to ``ref``'s dtype), and its parameter."""
    worst, name = 0.0, None
    for n, a, b in zip(names, got, ref):
        r = ((a.to(b.dtype) - b).abs().max().item()
             / max(b.abs().max().item(), 1e-30))
        if r > worst:
            worst, name = r, n
    return worst, name


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
    worst, name = worst_param([n for n, _ in model.named_parameters()], gk,
                              gp)
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
    return step_ms


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

    with chain_launch_shapes("training"):
        reset_counts()
        loss, gnorm = step(state, g, LR)
        torch.cuda.synchronize()
        launches = read_counts()
    loss, gnorm = loss.item(), gnorm.item()
    say("training", f"train_step(n_out={n_out}): loss {loss:.6f}, gradient "
        f"norm {gnorm:.6f}; launches {launches}")
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        fail("training", "non-finite loss or gradient norm")
    want = want_counts(mlp_chain=23 * n_out, gn_block=8 * n_out,
                       mlp_chain_bwd=23 * n_out, gn_block_bwd=8 * n_out,
                       sorted_segment_sum=8 * n_out)
    if launches != want:
        fail("training", f"launch counts {launches}, want {want}")

    grads_against_plain("training", model, g, crit, 3)
    steps_deterministic("training", model, step, state, g)
    step_ms = time_steps("training", lambda: step(state, g, LR), n_out, g,
                         smi, "training")
    return launches, step_ms


def make_adv_samples(num=8, n_nodes=5000, seed=11, n_out=4, dt=0.05):
    """Clouds at the bundled synthadv models' node input (the field, its
    advection velocity as ``loc``, ``omega``): a sum of three Fourier
    modes advected on the unit torus at a velocity per cloud, as
    ``tools/train_synthetic_adv.py:SyntheticAdv`` draws them (vel-max 2.0),
    through ``ConnectKNN(6)`` (periodic), ``ScaleEdgeAttr(0.04)`` and the
    3-scale runs' cells ``GridClustering([0.1, 0.2])``; targets ``n_out``
    steps of ``dt``."""
    from graphs4cfd_tpu_torch import transforms as T
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.utils import Compose
    pipeline = Compose([T.ConnectKNN(6, period=(1.0, 1.0)),
                        T.ScaleEdgeAttr(0.04), T.GridClustering([0.1, 0.2])])
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(num):
        pos = rng.random((n_nodes, 2)).astype(np.float32)
        vel = rng.uniform(-2.0, 2.0, 2).astype(np.float32)
        modes = [(int(rng.integers(1, 4)), int(rng.integers(1, 4)),
                  rng.uniform(0.2, 0.5), rng.uniform(0, 2 * np.pi))
                 for _ in range(3)]

        def field(t):
            x = pos - vel * np.float32(t)
            return sum(a * np.sin(2 * np.pi * (kx * x[:, :1] + ky * x[:, 1:])
                                  + ph)
                       for kx, ky, a, ph in modes).astype(np.float32)

        g = Graph()
        g.pos = pos
        g.loc = np.broadcast_to(vel, (n_nodes, 2)).copy()
        g.field = field(0.0)
        g.target = np.concatenate([field(dt * (j + 1)) for j in range(n_out)],
                                  axis=1)
        g.omega = np.zeros((n_nodes, 1), np.float32)
        g.bound = np.ones(n_nodes, np.uint8)
        out.append(pipeline(g))
    return out


def mus_launches(arch, n_out):
    """The kernel launches of a MuS ``solve(n_out)``: each level-1 MP
    layer one ``gn_block``; each coarse MP layer two ``mlp_chain`` (its
    edge and node MLP tails), each encoder, pooling MLP and the decoder
    one."""
    mp = [k for k in arch if k.startswith("mp")]
    level1 = [k for k in mp if k[2] == "1"]
    other = len(arch) - len(mp)
    return want_counts(
        mlp_chain=(2 * (len(mp) - len(level1)) + other) * n_out,
        gn_block=len(level1) * n_out)


def pretrained_phase(dev, smi):
    """The bundled 3-scale synthadv model through ``GNN(model=name)`` and
    ``solve`` of a list of graphs."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.nn import AdvThreeScaleGNN
    t = time.perf_counter()
    samples = make_adv_samples()
    say("pretrained", f"8 clouds of 5000 nodes in "
        f"{time.perf_counter() - t:.1f} s")
    model = AdvThreeScaleGNN(model=PRETRAINED_NAME, device=dev)
    n_out = 4
    model.solve(samples, 1)                            # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = model.solve(samples, n_out)
    torch.cuda.synchronize()
    launches = read_counts()
    g = Graph.from_numpy(collate(samples), dev)
    again = model.solve(g, n_out)
    width = model.layers["mp111"].edge_mlp.weights[0].shape[1]
    say("pretrained", f"AdvThreeScaleGNN(model={PRETRAINED_NAME!r}): "
        f"{model.num_params} params, {width} wide; solve(list of 8, "
        f"n_out={n_out}) -> {tuple(out.shape)}; launches {launches}")
    if model.num_params != PRETRAINED_PARAMS or width != 128:
        fail("pretrained", f"{model.num_params} parameters, {width} wide; "
             f"want {PRETRAINED_PARAMS}, 128")
    mask = g.node_mask
    if tuple(out.shape) != (g.num_nodes, n_out):
        fail("pretrained", f"output shape {tuple(out.shape)}")
    if not bool(torch.isfinite(out[mask]).all()):
        fail("pretrained", "non-finite values on valid rows")
    same = torch.equal(out, again)
    say("pretrained", f"solve of the list and of its collated batch: "
        f"{'bit-identical' if same else 'DIFFERENT'}")
    if not same:
        fail("pretrained", "solve of a list differs from solve of collate")
    want = mus_launches(model.arch, n_out)
    if launches != want:
        fail("pretrained", f"launch counts {launches}, want {want}")
    step_against_plain("pretrained", model, g)
    time_steps("pretrained", lambda: model.solve(g, n_out), n_out, g, smi,
               "rollout")


def fit_phase(samples7, train_launches, train_ms, dev, smi):
    """``fit`` of the flagship model on 16 samples: epoch 1 against
    ``make_train_step`` called by hand, the checkpoint read back, resume
    against a straight run; ms per training step beside the bare step's
    (``train_ms``, phase "training")."""
    import shutil
    import tempfile
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import DataLoader
    from graphs4cfd_tpu_torch.nn import (GraphLoss, NsThreeScaleGNN,
                                         TrainConfig)
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    t = time.perf_counter()
    samples = samples7 + make_samples(8, 5000, seed=8)
    say("fit", f"8 more graphs of 5000 nodes (seed 8) in "
        f"{time.perf_counter() - t:.1f} s")
    buckets = dict(node_bucket=512, edge_bucket=1024)
    loader = lambda: DataLoader(samples, batch_size=8, shuffle=True, seed=0,
                                **buckets)
    val = DataLoader(samples7, batch_size=8, **buckets)
    folder = tempfile.mkdtemp(prefix="g4c_fit_")

    def config(name, **kw):
        opts = dict(folder=folder, tensor_board=folder,
                    training_loss=GraphLoss(0.25), lr=LR,
                    grad_clip={"epoch": 0, "limit": 1.0}, num_steps=[1, 2],
                    add_steps={"tolerance": 1e9, "loss": "training"},
                    scheduler={"factor": 0.5, "patience": 0,
                               "loss": "training"},
                    epochs=3, chk_interval=1)
        opts.update(kw)
        return TrainConfig(name, **opts)

    try:
        # epoch 1 by hand: the same two batches, weights and Adam state
        ref = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev)
        step = make_train_step(ref, GraphLoss(0.25), 3, 1, 1.0)
        state = adam_init(ref.parameters())
        hand = [step(state, Graph.from_numpy(ref.prepare_batch(b), dev), LR,
                     True)[0] for b in loader()]
        hand_loss = 0.0
        for v in torch.stack(hand).tolist():
            hand_loss += v
        hand_loss /= len(hand)
        del ref, state, step, hand

        model = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev)
        train = loader()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        history = model.fit(config("fit"), train, val)
        torch.cuda.synchronize()
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated() / 2**30
        first = history[0]
        say("fit", f"epochs {[r['epoch'] for r in history]}, n_out "
            f"{[r['n_out'] for r in history]}, lr "
            f"{[r['lr'] for r in history]}, training losses "
            f"{[r['train_loss'] for r in history]}; launches in all "
            f"{launches}")
        if [r["n_out"] for r in history] != [1, 2, 2]:
            fail("fit", "the curriculum did not run")
        if not all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
                   for r in history):
            fail("fit", "non-finite loss")
        say("fit", f"epoch 1: loss {first['train_loss']!r}, by hand "
            f"{hand_loss!r} (two make_train_step calls, same batches, "
            f"weights and Adam state)")
        if first["train_loss"] != hand_loss:
            fail("fit", "epoch 1's loss differs from the hand-called steps")
        want = {k: 2 * v for k, v in train_launches.items()}
        say("fit", f"epoch 1's training launches {first['launches']} "
            f"(want 2 x phase 'training': {want})")
        if first["launches"] != want:
            fail("fit", "epoch 1's launch counts")
        if any(launches[k] < 1 for k in want if want[k]):
            fail("fit", f"a kernel of the path was not launched: {launches}")

        path = os.path.join(folder, "fit.chk")
        back = NsThreeScaleGNN(checkpoint=path, device=dev)
        same = all(torch.equal(a, b) for a, b in zip(back.parameters(),
                                                     model.parameters()))
        say("fit", f"checkpoint read back: parameters "
            f"{'bit-identical' if same else 'DIFFERENT'}")
        if not same:
            fail("fit", "the checkpoint does not give the parameters back")
        del back

        # resume into a model of other weights: they must come from the file
        again = NsThreeScaleGNN(arch=flagship_arch(), seed=1, device=dev)
        resumed = again.fit(config("fit", epochs=4, checkpoint=path), train,
                            val)
        straight = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev)
        straight.fit(config("straight", epochs=4), loader(), val)
        same = all(torch.equal(a, b) for a, b in zip(straight.parameters(),
                                                     again.parameters()))
        bck = os.path.exists(path + ".bck")
        say("fit", f"resumed at epoch {[r['epoch'] for r in resumed]} from "
            f"the epoch-3 checkpoint: parameters after epoch 4 "
            f"{'bit-identical' if same else 'DIFFERENT'} to a straight "
            f"4-epoch fit; fit.chk.bck {'exists' if bck else 'MISSING'}")
        if [r["epoch"] for r in resumed] != [4] or not same or not bck:
            fail("fit", "resume")
        del straight, again

        ms = 1e3 * first["seconds"] / first["steps"]
        rollout_ms = [1e3 * r["seconds"] / (r["steps"] * r["n_out"])
                      for r in history[1:]]
        say("fit", f"{ms:.3f} ms per training step in epoch 1 (n_out=1, "
            f"epoch wall time / {first['steps']} steps, host batches "
            f"included) against {train_ms:.3f} ms for the bare step (phase "
            f"'training'), {ms / train_ms - 1:+.1%}; epochs 2-3 (n_out=2): "
            f"{', '.join(f'{x:.3f}' for x in rollout_ms)} ms per rollout "
            f"step; on {smi}")
        say("fit", f"{first['edges_per_s']:.4e} level-1 edges/s in epoch 1; "
            f"peak device memory {peak:.3f} GiB "
            f"(torch.cuda.max_memory_allocated) on {smi}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


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
        with chain_launch_shapes("remus path"):
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
    want = want_counts(mlp_chain=11 * n_out, gn_block=18 * n_out)
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
        with chain_launch_shapes("remus training"):
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
    want = want_counts(mlp_chain=11 * n_out, gn_block=18 * n_out,
                       mlp_chain_bwd=11 * n_out, gn_block_bwd=18 * n_out,
                       sorted_segment_sum=18 * n_out)
    want_down = {key: 2 * n_out for key in in_down}
    if launches != want or in_down != want_down:
        fail("remus training", f"launch counts {launches} ({in_down} in "
             f"down_edge_mp), want {want} ({want_down})")

    grads_against_plain("remus training", model, g, crit, nf)
    steps_deterministic("remus training", model, step, state, g)
    time_steps("remus training", lambda: step(state, g, LR), n_out, g, smi,
               "training")
    return launches, in_down


def gmus_graphs(samples):
    """The gMuS workload's batch (``make_gmus_samples``) with the host
    sorts of its senders."""
    from graphs4cfd_tpu_torch.loader import attach_sender_sorts, collate
    t = time.perf_counter()
    gbatch = attach_sender_sorts(collate(samples, node_bucket=512,
                                         edge_bucket=1024))
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
    want = want_counts(mlp_chain=5 * n_out, gn_block=16 * n_out)
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
    want = want_counts(mlp_chain=5 * n_out, gn_block=16 * n_out,
                       mlp_chain_bwd=5 * n_out, gn_block_bwd=16 * n_out,
                       sorted_segment_sum=16 * n_out)
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


# ------------------------------------------------------- graph parallel (MuS)
GP_PARTS = 2
GP_N_OUT = 4               # rollout steps of phase "gp path"
GP_TOL = 1e-3              # rollout: max abs difference / max abs
GP_LOSS_TOL = 1e-5         # training loss, relative
GP_GRAD_TOL = 1e-3         # first-step gradients, relative L2
NCCL_TOL = 2e-4            # one forward, max abs difference / max abs
GP_AG_TOL = 1e-5           # all-gather fallback against the halo tables
GP_CASES = (("send_s", "halo_s", None), ("halo_sr_2", "halo_sr_2",
                                         "senders_2"),
            ("halo_sr_3", "halo_sr_3", "senders_3"),
            ("halo_p_2", "halo_p_2", "parent_2"),
            ("halo_p_3", "halo_p_3", "parent_3"))


def gp_graphs(batch):
    """``partition_graph(batch, 2)`` and ``attach_gp_sorts`` of the flagship
    batch: the halo tables' ``pmax`` and each level's local table size."""
    from graphs4cfd_tpu_torch.parallel import attach_gp_sorts, partition_graph
    t = time.perf_counter()
    sharded, info = partition_graph(batch, GP_PARTS)
    sharded = attach_gp_sorts(sharded)
    secs = time.perf_counter() - t
    d = sharded.data
    sizes = {}
    for table, (space, l) in ((k, v["space"])
                              for k, v in info["tables"].items()):
        block = d["pos" if l == 1 else f"pos_{l}"].shape[1]
        sizes[table] = block + GP_PARTS * info["pmax"][table]
    say("gp graphs", f"partition_graph(batch, {GP_PARTS}) + attach_gp_sorts "
        f"in {secs:.2f} s (host); pmax {info['pmax']}; local table rows S "
        f"{sizes}")
    want = {"halo_s", "halo_sr_2", "halo_sr_3", "halo_p_2", "halo_p_3"}
    if set(info["tables"]) != want:
        fail("gp graphs", f"halo tables {sorted(info['tables'])}, want "
             f"{sorted(want)}")
    return sharded, info


def gp_case(sharded, table, key, dev):
    """Part 0's table size ``S`` and map (with its host sort) of one
    gather of the partitioned forward."""
    d = sharded.data
    l = 1 if table == "halo_s" else int(table[-1])
    block = d["pos" if l == 1 else f"pos_{l}"].shape[1]
    S = block if key is None else block + GP_PARTS * d[table].shape[-1]
    m = table if key is None else f"{key}_lidx"
    put = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[0].reshape(-1))).to(dev)
    return S, put(d[m]), (put(d[f"{m}_perm"]), put(d[f"{m}_sorted"]))


def check_gp_kernels(dev, rng, sharded, smi):
    """``gather_rows`` (row 7) and its transpose, ``sorted_segment_sum``
    over the attached sorts (row 8's halo use), against their plain
    versions at part 0's shapes: the level-1 send gather (the halo_s rows
    part 0 sends) and the gathers from the coarse levels' shared tables
    and the up steps' parent tables; on f32 tables, then on bf16 tables
    (the bf16 policy's, at 2 bytes an element) with bf16 cotangent rows.
    The forward is a copy (exact); the library calls are
    ``index_select`` and ``index_add_`` (on f32 copies of bf16 rows)."""
    from graphs4cfd_tpu_torch.ops import gather
    H, out = 128, []
    for dtype in (torch.float32, BF16):
        sfx = "" if dtype == torch.float32 else "_bf16"
        for name, table, key in GP_CASES:
            S, idx, (perm, srt) = gp_case(sharded, table, key, dev)
            M = idx.shape[0]
            tab = torch.from_numpy(rng.normal(size=(S, H)).astype(
                np.float32)).to(dev).to(dtype)
            ct = torch.from_numpy(rng.normal(size=(M, H)).astype(
                np.float32)).to(dev).to(dtype)
            run = lambda: gather.gather_rows(tab, idx)
            plain = lambda: gather.gather_rows_plain(tab, idx)
            lib = lambda: torch.index_select(tab, 0, idx)
            got, ref = run(), plain()
            bad = idx.clone()
            bad[M // 2] = S
            nan_row = gather.gather_rows(tab, bad)[M // 2]
            torch.cuda.synchronize()
            rows = int(torch.unique(idx).numel())
            bms, by = bound_ms(0, rows * H * tab.element_size()
                               + nbytes(idx, got))
            fwd = {"name": f"gather_rows{sfx}[{name}]", "route": "cuda",
                   "source": "graphs4cfd_tpu_torch/csrc/gather_rows.cu",
                   "replaces": "graphs4cfd_tpu/ops/pallas_gather.py:37",
                   "max_abs_err": (got.float() - ref.float()).abs().max(
                       ).item(),
                   "ms": cuda_ms(run), "plain_ms": cuda_ms(plain),
                   "bound_ms": bms, "bound_by": by,
                   "library_ms": cuda_ms(lib), "shape": (S, M)}
            say("gp kernels", f"gather_rows{sfx} ({name}) [{S}, {H}] "
                f"{tab.dtype} -> [{M}, {H}] ({rows} distinct rows): max abs "
                f"err {fwd['max_abs_err']} (exact); kernel {fwd['ms']:.4f} "
                f"ms, plain {fwd['plain_ms']:.4f} ms, index_select "
                f"{fwd['library_ms']:.4f} ms, bound {bms:.4f} ms ({by}) on "
                f"{smi}")
            if got.dtype != dtype or not torch.equal(got, ref):
                fail("gp kernels", f"gather_rows{sfx} ({name}) differs from "
                     "plain")
            if not torch.equal(run(), run()):
                fail("gp kernels", f"gather_rows{sfx} ({name}): two launches "
                     "differ")
            if not bool(torch.isnan(nan_row.float()).all()):
                fail("gp kernels", f"gather_rows{sfx} ({name}): an index "
                     "outside the table does not give a NaN row")
            bwd = segment_record(
                "gp kernels", f"sorted_segment_sum{sfx}[{name}]",
                f"{name}, the transpose, {dtype} rows", ct, perm, srt, S,
                idx.long(), "graphs4cfd_tpu/ops/pallas_gather.py:80", smi)
            bwd["shape"] = (M, S)
            out += [fwd, bwd]
    floor = cuda_ms(lambda: torch.cuda._sleep(0))
    say("gp kernels", f"one empty launch (torch.cuda._sleep(0)), the launch "
        f"floor of gather_rows and the transposes: {floor:.4f} ms on {smi}")
    return out


def check_gp_gn_kernels(dev, rng, sharded, smi):
    """The GN-block kernel (rows 3/5), its backward (rows 4/6) and the
    backward's ``dvs`` sum at part 0's level-1 shapes: the rank's edges and
    nodes, a sender table of ``S = block + P * pmax`` rows (the rank's own
    ``vs`` rows, then the rows the halo exchange receives), the partitioned
    graph's ``senders_lidx`` and its host sort.  Chains 128 wide with
    LayerNorm and ``out_selu``; e' stored and skipped (the last level-1
    layer skips it).  The backward's time includes its ``dvs`` sum."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    k, H = 6, 128
    S, senders, sort = gp_case(sharded, "halo_s", "senders", dev)
    E = senders.shape[0]
    V = E // k
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    e, v, tab = t(E, H), t(V, H), t(S, H)
    ed, nd = [3 * H, H, H, H], [2 * H, H, H, H]
    edge = uniform_chain(rng, ed, True, dev)
    node = uniform_chain(rng, nd, True, dev)
    vs = tab @ edge[0][0][H:2 * H]
    params = [*edge[0], *edge[1], *edge[2], *node[0], *node[1], *node[2]]
    flops = gn_flops(E, V, H, H, ed, nd)
    shape = (E, V, S)
    out = []
    kinked = gn_kink_nodes(e, vs, v, senders, k, edge, node, True)
    gv = quiet(t(V, H), kinked)
    ge_full = quiet(t(E, H), kinked.repeat_interleave(k))
    for skip in (False, True):
        run = lambda: gn_op.gn_block(e, vs, v, senders, k, edge, node,
                                     out_selu=True, skip_e_out=skip)
        plain = lambda: gn_op.gn_block_plain(e, vs, v, senders, k, edge,
                                             node, out_selu=True,
                                             skip_e_out=skip)
        (vo, eo), (vr, er) = run(), plain()
        torch.cuda.synchronize()
        err = errors(vo, vr)[0] if skip else max(errors(vo, vr)[0],
                                                 errors(eo, er)[0])
        same = all(torch.equal(a, b) for a, b in zip(run(), run())
                   if a is not None)
        bms, by = bound_ms(flops, nbytes(e, vs, v, senders, vo, eo, *params))
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("gp kernels", f"gn_block (part 0, level 1) E={E} V={V} k={k} "
            f"table S={S} H={H} out_selu skip_e_out={skip}: max abs err "
            f"{err:.3e} (tol {GN_TOL}); two launches the same bits: {same}; "
            f"kernel {ms:.4f} ms, plain {pms:.4f} ms, bound {bms:.4f} ms "
            f"({by}) on {smi}")
        if not err <= GN_TOL or (skip and eo is not None) or not same:
            fail("gp kernels", f"gn_block at the partitioned shapes: error "
                 f"{err} (tol {GN_TOL}), e' skipped {eo is None}, "
                 f"deterministic {same}")
        if not skip:
            out.append(gn_record({
                "name": "gn_block[gp]", "route": "cuda",
                "source": "graphs4cfd_tpu_torch/csrc/gn_block.cu",
                "replaces": "graphs4cfd_tpu/ops/pallas_gnblock.py:132",
                "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "shape": shape}, flops,
                nbytes(e, vs, v, senders, vo, eo, *params)))
            say("gp kernels", f"gn_block (part 0, level 1): tensor-core "
                f"bound {out[-1]['bound_tc_ms']:.4f} ms, "
                f"{earlier_text(out[-1]['name'])}")
        del vo, eo, vr, er

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
        same = all(torch.equal(a, b) for a, b in zip(bwd_outputs(run()),
                                                     bwd_outputs(run())))
        bms, by = bound_ms(3 * flops, nbytes(e, vs, v, senders, *sort, gv, ge,
                                             *params, *bwd_outputs(got)))
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("gp kernels", f"gn_block_bwd (part 0, level 1) E={E} V={V} k={k} "
            f"table S={S} H={H} out_selu skip_e_out={skip}: max abs err "
            f"{err:.3e}, over max(1, max|ref|) {rel:.3e} (tol {GN_BWD_TOL}; "
            f"{int(kinked.sum())} nodes by a SELU kink and their edges given "
            f"a zero cotangent); dvs [{S}, {H}]; two launches the same bits: "
            f"{same}; kernel {ms:.4f} ms (with its dvs sum), plain "
            f"{pms:.4f} ms, bound {bms:.4f} ms ({by}) on {smi}")
        if not rel <= GN_BWD_TOL or not same or got[2].shape != (S, H):
            fail("gp kernels", f"gn_block_bwd at the partitioned shapes: "
                 f"error {rel} (tol {GN_BWD_TOL}), deterministic {same}, "
                 f"dvs {tuple(got[2].shape)}")
        if not skip:
            out.append(gn_record({
                "name": "gn_block_bwd[gp]", "route": "cuda",
                "source": "graphs4cfd_tpu_torch/csrc/gn_block_bwd.cu",
                "replaces": "graphs4cfd_tpu/ops/pallas_gnblock.py:152",
                "max_abs_err": err, "ms": ms, "plain_ms": pms,
                "bound_ms": bms, "bound_by": by, "library_ms": None,
                "shape": shape}, 3 * flops,
                nbytes(e, vs, v, senders, *sort, gv, ge, *params,
                       *bwd_outputs(got))))
            out[-1]["parts_ms"] = gn_bwd_parts((e, vs, v, senders, sort, k,
                                                edge, node, gv, ge, True))
            say("gp kernels", f"gn_block_bwd (part 0, level 1): tensor-core "
                f"bound {out[-1]['bound_tc_ms']:.4f} ms, "
                f"{earlier_text(out[-1]['name'])}; "
                f"parts {parts_text(out[-1]['parts_ms'])}")
        del got, ref

    # the dvs sum alone: per-edge rows into the S table rows
    res = segment_record("gp kernels", "sorted_segment_sum[gp_dvs]",
                         "the dvs sum, part 0, level 1", t(E, H), *sort, S,
                         senders.long(),
                         "graphs4cfd_tpu/ops/pallas_gnblock.py:719", smi)
    res["shape"] = (E, S)
    return out + [res]


@contextlib.contextmanager
def gp_launch_shapes():
    """Tally ``gather_rows`` launches by ``(S, M)`` (table rows, rows
    gathered), ``sorted_segment_sum`` launches by ``(rows, segments)``
    and the GN kernels' launches by ``(E, V, S)`` (edges, nodes, sender
    table rows) and by ``(E, V, S, fv)``; a bf16 launch under its
    wrapper's ``_bf16`` name.  ``("skip", name)`` keys count the GN
    launches by ``skip_e_out`` (the backward's: no e' cotangent)."""
    from graphs4cfd_tpu_torch.ops import gather, gn_block as gn_op, segment
    tally = {}
    saved = (gather._launch, segment._launch, gn_op._launch_fwd,
             gn_op._launch_bwd)
    g_launch, s_launch, fwd, bwd = saved

    def count(key):
        tally[key] = tally.get(key, 0) + 1

    def sfx(t):
        return "_bf16" if t.dtype == BF16 else ""

    def counted_gather(table, idx):
        count(("gather_rows" + sfx(table), (table.shape[0], idx.shape[0])))
        return g_launch(table, idx)

    def counted_sum(src, perm, srt, nseg):
        count(("sorted_segment_sum" + sfx(src), (src.shape[0], nseg)))
        return s_launch(src, perm, srt, nseg)

    def counted_gn(name, launch, skipped):
        def run(e, vs, v, *args):
            n = name + sfx(v)
            count((n, (e.shape[0], v.shape[0], vs.shape[0])))
            count((n, (e.shape[0], v.shape[0], vs.shape[0], v.shape[1])))
            count(("skip", n, skipped(args)))
            return launch(e, vs, v, *args)
        return run

    gather._launch, segment._launch = counted_gather, counted_sum
    # _launch_fwd(e, vs, v, senders, k, edge, node, out_selu, skip_e_out)
    # _launch_bwd(e, vs, v, senders, sort, k, edge, node, gv, ge, ...)
    gn_op._launch_fwd = counted_gn("gn_block", fwd, lambda a: bool(a[5]))
    gn_op._launch_bwd = counted_gn("gn_block_bwd", bwd,
                                   lambda a: a[6] is None)
    try:
        yield tally
    finally:
        (gather._launch, segment._launch, gn_op._launch_fwd,
         gn_op._launch_bwd) = saved


def gp_gathers_per_step(part, plan):
    """``gather_rows`` launches per partitioned time step, from the plan
    and the tables the partitioner kept: a level-1 MP layer gathers its
    halo_s send rows (its sender gather is inside the GN kernel); a coarse
    MP layer its halo_sr send rows, then senders and receivers; an up step
    its halo_p send rows, then the parents."""
    has = lambda t: int(t in part)
    n, level = 0, 1
    for op in plan:
        if op[0] == "mp":
            n += has("halo_s") if level == 1 else 2 + has(f"halo_sr_{level}")
        elif op[0] == "down":
            level = op[2]
        else:
            n += 1 + has(f"halo_p_{op[2]}")
            level = op[2] - 1
    return n


def _digest(tensors):
    import hashlib
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def _rank_time(run, n):
    """Median of 3 host-clock times of ``run()`` over ``n`` steps, each
    started together on every rank (a barrier) and ended by a
    synchronise."""
    import torch.distributed as dist
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        dist.barrier()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) / n)
    return 1e3 * float(np.median(times))


def gp_rank(rank, world, model, parts, job):
    """One rank of phases "gp path", "gp training" and "gp nccl" (the hook
    of ``run_gp_tasks``): the flagship model (seed 0) on this rank's part
    of the partitioned batch, on card 0."""
    from graphs4cfd_tpu_torch.nn import GraphLoss
    from graphs4cfd_tpu_torch.parallel import (
        gp_loss_and_grads, make_gp_forward, make_gp_rollout,
        make_gp_train_step)
    from graphs4cfd_tpu_torch.training import adam_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = parts["part"]
    res = {"gathers_per_step": gp_gathers_per_step(g.data, model.plan)}
    if job["kind"] == "nccl":
        with torch.inference_mode():
            res["out"] = make_gp_forward(model)(g).cpu().numpy()
    elif job["kind"] == "path":
        n_out = job["n_out"]
        rollout = make_gp_rollout(model, n_out)
        rollout(g)                                     # warm-up
        torch.cuda.synchronize()
        with gp_launch_shapes() as tally:
            reset_counts()
            out = rollout(g)
            torch.cuda.synchronize()
            res["launches"] = read_counts()
        res["tally"] = tally
        res["out"] = out.cpu().numpy()
        res["ms"] = _rank_time(lambda: rollout(g), n_out)
        # the all-gather fallback of every site against the halo tables
        forward = make_gp_forward(model)
        with torch.inference_mode():
            res["halo_vs_all_gather"] = tuple(
                forward(parts[x]).cpu().numpy() for x in ("part",
                                                           "all_gather"))
    else:
        crit = GraphLoss(lambda_d=0.25)
        params = list(model.parameters())
        loss, _, grads = gp_loss_and_grads(model, crit, g, g.target[:, :3])
        res["loss"] = loss.item()
        res["grads"] = torch.cat([x.reshape(-1) for x in grads]).cpu().numpy()
        step = make_gp_train_step(model, crit, 1, 1.0)
        saved = [p.detach().clone() for p in params]
        step(adam_init(params), g, LR)                 # warm-up
        digests = []
        for i in range(2):
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            state = adam_init(params)
            with gp_launch_shapes() as tally:
                reset_counts()
                loss, gnorm = step(state, g, LR)
                torch.cuda.synchronize()
                if i == 0:
                    res["launches"], res["tally"] = read_counts(), tally
            digests.append(_digest(params + state.mu + state.nu))
        res["digests"] = digests
        res["step"] = (loss.item(), gnorm.item())
        torch.cuda.reset_peak_memory_stats()
        res["ms"] = _rank_time(lambda: step(state, g, LR), 1)
        res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return res


def gp_spawn(phase, backend, world, kind, graphs, timeout):
    """``spawn_ranks`` of ``run_gp_tasks`` with ``gp_rank`` as its hook:
    the flagship model (seed 0) on card 0, ``graphs`` partitioned."""
    from graphs4cfd_tpu_torch.parallel import spawn_ranks
    from graphs4cfd_tpu_torch.parallel.run import run_gp_tasks
    t = time.perf_counter()
    try:
        ranks = spawn_ranks(run_gp_tasks, world, backend, {
            "arch": flagship_arch(), "seed": 0, "device": "cuda:0",
            "graphs": graphs, "hook": gp_rank, "kind": kind,
            "n_out": GP_N_OUT}, timeout=timeout)
    except RuntimeError as exc:
        fail(phase, str(exc))
    say(phase, f"{world} rank(s) over {backend} on card 0 returned in "
        f"{time.perf_counter() - t:.1f} s (process start-up included)")
    return ranks


def gp_path_phase(batch, sharded, info, ref_out, edges, smi):
    """``make_gp_rollout(n_out=4)`` over 2 gloo ranks sharing card 0,
    against the single-device ``solve(n_out=4)`` of the main path (same
    weights, same batch); and one forward with every halo table dropped
    (``halo_max_frac=0``: the all-gather fallback) against the forward on
    the halo tables."""
    from graphs4cfd_tpu_torch.parallel import unpermute
    from graphs4cfd_tpu_torch.parallel import (attach_gp_sorts,
                                               partition_graph)
    n_out = GP_N_OUT
    every, _ = partition_graph(batch, GP_PARTS, halo_max_frac=0.0)
    ranks = gp_spawn("gp path", "gloo", GP_PARTS, "path", {
        "part": sharded.data, "all_gather": attach_gp_sorts(every).data}, 600)
    out = unpermute([r["out"] for r in ranks], info)
    err, rel = errors(torch.from_numpy(out), torch.from_numpy(ref_out))
    per_step = ranks[0]["gathers_per_step"]
    say("gp path", f"make_gp_rollout(n_out={n_out}) -> {out.shape}, "
        f"un-permuted: max abs difference {err:.3e} from the single-device "
        f"solve, {rel:.3e} of its max abs (tol {GP_TOL}); launches per rank "
        f"{[r['launches'] for r in ranks]}; gather_rows per step "
        f"{per_step} (derived from the plan and the kept tables)")
    if out.shape != ref_out.shape or not np.isfinite(out).all():
        fail("gp path", f"output {out.shape} or a non-finite row")
    if not rel <= GP_TOL:
        fail("gp path", f"differs from the single-device solve by {rel}")
    for r in ranks:
        got = r["launches"]
        if got["gn_block"] != 8 * n_out or \
                got["gather_rows"] != per_step * n_out:
            fail("gp path", f"launch counts {got}: want gn_block == "
                 f"{8 * n_out}, gather_rows == {per_step * n_out}")
    ag = max(errors(*(torch.from_numpy(x) for x in r["halo_vs_all_gather"]
                      ))[1] for r in ranks)
    say("gp path", f"one forward over all-gathered levels against the halo "
        f"tables: max abs difference over max abs {ag:.3e} (tol "
        f"{GP_AG_TOL})")
    if not ag <= GP_AG_TOL:
        fail("gp path", f"the all-gather fallback differs by {ag}")
    ms = max(r["ms"] for r in ranks)
    say("gp path", f"{ms:.3f} ms per rollout step (slower rank, median of "
        f"3), {edges * 1e3 / ms:.4e} level-1 edges/s: 2 processes sharing "
        f"one card over gloo, not a scaling number, on {smi}")
    return ranks[0]


def gp_training_phase(sharded, ref, edges, smi):
    """One ``make_gp_train_step`` (``GraphLoss(0.25)``, n_out=1, clip 1.0,
    lr 1e-4) over 2 gloo ranks sharing card 0, against the single-device
    step's loss and first-step gradients from the same weights."""
    ranks = gp_spawn("gp training", "gloo", GP_PARTS, "train",
                     {"part": sharded.data}, 900)
    loss = ranks[0]["loss"]
    lrel = abs(loss - ref["loss"]) / abs(ref["loss"])
    g = ranks[0]["grads"]
    grel = float(np.linalg.norm(g - ref["grads"])
                 / np.linalg.norm(ref["grads"]))
    same = len({r["digests"][0] for r in ranks}) == 1
    repeat = all(r["digests"][0] == r["digests"][1] for r in ranks)
    say("gp training", f"global loss {loss:.7f} against the single-device "
        f"{ref['loss']:.7f} (relative {lrel:.3e}, tol {GP_LOSS_TOL}); "
        f"first-step gradients summed over the ranks: relative L2 "
        f"difference {grel:.3e} (tol {GP_GRAD_TOL}); train_step -> "
        f"{ranks[0]['step']}; parameters and Adam moments the same bits on "
        f"both ranks: {same}; two steps from the same state the same bits: "
        f"{repeat}; launches per rank {[r['launches'] for r in ranks]}")
    if not lrel <= GP_LOSS_TOL:
        fail("gp training", f"loss differs by {lrel}")
    if not grel <= GP_GRAD_TOL:
        fail("gp training", f"gradients differ by {grel}")
    if not (same and repeat):
        fail("gp training", "the step is not the same bits on both ranks "
             "or from the same state")
    per_step = ranks[0]["gathers_per_step"]
    for r in ranks:
        got = r["launches"]
        if got["gather_rows"] != per_step or \
                got["sorted_segment_sum"] != per_step + 8 or \
                got["gn_block_bwd"] != 8:
            fail("gp training", f"launch counts {got}: want gather_rows "
                 f"== {per_step}, sorted_segment_sum == {per_step + 8}, "
                 f"gn_block_bwd == 8")
    ms = max(r["ms"] for r in ranks)
    say("gp training", f"{ms:.3f} ms per training step (slower rank, median "
        f"of 3), {edges * 1e3 / ms:.4e} level-1 edges/s, peak device memory "
        f"per rank {[round(r['peak_gib'], 3) for r in ranks]} GiB: 2 "
        f"processes sharing one card over gloo, not a scaling number, on "
        f"{smi}")
    return ranks[0]


def gp_nccl_phase(batch, ref_fwd, smi):
    """One rank over NCCL (``partition_graph(batch, 1)``): the code path of
    one rank per card, against the single-device forward."""
    from graphs4cfd_tpu_torch.parallel import (attach_gp_sorts,
                                               partition_graph, unpermute)
    sharded, info = partition_graph(batch, 1)
    ranks = gp_spawn("gp nccl", "nccl", 1, "nccl",
                     {"part": attach_gp_sorts(sharded).data}, 300)
    out = unpermute([ranks[0]["out"]], info)
    err, rel = errors(torch.from_numpy(out), torch.from_numpy(ref_fwd))
    say("gp nccl", f"one forward over 1 NCCL rank: max abs difference "
        f"{err:.3e} from the single-device forward, {rel:.3e} of its max abs "
        f"(tol {NCCL_TOL}) on {smi}")
    if not rel <= NCCL_TOL or not np.isfinite(out).all():
        fail("gp nccl", f"differs from the single-device forward by {rel}")


def gp_reference(batch, dev):
    """The single-device forward, loss and first-step gradients of the
    flagship model (seed 0) on the batch, for the GP phases."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.nn import GraphLoss, NsThreeScaleGNN
    model = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev)
    g = Graph.from_numpy(batch, dev)
    with torch.inference_mode():
        fwd = model(g).cpu().numpy()
    loss = GraphLoss(lambda_d=0.25)(g, model(g), g.target[:, :3])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return {"forward": fwd, "loss": loss.item(),
            "grads": torch.cat([x.reshape(-1) for x in grads]).cpu().numpy()}


def gp_launches(cases, path, train, bf16_path=None, bf16_train=None):
    """Each GP kernel case's launches on the main paths, by shape: the
    gathers and GN blocks in one rank's ``make_gp_rollout(n_out=4)``, the
    transposes and GN backwards in one rank's training step (the bf16
    cases' in phase "bf16 gp"'s MuS run).  The GN cases must run at every
    level-1 layer: 8 per time step."""
    want = {"gn_block[gp]": 8 * GP_N_OUT, "gn_block_bwd[gp]": 8,
            "sorted_segment_sum[gp_dvs]": 8}
    for r in cases:
        kernel = r["name"].split("[")[0]
        bf = kernel.endswith("_bf16")
        p, t = (bf16_path, bf16_train) if bf else (path, train)
        tally = (p["tally"] if kernel.startswith(("gather_rows", "gn_block"))
                 and not kernel.startswith("gn_block_bwd") else t["tally"])
        r["launches"] = tally.get((kernel, r.pop("shape")), 0)
        if not r["launches"] or r["launches"] != want.get(r["name"],
                                                          r["launches"]):
            fail("gp kernels", f"{r['name']} was launched {r['launches']} "
                 f"times on the path, want {want.get(r['name'], '> 0')}")


# ------------------------------------------------------------ data parallel
DP_RANKS = 2               # phases "dp training", "dp families", "dp script"
DP_GP_MESH = (2, 2)        # phase "dp gp": data groups x graph parts


def dp_rank(rank, world, model, parts, mesh, job):
    """One rank of phases "dp training", "dp families" and "dp gp" (the
    hook of ``run_dp_tasks``): the first step's loss and gradients, reduced
    over the mesh, and one training step (``GraphLoss(0.25)``, n_out=1,
    clip 1.0, lr 1e-4) of this rank's shard (DP) or part (DP x GP) on card
    0, twice from the same state, with its launches and ms."""
    from graphs4cfd_tpu_torch.nn import GraphLoss
    from graphs4cfd_tpu_torch.parallel import (
        dp_loss_and_grads, gp_loss_and_grads, make_dp_gp_train_step,
        make_dp_train_step)
    from graphs4cfd_tpu_torch.parallel.collectives import all_reduce_grads_
    from graphs4cfd_tpu_torch.training import adam_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = parts["b"]
    crit = GraphLoss(lambda_d=0.25)
    target = g.target[:, :model.num_fields]
    params = list(model.parameters())
    res = {}
    if mesh.num_graph > 1:
        loss, _, grads = gp_loss_and_grads(model, crit, g, target,
                                           mesh.graph_group, mesh.group)
        step = make_dp_gp_train_step(model, crit, mesh, 1, 1.0)
        res["gathers_per_step"] = gp_gathers_per_step(g.data, model.plan)
        res["sites"] = gp_sites(g.data, job["family"], model.plan)
    else:
        loss, _, grads = dp_loss_and_grads(model, crit, g, target)
        step = make_dp_train_step(model, crit, 1, 1.0)
    res["loss"] = loss.item()
    res["grads"] = torch.cat([x.reshape(-1) for x in grads]).cpu().numpy()
    saved = [p.detach().clone() for p in params]
    step(adam_init(params), g, LR)                     # warm-up
    digests = []
    for i in range(2):
        with torch.no_grad():
            for p, x in zip(params, saved):
                p.copy_(x)
        state = adam_init(params)
        torch.cuda.synchronize()
        reset_counts()
        loss, gnorm = step(state, g, LR)
        torch.cuda.synchronize()
        if i == 0:
            res["launches"] = read_counts()
        digests.append(_digest(params + state.mu + state.nu))
    res["digests"] = digests
    res["step"] = (loss.item(), gnorm.item())
    torch.cuda.reset_peak_memory_stats()
    res["ms"] = _rank_time(lambda: step(state, g, LR), 1)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    # the step's one gradient all-reduce alone, over the whole mesh
    res["allreduce_ms"] = _rank_time(lambda: all_reduce_grads_(
        grads, mesh.group), 1)
    return res


def dp_job(family, arch, dtype, graph, graph_devices=1):
    return dict(family=family, arch=arch, seed=0, compute_dtype=dtype,
                device="cuda:0", devices=DP_RANKS, graph_devices=graph_devices,
                graphs={"b": graph.data}, hook=dp_rank)


def dp_spawn(phase, world, job, timeout):
    """``spawn_ranks`` of ``run_dp_tasks`` over gloo, every rank on card 0
    (NCCL refuses two ranks on one device)."""
    from graphs4cfd_tpu_torch.parallel import spawn_ranks
    from graphs4cfd_tpu_torch.parallel.run import run_dp_tasks
    t = time.perf_counter()
    try:
        ranks = spawn_ranks(run_dp_tasks, world, "gloo", job,
                            timeout=timeout)
    except RuntimeError as exc:
        fail(phase, str(exc))
    say(phase, f"{world} ranks over gloo on card 0 returned in "
        f"{time.perf_counter() - t:.1f} s (process start-up included)")
    return ranks


def dp_reference(model, batch, dev):
    """The single-device loss and first-step gradients of ``model`` on the
    unsplit batch (through its ``prepare_batch``), with the kernels."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.nn import GraphLoss
    g = Graph.from_numpy(model.prepare_batch(batch), dev)
    loss = GraphLoss(lambda_d=0.25)(g, model(g),
                                    g.target[:, :model.num_fields])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    return {"loss": loss.item(),
            "grads": torch.cat([x.reshape(-1) for x in grads]).cpu().numpy()}


def dp_check(phase, what, ranks, ref, loss_tol, grad_tol, want, smi):
    """One DP (or DP x GP) step against the single-device step on the
    unsplit batch: the loss and the gradients reduced over the ranks
    within their gates, the same bits on every rank and in two runs, and
    every rank's launches those of the single-device step (``want``)."""
    loss = ranks[0]["loss"]
    lrel = abs(loss - ref["loss"]) / abs(ref["loss"])
    grel = l2_gap(torch.from_numpy(ranks[0]["grads"]),
                  torch.from_numpy(ref["grads"]))
    same = (len({r["digests"][0] for r in ranks}) == 1
            and all(np.array_equal(r["grads"], ranks[0]["grads"])
                    and r["loss"] == loss for r in ranks))
    repeat = all(r["digests"][0] == r["digests"][1] for r in ranks)
    say(phase, f"{what}: loss {loss:.7f} against the single-device "
        f"{ref['loss']:.7f} (relative {lrel:.3e}, tol {loss_tol}); "
        f"first-step gradients reduced over the ranks: relative L2 "
        f"{grel:.3e} (tol {grad_tol}); train_step -> {ranks[0]['step']}; "
        f"loss, gradients, parameters and Adam moments the same bits on "
        f"every rank: {same}; two steps from the same state the same bits: "
        f"{repeat}")
    say(phase, f"{what}: launches a training step per rank "
        f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}")
    if not (lrel <= loss_tol and grel <= grad_tol):
        fail(phase, f"{what}: loss {lrel}, gradients {grel} off")
    if not (same and repeat):
        fail(phase, f"{what}: not the same bits on every rank or in two "
             f"runs")
    if any(r["launches"] != want for r in ranks):
        fail(phase, f"{what}: launches {[r['launches'] for r in ranks]}, "
             f"want {want}")
    ms = max(r["ms"] for r in ranks)
    mb = 4 * ranks[0]["grads"].size / 1e6
    say(phase, f"{what}: {ms:.3f} ms per training step (slower rank, "
        f"median of 3), of which one gradient all-reduce ({mb:.2f} MB "
        f"over gloo) alone takes {max(r['allreduce_ms'] for r in ranks):.3f}"
        f" ms; peak device memory per rank "
        f"{[round(r['peak_gib'], 3) for r in ranks]} GiB: {len(ranks)} "
        f"processes sharing one card over gloo, not a scaling number, on "
        f"{smi}")
    return ms


def dp_phases(samples7, batch, ref, rsamples, rbatch, gsamples, gbatch, dev,
              smi):
    """Phases "dp training" (MuS at the flagship arch, f32 then bf16) and
    "dp families" (REMuS and gMuS in bf16): each batch split by
    ``collate_sharded`` over 2 gloo ranks sharing card 0, one DP step
    against the single-device step on the unsplit batch."""
    from graphs4cfd_tpu_torch.loader import collate_sharded
    from graphs4cfd_tpu_torch.nn import (NsRotEquiThreeScaleGNN,
                                         NsThreeGuillardScaleGNN,
                                         NsThreeScaleGNN)
    t = time.perf_counter()
    shard = lambda s: collate_sharded(s, DP_RANKS, node_bucket=512,
                                      edge_bucket=1024)
    mus, remus, gmus = shard(samples7), shard(rsamples), shard(gsamples)
    say("dp training", f"collate_sharded into {DP_RANKS} shards: MuS "
        f"{mus.node_mask.shape}, REMuS {remus.node_mask.shape}, gMuS "
        f"{gmus.node_mask.shape} (shards, nodes) in "
        f"{time.perf_counter() - t:.1f} s (host)")
    cases = [("dp training", "MuS f32", "mus", flagship_arch(),
              torch.float32, mus, NsThreeScaleGNN, batch),
             ("dp training", "MuS bf16", "mus", flagship_arch(), BF16, mus,
              NsThreeScaleGNN, batch),
             ("dp families", "REMuS bf16", "remus", remus_arch(), BF16,
              remus, NsRotEquiThreeScaleGNN, rbatch),
             ("dp families", "gMuS bf16", "gmus", gmus_arch(), BF16, gmus,
              NsThreeGuillardScaleGNN, gbatch)]
    refs = []
    for phase, what, _, arch, dtype, _, cls, unsplit in cases:
        if dtype == torch.float32:
            refs.append(ref)
            continue
        model = cls(arch=arch, seed=0, device=dev, compute_dtype=dtype)
        refs.append(dp_reference(model, unsplit, dev))
        del model
    torch.cuda.empty_cache()
    ranks = dp_spawn("dp training", DP_RANKS, {"jobs": [
        dp_job(family, arch, dtype, graph)
        for _, _, family, arch, dtype, graph, _, _ in cases]}, 900)
    wants = {
        "MuS f32": want_counts(mlp_chain=23, gn_block=8, mlp_chain_bwd=23,
                               gn_block_bwd=8, sorted_segment_sum=8),
        "MuS bf16": want_counts(mlp_chain_bf16=23, gn_block_bf16=8,
                                mlp_chain_bwd_bf16=23, gn_block_bwd_bf16=8,
                                sorted_segment_sum_bf16=8),
        "REMuS bf16": want_counts(mlp_chain_bf16=11, gn_block_bf16=18,
                                  mlp_chain_bwd_bf16=11,
                                  gn_block_bwd_bf16=18,
                                  sorted_segment_sum_bf16=18),
        "gMuS bf16": want_counts(mlp_chain_bf16=5, gn_block_bf16=16,
                                 mlp_chain_bwd_bf16=5, gn_block_bwd_bf16=16,
                                 sorted_segment_sum_bf16=16)}
    for i, (phase, what, _, _, dtype, _, _, _) in enumerate(cases):
        f32 = dtype == torch.float32
        dp_check(phase, what, [r[i] for r in ranks], refs[i],
                 GP_LOSS_TOL if f32 else BF16_PATH_TOL,
                 GP_GRAD_TOL if f32 else BF16_GRAD_L2, wants[what], smi)
    return mus, gmus, refs[3]


def dp_gp_phase(mus, ref, gmus, gref, smi):
    """Phase "dp gp": MuS f32 at the flagship arch and gMuS bf16 at its
    cell's arch, each on a 2 x 2 mesh of 4 gloo ranks sharing card 0, the
    batch's two ``collate_sharded`` groups each partitioned in two
    (``partition_batches(regroup_sharded(...))``): one
    ``make_dp_gp_train_step`` against the single-device step, with GP's
    gates (bf16's for gMuS)."""
    from graphs4cfd_tpu_torch.parallel import (partition_batches,
                                               regroup_sharded)
    D, P = DP_GP_MESH
    jobs = []
    for what, family, arch, dtype, shards in (
            ("MuS f32", "mus", flagship_arch(), torch.float32, mus),
            ("gMuS bf16", "gmus", gmus_arch(), BF16, gmus)):
        t = time.perf_counter()
        sharded, info = partition_batches(regroup_sharded(shards, D), P)
        say("dp gp", f"{what}: partition_batches(regroup_sharded(batch, "
            f"{D}), {P}) in {time.perf_counter() - t:.2f} s (host); pmax "
            f"{info['pmax']}")
        jobs.append(dp_job(family, arch, dtype, sharded, graph_devices=P))
    ranks = dp_spawn("dp gp", D * P, {"jobs": jobs}, 900)
    mus_ranks = [r[0] for r in ranks]
    per_step = mus_ranks[0]["gathers_per_step"]
    want = want_counts(mlp_chain=23, gn_block=8, mlp_chain_bwd=23,
                       gn_block_bwd=8, sorted_segment_sum=per_step + 8,
                       gather_rows=per_step)
    dp_check("dp gp", f"MuS f32 on a {D} x {P} mesh", mus_ranks, ref,
             GP_LOSS_TOL, GP_GRAD_TOL, want, smi)
    say("dp gp", f"gather_rows "
        f"{[r['launches']['gather_rows'] for r in mus_ranks]} and "
        f"sorted_segment_sum "
        f"{[r['launches']['sorted_segment_sum'] for r in mus_ranks]} "
        f"launches a training step per rank ({per_step} halo gathers a "
        f"step, from the plan and the kept tables)")
    gmus_ranks = [r[1] for r in ranks]
    sites = gmus_ranks[0]["sites"]
    if any(r["sites"] != sites for r in gmus_ranks):
        fail("dp gp", f"gMuS ranks keep other halo tables: "
             f"{[r['sites'] for r in gmus_ranks]}")
    want = gp_want(want_counts(mlp_chain_bf16=5, gn_block_bf16=16,
                               mlp_chain_bwd_bf16=5, gn_block_bwd_bf16=16,
                               sorted_segment_sum_bf16=16), sites, BF16, 1,
                   True)
    dp_check("dp gp", f"gMuS bf16 on a {D} x {P} mesh", gmus_ranks, gref,
             BF16_PATH_TOL, BF16_GRAD_L2, want, smi)


def dp_script_rank(rank, world, folder):
    """One rank of phase "dp script":
    ``examples/training/distributed/NsThreeScaleGNN_dp.py`` on the port,
    at its full arch in bf16, joined through ``initialize_distributed``
    as the script joins (the ``GRAPHS4CFD_*`` variables ``spawn_ranks``
    sets with ``by_env``), cut as ``scripts_phase`` cuts
    ``NsThreeScaleGNN.py`` and to 2 ranks on card 0; then a model built
    from seed 1 resumes from the checkpoint for epoch 3."""
    import torch.distributed as dist
    import graphs4cfd_tpu_torch as gfd
    from graphs4cfd_tpu_torch import datasets
    from graphs4cfd_tpu_torch import transforms as T
    from graphs4cfd_tpu_torch.loader import collate, collate_sharded
    from graphs4cfd_tpu_torch.utils import random_split
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    joined = gfd.parallel.initialize_distributed()  # the script's call
    torch.cuda.set_device(0)
    train_config = gfd.nn.TrainConfig(
        name="NsThreeScaleGNN_dp", folder=folder, tensor_board=folder,
        chk_interval=1, training_loss=gfd.nn.GraphLoss(lambda_d=0.25),
        validation_loss=gfd.nn.GraphLoss(), epochs=2, num_steps=[1, 2],
        add_steps={"tolerance": 0.005, "loss": "training"}, batch_size=8,
        lr=1e-5, grad_clip={"epoch": 0, "limit": 1},
        scheduler={"factor": 0.5, "patience": 5, "loss": "training"},
        stopping=1e-8, mixed_precision=True, devices=joined)
    store = script_store()
    dataset = datasets.NsCircle(
        format="uvp", path="<preloaded>", seed=0,
        training_info={"n_in": 1, "n_out": train_config["num_steps"][-1],
                       "step": 1, "T": SCRIPT_T},
        transform=script_chain(T, seed=0))
    dataset.h5_data, dataset.preload = store, True
    train_set, test_set = random_split(dataset, [16, 8])
    train_loader = gfd.DataLoader(train_set,
                                  batch_size=train_config["batch_size"],
                                  shuffle=True)
    val_loader = gfd.DataLoader(test_set,
                                batch_size=train_config["batch_size"],
                                shuffle=False)
    model = gfd.nn.NsThreeScaleGNN(arch=flagship_arch())
    history = model.fit(train_config, train_loader, val_loader=val_loader)
    files = sorted(os.listdir(folder))
    resumed = gfd.nn.NsThreeScaleGNN(arch=flagship_arch(), seed=1)
    train_config.checkpoint = os.path.join(folder, "NsThreeScaleGNN_dp.chk")
    train_config.epochs = 3
    again = resumed.fit(train_config, train_loader, val_loader=val_loader)
    torch.cuda.synchronize()
    # the host work each rank does for a batch (the whole batch, as fit
    # builds it) against its own samples alone; both ranks at once
    host = []
    for build in (lambda: collate_sharded([train_set[i] for i in range(8)],
                                          joined),
                  lambda: collate([train_set[i]
                                   for i in range(rank, 8, joined)])):
        dist.barrier()
        t = time.perf_counter()
        build()
        host.append(time.perf_counter() - t)
    return {"history": history, "resumed": again, "files": files,
            "params": model.num_params, "host_s": host,
            "digest": _digest(list(resumed.parameters()))}


def dp_script_phase(bare_ms, smi):
    """Phase "dp script": ``NsThreeScaleGNN_dp.py`` through
    ``initialize_distributed`` and ``fit`` on 2 gloo ranks sharing card 0
    (the script asks for 8 cards)."""
    import shutil
    import tempfile
    from graphs4cfd_tpu_torch.parallel import spawn_ranks
    folder = tempfile.mkdtemp(prefix="g4c_dp_script_")
    t = time.perf_counter()
    try:
        ranks = spawn_ranks(dp_script_rank, DP_RANKS, "gloo", folder,
                            timeout=900, by_env=True)
    except RuntimeError as exc:
        fail("dp script", str(exc))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    say("dp script", f"{DP_RANKS} ranks over gloo on card 0 (joined through "
        f"initialize_distributed) returned in "
        f"{time.perf_counter() - t:.1f} s (process start-up included)")
    fields = ("epoch", "n_out", "lr", "train_loss", "grad_norm", "val_loss",
              "steps")
    keep = lambda h: [{k: r[k] for k in fields} for r in h]
    first = ranks[0]
    h, again = first["history"], first["resumed"]
    say("dp script", f"fit: NsThreeScaleGNN {first['params']} params, bf16, "
        f"devices={DP_RANKS}; epochs {[r['epoch'] for r in h]}, n_out "
        f"{[r['n_out'] for r in h]}, training losses "
        f"{[r['train_loss'] for r in h]}, validation losses "
        f"{[r['val_loss'] for r in h]}; resumed: epochs "
        f"{[r['epoch'] for r in again]}, training losses "
        f"{[r['train_loss'] for r in again]}; files after the first fit "
        f"{first['files']}")
    per_step = [{k: v // r["history"][0]["steps"]
                 for k, v in r["history"][0]["launches"].items() if v}
                for r in ranks]
    ms = [max(1e3 * r["history"][e]["seconds"] / r["history"][e]["steps"]
              for r in ranks) for e in range(len(h))]
    whole, own = (max(r["host_s"][i] for r in ranks) for i in (0, 1))
    say("dp script", f"host seconds a batch of 8 per rank, both ranks at "
        f"once: {whole:.3f} s for the whole batch (the script's chain and "
        f"collate_sharded: what fit builds on every rank), {own:.3f} s for "
        f"the rank's own {8 // DP_RANKS} samples (slower rank)")
    say("dp script", f"fit: bf16 launches a training step per rank "
        f"{per_step}; {', '.join(f'{x:.3f}' for x in ms)} ms per training "
        f"step (epochs 1, 2; slower rank; epoch wall time / steps, each "
        f"rank building every batch on the host) against {bare_ms:.3f} ms "
        f"for the bare single-device bf16 step (phase 'bf16 mus'): "
        f"{DP_RANKS} processes sharing one card over gloo, not a scaling "
        f"number, on {smi}")
    want = {k: v for k, v in want_counts(
        mlp_chain_bf16=23, gn_block_bf16=8, mlp_chain_bwd_bf16=23,
        gn_block_bwd_bf16=8, sorted_segment_sum_bf16=8).items() if v}
    if first["params"] != 2713347 or any(p != want for p in per_step):
        fail("dp script", f"{first['params']} params; launches a step "
             f"{per_step}, want {want}")
    if [r["epoch"] for r in h] != [1, 2] or \
            [r["epoch"] for r in again] != [3]:
        fail("dp script", "the epochs run or resumed")
    if not all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_loss"])
               for r in h + again):
        fail("dp script", "non-finite loss")
    if any(keep(r["history"]) != keep(h) or keep(r["resumed"]) != keep(again)
           or r["digest"] != first["digest"] for r in ranks):
        fail("dp script", "the ranks' histories or parameters differ")
    if [f for f in first["files"] if ".chk" in f] != \
            ["NsThreeScaleGNN_dp.chk"]:
        fail("dp script", f"files after the first fit {first['files']}: "
             f"want one checkpoint")
    say("dp script", "losses finite and the same bits on every rank; one "
        "checkpoint; the resume ran epoch 3 from it; the resumed parameters "
        "the same bits on every rank")


# ---------------------------------------------- graph parallel: every family
GP_FAMILY_N_OUT = 4        # rollout steps of phases "gp families", "bf16 gp"


def gp_sites(part, family, plan):
    """The ``gather_rows`` launches of one partitioned time step, from the
    plan and the tables the partitioner kept: ``{(on activations, with a
    gradient): count}``.  A site gathers its table's send rows (where the
    table was kept: ``halo_*``), then its map's rows; the GN kernels do
    their own sender gathers.  MuS: a level-1 MP layer its halo_s send
    rows; a coarse one its halo_sr rows, senders and receivers; an up step
    its halo_p rows and parents.  gMuS: every MP layer its level's halo_s
    send rows; a down step its halo_d rows and select; an up step its
    halo_u rows and interpolation.  REMuS: one halo_o exchange and each
    coarse level's origin rows (f32 inputs, no gradient); every EdgeMP
    layer its level's halo_s send rows (the folded edge table); a down
    step its halo_x rows; an up step its halo_u rows and interpolation (f32
    node vectors)."""
    has = lambda t: int(t in part)
    sfx = lambda l: "" if l == 1 else f"_{l}"
    n = {(True, True): 0, (False, True): 0, (False, False): 0}
    if family == "mus":
        level = 1
        for op in plan:
            if op[0] == "mp":
                n[True, True] += (has("halo_s") if level == 1
                                  else 2 + has(f"halo_sr_{level}"))
            elif op[0] == "down":
                level = op[2]
            else:
                n[True, True] += 1 + has(f"halo_p_{op[2]}")
                level = op[2] - 1
    elif family == "gmus":
        from graphs4cfd_tpu_torch.nn.mugs_gnn import level_groups
        groups, _ = level_groups(plan)
        level = 1
        for lvl, names in groups:
            while lvl > level:
                level += 1
                n[True, True] += 1 + has(f"halo_d_{level}")
            while lvl < level:
                n[True, True] += 1 + has(f"halo_u_{level}")
                level -= 1
            n[True, True] += len(names) * has(f"halo_s{sfx(level)}")
    else:
        levels = max([1] + [op[2] for op in plan if op[0] == "down"])
        if levels > 1:
            n[False, False] += has("halo_o") + levels - 1
        for op in plan:
            if op[0] == "mp":
                n[True, True] += has(f"halo_s{sfx(op[2])}")
            elif op[0] == "down":
                n[True, True] += has(f"halo_x_{op[2]}")
            else:
                n[False, True] += 1 + has(f"halo_u_{op[2]}")
    return n


def gp_want(single, sites, dtype, steps, train):
    """The launches a partitioned run should show: the single-device run's
    (``single``, the same steps) plus the halo gathers of ``steps`` time
    steps (``gp_sites``) and, in training, their transposes; a gather on
    bf16 activations launches the bf16 kernels, one on f32 rows the f32
    ones."""
    want = dict(single)
    for (act, grad), k in sites.items():
        sfx = "_bf16" if act and dtype == BF16 else ""
        want["gather_rows" + sfx] += k * steps
        if train and grad:
            want["sorted_segment_sum" + sfx] += k * steps
    return want


def gp_skip_flags(tally):
    return {k: v for k, v in tally.items() if k[0] == "skip"}


def gp_family_rank(rank, world, model, parts, job):
    """One rank of phases "gp families" and "bf16 gp" (the hook of
    ``run_gp_tasks``, one job a family and precision): on this rank's part
    of the family's partitioned batch, on card 0, ``make_gp_rollout(n_out
    = 4)`` and one ``make_gp_train_step`` (``GraphLoss(0.25)``, n_out 1,
    clip 1.0, lr 1e-4) twice from one state, each counted (launches by
    wrapper, by shape, and the GN kernels' ``skip_e_out`` flags) and timed;
    the first step's loss and gradients; with an ``all_gather`` part, one
    forward over the all-gather fallback beside one on the tables."""
    from graphs4cfd_tpu_torch.nn import GraphLoss
    from graphs4cfd_tpu_torch.parallel import (
        gp_loss_and_grads, make_gp_forward, make_gp_rollout,
        make_gp_train_step)
    from graphs4cfd_tpu_torch.training import adam_init
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g, nf, n_out = parts["part"], model.num_fields, GP_FAMILY_N_OUT
    res = {"sites": gp_sites(g.data, job["family"], model.plan)}
    rollout = make_gp_rollout(model, n_out)
    rollout(g)                                         # warm-up
    torch.cuda.synchronize()
    with gp_launch_shapes() as tally:
        reset_counts()
        out = rollout(g)
        torch.cuda.synchronize()
        res["path_launches"] = read_counts()
    res["path_tally"], res["out"] = tally, out.cpu().numpy()
    res["path_ms"] = _rank_time(lambda: rollout(g), n_out)
    if "all_gather" in parts:
        forward = make_gp_forward(model)
        with torch.inference_mode():
            res["halo_vs_all_gather"] = tuple(
                forward(parts[x]).cpu().numpy() for x in ("part",
                                                           "all_gather"))
    crit = GraphLoss(lambda_d=0.25)
    params = list(model.parameters())
    loss, _, grads = gp_loss_and_grads(model, crit, g, g.target[:, :nf])
    res["loss"] = loss.item()
    res["grads"] = torch.cat([x.reshape(-1) for x in grads]).cpu().numpy()
    del grads
    step = make_gp_train_step(model, crit, 1, 1.0)
    saved = [p.detach().clone() for p in params]
    step(adam_init(params), g, LR)                     # warm-up
    digests = []
    for i in range(2):
        with torch.no_grad():
            for p, x in zip(params, saved):
                p.copy_(x)
        state = adam_init(params)
        torch.cuda.synchronize()
        with gp_launch_shapes() as tally:
            reset_counts()
            step(state, g, LR)
            torch.cuda.synchronize()
            if i == 0:
                res["train_launches"], res["train_tally"] = (read_counts(),
                                                             tally)
        digests.append(_digest(params + state.mu + state.nu))
    res["digests"] = digests
    torch.cuda.reset_peak_memory_stats()
    res["train_ms"] = _rank_time(lambda: step(state, g, LR), 1)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del state, step, rollout
    torch.cuda.empty_cache()
    return res


def gp_family_reference(model, batch, dev):
    """The family's single-device run on the unsplit batch (through its
    ``prepare_batch``), counted as ``gp_family_rank`` counts its rank's:
    ``solve(n_out=4)``, the first step's loss and gradients, one
    ``make_train_step`` (n_out 1)."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.nn import GraphLoss
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    g = Graph.from_numpy(model.prepare_batch(batch), dev)
    nf = model.num_fields
    model.solve(g, 1)                                  # warm-up
    with gp_launch_shapes() as path_tally:
        reset_counts()
        out = model.solve(g, GP_FAMILY_N_OUT)
        torch.cuda.synchronize()
        path = read_counts()
    crit = GraphLoss(lambda_d=0.25)
    loss = crit(g, model(g), g.target[:, :nf])
    grads = torch.autograd.grad(loss, list(model.parameters()))
    step = make_train_step(model, crit, nf, 1, 1.0)
    saved = [p.detach().clone() for p in model.parameters()]
    with gp_launch_shapes() as train_tally:
        reset_counts()
        step(adam_init(list(model.parameters())), g, LR)
        torch.cuda.synchronize()
        train = read_counts()
    with torch.no_grad():
        for p, x in zip(model.parameters(), saved):
            p.copy_(x)
    return {"out": out.cpu().numpy(), "loss": loss.item(),
            "grads": torch.cat([x.reshape(-1) for x in grads]).cpu().numpy(),
            "path": path, "train": train,
            "path_flags": gp_skip_flags(path_tally),
            "train_flags": gp_skip_flags(train_tally)}


def gp_family_check(phase, what, ranks, info, ref, dtype, batch, smi):
    """One family's partitioned run on 2 ranks against its single-device
    run: the rollout, un-permuted, within ``GP_TOL`` (f32) or
    ``BF16_PATH_TOL`` of its max abs on the valid rows (a REMuS pad edge
    gathers its pad node's edges where one device gathers edge 0), every
    valid row finite; the all-gather
    fallback within ``GP_AG_TOL`` of the tables; the first step's loss
    and gradients within ``GP_LOSS_TOL`` and ``GP_GRAD_TOL`` (f32) or
    ``BF16_PATH_TOL`` and ``BF16_GRAD_L2``; the loss, gradients,
    parameters and Adam moments the same bits on both ranks and in two
    steps; each rank's launches the single-device run's plus its halo
    gathers and their transposes (``gp_want``), with the same GN
    ``skip_e_out`` flags.  Prints ms per step of the slower rank and the
    peak device memory per rank."""
    from graphs4cfd_tpu_torch.parallel import unpermute
    f32 = dtype == torch.float32
    edges, mask = int(batch.edge_mask.sum()), batch.node_mask
    out = unpermute([r["out"] for r in ranks], info)
    _, rel = errors(torch.from_numpy(out[mask]),
                    torch.from_numpy(ref["out"][mask]))
    loss = ranks[0]["loss"]
    lrel = abs(loss - ref["loss"]) / abs(ref["loss"])
    grel = l2_gap(torch.from_numpy(ranks[0]["grads"]),
                  torch.from_numpy(ref["grads"]))
    path_tol, loss_tol, grad_tol = ((GP_TOL, GP_LOSS_TOL, GP_GRAD_TOL) if f32
                                    else (BF16_PATH_TOL, BF16_PATH_TOL,
                                          BF16_GRAD_L2))
    same = (len({r["digests"][0] for r in ranks}) == 1
            and all(np.array_equal(r["grads"], ranks[0]["grads"])
                    and r["loss"] == loss for r in ranks))
    repeat = all(r["digests"][0] == r["digests"][1] for r in ranks)
    say(phase, f"{what}: make_gp_rollout(n_out={GP_FAMILY_N_OUT}) -> "
        f"{out.shape}, un-permuted: {rel:.3e} of the single-device solve's "
        f"max abs (tol {path_tol}); first-step loss {loss:.7f} against "
        f"{ref['loss']:.7f} (relative {lrel:.3e}, tol {loss_tol}), "
        f"gradients summed over the ranks: relative L2 {grel:.3e} (tol "
        f"{grad_tol}); the same bits on both ranks: {same}; two steps from "
        f"one state the same bits: {repeat}; halo gathers a step "
        f"{ranks[0]['sites']} ((on activations, with a gradient): count)")
    if out.shape != ref["out"].shape or not np.isfinite(out[mask]).all():
        fail(phase, f"{what}: output {out.shape} or a non-finite row")
    if not (rel <= path_tol and lrel <= loss_tol and grel <= grad_tol):
        fail(phase, f"{what}: rollout {rel}, loss {lrel}, gradients {grel}")
    if not (same and repeat):
        fail(phase, f"{what}: not the same bits on both ranks or in two "
             "steps")
    if "halo_vs_all_gather" in ranks[0]:
        ag = max(errors(*(torch.from_numpy(x) for x in
                          r["halo_vs_all_gather"]))[1] for r in ranks)
        say(phase, f"{what}: one forward over all-gathered levels against "
            f"the halo tables: {ag:.3e} of its max abs (tol {GP_AG_TOL})")
        if not ag <= GP_AG_TOL:
            fail(phase, f"{what}: the all-gather fallback differs by {ag}")
    for r in ranks:
        want_p = gp_want(ref["path"], r["sites"], dtype, GP_FAMILY_N_OUT,
                         False)
        want_t = gp_want(ref["train"], r["sites"], dtype, 1, True)
        if r["path_launches"] != want_p or r["train_launches"] != want_t:
            fail(phase, f"{what}: launches {r['path_launches']} (rollout), "
                 f"{r['train_launches']} (step), want {want_p}, {want_t}")
        if gp_skip_flags(r["path_tally"]) != ref["path_flags"] or \
                gp_skip_flags(r["train_tally"]) != ref["train_flags"]:
            fail(phase, f"{what}: GN skip_e_out flags "
                 f"{gp_skip_flags(r['path_tally'])}, "
                 f"{gp_skip_flags(r['train_tally'])}, want "
                 f"{ref['path_flags']}, {ref['train_flags']}")
    say(phase, f"{what}: launches a rollout step and a training step per "
        f"rank, the single-device run's plus the halo gathers and their "
        f"transposes, GN skip_e_out flags as on one device: "
        f"{[{k: v for k, v in r['train_launches'].items() if v} for r in ranks]}")
    path_ms = max(r["path_ms"] for r in ranks)
    train_ms = max(r["train_ms"] for r in ranks)
    say(phase, f"{what}: {path_ms:.3f} ms per rollout step, {train_ms:.3f} "
        f"ms per training step (slower rank, median of 3), "
        f"{edges * 1e3 / train_ms:.4e} level-1 edges/s trained; peak device "
        f"memory per rank {[round(r['peak_gib'], 3) for r in ranks]} GiB: 2 "
        f"processes sharing one card over gloo, not a scaling number, on "
        f"{smi}")
    return {"path_ms": path_ms, "train_ms": train_ms,
            "peak_gib": [r["peak_gib"] for r in ranks]}


def gp_fold_case(sharded, l, dev):
    """Part 0's folded-table map of a REMuS level's angle sources
    (``attach_gp_sorts``' ``angle_src{l}_fold``), its sort and the table's
    rows ``T * k``."""
    d, s = sharded.data, "" if l == 1 else f"_{l}"
    fold = d[f"angle_src{s}_fold"]
    k = fold.shape[-1]
    block = d[f"pos{s}"].shape[1]
    table = f"halo_s{s}"
    T = (block + GP_PARTS * d[table].shape[-1] if table in d
         else GP_PARTS * block)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[0].reshape(-1))).to(dev)
    key = f"angle_src{s}_fold"
    return T * k, put(fold), (put(d[f"{key}_perm"]), put(d[f"{key}_sorted"]))


def gp_map_case(sharded, table, key, space, dev):
    """Part 0's map of one gather into a table that may have fallen back
    to the all-gather: ``(S, map, sort)``."""
    d = sharded.data
    l = space[1]
    block = (d["pos" if l == 1 else f"pos_{l}"].shape[1] if space[0] == "node"
             else d["senders" if l == 1 else f"senders_{l}"].shape[1])
    kept = table in d
    S = block + GP_PARTS * d[table].shape[-1] if kept else GP_PARTS * block
    m = f"{key}_lidx" if kept else key
    put = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[0].reshape(-1))).to(dev)
    return S, put(d[m]), (put(d[f"{m}_perm"]), put(d[f"{m}_sorted"]))


def check_gp_family_gn_kernels(dev, rng, gsharded, rsharded, smi):
    """The GN-block kernel and its backward (rows 3-6) at part 0's shapes
    of the partitioned gMuS and REMuS paths, against their plain versions:
    gMuS ``mp121`` (level 1, the 256-wide node input of an up step) over
    the level's sender halo table (``S > V``: the two at once); a REMuS
    level-1 EdgeMP layer over the folded edge table (``T*k`` rows, indexed
    by ``angle_src_fold``); REMuS ``down_mp12`` over the fine-edge halo
    (``halo_x_2``).  Chains 128 wide with LayerNorm, ``out_selu``, e'
    stored; random inputs and sender tables, the partitioned maps and
    their host sorts."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    H = 128
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev)
    cases = [("gp_gmus_mp121", 6, 256, H + 512, H + 256,
              gp_map_case(gsharded, "halo_s", "senders", ("node", 1), dev),
              "graphs4cfd_tpu/ops/pallas_gnblock.py:132",
              "graphs4cfd_tpu/ops/pallas_gnblock.py:152"),
             ("gp_remus_mp1", 5, H, 3 * H, 2 * H, gp_fold_case(rsharded, 1,
                                                              dev),
              "graphs4cfd_tpu/ops/pallas_gnblock.py:132",
              "graphs4cfd_tpu/ops/pallas_gnblock.py:152"),
             ("gp_remus_down_mp12", 5, H, 3 * H, 2 * H,
              gp_map_case(rsharded, "halo_x_2", "xangle_src_2", ("edge", 1),
                          dev),
              "graphs4cfd_tpu/ops/pallas_gnblock.py:132",
              "graphs4cfd_tpu/ops/pallas_gnblock.py:152")]
    out = []
    for tag, k, fv, ed0, nd0, (S, senders, sort), fwd_of, bwd_of in cases:
        E = senders.shape[0]
        V = E // k
        e, v, vs = t(E, H), t(V, fv), t(S, H)
        ed, nd = [ed0, H, H], [nd0, H, H]
        if tag.startswith("gp_gmus"):
            ed, nd = ed + [H], nd + [H]
        edge = uniform_chain(rng, ed, True, dev)
        node = uniform_chain(rng, nd, True, dev)
        params = [*edge[0], *edge[1], *edge[2], *node[0], *node[1], *node[2]]
        flops = gn_flops(E, V, H, fv, ed, nd)
        shape = (E, V, S, fv)
        run = lambda: gn_op.gn_block(e, vs, v, senders, k, edge, node,
                                     out_selu=True)
        plain = lambda: gn_op.gn_block_plain(e, vs, v, senders, k, edge,
                                             node, out_selu=True)
        (vo, eo), (vr, er) = run(), plain()
        torch.cuda.synchronize()
        err = max(errors(vo, vr)[0], errors(eo, er)[0])
        same = all(torch.equal(a, b) for a, b in zip(run(), run()))
        nb = nbytes(e, vs, v, senders, vo, eo, *params)
        bms, by = bound_ms(flops, nb)
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("gp families", f"gn_block ({tag}, part 0) E={E} V={V} k={k} "
            f"fv={fv} table S={S}: max abs err {err:.3e} (tol {GN_TOL}); two "
            f"launches the same bits: {same}; kernel {ms:.4f} ms, plain "
            f"{pms:.4f} ms, bound {bms:.4f} ms ({by}) on {smi}")
        if not err <= GN_TOL or not same:
            fail("gp families", f"gn_block ({tag}) error {err}, "
                 f"deterministic {same}")
        out.append(gn_record({
            "name": f"gn_block[{tag}]", "route": "cuda",
            "source": "graphs4cfd_tpu_torch/csrc/gn_block.cu",
            "replaces": fwd_of, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "shape": shape}, flops, nb))
        del vo, eo, vr, er
        kinked = gn_kink_nodes(e, vs, v, senders, k, edge, node, True)
        gv = quiet(t(V, H), kinked)
        ge = quiet(t(E, H), kinked.repeat_interleave(k))
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
        same = all(torch.equal(a, b) for a, b in zip(bwd_outputs(run()),
                                                     bwd_outputs(run())))
        nb = nbytes(e, vs, v, senders, *sort, gv, ge, *params,
                    *bwd_outputs(got))
        bms, by = bound_ms(3 * flops, nb)
        ms, pms = cuda_ms(run), cuda_ms(plain)
        say("gp families", f"gn_block_bwd ({tag}, part 0) E={E} V={V} k={k} "
            f"fv={fv} table S={S}: max abs err {err:.3e}, over max(1, "
            f"max|ref|) {rel:.3e} (tol {GN_BWD_TOL}); dvs {tuple(got[2].shape)};"
            f" two launches the same bits: {same}; kernel {ms:.4f} ms (with "
            f"its dvs sum), plain {pms:.4f} ms, bound {bms:.4f} ms ({by}) on "
            f"{smi}")
        if not rel <= GN_BWD_TOL or not same or got[2].shape != (S, H):
            fail("gp families", f"gn_block_bwd ({tag}) error {rel}, "
                 f"deterministic {same}, dvs {tuple(got[2].shape)}")
        out.append(gn_record({
            "name": f"gn_block_bwd[{tag}]", "route": "cuda",
            "source": "graphs4cfd_tpu_torch/csrc/gn_block_bwd.cu",
            "replaces": bwd_of, "max_abs_err": err, "ms": ms,
            "plain_ms": pms, "bound_ms": bms, "bound_by": by,
            "library_ms": None, "shape": shape}, 3 * flops, nb))
        del got, ref
    return out


def gp_family_jobs(cases, dev):
    """``(jobs, references, infos)`` of ``cases``: ``(what, family name,
    model class, arch, dtype, batch, all-gather part or not)``; each
    family's single-device reference is run here, then its model freed,
    before the ranks start."""
    from graphs4cfd_tpu_torch.parallel import attach_gp_sorts, partition_graph
    jobs, refs, infos, shardeds = [], [], [], []
    for what, family, cls, arch, dtype, batch, ag in cases:
        t = time.perf_counter()
        sharded, info = partition_graph(batch, GP_PARTS)
        sharded = attach_gp_sorts(sharded)
        graphs = {"part": sharded.data}
        if ag:
            every, _ = partition_graph(batch, GP_PARTS, halo_max_frac=0.0)
            graphs["all_gather"] = attach_gp_sorts(every).data
        say("gp families" if dtype == torch.float32 else "bf16 gp",
            f"{what}: partition_graph(batch, {GP_PARTS}) + attach_gp_sorts "
            f"in {time.perf_counter() - t:.2f} s (host); pmax {info['pmax']}")
        model = cls(arch=arch, seed=0, device=dev, compute_dtype=dtype)
        refs.append(gp_family_reference(model, batch, dev))
        del model
        torch.cuda.empty_cache()
        jobs.append(dict(family=family, arch=arch, seed=0,
                         compute_dtype=dtype, device="cuda:0", graphs=graphs,
                         hook=gp_family_rank))
        infos.append(info)
        shardeds.append(sharded)
    return jobs, refs, infos, shardeds


def gp_families_phase(rbatch, gbatch, dev, rng, smi):
    """Phase "gp families": REMuS (phase 13's workload and arch) and gMuS
    (phase 16's) in f32 on 2 gloo ranks sharing card 0, each through
    ``partition_graph(batch, 2)`` and ``attach_gp_sorts``, against the
    family's single-device run (``gp_family_check``), with the all-gather
    fallback; and the GN kernels at their partitioned shapes
    (``check_gp_family_gn_kernels``)."""
    from graphs4cfd_tpu_torch.nn import (NsRotEquiThreeScaleGNN,
                                         NsThreeGuillardScaleGNN)
    from graphs4cfd_tpu_torch.parallel import spawn_ranks
    from graphs4cfd_tpu_torch.parallel.run import run_gp_tasks
    cases = [("REMuS f32", "remus", NsRotEquiThreeScaleGNN, remus_arch(),
              torch.float32, rbatch, True),
             ("gMuS f32", "gmus", NsThreeGuillardScaleGNN, gmus_arch(),
              torch.float32, gbatch, True)]
    jobs, refs, infos, shardeds = gp_family_jobs(cases, dev)
    records = check_gp_family_gn_kernels(dev, rng, shardeds[1], shardeds[0],
                                         smi)
    torch.cuda.empty_cache()
    t = time.perf_counter()
    try:
        ranks = spawn_ranks(run_gp_tasks, GP_PARTS, "gloo", {"jobs": jobs},
                            timeout=900)
    except RuntimeError as exc:
        fail("gp families", str(exc))
    say("gp families", f"{GP_PARTS} ranks over gloo on card 0 returned in "
        f"{time.perf_counter() - t:.1f} s (process start-up included)")
    out = {}
    for i, (what, _, _, _, dtype, batch, _) in enumerate(cases):
        out[what] = gp_family_check(
            "gp families", what, [r[i] for r in ranks], infos[i], refs[i],
            dtype, batch, smi)
    # each GN case's launches on its family's partitioned path
    tallies = {"gp_gmus": (ranks[0][1]["path_tally"],
                           ranks[0][1]["train_tally"]),
               "gp_remus": (ranks[0][0]["path_tally"],
                            ranks[0][0]["train_tally"])}
    for r in records:
        kernel, tag = r["name"][:-1].split("[")
        path, train = tallies["_".join(tag.split("_")[:2])]
        r["launches"] = (path if kernel == "gn_block" else train).get(
            (kernel, r.pop("shape")), 0)
        say("gp families", f"{r['name']}: {r['launches']} launches in rank "
            f"0's counted {'rollout' if kernel == 'gn_block' else 'step'}")
        if not r["launches"]:
            fail("gp families", f"{r['name']} was not launched on the path")
    return records, out


def bf16_gp_phase(batch, rbatch, gbatch, dev, smi):
    """Phase "bf16 gp": MuS (phase 5's batch, the flagship arch), REMuS and
    gMuS (phases 13 and 16) in bf16 on the same 2 ranks, against each
    family's single-device bf16 run (``gp_family_check``: the bf16
    gates; the bf16 launch counts, ``gather_rows_bf16`` among them).
    Returns the MuS run's rank 0 tallies (the bf16 gather cases'
    launches)."""
    from graphs4cfd_tpu_torch.nn import (NsRotEquiThreeScaleGNN,
                                         NsThreeGuillardScaleGNN,
                                         NsThreeScaleGNN)
    from graphs4cfd_tpu_torch.parallel import spawn_ranks
    from graphs4cfd_tpu_torch.parallel.run import run_gp_tasks
    cases = [("MuS bf16", "mus", NsThreeScaleGNN, flagship_arch(), BF16,
              batch, False),
             ("REMuS bf16", "remus", NsRotEquiThreeScaleGNN, remus_arch(),
              BF16, rbatch, False),
             ("gMuS bf16", "gmus", NsThreeGuillardScaleGNN, gmus_arch(), BF16,
              gbatch, False)]
    jobs, refs, infos, _ = gp_family_jobs(cases, dev)
    t = time.perf_counter()
    try:
        ranks = spawn_ranks(run_gp_tasks, GP_PARTS, "gloo", {"jobs": jobs},
                            timeout=900)
    except RuntimeError as exc:
        fail("bf16 gp", str(exc))
    say("bf16 gp", f"{GP_PARTS} ranks over gloo on card 0 returned in "
        f"{time.perf_counter() - t:.1f} s (process start-up included)")
    out = {}
    for i, (what, _, _, _, dtype, b, _) in enumerate(cases):
        out[what] = gp_family_check("bf16 gp", what, [r[i] for r in ranks],
                                    infos[i], refs[i], dtype, b, smi)
        if not ranks[0][i]["path_launches"]["gather_rows_bf16"]:
            fail("bf16 gp", f"{what}: no bf16 gather launched")
    mus = ranks[0][0]
    return ({"tally": mus["path_tally"]}, {"tally": mus["train_tally"]}, out)


# ------------------------------------------------------------ bf16 policy
PEAK_BF16_FLOPS = 989e12   # H100 SXM, bf16 on the tensor cores (dense)
BF16 = torch.bfloat16
# The bf16 kernels against their bf16 plain versions: both round the same
# operands to bf16 and sum in f32, in another order, so an output may land
# one bf16 ulp (2^-8 relative) apart: forward outputs within BF16_TOL of
# max(1, max |ref|).  An operand one ulp apart can put a SELU input on the
# other side of 0, where the derivative jumps: the backward outputs are
# held in relative L2 (BF16_BWD_L2), and so are a model's gradients
# (BF16_GRAD_L2, over all its parameters); one step of a model within
# BF16_PATH_TOL of the plain step's max abs.
BF16_TOL = 8e-3
BF16_BWD_L2 = 1e-2
BF16_PATH_TOL = 1e-2
BF16_GRAD_L2 = 5e-2
# the bf16 kernel records by name, and their launches in the bf16 phases
BF16_RECORDS = {}
BF16_LAUNCHES = {}


def bound_bf16_ms(flops, nbytes):
    """The bound of work whose products run in bf16 on the tensor cores:
    max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s); bf16 tensors count 2
    bytes an element (``nbytes``)."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def l2_gap(out, ref):
    """Relative L2 distance, in float64."""
    out, ref = out.double(), ref.double()
    return ((out - ref).norm() / ref.norm().clamp_min(1e-30)).item()


def bf16_record(name, source, replaces, run, plain, flops, inputs,
                backward, f32_ms, parts=None):
    """A bf16 kernel against its bf16 plain version: the forward's outputs
    within BF16_TOL of max(1, max |ref|), a backward's within BF16_BWD_L2
    in relative L2, two launches the same bits; device ms of the kernel
    and the plain version, the bf16 bound.  ``run``/``plain`` return a
    list of tensors; ``parts`` times the backward's launches apart."""
    got, ref = run(), plain()
    torch.cuda.synchronize()
    if len(got) != len(ref) or any(a.shape != b.shape or a.dtype != b.dtype
                                   for a, b in zip(got, ref)):
        fail("bf16 kernels", f"{name}: outputs {[(a.shape, a.dtype) for a in got]} "
             f"against {[(b.shape, b.dtype) for b in ref]}")
    err = max((a.float() - b.float()).abs().max().item() for a, b in
              zip(got, ref))
    if backward:
        gap = max(l2_gap(a, b) for a, b in zip(got, ref))
        tol, what = BF16_BWD_L2, "relative L2"
    else:
        gap = max(scaled_err(a.float(), b.float()) for a, b in zip(got, ref))
        tol, what = BF16_TOL, "max abs err over max(1, max|ref|)"
    same = all(torch.equal(a, b) for a, b in zip(run(), run()))
    nb = nbytes(*inputs, *got)
    bms, by = bound_bf16_ms(flops, nb)
    res = {"name": name, "route": "cuda", "source": source,
           "replaces": replaces, "max_abs_err": err, "ms": cuda_ms(run),
           "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
           "library_ms": None, "f32_ms": f32_ms, "launches": 0}
    if parts is not None:
        res["parts_ms"] = parts()
    say("bf16 kernels", f"{name}: {what} {gap:.3e} (tol {tol}), max abs "
        f"err {err:.3e}; two launches the same bits: {same}; kernel "
        f"{res['ms']:.4f} ms (f32 {f32_ms:.4f} ms), plain "
        f"{res['plain_ms']:.4f} ms, bf16 bound {bms:.4f} ms ({by})"
        + (f"; parts {parts_text(res['parts_ms'])}" if parts else ""))
    if not gap <= tol:
        fail("bf16 kernels", f"{name}: {what} {gap} above {tol}")
    if not same:
        fail("bf16 kernels", f"{name}: two launches differ")
    BF16_RECORDS[name] = res
    return res


def f32_ms_of(results, name):
    for r in results:
        if r["name"] == name:
            return r["ms"]
    fail("bf16 kernels", f"no f32 record {name!r}")


def bf16_chain_cases(dev, rng, f32_results):
    """Rows 1 and 2 in bf16 at each of ``CHAIN_CASES``."""
    from graphs4cfd_tpu_torch.ops import fused_mlp
    out = []
    for case, rows, dims, ln, preact, need_dx, _ in CHAIN_CASES:
        x, g, ws, bs, lns = chain_case(dev, rng, rows, dims, ln)
        x, g = x.to(BF16), g.to(BF16)
        lnp = lns or (None, None)
        params = [*ws, *bs, *(lns or ())]
        fwd = chain_name("mlp_chain", case)
        name = fwd.replace("mlp_chain", "mlp_chain_bf16")
        say("bf16 kernels", f"{name}: {earlier_text(name)}")
        out.append(bf16_record(
            name, "graphs4cfd_tpu_torch/csrc/mlp_chain_fwd_bf16.cu",
            "graphs4cfd_tpu/ops/pallas_mlp.py:75",
            lambda: [fused_mlp.mlp_chain(x, ws, bs, *lnp,
                                         preact_input=preact)],
            lambda: [fused_mlp.mlp_chain_plain(x, ws, bs, *lnp,
                                               preact_input=preact)],
            chain_flops(rows, dims), [x, *params], False,
            f32_ms_of(f32_results, fwd)))
        s = lns[0] if lns else None
        args = (x, g, ws, bs, s, preact, need_dx)
        flat = lambda r: [t for t in bwd_outputs_chain(r) if t is not None]
        bwd = chain_name("mlp_chain_bwd", case)
        out.append(bf16_record(
            bwd.replace("mlp_chain_bwd", "mlp_chain_bwd_bf16"),
            "graphs4cfd_tpu_torch/csrc/mlp_chain_bwd_bf16.cu",
            "graphs4cfd_tpu/ops/pallas_mlp.py:88",
            lambda: flat(fused_mlp.mlp_chain_bwd(
                x, g, ws, bs, s, preact_input=preact, need_dx=need_dx)),
            lambda: flat(fused_mlp.mlp_chain_bwd_plain(
                x, g, ws, bs, s, preact_input=preact, need_dx=need_dx)),
            chain_bwd_flops(rows, dims, ln, need_dx), [x, g, *params], True,
            f32_ms_of(f32_results, bwd),
            parts=lambda: chain_bwd_parts(args)))
    return out


def bwd_outputs_chain(res):
    dx, dws, dbs, dln = res
    return [dx, *dws, *dbs, *(dln or ())]


def bf16_gn_case(name, bwd_name, replaces, e, vs, v, senders, sort, k,
                 edge, node, skip, gv, ge, f32_results, f32_names):
    """The GN block and its backward in bf16 on one case (``skip``: e' not
    stored and no e' cotangent)."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    E, V, fe, fv = e.shape[0], v.shape[0], e.shape[1], v.shape[1]
    ed = [edge[0][0].shape[0]] + [w.shape[1] for w in edge[0]]
    nd = [node[0][0].shape[0]] + [w.shape[1] for w in node[0]]
    params = [*edge[0], *edge[1], *edge[2], *node[0], *node[1], *node[2]]
    flops = gn_flops(E, V, fe, fv, ed, nd)
    outs = lambda r: [t for t in r if t is not None]
    fwd = bf16_record(
        name, "graphs4cfd_tpu_torch/csrc/gn_block_bf16.cu", replaces[0],
        lambda: outs(gn_op.gn_block(e, vs, v, senders, k, edge, node,
                                    out_selu=True, skip_e_out=skip)),
        lambda: outs(gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                                          out_selu=True, skip_e_out=skip)),
        flops, [e, vs, v, senders, *params], False,
        f32_ms_of(f32_results, f32_names[0]))
    ge = None if skip else ge
    args = (e, vs, v, senders, sort, k, edge, node, gv, ge)
    bwd = bf16_record(
        bwd_name, "graphs4cfd_tpu_torch/csrc/gn_block_bf16.cu", replaces[1],
        lambda: bwd_outputs(gn_op.gn_block_bwd(*args, out_selu=True)),
        lambda: bwd_outputs(gn_op.gn_block_bwd_plain(*args, out_selu=True)),
        3 * flops, [e, vs, v, senders, *sort, gv, ge, *params], True,
        f32_ms_of(f32_results, f32_names[1]),
        parts=lambda: gn_bwd_parts(args + (True,)))
    return [fwd, bwd]


def bf16_segment(res, f32_results, f32_name):
    """A bf16 segment-sum record (``segment_record``), with the f32
    kernel's ms at the same case and its launches to be taken from the
    bf16 phases."""
    res.update(f32_ms=f32_ms_of(f32_results, f32_name), launches=0)
    BF16_RECORDS[res["name"]] = res
    return res


def wgrad_cases(rbatch):
    """The bf16 backward cases of this phase whose weight-gradient products
    ``bf16_wgrad_record`` runs: (case, the backward record, the TPU line,
    ``(rows, K, N, X is bf16)`` of each product, ``ops.wgrad``'s mirror of
    the backwards' plans)."""
    from graphs4cfd_tpu_torch.ops import wgrad
    H, chain_dw = 128, "graphs4cfd_tpu/ops/pallas_mlp.py:136"
    gn_dw = "graphs4cfd_tpu/ops/pallas_gnblock.py:62"
    out = []
    for case, rows, dims, _, preact, _, _ in CHAIN_CASES:
        out.append((case, chain_name("mlp_chain_bwd_bf16", case), chain_dw,
                    wgrad.chain_products(rows, dims, preact)))
    out.append(("mus_level1", "gn_block_bwd_bf16", gn_dw, wgrad.gn_products(
        BENCH_SIZES["V"], 6, H, H, [3 * H, H, H, H], [2 * H, H, H, H])))
    for name, key in (("edge_mp", "angle_src"),
                      ("down_edge_mp", "xangle_src_2")):
        out.append((name, f"gn_block_bwd_bf16[{name}]", gn_dw,
                    wgrad.gn_products(rbatch.data[key].shape[0], 5, H, H,
                                      [3 * H, H, H], [2 * H, H, H])))
    for name, V in (("mp121", GMUS_SIZES["V"]), ("mp221", GMUS_SIZES["V2"])):
        out.append((name, f"gn_block_bwd_bf16[{name}]", gn_dw,
                    wgrad.gn_products(V, 6, H, 256, [H + 512, H, H, H],
                                      [H + 256, H, H, H])))
    return out


#: the weight-gradient records -> the backward record whose launches they
#: share (each backward launches the kernel once)
WGRAD_OF = {}


def bf16_wgrad_record(dev, rng, case, bwd_name, replaces, products):
    """The bf16 weight-gradient kernel on one backward's products (random
    operands of their shapes and types: bf16 D, bf16 or f32 X), as the
    backward launches it (one launch and the reduction): within
    BF16_BWD_L2 relative L2 of the plain version and of ``torch.mm`` on
    bf16 copies (bf16 output), two launches the same bits; device ms of
    the kernel (with its reduction; its parts apart), the plain version,
    one ``torch.mm`` a product on bf16 copies made outside the timed
    window (``library_ms``), the kernel on those bf16 copies of its f32
    inputs (``copies_ms``: the same bits), and the f32 kernel and f32
    ``torch.mm`` on f32 copies (``f32_ms``, ``f32_library_ms``); the bf16
    bound (operands at their stored widths read once, the gradients
    written once) and the f32 one (3xTF32)."""
    from graphs4cfd_tpu_torch.ops import wgrad
    name = f"weight_grads_bf16[{case}]"
    pairs = []
    for rows, K, N, xb in products:
        x = torch.from_numpy(rng.normal(size=(rows, K)).astype(
            np.float32)).to(dev)
        d = torch.from_numpy(rng.normal(size=(rows, N)).astype(
            np.float32)).to(dev).to(BF16)
        pairs.append((x.to(BF16) if xb else x, d))
    run = lambda: wgrad.weight_grads(pairs)
    plain = lambda: wgrad.weight_grads_plain(pairs)
    got, ref = run(), plain()
    b16 = [(x.to(BF16), d) for x, d in pairs]
    lib = lambda: [torch.mm(x.t(), d) for x, d in b16]
    mm = lib()
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item() for a, b in zip(got, ref))
    gap = max(l2_gap(a, b) for a, b in zip(got, ref))
    gap_mm = max(l2_gap(a, b.float()) for a, b in zip(got, mm))
    same = all(torch.equal(a, b) for a, b in zip(run(), run()))
    flops = sum(2 * rows * K * N for rows, K, N, _ in products)
    nb = nbytes(*[t for p in pairs for t in p], *got)
    bms, by = bound_bf16_ms(flops, nb)
    res = {"name": name, "route": "cuda",
           "source": "graphs4cfd_tpu_torch/csrc/wgrad_bf16.cu",
           "replaces": replaces, "max_abs_err": err, "ms": cuda_ms(run),
           "plain_ms": cuda_ms(plain), "bound_ms": bms, "bound_by": by,
           "library_ms": cuda_ms(lib), "launches": 0,
           "parts_ms": bwd_parts(wgrad._launch, (pairs,),
                                 ("wgrad", "reduce"))}
    # the f32 layer inputs as bf16 copies, as a tile kernel writing them
    # would hand them over: the same rounding, so the same bits
    res["copies_ms"] = cuda_ms(lambda: wgrad.weight_grads(b16))
    same_copies = all(torch.equal(a, b) for a, b in
                      zip(got, wgrad.weight_grads(b16)))
    extra = sum(2 * x.numel() for x, _ in pairs if x.dtype != BF16)
    del b16
    f32 = [(x.float(), d.float()) for x, d in pairs]
    res["f32_ms"] = cuda_ms(lambda: wgrad.weight_grads(f32))
    res["f32_library_ms"] = cuda_ms(lambda: [torch.mm(x.t(), d)
                                             for x, d in f32])
    res["f32_bound_ms"] = bound_tc_ms(flops, nbytes(*[t for p in f32
                                                      for t in p], *got))
    del f32
    part = BF16_RECORDS.get(bwd_name, {}).get("parts_ms", {}).get("wgrad")
    say("bf16 kernels", f"{name}: {len(products)} products "
        f"{[(r, K, N, 'bf16' if xb else 'f32') for r, K, N, xb in products]}"
        f"; relative L2 {gap:.3e} from the plain version, {gap_mm:.3e} from "
        f"torch.mm (tol {BF16_BWD_L2}), max abs err {err:.3e}; two launches "
        f"the same bits: {same}; kernel {res['ms']:.4f} ms (parts "
        f"{parts_text(res['parts_ms'])}; in the backward "
        f"{part if part is None else round(part, 4)} ms), bound "
        f"{bms:.4f} ms ({by}), torch.mm {res['library_ms']:.4f} ms, plain "
        f"{res['plain_ms']:.4f} ms; with bf16 copies of its f32 inputs "
        f"{res['copies_ms']:.4f} ms, the same bits: {same_copies} (the "
        f"copies: {extra / 1e6:.1f} MB more for the tile kernels to write, "
        f"at least {extra / PEAK_BYTES * 1e3:.4f} ms); f32: kernel "
        f"{res['f32_ms']:.4f} ms, torch.mm {res['f32_library_ms']:.4f} ms, "
        f"bound {res['f32_bound_ms']:.4f} ms")
    if not (gap <= BF16_BWD_L2 and gap_mm <= BF16_BWD_L2):
        fail("bf16 kernels", f"{name}: relative L2 {gap}, {gap_mm} above "
             f"{BF16_BWD_L2}")
    if not same_copies:
        fail("bf16 kernels", f"{name}: f32 inputs rounded in the kernel "
             "differ from bf16 copies")
    if not same:
        fail("bf16 kernels", f"{name}: two launches differ")
    BF16_RECORDS[name] = res
    WGRAD_OF[name] = bwd_name
    return res


def bf16_tile_geometry():
    """The bf16 tiles at the bf16 main paths' shapes: the GN tile
    (``csrc/gn_tile_bf16.cuh``: receivers and edge rows a tile, warpgroups,
    shared memory, each kernel's registers a thread and resident blocks an
    SM), the chain forward's and backward's (``csrc/mlp_tile_bf16.cuh``, at
    the chain cases' widths and a 258-wide input) and the weight-gradient
    kernel's."""
    import ctypes
    from graphs4cfd_tpu_torch.ops import _build
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    lib = _build.load()
    out = []
    for name, k, fv, ne in (("MuS/gMuS k=6", 6, 128, 3),
                            ("gMuS mp121/mp221 fv=256", 6, 256, 3),
                            ("REMuS EdgeMP k=5", 5, 128, 2)):
        npb = gn_op.tile_receivers(k, BF16, fv, ne)
        smem = gn_op.bf16_tile_smem(npb, k, fv, ne)
        occ = []
        for bwd in (0, 1):
            regs, blocks = ctypes.c_int(), ctypes.c_int()
            _build.check(lib.g4c_gn_bf16_occupancy(
                bwd, smem, ctypes.byref(regs), ctypes.byref(blocks)))
            occ.append(f"{'backward' if bwd else 'forward'} {regs.value} "
                       f"registers a thread, {blocks.value} block(s) an SM")
        out.append(f"{name}: {npb} receivers, {-(-npb * k // 64) * 64} edge "
                   f"rows, 2 warpgroups (256 threads), {smem} bytes of "
                   f"shared memory; " + "; ".join(occ))
    say("bf16 kernels", "bf16 GN tile: " + " | ".join(out))
    from graphs4cfd_tpu_torch.ops import fused_mlp, wgrad
    chain = []
    for dims in ((2, 128, 128, 128), (4, 128, 128), (128, 128, 128),
                 (258, 128, 128, 128)):
        smem = fused_mlp.bf16_bwd_smem(dims[0], len(dims) - 1)
        regs, blocks = ctypes.c_int(), ctypes.c_int()
        _build.check(lib.g4c_mlp_chain_bwd_bf16_occupancy(
            smem, ctypes.byref(regs), ctypes.byref(blocks)))
        chain.append(
            f"{'->'.join(map(str, dims))}: "
            f"{fused_mlp.bf16_bwd_xs_tiles(dims[0], len(dims) - 1)} f32 xo "
            f"tile(s), {smem} bytes, {regs.value} registers a thread, "
            f"{blocks.value} block(s) an SM")
    fwd = []
    for dims in ((2, 128, 128, 128), (4, 128, 128), (128, 128, 128),
                 (258, 128, 128, 128)):
        g, streamed, regs, blocks = (ctypes.c_int(), ctypes.c_int(),
                                     ctypes.c_int(), ctypes.c_int())
        smem = ctypes.c_size_t()
        _build.check(lib.g4c_mlp_chain_fwd_bf16_geometry(
            len(dims) - 1, _build.int_array(dims), ctypes.byref(g),
            ctypes.byref(smem), ctypes.byref(streamed), ctypes.byref(regs),
            ctypes.byref(blocks)))
        got = (bool(streamed.value), g.value, smem.value)
        if got != fused_mlp.bf16_fwd_geometry(list(dims)):
            fail("bf16 kernels", f"the bf16 chain forward at {dims}: the "
                 f"library says {got}, ops.fused_mlp "
                 f"{fused_mlp.bf16_fwd_geometry(list(dims))}")
        fwd.append(f"{'->'.join(map(str, dims))}: weights "
                   f"{'streamed' if streamed.value else 'resident'}, "
                   f"{g.value} warpgroup(s) a block at most, {smem.value} "
                   f"bytes, {regs.value} registers a thread, {blocks.value} "
                   f"block(s) an SM")
    say("bf16 kernels", f"bf16 chain forward: {fused_mlp.BF16_FWD_ROWS}-row "
        f"m-tiles, one a warpgroup at a time, m64n128 products; " +
        "; ".join(fwd))
    say("bf16 kernels", f"bf16 chain backward tile: "
        f"{fused_mlp.BF16_BWD_ROWS} rows (two 64-row m-tiles), "
        f"{fused_mlp.BF16_BWD_THREADS // 128} warpgroups "
        f"({fused_mlp.BF16_BWD_THREADS} threads), " + "; ".join(chain))
    smem, regs, blocks = ctypes.c_size_t(), ctypes.c_int(), ctypes.c_int()
    _build.check(lib.g4c_wgrad_bf16_occupancy(
        ctypes.byref(smem), ctypes.byref(regs), ctypes.byref(blocks)))
    if smem.value != wgrad.bf16_smem():
        fail("bf16 kernels", f"the weight-gradient kernel takes {smem.value} "
             f"bytes of shared memory, ops.wgrad says {wgrad.bf16_smem()}")
    say("bf16 kernels", f"bf16 weight-gradient kernel: "
        f"{wgrad.BF16_STAGES} stages of {wgrad.BF16_STAGE_ROWS} rows, "
        f"{smem.value} bytes of shared memory, {regs.value} registers a "
        f"thread, {blocks.value} block(s) an SM")
    return out


def bf16_kernels_phase(dev, rng, rbatch, f32_results, smi):
    """Each bf16 kernel (rows 1-6, 9, 10 and the bf16 rows of the segment
    sum) against its bf16 plain version at the main paths' shapes: the
    chain cases; MuS level 1 (V=40448, k=6); REMuS's level-1 EdgeMP and
    ``down_mp12`` with that graph's angle sources and host sorts; gMuS
    ``mp121`` and ``mp221`` (fv = 256; random senders at the level
    sizes); the ``dvs`` sums of MuS level 1 and of REMuS's angle sources.
    Launches are taken from the bf16 phases."""
    t = lambda *shape: torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev).to(BF16)
    out = bf16_chain_cases(dev, rng, f32_results)
    H, V = 128, BENCH_SIZES["V"]
    # MuS level 1 (rows 5, 6)
    e, v, senders, edge, node, vs, sort = gn_case(dev, rng, V, 6, H)
    e, v, vs = e.to(BF16), v.to(BF16), vs.to(BF16)
    out += bf16_gn_case("gn_block_bf16", "gn_block_bwd_bf16",
                        ("graphs4cfd_tpu/ops/pallas_gnblock.py:517",
                         "graphs4cfd_tpu/ops/pallas_gnblock.py:556"),
                        e, vs, v, senders, sort, 6, edge, node, False,
                        t(V, H), t(V * 6, H), f32_results,
                        ("gn_block", "gn_block_bwd"))
    src = t(V * 6, H)
    out.append(bf16_segment(segment_record(
        "bf16 kernels", "sorted_segment_sum_bf16", "bf16 rows, MuS level-1 "
        "dvs", src, sort[0], sort[1], V, senders.long(),
        "graphs4cfd_tpu/ops/pallas_gnblock.py:719", smi), f32_results,
        "sorted_segment_sum"))
    del e, v, vs, src
    # REMuS: one level-1 EdgeMP (rows 9, 10) and down_mp12 (rows 3, 4)
    k = 5
    for name, key, skip, replaces, f32_names in (
            ("edge_mp", "angle_src", False,
             ("graphs4cfd_tpu/ops/pallas_edgemp.py:112",
              "graphs4cfd_tpu/ops/pallas_edgemp.py:151"),
             ("gn_block[edge_mp]", "gn_block_bwd[edge_mp]")),
            ("down_edge_mp", "xangle_src_2", True,
             ("graphs4cfd_tpu/ops/pallas_gnblock.py:132",
              "graphs4cfd_tpu/ops/pallas_gnblock.py:152"),
             ("gn_block[down_edge_mp]", "gn_block_bwd[down_edge_mp]"))):
        src_idx = rbatch.data[key]
        V, S = src_idx.shape[0], rbatch.angle_src.shape[0]
        senders = torch.from_numpy(src_idx.reshape(-1)).to(dev)
        sort = host_sort(src_idx, dev)
        angle = uniform_chain(rng, [3 * H, H, H], True, dev)
        edge = uniform_chain(rng, [2 * H, H, H], True, dev)
        vs = (t(S, H).float() @ angle[0][0][H:2 * H]).to(BF16)
        out += bf16_gn_case(f"gn_block_bf16[{name}]",
                            f"gn_block_bwd_bf16[{name}]", replaces,
                            t(V * k, H), vs, t(V, H), senders, sort, k,
                            angle, edge, skip, t(V, H), t(V * k, H),
                            f32_results, f32_names)
        if name == "edge_mp":
            out.append(bf16_segment(segment_record(
                "bf16 kernels", "sorted_segment_sum_bf16[edge_mp]",
                "bf16 rows, REMuS level-1 angle sources", t(V * k, H),
                sort[0], sort[1], S, senders.long(),
                "graphs4cfd_tpu/ops/pallas_gather.py:57", smi), f32_results,
                "sorted_segment_sum[edge_mp]"))
    # gMuS: the two layers with a 256-wide node input (rows 3-6)
    for name, V, replaces in (
            ("mp121", GMUS_SIZES["V"],
             ("graphs4cfd_tpu/ops/pallas_gnblock.py:517",
              "graphs4cfd_tpu/ops/pallas_gnblock.py:556")),
            ("mp221", GMUS_SIZES["V2"],
             ("graphs4cfd_tpu/ops/pallas_gnblock.py:132",
              "graphs4cfd_tpu/ops/pallas_gnblock.py:152"))):
        k, fv = 6, 256
        senders = torch.from_numpy(rng.integers(0, V, V * k).astype(
            np.int32)).to(dev)
        srt, perm = torch.sort(senders, stable=True)
        edge = uniform_chain(rng, [H + 2 * fv, H, H, H], True, dev)
        node = uniform_chain(rng, [H + fv, H, H, H], True, dev)
        v = t(V, fv)
        vs = (v.float() @ edge[0][0][H:H + fv]).to(BF16)
        out += bf16_gn_case(f"gn_block_bf16[{name}]",
                            f"gn_block_bwd_bf16[{name}]", replaces,
                            t(V * k, H), vs, v, senders,
                            (perm.int(), srt.int()), k, edge, node, False,
                            t(V, H), t(V * k, H), f32_results,
                            (f"gn_block[{name}]", f"gn_block_bwd[{name}]"))
    for case, bwd_name, replaces, products in wgrad_cases(rbatch):
        out.append(bf16_wgrad_record(dev, rng, case, bwd_name, replaces,
                                     products))
    bf16_tile_geometry()
    return out


@contextlib.contextmanager
def launches_inside(module, fn_name, tally):
    """Count the launches of every wrapper inside calls of
    ``module.fn_name`` into ``tally`` (name -> launches)."""
    real = getattr(module, fn_name)

    def counted(*args, **kw):
        before = read_counts()
        out = real(*args, **kw)
        after = read_counts()
        for key in after:
            tally[key] = tally.get(key, 0) + after[key] - before[key]
        return out

    setattr(module, fn_name, counted)
    try:
        yield tally
    finally:
        setattr(module, fn_name, real)


@contextlib.contextmanager
def plain_launches():
    """Every wrapper's launch done by its plain PyTorch version: the same
    dispatch and autograd Functions, so a model's gradients go through the
    plain backward versions (under the bf16 policy those round the
    products' operands, as the kernels and the JAX kernels do, where
    autograd through the plain forward ops would round the cotangents at
    every cast instead)."""
    from graphs4cfd_tpu_torch.ops import fused_mlp, gn_block as gn_op
    from graphs4cfd_tpu_torch.ops import segment
    saved = (fused_mlp._launch_fwd, fused_mlp._launch_bwd, gn_op._launch_fwd,
             gn_op._launch_bwd, segment._launch)

    def chain_fwd(x, ws, bs, ln_scale, ln_bias, preact):
        return fused_mlp.mlp_chain_plain(x, ws, bs, ln_scale, ln_bias,
                                         preact_input=preact)

    def chain_bwd(x, g, ws, bs, ln_scale, preact, need_dx, events=None):
        return fused_mlp.mlp_chain_bwd_plain(x, g, ws, bs, ln_scale,
                                             preact_input=preact,
                                             need_dx=need_dx)

    def gn_fwd(e, vs, v, senders, k, edge, node, out_selu, skip_e_out):
        return gn_op.gn_block_plain(e, vs, v, senders, k, edge, node,
                                    out_selu=out_selu, skip_e_out=skip_e_out)

    def gn_bwd(e, vs, v, senders, sort, k, edge, node, gv, ge, out_selu,
               events=None):
        return gn_op.gn_block_bwd_plain(e, vs, v, senders, sort, k, edge,
                                        node, gv, ge, out_selu=out_selu)

    def seg(src, perm, srt, n, long_rows=None, events=None):
        return segment.sorted_segment_sum_plain(src, perm, srt, n)

    (fused_mlp._launch_fwd, fused_mlp._launch_bwd, gn_op._launch_fwd,
     gn_op._launch_bwd, segment._launch) = (chain_fwd, chain_bwd, gn_fwd,
                                            gn_bwd, seg)
    try:
        yield
    finally:
        (fused_mlp._launch_fwd, fused_mlp._launch_bwd, gn_op._launch_fwd,
         gn_op._launch_bwd, segment._launch) = saved


@contextlib.contextmanager
def foreign_table_backwards(tally):
    """Count the launches of every wrapper inside the GN backwards whose
    table is not the receivers' own (S != V: REMuS's ``down_edge_mp``)
    into ``tally``."""
    from graphs4cfd_tpu_torch.ops import gn_block as gn_op
    real = gn_op._launch_bwd

    def counted(e, vs, v, *args, **kw):
        before = read_counts()
        out = real(e, vs, v, *args, **kw)
        if vs.shape[0] != v.shape[0]:
            after = read_counts()
            for key in after:
                tally[key] = tally.get(key, 0) + after[key] - before[key]
        return out

    gn_op._launch_bwd = counted
    try:
        yield tally
    finally:
        gn_op._launch_bwd = real


def bf16_step_against_plain(phase, model, g):
    """One bf16 rollout step, kernels against the bf16 plain versions, on
    the valid rows: within BF16_PATH_TOL of the plain output's max abs."""
    mask = g.node_mask
    with torch.inference_mode():
        step_k = model(g)
        with plain_launches():
            step_p = model(g)
    _, rel = errors(step_k[mask], step_p[mask])
    say(phase, f"one bf16 step, kernels vs bf16 plain versions: max rel "
        f"difference {rel:.3e} (tol {BF16_PATH_TOL}); output {step_k.dtype}")
    if step_k.dtype != torch.float32 or not rel <= BF16_PATH_TOL:
        fail(phase, f"kernels differ from plain by {rel} ({step_k.dtype})")


def bf16_grads_against_plain(phase, model, g, crit, nf):
    """One bf16 step's gradients, kernels against the bf16 plain versions:
    f32, within BF16_GRAD_L2 in relative L2 over all parameters."""
    params = list(model.parameters())

    def grads():
        pred = model(g)
        return torch.autograd.grad(crit(g, pred, g.target[:, :nf]), params)
    gk = grads()
    with plain_launches():
        gp = grads()
    flat = lambda gs: torch.cat([x.reshape(-1) for x in gs])
    gap = l2_gap(flat(gk), flat(gp))
    names = [n for n, _ in model.named_parameters()]
    worst = max(zip((l2_gap(a, b) for a, b in zip(gk, gp)), names))
    say(phase, f"one bf16 step's gradients, kernels vs bf16 plain "
        f"versions: relative L2 over all parameters {gap:.3e} (tol "
        f"{BF16_GRAD_L2}); the largest of one parameter {worst[0]:.3e} "
        f"({worst[1]})")
    if not all(x.dtype == torch.float32 for x in gk) or \
            not gap <= BF16_GRAD_L2:
        fail(phase, f"gradients differ from plain by {gap}")


def bf16_family_phase(phase, model, g, nf, want_path, want_train, smi,
                      count_path=None, count_train=None):
    """A family's bf16 ``solve(n_out=4)`` and ``train_step(n_out=1)``:
    the launch counts (bf16 kernels only), one step and its gradients
    against the bf16 plain versions, two training steps the same bits;
    ms per step and peak device memory of each.  ``count_path`` and
    ``count_train`` (a dict -> a context that tallies launches into it)
    count some launches of the counted runs apart."""
    from graphs4cfd_tpu_torch.nn import GraphLoss
    from graphs4cfd_tpu_torch.training import adam_init, make_train_step
    if model.compute_dtype != BF16:
        fail(phase, f"model in {model.compute_dtype}")
    n_out = 4
    model.solve(g, 1)                                  # warm-up
    torch.cuda.synchronize()
    inside = {}
    ctx = (count_path(inside) if count_path else contextlib.nullcontext())
    with ctx, chain_launch_shapes(f"{phase} path"), \
            gn_launch_shapes() as tally_p:
        reset_counts()
        out = model.solve(g, n_out)
        torch.cuda.synchronize()
        launches = read_counts()
    say(phase, f"{type(model).__name__} {model.num_params} params, bf16; "
        f"solve(n_out={n_out}) -> {tuple(out.shape)} {out.dtype}; "
        f"launches {launches}" + (f", counted apart {inside}"
                                  if count_path else ""))
    if out.dtype != torch.float32 or \
            not bool(torch.isfinite(out[g.node_mask]).all()):
        fail(phase, f"{out.dtype} output or non-finite values")
    want = want_counts(**{k: v * n_out for k, v in want_path.items()})
    if launches != want:
        fail(phase, f"launch counts {launches}, want {want}")
    bf16_step_against_plain(phase, model, g)
    rollout_ms = time_steps(phase, lambda: model.solve(g, n_out), n_out, g,
                            smi, "bf16 rollout")
    crit = GraphLoss(lambda_d=0.25)
    step = make_train_step(model, crit, nf, 1, 1.0)
    state = adam_init(list(model.parameters()))
    step(state, g, LR)                                 # warm-up
    torch.cuda.synchronize()
    inside_t = {}
    ctx = (count_train(inside_t) if count_train
           else contextlib.nullcontext())
    with ctx, chain_launch_shapes(f"{phase} training"), \
            gn_launch_shapes() as tally_t:
        reset_counts()
        loss, gnorm = step(state, g, LR)
        torch.cuda.synchronize()
        launches_t = read_counts()
    loss, gnorm = loss.item(), gnorm.item()
    say(phase, f"bf16 train_step(n_out=1): loss {loss:.6f}, gradient norm "
        f"{gnorm:.6f}; launches {launches_t}" + (
            f", counted apart {inside_t}" if count_train else ""))
    if not (np.isfinite(loss) and np.isfinite(gnorm)):
        fail(phase, "non-finite loss or gradient norm")
    want = want_counts(**want_train)
    if launches_t != want:
        fail(phase, f"launch counts {launches_t}, want {want}")
    if not all(p.dtype == torch.float32 for p in model.parameters()) or \
            not all(m.dtype == torch.float32 for m in state.mu + state.nu):
        fail(phase, "parameters or Adam moments not float32")
    bf16_grads_against_plain(phase, model, g, crit, nf)
    steps_deterministic(phase, model, step, state, g)
    train_ms = time_steps(phase, lambda: step(state, g, LR), 1, g, smi,
                          "bf16 training")
    return dict(path=launches, train=launches_t, inside=inside,
                inside_t=inside_t, tally_p=tally_p, tally_t=tally_t,
                rollout_ms=rollout_ms, train_ms=train_ms)


def set_bf16_launches(name, n):
    BF16_LAUNCHES[name] = n


def bf16_launches():
    """Each bf16 kernel record's launches in its bf16 phase (the chain
    cases' by shape); fails if a record's kernel was not launched
    there."""
    bf16_chain_launches({"main path": "bf16 mus path",
                         "training": "bf16 mus training",
                         "remus path": "bf16 remus path",
                         "remus training": "bf16 remus training"})
    for name, bwd_name in WGRAD_OF.items():
        set_bf16_launches(name, BF16_LAUNCHES.get(bwd_name, 0))
    for name, res in BF16_RECORDS.items():
        res["launches"] = BF16_LAUNCHES.get(name, 0)
        if res["launches"] < 1:
            fail("bf16 kernels", f"{name} was not launched in its bf16 "
                 f"phase ({BF16_LAUNCHES})")


def bf16_chain_launches(phase_of):
    """The bf16 chain records' launches by shape in the bf16 phases
    (``phase_of``: the f32 phase name -> the bf16 phase that stands for
    it)."""
    for case, rows, dims, ln, preact, _, phases in CHAIN_CASES:
        for kernel, phase in zip(("mlp_chain", "mlp_chain_bwd"), phases):
            n = CHAIN_SHAPES.get(phase_of[phase], {}).get(
                (kernel, rows, dims, ln, preact), 0)
            name = chain_name(kernel, case).replace(kernel, kernel + "_bf16")
            set_bf16_launches(name, n)
            say("bf16 kernels", f"{name}: {n} launches in the counted run "
                f"of phase {phase_of[phase]!r}")


def bf16_mus_phase(batch, dev, smi):
    """MuS at the flagship arch in bf16 (phase 5's batch, random weights
    from seed 0)."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.nn import NsThreeScaleGNN
    model = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev,
                            compute_dtype=BF16)
    g = Graph.from_numpy(batch, dev)
    r = bf16_family_phase(
        "bf16 mus", model, g, 3,
        {"mlp_chain_bf16": 23, "gn_block_bf16": 8},
        {"mlp_chain_bf16": 23, "gn_block_bf16": 8, "mlp_chain_bwd_bf16": 23,
         "gn_block_bwd_bf16": 8, "sorted_segment_sum_bf16": 8}, smi)
    set_bf16_launches("gn_block_bf16", r["path"]["gn_block_bf16"])
    set_bf16_launches("gn_block_bwd_bf16", r["train"]["gn_block_bwd_bf16"])
    set_bf16_launches("sorted_segment_sum_bf16",
                      r["train"]["sorted_segment_sum_bf16"])
    return r


def bf16_remus_phase(rbatch, dev, smi):
    """REMuS at its cell's arch in bf16 (random weights from seed 0)."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import attach_angle_sorts
    from graphs4cfd_tpu_torch.nn import NsRotEquiThreeScaleGNN, remus_gnn
    model = NsRotEquiThreeScaleGNN(arch=remus_arch(), seed=0, device=dev,
                                   compute_dtype=BF16)
    g = Graph.from_numpy(attach_angle_sorts(rbatch), dev)
    r = bf16_family_phase(
        "bf16 remus", model, g, 2,
        {"mlp_chain_bf16": 11, "gn_block_bf16": 18},
        {"mlp_chain_bf16": 11, "gn_block_bf16": 18,
         "mlp_chain_bwd_bf16": 11, "gn_block_bwd_bf16": 18,
         "sorted_segment_sum_bf16": 18}, smi,
        count_path=lambda d: launches_inside(remus_gnn, "down_edge_mp", d),
        count_train=foreign_table_backwards)
    down_p = r["inside"].get("gn_block_bf16", 0)
    down_t = r["inside_t"].get("gn_block_bwd_bf16", 0)
    if down_p != 2 * 4 or down_t != 2:
        fail("bf16 remus", f"down_edge_mp launches {down_p}, {down_t}: want "
             "8, 2")
    set_bf16_launches("gn_block_bf16[edge_mp]",
                      r["path"]["gn_block_bf16"] - down_p)
    set_bf16_launches("gn_block_bf16[down_edge_mp]", down_p)
    set_bf16_launches("gn_block_bwd_bf16[edge_mp]",
                      r["train"]["gn_block_bwd_bf16"] - down_t)
    set_bf16_launches("gn_block_bwd_bf16[down_edge_mp]", down_t)
    set_bf16_launches("sorted_segment_sum_bf16[edge_mp]",
                      r["train"]["sorted_segment_sum_bf16"]
                      - r["inside_t"].get("sorted_segment_sum_bf16", 0))
    return r


def bf16_gmus_phase(gbatch, dev, smi):
    """gMuS at its cell's arch in bf16 (random weights from seed 0)."""
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.nn import NsThreeGuillardScaleGNN
    model = NsThreeGuillardScaleGNN(arch=gmus_arch(), seed=0, device=dev,
                                    compute_dtype=BF16)
    g = Graph.from_numpy(gbatch, dev)
    r = bf16_family_phase(
        "bf16 gmus", model, g, 3,
        {"mlp_chain_bf16": 5, "gn_block_bf16": 16},
        {"mlp_chain_bf16": 5, "gn_block_bf16": 16, "mlp_chain_bwd_bf16": 5,
         "gn_block_bwd_bf16": 16, "sorted_segment_sum_bf16": 16}, smi)
    for layer, V in (("mp121", GMUS_SIZES["V"]), ("mp221", GMUS_SIZES["V2"])):
        set_bf16_launches(f"gn_block_bf16[{layer}]",
                          wide_launches(r["tally_p"], "gn_block").get(V, 0))
        set_bf16_launches(f"gn_block_bwd_bf16[{layer}]",
                          wide_launches(r["tally_t"], "gn_block_bwd").get(V,
                                                                          0))
    return r


def bf16_fit_phase(samples7, dev, smi):
    """``fit`` with ``TrainConfig(mixed_precision=True)``: one epoch of the
    flagship model over phase 5's 8 graphs (one batch of 8, two rollout
    steps): the model left in bf16, the epoch's bf16 launches those of two
    training steps and no f32 launch, a finite loss, and its checkpoint's
    weights and Adam state f32."""
    import tempfile
    from graphs4cfd_tpu_torch.loader import DataLoader
    from graphs4cfd_tpu_torch.nn import GraphLoss, NsThreeScaleGNN
    from graphs4cfd_tpu_torch.nn.model import tree_leaves
    from graphs4cfd_tpu_torch.training import TrainConfig, load_checkpoint
    folder = tempfile.mkdtemp(prefix="g4c_bf16_fit_")
    model = NsThreeScaleGNN(arch=flagship_arch(), seed=0, device=dev)
    cfg = TrainConfig("bf16", folder=folder, training_loss=GraphLoss(0.25),
                      lr=LR, epochs=1, num_steps=[2], mixed_precision=True,
                      grad_clip={"epoch": 0, "limit": 1.0})
    (rec,) = model.fit(cfg, DataLoader(samples7, batch_size=8))
    state = load_checkpoint(os.path.join(folder, "bf16.chk"))
    leaves = [np.asarray(x) for x in tree_leaves(state["weights"])]
    count, mu, nu = state["optimiser"]
    moments = [np.asarray(x) for x in tree_leaves(mu) + tree_leaves(nu)]
    say("bf16 fit", f"fit(mixed_precision=True), 1 epoch, n_out=2: loss "
        f"{rec['train_loss']:.6f}, {rec['seconds'] * 1e3 / 2:.3f} ms per "
        f"rollout step, launches {rec['launches']}; model "
        f"{model.compute_dtype}; checkpoint weights "
        f"{sorted({x.dtype.name for x in leaves})}, Adam state "
        f"{sorted({x.dtype.name for x in moments})} (count "
        f"{int(np.asarray(count))}) on {smi}")
    want = want_counts(mlp_chain_bf16=46, gn_block_bf16=16,
                       mlp_chain_bwd_bf16=46, gn_block_bwd_bf16=16,
                       sorted_segment_sum_bf16=16)
    if model.compute_dtype != BF16 or rec["launches"] != want:
        fail("bf16 fit", f"model in {model.compute_dtype}, launches "
             f"{rec['launches']}, want {want}")
    if not np.isfinite(rec["train_loss"]):
        fail("bf16 fit", "non-finite loss")
    if any(x.dtype != np.float32 for x in leaves + moments):
        fail("bf16 fit", "checkpoint weights or Adam state not float32")



SCRIPT_SIMS, SCRIPT_NODES, SCRIPT_T = 24, 5000, 100
SCRIPT_SCALING = {"u": (-2.1, 2.6), "v": (-2.25, 2.1), "p": (-3.7, 2.35),
                  "Re": (500, 1000)}


def script_store(seed=21):
    """A synthetic store in the ``NsCircle`` layout, ``[24, 5000, 304]``
    float32: pos in the benchmark's 4 x 2 box, Re in [500, 1000] a
    simulation, bound codes 0-4, then ``T = 100`` frames of (u, v, p)
    drawn in ``ScaleNs``'s ranges, all from one numpy generator."""
    rng = np.random.default_rng(seed)
    n, T = SCRIPT_NODES, SCRIPT_T
    data = np.empty((SCRIPT_SIMS, n, 4 + 3 * T), np.float32)
    for i in range(SCRIPT_SIMS):
        data[i, :, :2] = rng.random((n, 2)) * np.array([4.0, 2.0])
        data[i, :, 2] = rng.uniform(500, 1000)
        data[i, :, 3] = rng.integers(0, 5, n)
        frames = data[i, :, 4:].reshape(n, T, 3)
        for c, key in enumerate("uvp"):
            lo, hi = SCRIPT_SCALING[key]
            frames[:, :, c] = rng.uniform(lo, hi, (n, T))
    return data


def script_chain(T, seed):
    """``examples/training/NsMuSGNN/NsThreeScaleGNN.py:32-43``'s transform
    chain, its random transforms seeded."""
    from graphs4cfd_tpu_torch.utils import Compose
    return Compose([
        T.SpatialSort(), T.ConnectKNN(6, period=[None, "auto"]),
        T.ScaleNs(SCRIPT_SCALING, format="uvp"), T.ScaleEdgeAttr(0.1),
        T.RandomGraphRotation(eq="ns", format="uvp", seed=seed),
        T.RandomGraphFlip(eq="ns", format="uvp", seed=seed + 1),
        T.AddUniformNoise(0.01, seed=seed + 2),
        T.GridClustering([0.15, 0.30])])


@contextlib.contextmanager
def plain_host():
    """The host pipeline's k-NN and Guillard sweep on their numpy plain
    versions in place of the C++ helper."""
    from graphs4cfd_tpu_torch.ops import coarsen, knn
    saved = knn.knn_neighbors, coarsen.guillard_coarsening
    knn.knn_neighbors = knn.knn_neighbors_plain
    coarsen.guillard_coarsening = coarsen.guillard_coarsening_plain
    try:
        yield
    finally:
        knn.knn_neighbors, coarsen.guillard_coarsening = saved


def same_arrays(a, b):
    return set(a.data) == set(b.data) and all(
        (np.asarray(a.data[k]).tobytes() == np.asarray(b.data[k]).tobytes()
         and np.asarray(a.data[k]).dtype == np.asarray(b.data[k]).dtype)
        if isinstance(a.data[k], np.ndarray) else a.data[k] == b.data[k]
        for k in a.data)


def script_helper_checks(raw):
    """The script's chain on one batch of raw graphs with the C++ helper
    and with the numpy plain versions: host seconds of each and the same
    collated bits; the helper against the plain versions on a 70 x 70
    grid (equidistant neighbours, the grid search) and Guillard's sweep
    on a 5000-node cloud."""
    from graphs4cfd_tpu_torch import native
    from graphs4cfd_tpu_torch import transforms as T
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.ops import coarsen, knn

    def batch_of():
        chain = script_chain(T, seed=0)
        t = time.perf_counter()
        b = collate([chain(Graph(dict(g.data))) for g in raw])
        return b, time.perf_counter() - t

    batch_of()                                        # warm-up
    helper, helper_s = batch_of()
    with plain_host():
        plain, plain_s = batch_of()
    say("scripts", f"host seconds per batch of 8 ({SCRIPT_NODES}-node "
        f"clouds) through NsThreeScaleGNN.py's chain and collate: "
        f"{helper_s:.3f} s with the C++ helper ({native.build_info}), "
        f"{plain_s:.3f} s with knn_neighbors_plain; batches "
        f"{'bit-identical' if same_arrays(helper, plain) else 'DIFFERENT'}")
    if not same_arrays(helper, plain):
        fail("scripts", "the helper's batch differs from the plain one's")
    a = (np.arange(70) * 0.01).astype(np.float32)
    x, y = np.meshgrid(a, a, indexing="ij")
    grid = np.stack([x.ravel(), y.ravel()], 1)
    for period in (None, [None, "auto"]):
        got = knn.connect_knn(grid, 6, period=period)
        with plain_host():
            ref = knn.connect_knn(grid, 6, period=period)
        same = all(np.array_equal(u, v) for u, v in zip(got, ref))
        say("scripts", f"70 x 70 grid, period {period}: helper "
            f"{'bit-identical to' if same else 'DIFFERENT from'} "
            f"knn_neighbors_plain")
        if not same:
            fail("scripts", "k-NN helper differs from its plain version")
    s = helper.senders[:SCRIPT_NODES * 6]
    got = coarsen.guillard_coarsening(s, SCRIPT_NODES, 6)
    ref = coarsen.guillard_coarsening_plain(s, SCRIPT_NODES, 6)
    same = np.array_equal(got, ref)
    say("scripts", f"Guillard on a {SCRIPT_NODES}-node cloud: {got.sum()} "
        f"nodes kept, helper "
        f"{'bit-identical to' if same else 'DIFFERENT from'} its plain "
        f"version")
    if not same:
        fail("scripts", "Guillard helper differs from its plain version")
    return helper_s, plain_s


def scripts_phase(bare_ms, dev, smi):
    """``examples/training/NsMuSGNN/NsThreeScaleGNN.py`` on the port, at
    its full width in bf16, and ``examples/inference/mus_gnn/
    ns_mus_gnn.py``'s rollout of the checkpoint it writes."""
    import shutil
    import tempfile
    from graphs4cfd_tpu_torch import datasets
    from graphs4cfd_tpu_torch import transforms as T
    from graphs4cfd_tpu_torch.loader import DataLoader, collate
    from graphs4cfd_tpu_torch.nn import GraphLoss, NsThreeScaleGNN, TrainConfig
    from graphs4cfd_tpu_torch.utils import Compose, random_split
    t = time.perf_counter()
    store = script_store()
    say("scripts", f"synthetic NsCircle store {store.shape} "
        f"{store.dtype} ({store.nbytes / 1e6:.0f} MB) in "
        f"{time.perf_counter() - t:.1f} s; it goes to NsCircle as the "
        f"preloaded array (h5_data, the state Dataset.load leaves), so no "
        f"HDF5 file is read here (the HDF5 read is tested on the CPU)")

    def dataset(transform, **kw):
        ds = datasets.NsCircle(format="uvp", path="<preloaded>",
                               transform=transform, **kw)
        ds.h5_data, ds.preload = store, True
        return ds

    raw = dataset(None)
    helper_s, plain_s = script_helper_checks(
        [raw.get_sequence(i, 0, n_in=1, n_out=2) for i in range(8)])

    folder = tempfile.mkdtemp(prefix="g4c_scripts_")
    try:
        cfg = TrainConfig(
            name="NsThreeScaleGNN", folder=folder, tensor_board=folder,
            chk_interval=1, training_loss=GraphLoss(lambda_d=0.25),
            validation_loss=GraphLoss(), epochs=2, num_steps=[1, 2],
            add_steps={"tolerance": 0.005, "loss": "training"},
            batch_size=8, lr=1e-5, grad_clip={"epoch": 0, "limit": 1},
            scheduler={"factor": 0.5, "patience": 5, "loss": "training"},
            stopping=1e-8, mixed_precision=True)
        ds = dataset(script_chain(T, seed=0), training_info={
            "n_in": 1, "n_out": cfg["num_steps"][-1], "step": 1,
            "T": SCRIPT_T}, seed=0)
        train_set, test_set = random_split(ds, [16, 8])
        train_loader = DataLoader(train_set, batch_size=cfg["batch_size"],
                                  shuffle=True)
        val_loader = DataLoader(test_set, batch_size=cfg["batch_size"],
                                shuffle=False)
        model = NsThreeScaleGNN(arch=flagship_arch(), device=dev)
        if model.num_params != 2713347:
            fail("scripts", f"{model.num_params} parameters, want 2713347")
        torch.cuda.synchronize()
        reset_counts()
        history = model.fit(cfg, train_loader, val_loader=val_loader)
        torch.cuda.synchronize()
        launches = read_counts()
        first = history[0]
        per_step = {k: v // first["steps"]
                    for k, v in first["launches"].items()}
        want = want_counts(mlp_chain_bf16=23, gn_block_bf16=8,
                           mlp_chain_bwd_bf16=23, gn_block_bwd_bf16=8,
                           sorted_segment_sum_bf16=8)
        ms = [1e3 * r["seconds"] / r["steps"] for r in history]
        say("scripts", f"fit: NsThreeScaleGNN {model.num_params} params, "
            f"{model.compute_dtype}; epochs {[r['epoch'] for r in history]}"
            f", n_out {[r['n_out'] for r in history]}, training losses "
            f"{[r['train_loss'] for r in history]}, validation losses "
            f"{[r['val_loss'] for r in history]}; launches in all "
            f"{launches}")
        say("scripts", f"fit: {', '.join(f'{x:.3f}' for x in ms)} ms per "
            f"training step (epochs 1, 2: epoch wall time / "
            f"{first['steps']} steps, the host's graph building in the "
            f"loop included) against {bare_ms:.3f} ms for the bare bf16 "
            f"step (phase 'bf16 mus'); host chain {helper_s:.3f} s a batch "
            f"with the helper, {plain_s:.3f} s with the plain k-NN; on "
            f"{smi}")
        say("scripts", f"fit: bf16 launches per training step "
            f"{per_step}")
        if model.compute_dtype != BF16 or per_step != want or \
                any(v % first["steps"] for v in first["launches"].values()):
            fail("scripts", f"launches per step {per_step}, want {want}")
        if any(launches[k] < 1 for k in want if want[k]):
            fail("scripts", f"a kernel of the path was not launched: "
                 f"{launches}")
        if not all(np.isfinite(r["train_loss"]) and
                   np.isfinite(r["val_loss"]) for r in history):
            fail("scripts", "non-finite loss")

        # examples/inference/mus_gnn/ns_mus_gnn.py:23-36
        path = os.path.join(folder, "NsThreeScaleGNN.chk")
        model = NsThreeScaleGNN(checkpoint=path, device=dev)
        n_out = 10
        transform = Compose([
            T.ConnectKNN(6, period=[None, "auto"]),
            T.ScaleNs(SCRIPT_SCALING, format="uvp"), T.ScaleEdgeAttr(0.1),
            T.GridClustering([0.15, 0.30])])
        graph = dataset(transform).get_sequence(0, sequence_start=0, n_in=1,
                                                n_out=n_out)
        batch = collate([graph]).to_device()
        torch.cuda.synchronize()
        reset_counts()
        pred = model.solve(batch, n_out=n_out)
        torch.cuda.synchronize()
        launches = read_counts()
        mask = batch.node_mask
        finite = bool(torch.isfinite(pred[mask]).all())
        rmse = float(((pred[mask] - batch.target[mask]) ** 2).mean().sqrt())
        say("scripts", f"inference: NsThreeScaleGNN(checkpoint=...) "
            f"solve(n_out={n_out}) -> {tuple(pred.shape)} {pred.dtype}, "
            f"finite on valid rows: {finite}, rollout RMSE {rmse:.4e} "
            f"(random data); launches {launches}")
        want = want_counts(mlp_chain=23 * n_out, gn_block=8 * n_out)
        if tuple(pred.shape) != (batch.num_nodes, 3 * n_out) or not finite:
            fail("scripts", "inference output")
        if launches != want:
            fail("scripts", f"inference launches {launches}, want {want}")
    finally:
        shutil.rmtree(folder, ignore_errors=True)


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
    rsamples = make_remus_samples()
    rbatch = collate(rsamples, node_bucket=512, edge_bucket=1024)
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
    chain_results = check_mlp_chain(dev, rng) + check_mlp_chain_bwd(dev, rng)
    results = [check_gn_block(dev, rng), check_gn_block_bwd(dev, rng),
               check_sorted_segment_sum(dev, rng, smi)]
    remus_results = check_remus_gn_block(dev, rng)
    remus_bwd_results = (check_remus_gn_block_bwd(dev, rng, rbatch, smi)
                         + check_remus_segment_sum(dev, rng, rbatch, smi))

    # 5. host graphs
    t = time.perf_counter()
    samples7 = make_samples(8, 5000, seed=7)
    batch = collate(samples7, node_bucket=512, edge_bucket=1024)
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
    with chain_launch_shapes("main path"):
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
    main_out = out.cpu().numpy()

    # 7. training
    train_launches, train_ms = training_phase(model, g, smi)
    for r in results:
        r["launches"] = (launches if r["name"] == "gn_block"
                         else train_launches)[r["name"]]
    del model, g

    # 8. bf16 mus
    bf16_mus = bf16_mus_phase(batch, dev, smi)

    # 9. pretrained, 10. fit, 11. bf16 fit
    pretrained_phase(dev, smi)
    fit_phase(samples7, train_launches, train_ms, dev, smi)
    bf16_fit_phase(samples7, dev, smi)

    # 12. scripts
    scripts_phase(bf16_mus["train_ms"], dev, smi)

    # 13. REMuS path
    remus_launches, in_down = remus_phase(rbatch, dev, smi)
    for r in remus_results:
        r["launches"] = (in_down if r["name"] == "gn_block[down_edge_mp]"
                         else remus_launches["gn_block"] - in_down)

    # 14. REMuS training
    rt_launches, rt_down = remus_training_phase(rbatch, dev, smi)
    for r in remus_bwd_results:
        kernel, layer = r["name"][:-1].split("[")
        r["launches"] = (rt_down[kernel] if layer == "down_edge_mp"
                         else rt_launches[kernel] - rt_down[kernel])

    # 15. bf16 remus
    bf16_remus_phase(rbatch, dev, smi)
    chain_launches(chain_results)

    # 16.-19. gMuS
    gsamples = make_gmus_samples()
    gbatch = gmus_graphs(gsamples)
    gmus_results = check_gmus_gn_kernels(dev, rng, gbatch, smi)
    _, path_wide = gmus_phase(gbatch, dev, smi)
    _, train_wide = gmus_training_phase(gbatch, dev, smi)
    for r in gmus_results:
        kernel, layer = r["name"][:-1].split("[")
        V = GMUS_SIZES["V" if layer == "mp121" else "V2"]
        r["launches"] = (path_wide if kernel == "gn_block"
                         else train_wide["gn_block_bwd"])[V]

    # 20. bf16 gmus
    bf16_gmus_phase(gbatch, dev, smi)

    # 21.-25. graph parallel (MuS)
    sharded, info = gp_graphs(batch)
    gp_results = (check_gp_kernels(dev, rng, sharded, smi)
                  + check_gp_gn_kernels(dev, rng, sharded, smi))
    ref = gp_reference(batch, dev)
    edges = int(batch.edge_mask.sum())
    path = gp_path_phase(batch, sharded, info, main_out, edges, smi)
    train = gp_training_phase(sharded, ref, edges, smi)
    gp_nccl_phase(batch, ref["forward"], smi)

    # 26.-29. data parallel (every family), DP x GP (MuS f32, gMuS bf16),
    # the DP script
    mus_shards, gmus_shards, gmus_ref = dp_phases(
        samples7, batch, ref, rsamples, rbatch, gsamples, gbatch, dev, smi)
    del samples7, gsamples
    dp_gp_phase(mus_shards, ref, gmus_shards, gmus_ref, smi)
    del mus_shards, gmus_shards
    dp_script_phase(bf16_mus["train_ms"], smi)

    # 30. bf16 kernels, beside the f32 kernels' times of phases 4 and 17
    f32_results = (chain_results + results + remus_results
                   + remus_bwd_results + gmus_results)
    bf16_results = bf16_kernels_phase(dev, rng, rbatch, f32_results, smi)
    bf16_launches()

    # 31. gp families (REMuS, gMuS), 32. bf16 gp (every family)
    family_results, _ = gp_families_phase(rbatch, gbatch, dev, rng, smi)
    bf16_path, bf16_train, _ = bf16_gp_phase(batch, rbatch, gbatch, dev, smi)
    gp_launches(gp_results, path, train, bf16_path, bf16_train)
    del rbatch, gbatch

    print(json.dumps({"kernels": f32_results + gp_results + bf16_results
                      + family_results}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
