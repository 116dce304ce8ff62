"""Where the tensor-core kernels' time goes: build patched copies of the
port's GN-block and MLP-chain kernels and time them against the kernels as
built.

    python3 tools/gn_variants.py [--rounds 2] [--only NAME ...]
    python3 tools/gn_variants.py --bf16-chain-fwd [--src DIR] [--only NAME ...]
    python3 tools/gn_variants.py --remus-grads [SEED ...] [--only NAME ...]

Each variant is a copy of ``graphs4cfd_tpu_torch/csrc`` with one text patch
(a part of the work taken out, or a design choice undone), built with
``nvcc`` into ``build/gn_variants/<name>/`` (all builds started together)
and called through the port's own wrappers: the GN kernels at the MuS
level-1 shapes (V=40448, k=6, H=128, 3-layer chains with LayerNorm,
``out_selu``; the inputs of ``chip_smoke.gn_case``), the forward with e'
stored and skipped and the backward's parts, in f32 and, on the same
inputs rounded to bf16, under the bf16 policy; the chain kernels at each of
``chip_smoke.CHAIN_CASES``, the forward and the backward's parts (CUDA
events between them), and the backward's parts under the bf16 policy.  The variants compute wrong results on purpose: only
their times mean anything.  A patch whose text no longer matches the
sources stops the script.  With ``--remus-grads`` it times nothing: it
runs ``tools/remus_grad_gate.py``'s study (the REMuS training-gradient
gate of ``chip_smoke.py`` over model seeds 0-7, or the seeds given) on
the kernels as built and on each variant's.  Needs a CUDA card.
"""
import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from chip_smoke import (CHAIN_CASES, chain_bwd_parts, chain_case,  # noqa
                        cuda_ms, gn_bwd_parts, gn_case)
from graphs4cfd_tpu_torch.ops import _build  # noqa: E402
from graphs4cfd_tpu_torch.ops import fused_mlp  # noqa: E402
from graphs4cfd_tpu_torch.ops import gn_block as gn_op  # noqa: E402

SRC = ROOT / "graphs4cfd_tpu_torch" / "csrc"
OUT = ROOT / "build" / "gn_variants"
NODE_MM = """                                   float* ring) {
  tc::mm<L::WM, L::MT, L::WN, L::NT, C>(acc, A, lda, mtiles, W, K, N, ring);"""
MMA3 = """        mma(t, al, bh[j][0], bh[j][1]);
        mma(t, ah, bl[j][0], bl[j][1]);
        mma(t, ah, bh[j][0], bh[j][1]);"""
MMA_BF16 = "        mma_bf16(d, a, b[j][0], b[j][1]);\n"
WGMMA = """    if constexpr (NJ == 16)
      wgmma_n128<TB>(d, da, db, scale);
    else
      wgmma_n64<TB>(d, da, db, scale);"""
VS_LOAD = ("      cp16(buf + toff(64, r, c), ok ? a.vs + (size_t)s * H1 + c "
           ": a.vs,\n           ok ? 16 : 0);")
#: SELU with expm1 of min(a, 0) on a Taylor polynomial of degree 7 after a
#: Cody-Waite reduction by ln 2 (within one ulp of float64's expm1 over
#: [-30, 0] in an f32 emulation; about 20 instructions, under half of
#: expm1f's): a design timed, not taken (the kernels compute SELU as the
#: plain version does, on expm1f)
SHORT_SELU = """__device__ __forceinline__ float selu_short(float a) {
  const float x = fmaxf(fminf(a, 0.f), -30.f);
  const float j = rintf(x * 1.44269504f);
  float f = fmaf(j, -0.693145751953125f, x);
  f = fmaf(j, -1.42860677e-6f, f);
  float q = fmaf(1.98412698e-4f, f, 1.38888889e-3f);
  q = fmaf(q, f, 8.33333333e-3f);
  q = fmaf(q, f, 4.16666667e-2f);
  q = fmaf(q, f, 1.66666667e-1f);
  q = fmaf(q, f, 0.5f);
  const float m = fmaf(q * f, f, f);
  const float t = __int_as_float(((int)j + 127) << 23);
  const float e = fmaf(t, m, t - 1.f);
  return SELU_SCALE * (a > 0.f ? a : SELU_ALPHA * e);
}

"""
#: name -> [(file, text, replacement)]
VARIANTS = {
    "as built": [],
    "no sender gather (vs rows read as zeros)": [
        ("gn_tile.cuh", "tc::cp16(dst, src, ok ? 16 : 0, keep);",
         "tc::cp16(dst, src, 0, keep);")],
    "no node-side products": [
        ("gn_tile.cuh", NODE_MM, NODE_MM.replace(
            "  tc::mm<", "  if (L::MT == 1) {\n    __syncthreads();\n"
            "    return;\n  }\n  tc::mm<"))],
    "no edge-side products": [
        ("gn_tile.cuh", NODE_MM, NODE_MM.replace(
            "  tc::mm<", "  if (L::MT == 3) {\n    __syncthreads();\n"
            "    return;\n  }\n  tc::mm<"))],
    "no tensor-core products": [("mma_tf32x3.cuh", MMA3, "")],
    "bf16 wgmma tile: no tensor-core products": [
        ("gn_tile_bf16.cuh", WGMMA, "    (void)da, (void)db, (void)scale;")],
    "bf16 wgmma tile: no node-side products": [
        ("gn_tile_bf16.cuh", WGMMA, WGMMA.split("\n    else")[0])],
    "bf16 wgmma tile: no sender gather (vs rows read as zeros)": [
        ("gn_tile_bf16.cuh", VS_LOAD, "      (void)ok;")],
    "bf16 wgmma tile: no weight staging (slices left as they are)": [
        ("gn_tile_bf16.cuh", "  slice_store(m.w, x);\n  if (tiles)",
         "  if (tiles)")],
    "bf16 wgmma tile: no row-order sums over k (aggr, dvr)": [
        ("gn_tile_bf16.cuh",
         "      if (last) rounds_add(acc, has, mt, ev, k, m.ag);\n", ""),
        ("gn_block_bf16.cu",
         "      if (first) rounds_add(acc, has, mt, ev, k, m.nf);\n", "")],
    "bf16 wgmma tile: SELU as exp - 1 (fast, less exact)": [
        ("gn_tile_bf16.cuh", "  const float em1 = expm1f(a);",
         "  const float em1 = a > -1e-4f ? a * (1.f + 0.5f * a) "
         ": __expf(a) - 1.f;")],
    "bf16 wgmma tile: no e' stores": [
        ("gn_tile_bf16.cuh",
         "          if (!BWD && a.e_out != nullptr)\n            store_tile",
         "          if (false)\n            store_tile"),
        ("gn_tile_bf16.cuh",
         "  if (!BWD && a.e_out != nullptr)\n    for (int mt = wg;",
         "  if (false)\n    for (int mt = wg;")],
    "bf16 chain fwd: no weight rounding (images left as they are)": [
        ("mlp_chain_fwd_bf16.cu", "        wimage<8>(p, a.w[l], a.dims[l], "
         "a.dims[l + 1], 0, ks, c0,\n                  threadIdx.x, "
         "blockDim.x);\n", "")],
    "bf16 chain fwd: no x loads": [
        ("mlp_chain_fwd_bf16.cu", "    load_x(ein, a.x, row0, valid, K0, "
         "a.preact != 0);\n", "    (void)K0;\n")],
    "bf16 chain fwd: SELU on a shorter expm1 (Taylor, degree 7)": [
        ("mlp_chain_fwd_bf16.cu", "// GENERAL: the chain's weights are "
         "streamed", SHORT_SELU + "// GENERAL: the chain's weights are "
         "streamed"),
        ("mlp_chain_fwd_bf16.cu", "          gn16::apply_selu(acc);\n",
         "#pragma unroll\n          for (int i = 0; i < 64; ++i) acc[i] = "
         "selu_short(acc[i]);\n")],
    "bf16 chain fwd: no SELU": [
        ("mlp_chain_fwd_bf16.cu", "          gn16::apply_selu(acc);\n", "")],
    "bf16 chain fwd: no LayerNorm": [
        ("mlp_chain_fwd_bf16.cu", "          if (Nl == 128)\n            "
         "layer_norm_q<true>(acc, Nl, a.ln_scale, a.ln_bias);\n          else"
         "\n            layer_norm_q<false>(acc, Nl, a.ln_scale, a.ln_bias);\n",
         "")],
    "bf16 chain fwd: no output stores": [
        ("mlp_chain_fwd_bf16.cu", "    rows_out(ein, a.out + row0 * N, valid, "
         "N);\n", "    (void)N;\n")],
    "bf16 chain fwd: three warpgroups a block (170 registers)": [
        ("mlp_tile_bf16.cuh", "constexpr int FWD_WG_MAX = 4;",
         "constexpr int FWD_WG_MAX = 3;")],
    "bf16 chain fwd: one warpgroup a block": [
        ("mlp_chain_fwd_bf16.cu", "  int g = fwd_fit(a.n, a.dims, streamed);",
         "  int g = 1;")],
    "bf16 chain bwd: no weight fetch (slices left as they are)": [
        ("mlp_chain_bwd_bf16.cu", "      gn16::cp16(m.w + off, src + off, "
         "16);", "      (void)src, (void)off;")],
    "bf16 chain bwd: no SELU' (derivative 1)": [
        ("mlp_chain_bwd_bf16.cu", "    if (l <= xst)\n      gn16::mul_dselu<8>"
         "(acc,\n", "    if (false)\n      gn16::mul_dselu<8>(acc,\n"),
        ("mlp_chain_bwd_bf16.cu", "    else\n      gn16::mul_dselu<8>(acc, "
         "a.xo[l]", "    else if (false)\n      gn16::mul_dselu<8>(acc, "
         "a.xo[l]")],
    "bf16 chain bwd: no xo and d_op stores to device memory": [
        ("mlp_chain_bwd_bf16.cu", "      *reinterpret_cast<float4*>(out + "
         "(int64_t)r * N + c) =\n          *reinterpret_cast<const float4*>("
         "own + r * XS_LD + c);", "      (void)r, (void)c;"),
        ("mlp_chain_bwd_bf16.cu", "      *reinterpret_cast<uint4*>(out + "
         "(int64_t)r * N + c) =\n          *reinterpret_cast<const uint4*>("
         "m.e +\n                                          gn16::toff(ROWS, "
         "64 * mt + r, c));", "      (void)r, (void)c;")],
    "bf16 chain bwd: no column sums": [
        ("mlp_chain_bwd_bf16.cu", "    tile_colsum(acc, Nl, m.cs, cs + "
         "a.cs_b[l]);  // db\n", "")],
    "bf16 chain bwd: no SELU in the forward": [
        ("mlp_chain_bwd_bf16.cu", "    gn16::apply_selu(acc);\n    if (l + 1 "
         "<= xst)", "    if (l + 1 <= xst)")],
    "bf16 chain bwd: no g load": [
        ("mlp_chain_bwd_bf16.cu", "  gn16::load_tile(m.e, ROWS, a.g, row0, "
         "valid, ROWS, N, true);\n", "")],
    "bf16 chain bwd: no LayerNorm backward": [
        ("mlp_chain_bwd_bf16.cu", "  if (a.ln_scale != nullptr) {\n    // acc:"
         " the pre-LN rows", "  if (false) {\n    // acc: the pre-LN rows")],
    "one TF32 product (hi*hi)": [
        ("mma_tf32x3.cuh", MMA3, "        mma(t, ah, bh[j][0], bh[j][1]);")],
    "no e' stores": [
        ("gn_tile.cuh", "store_row(a.e_out + (e0 + q) * He, y, He, true);",
         "if (y[0] == 1234.5f) a.e_out[0] = y[1] + y[2] + y[3];")],
    "no L2 policies (weights, table, tiles)": [
        ("mma_tf32x3.cuh", '"createpolicy.fractional.L2::evict_last.b64 %0, '
         '1.0;\\n"', '"createpolicy.fractional.L2::evict_normal.b64 %0, '
         '1.0;\\n"'),
        ("mma_tf32x3.cuh", '"createpolicy.fractional.L2::evict_first.b64 %0, '
         '1.0;\\n"', '"createpolicy.fractional.L2::evict_normal.b64 %0, '
         '1.0;\\n"')],
    "registers unbounded (one block per SM)": [
        ("gn_block.cu", "__launch_bounds__(THREADS, 2) gn_block_kernel",
         "__launch_bounds__(THREADS, 1) gn_block_kernel"),
        ("gn_block_bwd.cu", "__launch_bounds__(THREADS, 2)\n    "
         "gn_block_bwd_kernel", "__launch_bounds__(THREADS, 1)\n    "
         "gn_block_bwd_kernel")],
    "chain: 96-row tiles at every size": [
        ("mlp_tile.cuh", "constexpr int64_t SMALL_BELOW = 32768;",
         "constexpr int64_t SMALL_BELOW = 0;")],
    "chain: 64-row tiles at every size": [
        ("mlp_tile.cuh", "constexpr int64_t SMALL_BELOW = 32768;",
         "constexpr int64_t SMALL_BELOW = (int64_t)1 << 62;")],
    "chain: backward on 64-row tiles at every size": [
        ("mlp_chain_bwd.cu", '#include "wgrad.cuh"\n',
         '#include "wgrad.cuh"\n#define ROWS SMALL_ROWS\n'),
        ("mlp_chain_bwd.cu", "  using L = EdgeL;\n", "  using L = SmallL;\n")],
    "chain: no LayerNorm, stores, SELU' reads or slice waits": [
        ("mlp_tile.cuh", "    ln_rows_out(cur, ld, valid, a.dims[a.n], "
         "a.ln_scale, a.ln_bias, a.out,\n                row0);",
         "    __syncthreads();"),
        ("mlp_chain_bwd.cu", "  if (a.ln_scale != nullptr) {\n    float c1",
         "  if (false) {\n    float c1"),
        ("mlp_tile.cuh", "store_out<L>(acc, a.out + c0, row0, valid, cw, N);",
         "if (acc[0][0][0] == 1234.5f) a.out[0] = acc[0][0][1];"),
        ("mlp_tile.cuh", "store_row(out + (row0 + r) * N + COLS * h, y, "
         "N - COLS * h, true);", "if (y[0] == 1234.5f) out[0] = y[1];"),
        ("mlp_tile.cuh", "copy_rows(dst, ld, valid, N, a.xo[l + 1], row0, "
         "nullptr, nullptr,", "copy_rows(dst, ld, valid, N, (float*)nullptr, "
         "row0, nullptr, nullptr,"),
        ("mlp_chain_bwd.cu", "copy_rows(T, ld, valid, Nl, a.d_op[l], row0, "
         "ring,", "copy_rows(T, ld, valid, Nl, (float*)nullptr, row0, ring,"),
        ("mlp_chain_bwd.cu", "      mul_dselu<L>(acc, a.xo[l] + row0 * K, "
         "valid, K);\n", ""),
        ("mma_tf32x3.cuh", "    cp_wait<0>();\n    __syncthreads();  // slice s "
         "landed; every warp is done with slice s - 1\n    if (s + 1 < ns) {\n"
         "      const int k1", "    __syncthreads();\n    if (s + 1 < ns) {\n"
         "      const int k1")],
}
#: the commit whose sources hold the bf16 chain forward before its redesign
OLD_COMMIT = "576896c"
#: that kernel's variants, for ``--src`` pointing at the ``csrc`` of a
#: ``git archive`` of ``OLD_COMMIT`` (the parts of the kernel they take
#: out are gone from this tree): name -> [(file, text, replacement)]
OLD_BF16_FWD = {
    "old bf16 fwd: no weight staging (ring left as it is)": [
        ("mma_tf32x3.cuh", "  load_w(ring, ldw, W, K, N, 0, min(BK, K8), ldg);\n",
         ""),
        ("mma_tf32x3.cuh", "      load_w(ring + ((s + 1) & 1) * STAGE, ldw, W, "
         "K, N, k1,\n             min(BK, K8 - k1), ldg);",
         "      (void)k1;")],
    "old bf16 fwd: no fragment-load rounding (bits cut)": [
        ("mma_bf16.cuh", "  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, "
         "hi);\n  return *reinterpret_cast<const uint32_t*>(&p);",
         "  return (__float_as_uint(lo) >> 16) | (__float_as_uint(hi) & "
         "0xffff0000u);")],
    "old bf16 fwd: no tensor-core products": [
        ("mma_bf16.cuh", MMA_BF16, "")],
    "old bf16 fwd: no SELU": [
        ("mlp_tile.cuh", "        apply_selu<L>(acc);\n", "")],
    "old bf16 fwd: no LayerNorm row pass": [
        ("mlp_tile.cuh", "    ln_rows_out(cur, ld, valid, a.dims[a.n], "
         "a.ln_scale, a.ln_bias, a.out,\n                row0);",
         "    __syncthreads();")],
    "old bf16 fwd: no output stores": [
        ("mlp_tile.cuh", "store_out<L>(acc, a.out + c0, row0, valid, cw, N);",
         "if (acc[0][0][0] == 1234.5f) a.out[0] = acc[0][0][1];"),
        ("mlp_tile.cuh", "store_row(out + (row0 + r) * N + COLS * h, y, "
         "N - COLS * h, true);", "if (y[0] == 1234.5f) out[0] = y[1];")],
    "old bf16 fwd: no x loads (rows read as zeros)": [
        ("mma_bf16.cuh", "      if (r < valid)\n        unpack8(", "      if (false)"
         "\n        unpack8("),
        ("mma_bf16.cuh", "      dst[r * ld + c] = r < valid && c < F\n",
         "      dst[r * ld + c] = false\n")],
}
SOURCES = ("gn_block.cu", "gn_block_bwd.cu", "gn_block_bf16.cu", "wgrad.cu",
           "wgrad_bf16.cu", "sorted_segment_sum.cu", "mlp_chain.cu",
           "mlp_chain_bwd.cu", "mlp_chain_bwd_bf16.cu",
           "mlp_chain_fwd_bf16.cu", "gather_rows.cu")
ENTRY_POINTS = ("g4c_error_string", "g4c_gn_block_smem", "g4c_gn_block",
                "g4c_gn_block_bwd_smem", "g4c_gn_block_bwd_work",
                "g4c_gn_block_bwd", "g4c_sorted_segment_sum_work",
                "g4c_sorted_segment_sum",
                "g4c_mlp_chain_smem", "g4c_mlp_chain",
                "g4c_mlp_chain_bwd_smem", "g4c_mlp_chain_bwd_work",
                "g4c_mlp_chain_bwd")


def build(names, src=SRC):
    """Patch and build each variant (of the sources in ``src``); their
    libraries by name."""
    nvcc = _build.find_nvcc()
    every = {**VARIANTS, **OLD_BF16_FWD}
    procs = {}
    for name in names:
        d = OUT / f"v{list(every).index(name)}"
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        for f, old, new in every[name]:
            text = (d / f).read_text()
            if old not in text:
                raise SystemExit(f"variant {name!r}: {f} no longer holds "
                                 f"the text it patches:\n{old}")
            (d / f).write_text(text.replace(old, new))
        cmd = [nvcc, *_build.NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"),
               *map(str, sorted(d.glob("*.cu")))]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True))
    real = _build.load()
    libs = {}
    for name, (d, proc) in procs.items():
        out, _ = proc.communicate()
        (d / "build.log").write_text(out)
        if proc.returncode:
            raise SystemExit(f"variant {name!r} did not build:\n{out[-4000:]}")
        lib = ctypes.CDLL(str(d / "lib.so"))
        for fn in ENTRY_POINTS:
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
        libs[name] = lib
    return libs


def time_bf16_fwd(chains):
    """ms of the bf16 chain forward at each chain case."""
    res = {}
    for name, (x, g, ws, bs, lns, preact, need_dx) in chains.items():
        lnp, xb = lns or (None, None), x.to(torch.bfloat16)
        res[f"bf16 {name} fwd"] = cuda_ms(lambda: fused_mlp.mlp_chain(
            xb, ws, bs, *lnp, preact_input=preact))
    return res


def time_variant(lib, case, chains, bf16_fwd=False):
    """ms of the GN forward (e' stored, skipped) and of its backward's
    parts, and of each chain case's forward and backward parts, with
    ``lib`` in the place of the port's kernel library (``bf16_fwd``: only
    the bf16 chain forwards)."""
    e, v, senders, edge, node, vs, sort, gv, ge = case
    loaded, load = _build._lib, _build.load
    _build._lib, _build.load = lib, (lambda: lib)
    try:
        if bf16_fwd:
            return time_bf16_fwd(chains)
        res = {f"fwd skip_e={skip}": cuda_ms(
            lambda: gn_op.gn_block(e, vs, v, senders, 6, edge, node,
                                   out_selu=True, skip_e_out=skip))
            for skip in (False, True)}
        parts = gn_bwd_parts((e, vs, v, senders, sort, 6, edge, node, gv, ge,
                              True), iters=5)
        res.update({f"bwd {k}": t for k, t in parts.items()})
        # the same case under the bf16 policy
        bf = [t.to(torch.bfloat16) for t in (e, vs, v, gv, ge)]
        res.update({f"bf16 fwd skip_e={skip}": cuda_ms(
            lambda: gn_op.gn_block(bf[0], bf[1], bf[2], senders, 6, edge,
                                   node, out_selu=True, skip_e_out=skip))
            for skip in (False, True)})
        parts = gn_bwd_parts((bf[0], bf[1], bf[2], senders, sort, 6, edge,
                              node, bf[3], bf[4], True), iters=5)
        res.update({f"bf16 bwd {k}": t for k, t in parts.items()})
        for name, (x, g, ws, bs, lns, preact, need_dx) in chains.items():
            lnp = lns or (None, None)
            res[f"{name} fwd"] = cuda_ms(lambda: fused_mlp.mlp_chain(
                x, ws, bs, *lnp, preact_input=preact))
            parts = chain_bwd_parts((x, g, ws, bs, lnp[0], preact, need_dx),
                                    iters=5)
            res.update({f"{name} bwd {k}": t for k, t in parts.items()})
            # the same case under the bf16 policy
            xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
            parts = chain_bwd_parts((xb, gb, ws, bs, lnp[0], preact,
                                     need_dx), iters=5)
            res.update({f"bf16 {name} bwd {k}": t for k, t in parts.items()})
    finally:
        _build._lib, _build.load = loaded, load
    return res


def remus_grads(libs, seeds):
    """``tools/remus_grad_gate.py``'s study (the REMuS gradient gate of
    ``chip_smoke.py`` over model seeds) with each library's kernels."""
    sys.path.insert(0, str(ROOT / "tools"))
    import remus_grad_gate
    loaded, load = _build._lib, _build.load
    for name, lib in libs.items():
        print(f"{name}:", flush=True)
        _build._lib, _build.load = lib, (lambda: lib)
        try:
            remus_grad_gate.gate(seeds)
        finally:
            _build._lib, _build.load = loaded, load


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--remus-grads", type=int, nargs="*", default=None,
                    metavar="SEED")
    ap.add_argument("--bf16-chain-fwd", action="store_true",
                    help="time only the bf16 chain forward")
    ap.add_argument("--src", type=Path, default=SRC,
                    help="the csrc directory to patch (default: this tree's)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    every = {**VARIANTS, **OLD_BF16_FWD}
    names = [n for n in every if (n in args.only if args.only is not None
                                  else n in VARIANTS)]
    libs = build(names, args.src.resolve())
    if args.remus_grads is not None:
        remus_grads({"as built": _build.load(), **libs},
                    args.remus_grads or list(range(8)))
        return
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    e, v, senders, edge, node, vs, sort = gn_case(dev, rng)
    gv = torch.randn(v.shape[0], 128, device=dev)
    ge = torch.randn(e.shape[0], 128, device=dev)
    case = (e, v, senders, edge, node, vs, sort, gv, ge)
    chains = {name: (*chain_case(dev, rng, rows, dims, ln), preact, need_dx)
              for name, rows, dims, ln, preact, need_dx, _ in CHAIN_CASES}
    print(f"{torch.cuda.get_device_name(0)}; GN: MuS level 1 (V=40448, k=6, "
          f"H=128); chains: chip_smoke.CHAIN_CASES; ms per launch",
          flush=True)
    for rnd in range(args.rounds):
        for name in names:
            res = time_variant(libs[name], case, chains, args.bf16_chain_fwd)
            print(f"round {rnd} | {name} | " + ", ".join(
                f"{k} {t:.4f}" for k, t in res.items()), flush=True)


if __name__ == "__main__":
    main()
