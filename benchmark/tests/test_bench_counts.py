"""``benchmark/counts`` against the numbers PERF.md section 6 already
cites (``chip_smoke.py``'s counting at the kernels' shapes), and the work
of one step of each cell."""
from __future__ import annotations

import json
import os

import pytest

from benchmark import counts as C
from benchmark.reference import host

from .conftest import ROOT

P = C.PEAKS


def bounds(k):
    """(f32 bound, 3xTF32 bound, bf16 bound) in ms, as PERF.md's tables."""
    by = k.bytes / P["bytes_per_s"]
    return (round(max(k.flops / P["f32_flops_per_s"], by) * 1e3, 4),
            round(max(3 * k.flops / P["tf32_flops_per_s"], by) * 1e3, 4))


def bf16_bound(k):
    return round(max(k.flops / P["bf16_flops_per_s"],
                     k.bytes / P["bytes_per_s"]) * 1e3, 4)


CHAINS = {"tail": (14336, [128, 128, 128], True, True),
          "mus_edge_encoder": (242688, [2, 128, 128, 128], False, False),
          "remus_angle_encoder": (512000, [4, 128, 128], True, False)}


@pytest.mark.parametrize("case,f32,tc,bf16", [
    ("tail", 0.0140, 0.0057, 0.0022),
    ("mus_edge_encoder", 0.2392, 0.0971, 0.0189),
    ("remus_angle_encoder", 0.2582, 0.1049, 0.0404)])
def test_row1_chain_forward(case, f32, tc, bf16):
    rows, dims, ln, _ = CHAINS[case]
    assert bounds(C.chain_fwd(case, rows, dims, ln, 4)) == (f32, tc)
    assert bf16_bound(C.chain_fwd(case, rows, dims, ln, 2)) == bf16


@pytest.mark.parametrize("case,f32,tc,bf16", [
    ("tail", 0.0421, 0.0171, 0.0034),
    ("mus_edge_encoder", 0.5972, 0.2425, 0.0405),
    ("remus_angle_encoder", 0.7669, 0.3114, 0.0520)])
def test_row2_chain_backward(case, f32, tc, bf16):
    rows, dims, ln, dx = CHAINS[case]
    assert bounds(C.chain_bwd(case, rows, dims, ln, dx, 4)) == (f32, tc)
    assert bf16_bound(C.chain_bwd(case, rows, dims, ln, dx, 2)) == bf16


# rows 5-6: MuS level 1, V=40448, k=6; rows 9-10: the level-1 EdgeMP,
# 102,400 edges x k=5 angles, the edge table itself
GN = {5: (242688, 40448, 40448, [384, 128, 128, 128], [256, 128, 128, 128]),
      9: (512000, 102400, 102400, [384, 128, 128], [256, 128, 128])}


@pytest.mark.parametrize("row,f32,tc,bf16", [
    (5, 0.4550, 0.1848, 0.0468), (9, 0.7011, 0.2847, 0.1025)])
def test_rows_5_9_gn_forward(row, f32, tc, bf16):
    E, V, S, ed, nd = GN[row]
    k = C.gn_fwd("gn", E, V, S, 128, 128, ed, nd, True, True, 4)
    assert bounds(k) == (f32, tc)
    assert k.flops == C.gn_flops(E, V, 128, 128, ed, nd)
    assert bf16_bound(C.gn_fwd("gn", E, V, S, 128, 128, ed, nd, True, True,
                               2)) == bf16


@pytest.mark.parametrize("row,f32,tc,bf16", [
    (5, 1.3650, 0.5543, 0.0925), (9, 2.1034, 0.8541, 0.1664)])
def test_rows_6_10_gn_backward(row, f32, tc, bf16):
    E, V, S, ed, nd = GN[row]
    assert bounds(C.gn_bwd("gn", E, V, S, 128, 128, ed, nd, True, True,
                           4)) == (f32, tc)
    assert bf16_bound(C.gn_bwd("gn", E, V, S, 128, 128, ed, nd, True, True,
                               2)) == bf16


def test_peaks_are_the_data_sheet():
    assert (P["bf16_flops_per_s"], P["tf32_flops_per_s"],
            P["bytes_per_s"]) == (989e12, 495e12, 3.35e12)
    assert C.peak_flops("bf16") == 989e12 and C.peak_flops("f32") == 495e12


def _cell_sizes(config, batch):
    """Valid sizes of a batch of the cell's clouds (seed 1), from the
    reference's own graphs."""
    from benchmark import data
    conf = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                       config + ".json")))
    graphs = [host.build(r, conf["transforms"]) for r in data.clouds(
        batch, conf["n_nodes"], 1, conf["nf"])]
    k = graphs[0]["k"]
    sz = {"V1": sum(len(g["pos"]) for g in graphs), "k": k}
    sz["E1"] = k * sz["V1"]
    if conf["family"] == "mus":
        for l in (2, 3):
            sz[f"V{l}"] = sum(g[f"V_{l}"] for g in graphs)
            sz[f"E{l}"] = sum(len(g[f"senders_{l}"]) for g in graphs)
    else:
        for l in (2, 3):
            sz[f"V{l}"] = sum(len(g[f"pos_{l}"]) for g in graphs)
            sz[f"E{l}"] = k * sz[f"V{l}"]
    return conf, sz


# (cell, config, batch, training, kernels a step, model GFLOP a step,
#  least ms a step of the port's kernels)
STEPS = [
    ("mus3.train.bf16", "mus3", 32, "bf16", 62, 3512.7, 4.981),
    ("remus3.train.bf16", "remus3", 4, "bf16", 58, 1541.0, 2.627),
    ("mus3.rollout.f32", "mus3", 8, "f32", 31, 292.7, 0.816),
    ("remus3.rollout.f32", "remus3", 4, "f32", 29, 513.7, 1.961)]


@pytest.mark.parametrize("cell,config,batch,prec,nk,gflop,ms", STEPS)
def test_the_work_of_one_step_of_each_cell(cell, config, batch, prec, nk,
                                           gflop, ms):
    conf, sz = _cell_sizes(config, batch)
    fam = C.family(conf["family"])
    train = "train" in cell
    ks = fam.kernels(conf["arch"], sz, train, C.ACT_BYTES[prec])
    assert len(ks) == nk
    assert C.step_model_flops(fam, conf["arch"], sz, train) / 1e9 == \
        pytest.approx(gflop, abs=0.05)
    assert C.step_seconds(fam, conf["arch"], sz, train, prec) * 1e3 == \
        pytest.approx(ms, abs=5e-4)
