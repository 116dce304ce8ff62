"""``benchmark/reference`` against the port's plain path (the port's CPU
fallback of its kernels) for both families, at 16 wide on clouds of 300
nodes: one step, a short rollout, and the first training steps through
``fit`` in float32."""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from benchmark import compare, data, harness, reference, weights
from benchmark.entries import common, fit

from .conftest import _narrow


def tiny(config):
    root = os.path.join(os.path.dirname(__file__), "..", "configs")
    conf = json.load(open(os.path.join(root, config + ".json")))
    conf["arch"] = {k: _narrow(v, 16) for k, v in conf["arch"].items()}
    return conf


@pytest.mark.parametrize("config", ["mus3", "remus3"])
def test_one_step_and_a_rollout_agree(config, few_threads):
    from graphs4cfd_tpu_torch.graph import Graph
    from graphs4cfd_tpu_torch.loader import collate
    conf = tiny(config)
    raws = data.clouds(2, 300, 5, conf["nf"])
    W = weights.make(conf["arch"], 5, "cpu")
    model = common.program_model(conf, W, "cpu", "f32")
    graphs = common.program_graphs(raws, conf)
    with torch.no_grad():
        got = model(Graph.from_numpy(collate(graphs), "cpu"))
    roll = model.solve(graphs, 5).numpy()
    ref = reference.Model(conf, W)
    ts = ref.graphs(raws, "cpu")
    with torch.no_grad():
        want = torch.cat([ref.step(t, t["field"]) for t in ts])
    want_roll = torch.cat([ref.rollout(t, 5) for t in ts]).numpy()
    scale = want.abs().max()
    assert (got[:len(want)] - want).abs().max() <= 1e-5 * scale
    gaps = compare.rollout_numbers([(roll[:len(want_roll)], want_roll)],
                                   conf["nf"])
    assert gaps["rollout_gap"] < 1e-5


@pytest.mark.parametrize("config", ["mus3", "remus3"])
def test_the_first_training_steps_agree(config, few_threads):
    conf = tiny(config)
    trf = {"n_out": 3, "lr": 1e-5, "grad_clip": 1.0, "lambda_d": 0.25,
           "precision": "f32", "reference_block": 1}
    raws = data.clouds(2, 300, 6, conf["nf"], 10)
    W = weights.make(conf["arch"], 6, "cpu")
    model = common.program_model(conf, W, "cpu", "f32")
    with tempfile.TemporaryDirectory() as folder:
        train_config, loss = fit.configs(trf, folder)
        got = fit.first_steps(model, common.program_graphs(raws, conf),
                              train_config, loss(), 3, lambda: None)
    cell = harness.Cell(spec={}, config=conf, traffic=trf, limits={},
                        end_to_end=[], per_layer=[], readers={})
    ctx = harness.Ctx(cell=cell, seed=6, seconds=0, trace=False,
                      device=torch.device("cpu"), started=0.0)
    losses, grads, after = fit.reference_steps(ctx, raws, W, 3)
    n = compare.training_numbers(got["losses"], losses, got["grads"],
                                 grads, W, got["after"], after)
    assert n["loss_gap"] < 1e-5 and n["grad_gap"] < 1e-4, n
    assert n["grad_cos_gap_median"] < 1e-6, n
    assert n["update_gap"] < 1e-2, n
    assert np.all(np.diff(losses) != 0)


def test_the_control_precisions_round_as_named():
    from benchmark.reference.nn import round_fp8, round_tf32
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11, -(1.0 + 2 ** -10)])
    assert round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, -(1.0 + 2 ** -10)]
    y = torch.tensor([448.0, 1.0, 1.06])
    assert round_fp8(y).tolist() == [448.0, 1.0, 1.0]
