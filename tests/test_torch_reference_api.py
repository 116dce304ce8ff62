"""The port's ``ops`` names and the reference's one-call helpers against
the JAX package's, on the CPU.

* ``ops.pinv_k2`` against the JAX ``pinv_k2`` and float64
  ``numpy.linalg.pinv`` (1e-5 max abs), on a seeded ``[64, 6, 2]`` stack
  and on rank-deficient and bf16 inputs;
* ``nn.blocks.lstsq`` against the JAX one (1e-5 relative), through the
  ``[N, k, 2]`` pinverse and through ``torch.linalg.lstsq``;
* ``restriction`` and ``pool_edge``: indices exact, pooled features
  within 1e-6, for ``aggr="mean"`` and ``"sum"``;
* ``mlp_output_size`` on every MLP of the arch of each of the 12 classes'
  training scripts and of every bundled checkpoint;
* every name of the JAX package's ``ops`` but the window-plan pair
  resolves on the port's ``ops``, and ``ops.gather`` gathers as the JAX
  ``ops.gather`` does while its kernel wrapper stays reachable.
"""
import ast
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphs4cfd_tpu.ops as jax_ops
from graphs4cfd_tpu.graph import Graph as JaxGraph
from graphs4cfd_tpu.nn import blocks as jax_blocks
from graphs4cfd_tpu.nn import mlp as jax_mlp
from graphs4cfd_tpu.ops.linalg import pinv_k2 as jax_pinv_k2
from graphs4cfd_tpu_torch import ops
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.nn import blocks, bundled_checkpoint_path
from graphs4cfd_tpu_torch.nn.mlp import mlp_output_size
from graphs4cfd_tpu_torch.training import load_checkpoint

ROOT = Path(__file__).resolve().parent.parent
CLASS_NAMES = ("NsOneScaleGNN", "NsTwoScaleGNN", "NsThreeScaleGNN",
               "NsFourScaleGNN", "AdvOneScaleGNN", "AdvTwoScaleGNN",
               "AdvThreeScaleGNN", "AdvFourScaleGNN",
               "NsTwoGuillardScaleGNN", "NsThreeGuillardScaleGNN",
               "NsFourGuillardScaleGNN", "NsRotEquiThreeScaleGNN")
PINV_TOL = 1e-5
LSTSQ_RTOL = 1e-5
POOL_TOL = 1e-6


def _stack(rng, n=64, k=6):
    """Unit edge vectors of ``n`` nodes with ``k`` edges each, as the
    REMuS pipeline's projections see them."""
    ang = rng.uniform(0, 2 * np.pi, size=(n, k))
    return np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)


def test_pinv_k2_matches_jax_and_float64():
    a = _stack(np.random.default_rng(0))
    got = ops.pinv_k2(torch.from_numpy(a))
    assert got.dtype == torch.float32 and got.shape == (64, 2, 6)
    want = np.asarray(jax_pinv_k2(jnp.asarray(a)))
    exact = np.linalg.pinv(a.astype(np.float64))
    assert np.abs(got.numpy() - want).max() <= PINV_TOL
    assert np.abs(got.numpy() - exact).max() <= PINV_TOL
    # leading batch dims, a bf16 input (widened to f32 first)
    b = torch.from_numpy(a.reshape(4, 16, 6, 2)).to(torch.bfloat16)
    got = ops.pinv_k2(b)
    want = np.asarray(jax_pinv_k2(jnp.asarray(b.float().numpy())))
    assert got.shape == (4, 16, 2, 6) and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= PINV_TOL


def test_pinv_k2_of_a_rank_deficient_stack_matches_jax():
    a = np.zeros((3, 5, 2), np.float32)          # det 0: the 1e-30 floor
    a[1, :, 0] = 1.0
    got = ops.pinv_k2(torch.from_numpy(a)).numpy()
    want = np.asarray(jax_pinv_k2(jnp.asarray(a)))
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    assert np.abs(got[fin] - want[fin]).max(initial=0) <= PINV_TOL


def test_lstsq_matches_jax():
    rng = np.random.default_rng(1)
    a = _stack(rng, 32, 5)
    b = rng.normal(size=(32, 5, 3)).astype(np.float32)
    got = blocks.lstsq(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = np.asarray(jax_blocks.lstsq(jnp.asarray(a), jnp.asarray(b)))
    assert got.shape == want.shape == (32, 2, 3)
    np.testing.assert_allclose(got, want, rtol=LSTSQ_RTOL, atol=0)
    # a general system: torch.linalg.lstsq against jnp.linalg.lstsq
    a2 = rng.normal(size=(20, 4)).astype(np.float32)
    b2 = rng.normal(size=(20, 3)).astype(np.float32)
    got = blocks.lstsq(torch.from_numpy(a2), torch.from_numpy(b2)).numpy()
    want = np.asarray(jax_blocks.lstsq(jnp.asarray(a2), jnp.asarray(b2)))
    assert got.shape == want.shape == (4, 3)
    np.testing.assert_allclose(got, want, rtol=LSTSQ_RTOL,
                               atol=LSTSQ_RTOL * np.abs(want).max())


def _coarse_graph(rng, V=300, k=6, Vc=40):
    parent = rng.integers(0, Vc, V)
    senders = rng.integers(0, V, V * k)
    receivers = np.repeat(np.arange(V), k)
    return parent, senders, receivers


def test_restriction_matches_jax():
    rng = np.random.default_rng(2)
    mask = rng.random(300) < 0.3
    keep = np.flatnonzero(mask)
    edge_index = np.stack([rng.choice(keep, 500), rng.choice(keep, 500)])
    attr = rng.normal(size=(500, 2)).astype(np.float32)
    for m, idx, kw in ((mask, edge_index, {"device": "cpu"}),
                       (torch.from_numpy(mask), torch.from_numpy(edge_index),
                        {})):
        g = blocks.restriction(Graph(), m, torch.from_numpy(attr), idx, 300,
                               **kw)
        ref = jax_blocks.restriction(JaxGraph(), mask, jnp.asarray(attr),
                                     edge_index, 300)
        for key in ("senders", "receivers"):
            got, want = g.data[key], np.asarray(ref.data[key])
            assert got.dtype == torch.int32 and want.dtype == np.int32
            assert got.numpy().tobytes() == want.tobytes(), key
        assert g.edge_attr.numpy().tobytes() == attr.tobytes()
        assert int(g.senders.min()) >= 0
        assert int(g.senders.max()) < mask.sum()


@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_pool_edge_matches_jax(aggr):
    rng = np.random.default_rng(3)
    parent, senders, receivers = _coarse_graph(rng)
    attr = rng.normal(size=(senders.size, 4)).astype(np.float32)
    (cs, cr), got = blocks.pool_edge(torch.from_numpy(parent),
                                     torch.from_numpy(senders), receivers,
                                     torch.from_numpy(attr), aggr=aggr)
    (jcs, jcr), want = jax_blocks.pool_edge(parent, senders, receivers,
                                            jnp.asarray(attr), aggr=aggr)
    assert cs.tobytes() == np.asarray(jcs).tobytes()
    assert cr.tobytes() == np.asarray(jcr).tobytes()
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert np.abs(got.numpy() - want).max() <= POOL_TOL


def test_restriction_and_pool_edge_put_numpy_inputs_on_the_card():
    """Given numpy and no ``device``, both helpers work on the card, as the
    entry points do: where there is none, they raise."""
    rng = np.random.default_rng(4)
    parent, senders, receivers = _coarse_graph(rng)
    attr = rng.normal(size=(senders.size, 4)).astype(np.float32)
    mask = rng.random(300) < 0.3
    edge_index = np.stack([np.flatnonzero(mask)] * 2)
    calls = (lambda: blocks.restriction(Graph(), mask, attr, edge_index,
                                        300).senders,
             lambda: blocks.pool_edge(parent, senders, receivers, attr)[1])
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def _script_arch(path):
    """The ``arch = {...}`` dict of a training script, evaluated alone."""
    tree = ast.parse(path.read_text())
    (node,) = [n for n in tree.body if isinstance(n, ast.Assign)
               and any(getattr(t, "id", None) == "arch" for t in n.targets)]
    return eval(compile(ast.Expression(node.value), str(path), "eval"),
                {"__builtins__": {}})


def _mlps(arch):
    for entry in arch.values():
        if isinstance(entry[0], (tuple, list)):       # (edge MLP, node MLP)
            yield from entry
        else:
            yield entry


def test_mlp_output_size_matches_jax_on_every_class_arch():
    archs = {}
    for cls in CLASS_NAMES:
        (script,) = ROOT.glob(f"examples/training/*/{cls}.py")
        archs[cls] = _script_arch(script)
    for chk in sorted((ROOT / "graphs4cfd_tpu" / "nn" / "weights")
                      .rglob("*.chk")):
        rel = chk.relative_to(chk.parents[1])
        archs[str(rel)] = load_checkpoint(bundled_checkpoint_path(
            str(rel)))["arch"]
    assert len(archs) >= 12 + 9
    sizes = 0
    for name, arch in archs.items():
        for t in _mlps(arch):
            got, want = mlp_output_size(t), jax_mlp.mlp_output_size(t)
            assert type(got) is int and got == want, (name, t)
            sizes += 1
    assert sizes > 200


def test_every_jax_ops_name_resolves_on_the_port():
    left_out = {"build_window_gather_plan", "WindowGatherPlan"}
    missing = [n for n in jax_ops.__all__
               if n not in left_out and not hasattr(ops, n)]
    assert not missing
    assert set(jax_ops.__all__) - left_out <= set(ops.__all__)
    for n in ("launch_counters", "launch_counts"):
        assert callable(getattr(ops, n))


def test_ops_gather_is_the_jax_row_gather_and_keeps_its_kernel_module():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(0, 50, (30, 2)).astype(np.int32)
    want = np.asarray(jax_ops.gather(jnp.asarray(x), jnp.asarray(idx)))
    got = ops.gather(torch.from_numpy(x), torch.from_numpy(idx))
    assert got.shape == want.shape == (30, 2, 8)
    assert got.numpy().tobytes() == want.tobytes()
    from graphs4cfd_tpu_torch.ops import gather, segment
    assert gather is ops.gather and segment.gather is segment.take_rows
    assert gather.gather_rows.__module__ == "graphs4cfd_tpu_torch.ops.gather"
    assert "gather_rows" in ops.launch_counters()
    # the gradient goes back through the fixed-order sum
    xt = torch.from_numpy(x).requires_grad_()
    ops.gather(xt, torch.from_numpy(idx)).sum().backward()
    np.testing.assert_array_equal(
        xt.grad.numpy()[:, 0], np.bincount(idx.ravel(), minlength=50))
