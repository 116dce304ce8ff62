"""The port's graph-parallel host side and its row gather, on the CPU.

* ``partition_graph`` byte-equal to the JAX package's on every key but
  the TPU window plans (``wg_*``), at ``halo_max_frac`` 0.5, 0 (all-gather
  everywhere) and 1e9 (a halo table everywhere), with the same node
  permutations;
* ``attach_gp_sorts`` and ``part_of``;
* ``gather_rows_plain`` against ``pallas_gather.windowed_take`` in
  interpret mode (a rolling window plan over a table with a tail that
  only exception rows reach, with and without ``zero_tail``), its sorted
  backward against ``jax.vjp`` of it at 1e-6, and the out-of-table
  indices it refuses.

No rank is spawned here (``test_torch_gp.py`` does that).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphs4cfd_tpu import transforms as JT
from graphs4cfd_tpu.loader import collate as jax_collate
from graphs4cfd_tpu.ops.pallas_gather import windowed_take
from graphs4cfd_tpu.ops.window_plan import build_window_gather_plan
from graphs4cfd_tpu.parallel import partition_graph as jax_partition
from graphs4cfd_tpu_torch import transforms as T
from graphs4cfd_tpu_torch.graph import Graph
from graphs4cfd_tpu_torch.loader import collate
from graphs4cfd_tpu_torch.ops import gather
from graphs4cfd_tpu_torch.parallel import (attach_gp_sorts, part_of,
                                           partition_graph)
from test_models import make_cloud
from test_window_gather import _device_plan

P = 4


def _graphs(seed, sizes, pipeline, wrap):
    """``test_parallel._samples``' clouds through ``pipeline``."""
    rng = np.random.default_rng(seed)
    out = []
    for n in sizes:
        g = wrap(make_cloud(rng, n))
        for t in pipeline:
            g = t(g)
        out.append(g)
    return out


def jax_batch(seed=3, sizes=(430,)):
    """The JAX package's ``tests/test_parallel.py`` batch."""
    return jax_collate(_graphs(seed, sizes, [
        JT.ConnectKNN(k=4), JT.ScaleEdgeAttr(0.02), JT.GridClustering([0.3])],
        lambda g: g), node_bucket=64, edge_bucket=128)


def port_batch(seed=3, sizes=(430,)):
    """The same batch through the port's transforms and ``collate``."""
    return collate(_graphs(seed, sizes, [
        T.ConnectKNN(k=4), T.ScaleEdgeAttr(0.02), T.GridClustering([0.3])],
        lambda g: Graph(dict(g.data))), node_bucket=64, edge_bucket=128)


@pytest.mark.parametrize("frac", [0.5, 0.0, 1e9])
def test_partition_byte_equal_to_jax(frac):
    ref, ref_info = jax_partition(jax_batch(), P, halo_max_frac=frac)
    got, info = partition_graph(port_batch(), P, halo_max_frac=frac)
    want = {k: v for k, v in ref.data.items() if not k.startswith("wg_")}
    assert set(got.data) == set(want)
    for key, x in want.items():
        y = got.data[key]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape, key
            assert x.tobytes() == y.tobytes(), key
        else:
            assert x == y, key
    assert set(info["perms"]) == set(ref_info["perms"])
    for l, perm in ref_info["perms"].items():
        np.testing.assert_array_equal(info["perms"][l], perm)
    assert info["pmax"] == ref_info["pmax"]
    tables = {k for k in want if k.startswith("halo_")}
    if frac == 0.0:
        assert not tables
    if frac == 1e9:
        assert tables == {"halo_s", "halo_sr_2", "halo_p_2"}


def test_partition_refuses_rows_that_do_not_divide():
    with pytest.raises(ValueError, match="not divisible"):
        partition_graph(port_batch(), 7)


@pytest.mark.parametrize("frac", [0.0, 1e9])
def test_attach_gp_sorts_sorts_every_gather_map(frac):
    sharded, _ = partition_graph(port_batch(), P, halo_max_frac=frac)
    got = attach_gp_sorts(sharded)
    maps = (["senders_lidx", "senders_2_lidx", "receivers_2_lidx",
             "parent_2_lidx", "halo_s", "halo_sr_2", "halo_p_2"] if frac
            else ["senders", "senders_2", "receivers_2", "parent_2"])
    added = {k for k in got.data if k not in sharded.data}
    assert added == {f"{m}_{s}" for m in maps for s in ("perm", "sorted")}
    for m in maps:
        flat = sharded.data[m].reshape(P, -1)
        perm, srt = got.data[f"{m}_perm"], got.data[f"{m}_sorted"]
        assert perm.dtype == srt.dtype == np.int32
        for d in range(P):
            np.testing.assert_array_equal(
                perm[d], np.argsort(flat[d], kind="stable"))
            np.testing.assert_array_equal(srt[d], flat[d][perm[d]])


def test_part_of_slices_every_array():
    sharded, _ = partition_graph(port_batch(), P)
    part = part_of(sharded, 2, "cpu")
    for key, v in sharded.data.items():
        if isinstance(v, np.ndarray):
            got = part.data[key]
            assert isinstance(got, torch.Tensor)
            np.testing.assert_array_equal(got.numpy(), v[2])
        else:
            assert part.data[key] == v
    assert part.gp_rank == 2 and part.gp_num_parts == P


def _gather_case(rng, tail, N=512, M=1024, H=128, block=256):
    """``test_window_gather.test_windowed_take_grad``'s indices
    (clustered as a Morton-sorted graph's senders, 2 % of them far away)
    under a rolling plan.  With ``tail`` rows past the ``N`` that the
    plan's windows reach (as a graph-parallel halo region is), the far
    indices point into the tail, which only the exception rows reach and
    which ``zero_tail`` exists for."""
    base = np.repeat(np.linspace(0, N - 1, M // block, dtype=np.int64),
                     block)
    idx = np.clip(base + rng.integers(-60, 60, M), 0, N - 1)
    far = rng.random(M) < 0.02
    idx[far] = rng.integers(N if tail else 0, N + tail, far.sum())
    plan = build_window_gather_plan(idx, N + tail, block_rows=block,
                                    window=block, stride=128)
    assert plan is not None and plan.stride == 128
    # the rolling flush writes the rows its windows cover, and no others
    assert (plan.starts[-1] + plan.window < N + tail) == bool(tail)
    table = rng.normal(size=(N + tail, H)).astype(np.float32)
    return table, idx.astype(np.int32), plan


@pytest.mark.parametrize("zero_tail,tail", [(False, 0), (True, 256)])
def test_gather_rows_plain_matches_windowed_take(rng, zero_tail, tail):
    table, idx, plan = _gather_case(rng, tail)
    dp = _device_plan(plan)
    ct = rng.normal(size=(idx.shape[0], table.shape[1])).astype(np.float32)
    out, vjp = jax.vjp(lambda t: windowed_take(t, dp, interpret=True,
                                               zero_tail=zero_tail),
                       jnp.asarray(table))
    (ref_dt,) = vjp(jnp.asarray(ct))
    tab = torch.from_numpy(table).requires_grad_()
    idx_t = torch.from_numpy(idx)
    got = gather.gather_rows(tab, idx_t)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    np.testing.assert_array_equal(
        gather.gather_rows_plain(tab.detach(), idx_t).numpy(), table[idx])
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(tab.grad.numpy(), np.asarray(ref_dt),
                               rtol=1e-6, atol=1e-6)


def test_gather_rows_backward_walks_the_sort_given(rng):
    """With a host sort, without one (sorted on the device) and through
    ``index_add_``: the same sums; rows nothing gathers get 0."""
    S, M, H = 300, 1000, 8
    table = rng.normal(size=(S, H)).astype(np.float32)
    idx = rng.integers(0, S - 20, M).astype(np.int32)
    ct = torch.from_numpy(rng.normal(size=(M, H)).astype(np.float32))
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    sort = (torch.from_numpy(perm), torch.from_numpy(idx[perm]))
    grads = []
    for s in (sort, None):
        tab = torch.from_numpy(table).requires_grad_()
        gather.gather_rows(tab, torch.from_numpy(idx), s).backward(ct)
        grads.append(tab.grad)
    ref = torch.zeros(S, H).index_add_(0, torch.from_numpy(idx).long(), ct)
    torch.testing.assert_close(grads[0], ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(grads[0], grads[1])
    assert not grads[0][S - 20:].any()


@pytest.mark.parametrize("bad", [-1, 300])
def test_gather_rows_plain_raises_outside_the_table(rng, bad):
    table = torch.from_numpy(rng.normal(size=(300, 4)).astype(np.float32))
    idx = torch.tensor([0, 5, bad, 7], dtype=torch.int32)
    with pytest.raises(IndexError, match="outside"):
        gather.gather_rows_plain(table, idx)
    with pytest.raises(IndexError, match="outside"):
        gather.gather_rows(table, idx)
