"""The port's graph-parallel host side and its row gather, on the CPU.

* ``partition_graph`` byte-equal to the JAX package's on every key but
  the TPU window plans (``wg_*``), at ``halo_max_frac`` 0.5, 0 (all-gather
  everywhere) and 1e9 (a halo table everywhere), with the same node
  permutations, on the MuS batch and on ``tests/test_parallel.py``'s gMuS
  and REMuS GP batches;
* ``attach_gp_sorts`` and ``part_of``;
* ``gather_rows_plain`` against ``pallas_gather.windowed_take`` in
  interpret mode (a rolling window plan over a table with a tail that
  only exception rows reach, with and without ``zero_tail``), its sorted
  backward against ``jax.vjp`` of it at 1e-6, and the out-of-table
  indices it refuses; on a bf16 table, exact against indexing, with its
  backward's sums in f32 rounded to bf16 once.

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


def _family_cloud(family, seed, n, pipeline, wrap):
    """``tests/test_parallel.py``'s ``_mugs_batch``/``_remus_batch`` cloud
    (430 nodes, 3 levels, k=4) through ``pipeline``."""
    rng = np.random.default_rng(seed)
    g = wrap(make_cloud(rng, n, with_glob=True) if family == "mugs" else
             make_cloud(rng, n, n_in=1, nf=2, with_loc=False,
                        with_glob=True))
    for t in pipeline:
        g = t(g)
    return g


def _family_pipeline(tf, family):
    if family == "mugs":
        return [tf.GuillardCoarseningAndConnectKNN(
            k=[4, 4, 4], scale_edge_attr=(0.02, 0.04, 0.08)),
            tf.BuildKnnInterpWeights(3)]
    return [tf.BuildRemusGraph(num_levels=3, k=4,
                               scale_edge_length=(0.02, 0.04, 0.08)),
            tf.BuildKnnInterpWeights(3)]


FAMILY_SEEDS = {"mugs": 7, "remus": 8}


def jax_family_batch(family, seed=None, n=430):
    """The JAX package's gMuS or REMuS GP batch of ``tests/test_parallel.py``
    (``_mugs_batch``, ``_remus_batch``)."""
    seed = FAMILY_SEEDS[family] if seed is None else seed
    return jax_collate([_family_cloud(family, seed, n, _family_pipeline(
        JT, family), lambda g: g)], node_bucket=16, edge_bucket=64)


def port_family_batch(family, seed=None, n=430):
    """The same batch through the port's transforms and ``collate``."""
    seed = FAMILY_SEEDS[family] if seed is None else seed
    return collate([_family_cloud(family, seed, n, _family_pipeline(
        T, family), lambda g: Graph(dict(g.data)))], node_bucket=16,
        edge_bucket=64)


BATCHES = {"mus": (jax_batch, port_batch),
           "mugs": (lambda: jax_family_batch("mugs"),
                    lambda: port_family_batch("mugs")),
           "remus": (lambda: jax_family_batch("remus"),
                     lambda: port_family_batch("remus"))}
#: the halo tables a partition keeps at halo_max_frac 1e9
EVERY_TABLE = {"mus": {"halo_s", "halo_sr_2", "halo_p_2"},
               "mugs": {"halo_s", "halo_s_2", "halo_s_3", "halo_d_2",
                        "halo_d_3", "halo_u_2", "halo_u_3", "halo_o"},
               "remus": {"halo_s", "halo_s_2", "halo_s_3", "halo_o",
                         "halo_x_2", "halo_x_3", "halo_u_2", "halo_u_3",
                         "halo_d_2", "halo_d_3"}}
CASES = [(b, f) for b in BATCHES for f in (0.5, 0.0, 1e9)]


@pytest.mark.parametrize("batch,frac", CASES, ids=[
    str(f) if b == "mus" else f"{b}-{f}" for b, f in CASES])
def test_partition_byte_equal_to_jax(batch, frac):
    """Byte-equal on every key but the TPU window plans; with every table
    kept, the tables ``tests/test_parallel.py:216-224`` asks of the JAX
    package's gMuS and REMuS partitions are there."""
    jax_of, port_of = BATCHES[batch]
    ref, ref_info = jax_partition(jax_of(), P, halo_max_frac=frac)
    got, info = partition_graph(port_of(), P, halo_max_frac=frac)
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
        assert tables == EVERY_TABLE[batch]


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


@pytest.mark.parametrize("frac", [0.0, 1e9])
def test_attach_gp_sorts_folds_the_remus_angle_sources(frac):
    """Each REMuS level's angle sources as rows of the folded edge table:
    ``s*k + j``, ``s`` the sender's map into the local table (or the
    global sender over the all-gather), with its sort; a valid edge whose
    sources are not the canonical layout is refused."""
    sharded, _ = partition_graph(port_family_batch("remus"), P,
                                 halo_max_frac=frac)
    got = attach_gp_sorts(sharded).data
    for s in ("", "_2", "_3"):
        k = sharded.data[f"angle_src{s}"].shape[-1]
        base = sharded.data[f"senders{s}_lidx" if frac else f"senders{s}"]
        fold = got[f"angle_src{s}_fold"]
        np.testing.assert_array_equal(fold, base[..., None] * k
                                      + np.arange(k))
        flat = fold.reshape(P, -1)
        for d in range(P):
            np.testing.assert_array_equal(got[f"angle_src{s}_fold_perm"][d],
                                          np.argsort(flat[d], kind="stable"))
    bad = dict(sharded.data)
    bad["angle_src_2"] = bad["angle_src_2"].copy()
    valid = np.argwhere(bad["edge_mask_2"])[0]
    bad["angle_src_2"][tuple(valid)] = bad["angle_src_2"][tuple(valid)][::-1]
    with pytest.raises(ValueError, match="canonical"):
        attach_gp_sorts(Graph(bad))


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


def test_gather_rows_plain_takes_bf16(rng):
    """A bf16 table: the forward exact against indexing, in bf16; the
    sorted backward adds the bf16 cotangent rows in f32 and hands the
    table the sums rounded to bf16 once."""
    S, M, H = 300, 1000, 24
    table = torch.from_numpy(rng.normal(size=(S, H)).astype(
        np.float32)).bfloat16()
    idx = rng.integers(0, S - 20, M).astype(np.int32)
    perm = np.argsort(idx, kind="stable").astype(np.int32)
    sort = (torch.from_numpy(perm), torch.from_numpy(idx[perm]))
    idx_t = torch.from_numpy(idx)
    got = gather.gather_rows_plain(table, idx_t)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, table[idx_t.long()])
    ct = torch.from_numpy(rng.normal(size=(M, H)).astype(
        np.float32)).bfloat16()
    tab = table.clone().requires_grad_()
    out = gather.gather_rows(tab, idx_t, sort)
    assert out.dtype == torch.bfloat16 and torch.equal(out.detach(), got)
    out.backward(ct)
    assert tab.grad.dtype == torch.bfloat16
    ref = np.zeros((S, H), np.float64)
    np.add.at(ref, idx, ct.double().numpy())
    # each sum within half a bf16 step (2^-8 relative) of the exact sum
    np.testing.assert_allclose(tab.grad.double().numpy(), ref, rtol=2 ** -8,
                               atol=1e-6)
    torch.testing.assert_close(
        tab.grad, gather.segment.sorted_segment_sum(
            ct, *sort, S).bfloat16(), rtol=0, atol=0)
    assert not tab.grad[S - 20:].float().any()
