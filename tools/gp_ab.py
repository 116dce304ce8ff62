"""Time the MuS f32 graph-parallel training step and rollout of one tree:
the spawns of ``chip_smoke.py`` phases "gp training" and "gp path" (2 gloo
ranks sharing card 0, the flagship batch through ``partition_graph(batch,
2)``), each the slower rank's median of 3.

    python3 tools/gp_ab.py TREE LABEL

``TREE`` holds ``chip_smoke.py`` and ``graphs4cfd_tpu_torch/`` (this
checkout, or a ``git archive`` of another commit unpacked under a
git-ignored directory); the kernels build under ``TREE/build``.  Compare
two trees in one card call, in turns: parent, change, change, parent.
Prints one ``AB LABEL KIND ms T`` line per kind.
"""
import os
import sys


def main():
    tree = os.path.abspath(sys.argv[1])
    os.chdir(tree)
    sys.path.insert(0, tree)
    import chip_smoke as cs
    from graphs4cfd_tpu_torch.loader import collate
    from graphs4cfd_tpu_torch.ops import _build
    from graphs4cfd_tpu_torch.parallel import attach_gp_sorts, partition_graph
    _build.load()
    batch = collate(cs.make_samples(8, 5000, seed=7), node_bucket=512,
                    edge_bucket=1024)
    sharded, _ = cs.gp_graphs(batch)
    every = attach_gp_sorts(partition_graph(batch, 2, halo_max_frac=0.0)[0])
    for kind in ("train", "path"):
        ranks = cs.gp_spawn("gp ab", "gloo", 2, kind, {
            "part": sharded.data, "all_gather": every.data}, 300)
        print(f"AB {sys.argv[2]} {kind} ms "
              f"{max(r['ms'] for r in ranks):.3f}", flush=True)


if __name__ == "__main__":
    main()
