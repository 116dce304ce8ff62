"""Parallelism over ``torch.distributed`` (port of
``graphs4cfd_tpu/parallel``): process groups and the (data, graph) mesh;
data parallelism, edge-partitioned graph parallelism and the two composed
(DP x GP), each for every model family (MuS-, gMuS- and REMuS-GNN), in
f32 and under the bf16 policy."""
from .dp import (dp_loss_and_grads, make_dp_rollout, make_dp_train_step,
                 make_dp_val_step)
from .graph_parallel import (attach_gp_sorts, gp_apply_fn, gp_loss_and_grads,
                             gp_mugs_apply, gp_mus_apply, gp_remus_apply,
                             make_dp_gp_forward, make_dp_gp_train_step,
                             make_dp_gp_val_step, make_gp_forward,
                             make_gp_rollout, make_gp_train_step,
                             make_gp_val_step, part_of, partition_batches,
                             partition_graph, regroup_sharded, unpermute)
from .mesh import (Mesh, init_process_group, initialize_distributed,
                   make_hybrid_mesh, make_mesh, spawn_ranks)

__all__ = ["make_mesh", "make_hybrid_mesh", "initialize_distributed", "Mesh",
           "init_process_group", "spawn_ranks", "make_dp_train_step",
           "make_dp_val_step", "make_dp_rollout", "dp_loss_and_grads",
           "partition_graph", "partition_batches", "regroup_sharded",
           "attach_gp_sorts", "part_of", "unpermute", "gp_mus_apply",
           "gp_mugs_apply", "gp_remus_apply", "gp_apply_fn",
           "gp_loss_and_grads", "make_gp_forward", "make_gp_rollout",
           "make_gp_train_step", "make_gp_val_step", "make_dp_gp_forward",
           "make_dp_gp_train_step", "make_dp_gp_val_step"]
