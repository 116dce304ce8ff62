"""Parallelism: process groups and edge-partitioned graph parallelism for
the MuS-GNN family (port of ``graphs4cfd_tpu/parallel``).  Data
parallelism, DP x GP, the gMuS and REMuS partitioned bodies and graph
parallelism under the bf16 policy (a bf16 model raises) are not ported
yet."""
from .graph_parallel import (attach_gp_sorts, gp_loss_and_grads, gp_mus_apply,
                             make_gp_forward, make_gp_rollout,
                             make_gp_train_step, make_gp_val_step,
                             part_of, partition_graph, unpermute)
from .mesh import init_process_group, spawn_ranks

__all__ = ["attach_gp_sorts", "gp_loss_and_grads",
           "gp_mus_apply", "make_gp_forward", "make_gp_rollout",
           "make_gp_train_step", "make_gp_val_step", "part_of",
           "partition_graph", "unpermute", "init_process_group",
           "spawn_ranks"]
