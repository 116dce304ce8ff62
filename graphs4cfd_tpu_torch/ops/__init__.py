"""Host graph ops (numpy) and device ops with their CUDA kernels.

The JAX package's ``ops`` names (``graphs4cfd_tpu/ops/__init__.py``), all
but ``build_window_gather_plan`` and ``WindowGatherPlan``: those plan the
TPU's windowed one-hot gather, and the port's kernels load rows by index.
``gather`` is the module of the row-gather kernel, which called as a
function is the JAX package's ``gather`` (``ops.segment.gather``, plain
torch indexing): ``ops.gather(...)`` never launches the kernel,
``ops.gather.gather_rows`` does.

Importing this package builds nothing: the C++ helper is compiled at its
first call and the kernels on the first call that gives them a CUDA
tensor (``ops._build``).
"""
from . import gather
from .angles import extend_graph, inter_level_angles
from .coarsen import guillard_coarsening, pool_edge_structure
from .interp import knn_interp_weights, knn_interpolate
from .knn import connect_knn, cross_knn, knn_neighbors
from .linalg import pinv_k2, pinv_k2_np
from .order import morton_code, spatial_sort_perm
from .segment import aggregate_fixed_k, segment_mean, segment_sum
from .voxel import grid_clustering, voxel_grid

__all__ = [
    "segment_sum", "segment_mean", "aggregate_fixed_k", "gather",
    "connect_knn", "cross_knn", "knn_neighbors",
    "voxel_grid", "grid_clustering",
    "guillard_coarsening", "pool_edge_structure",
    "extend_graph", "inter_level_angles",
    "knn_interp_weights", "knn_interpolate",
    "pinv_k2", "pinv_k2_np",
    "morton_code", "spatial_sort_perm",
    "launch_counters", "launch_counts", "kernel_names",
]

#: each wrapper's ``__global__`` function (``csrc/*.cu``), as a
#: ``torch.profiler`` trace names its kernel's events (``void g4c::...``);
#: the f32 and bf16 launches of one template share its name
_KERNELS = {
    "mlp_chain": "mlp_chain_kernel",
    "gn_block": "gn_block_kernel",
    "mlp_chain_bwd": "mlp_chain_bwd_kernel",
    "gn_block_bwd": "gn_block_bwd_kernel",
    "weight_grads": "gn_wgrad_kernel",
    "sorted_segment_sum": "sorted_segment_sum_kernel",
    "gather_rows": "gather_rows_kernel",
    "mlp_chain_bf16": "mlp_chain_fwd_bf16_kernel",
    "gn_block_bf16": "gn_block_bf16_kernel",
    "mlp_chain_bwd_bf16": "mlp_chain_bwd_bf16_kernel",
    "gn_block_bwd_bf16": "gn_block_bwd_bf16_kernel",
    "weight_grads_bf16": "wgrad_bf16_kernel",
    "sorted_segment_sum_bf16": "sorted_segment_sum_kernel",
    "gather_rows_bf16": "gather_rows_kernel",
}


def launch_counters() -> dict:
    """Every kernel wrapper by name, each counting its kernel's launches in
    ``.launches``; the bf16 policy's launches of a wrapper count apart, in
    its ``.bf16`` (the ``_bf16`` names).  ``weight_grads`` also counts the
    weight-gradient kernel's launch inside each backward."""
    from . import fused_mlp, gn_block, segment, wgrad
    wrappers = {"mlp_chain": fused_mlp.mlp_chain,
                "gn_block": gn_block.gn_block,
                "mlp_chain_bwd": fused_mlp.mlp_chain_bwd,
                "gn_block_bwd": gn_block.gn_block_bwd,
                "weight_grads": wgrad.weight_grads,
                "sorted_segment_sum": segment.sorted_segment_sum,
                "gather_rows": gather.gather_rows}
    return {**wrappers, **{f"{name}_bf16": fn.bf16
                           for name, fn in wrappers.items()
                           if hasattr(fn, "bf16")}}


def launch_counts() -> dict:
    """Every wrapper's launch count by name (``config.fast_path_report``
    gives the nonzero ones)."""
    return {name: fn.launches for name, fn in launch_counters().items()}


def kernel_names() -> dict:
    """Every wrapper's ``__global__`` function by wrapper name (the names
    of ``launch_counters``): what a profiler trace calls the kernel that the
    wrapper counts."""
    return dict(_KERNELS)
