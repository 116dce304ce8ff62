"""Host graph ops (numpy) and device ops with their CUDA kernels.

Importing this package builds nothing: the kernels are compiled on the
first call that gives them a CUDA tensor (``ops._build``).
"""


def launch_counters() -> dict:
    """Every kernel wrapper by name, each counting its kernel's launches in
    ``.launches``; the bf16 policy's launches of a wrapper count apart, in
    its ``.bf16`` (the ``_bf16`` names).  ``weight_grads`` also counts the
    weight-gradient kernel's launch inside each backward."""
    from . import fused_mlp, gather, gn_block, segment, wgrad
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
    """Every wrapper's launch count by name (the port's counterpart of the
    JAX package's ``fast_path_report``)."""
    return {name: fn.launches for name, fn in launch_counters().items()}
