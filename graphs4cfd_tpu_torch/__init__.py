"""PyTorch/CUDA port of graphs4cfd_tpu for NVIDIA Hopper (H100).

Slice 1: the MuS-GNN forward pass and its ``solve`` rollout, the host
graph pipeline it needs (numpy), and two hand-written CUDA kernels, the
fused MLP chain (``ops.fused_mlp``) and the fused GN block
(``ops.gn_block``).  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.

Importing the package imports no submodule and builds nothing: the kernels
are compiled on their first CUDA call.
"""
