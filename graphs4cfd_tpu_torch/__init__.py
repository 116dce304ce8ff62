"""PyTorch/CUDA port of graphs4cfd_tpu for NVIDIA Hopper (H100).

The MuS-GNN, REMuS-GNN and gMuS-GNN forward passes, their ``solve``
rollouts, training steps and pretrained tables, the runtime
(``training``: ``fit``, ``TrainConfig``, the plateau schedule, metrics,
``.chk`` checkpoints both ways), ``loader.DataLoader``, ``metrics``,
``utils``, MuS-GNN graph parallelism over ``torch.distributed``
(``parallel``), the host graph pipeline they need (numpy), and the
hand-written CUDA kernels under ``csrc/``: the fused MLP
chain (``ops.fused_mlp``), the fused GN block (``ops.gn_block``), their
backwards, the sorted segment sum (``ops.segment``) and the row gather
(``ops.gather``), each for f32 and, under the bf16 policy
(``GNN(compute_dtype=torch.bfloat16)``, ``TrainConfig(mixed_precision=
True)``), for bf16 activations.  Entry points run on ``device="cuda"``
unless the caller asks for the CPU.

Importing the package imports no submodule and builds nothing: the kernels
are compiled on their first CUDA call.
"""
