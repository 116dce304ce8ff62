"""PyTorch/CUDA port of graphs4cfd_tpu for NVIDIA Hopper (H100).

What a user's script calls, under the JAX package's names: the MuS-GNN,
REMuS-GNN and gMuS-GNN families (``nn``) with ``solve``, ``fit``,
``TrainConfig``, ``load_model`` and the pretrained tables; the runtime
(``training``: the training step, the plateau schedule, metrics, ``.chk``
checkpoints both ways and the reference-checkpoint converter); the HDF5
datasets (``datasets``); the host graph pipeline and augmentation
transforms (``transforms``, numpy and a C++ helper for k-NN and Guillard
coarsening, ``native``); ``DataLoader`` and ``collate`` (``loader``);
``metrics``; ``utils``; MuS-GNN graph parallelism over
``torch.distributed`` (``parallel``); and the hand-written CUDA kernels
under ``csrc/``: the fused MLP chain (``ops.fused_mlp``), the fused GN
block (``ops.gn_block``), their backwards, the sorted segment sum
(``ops.segment``) and the row gather (``ops.gather``), each for f32 and,
under the bf16 policy (``GNN(compute_dtype=torch.bfloat16)``,
``TrainConfig(mixed_precision=True)``), for bf16 activations.  Entry
points run on ``device="cuda"`` unless the caller asks for the CPU.

``import graphs4cfd_tpu_torch as gfd`` imports no submodule and builds
nothing: ``gfd.nn``, ``gfd.transforms``, ``gfd.datasets``, ... and
``gfd.DataLoader`` import on first access, the C++ helper is compiled at
its first call and the CUDA kernels at their first CUDA call.
"""

__version__ = "0.1.0"

_SUBMODULES = ("nn", "transforms", "datasets", "loader", "metrics",
               "training", "parallel", "utils", "ops")


def __getattr__(name):
    if name in _SUBMODULES:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name == "DataLoader":
        from .loader import DataLoader
        return DataLoader
    if name == "Graph":
        from .graph import Graph
        return Graph
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
