"""Training configuration (port of ``graphs4cfd_tpu/training/config.py``).

Every field and default of the JAX package's ``TrainConfig``, with
dict-style access.  ``checkpoint_format="orbax"`` is refused at
construction (Orbax is a JAX library).  ``mixed_precision=True`` makes
``fit`` train with ``model.compute_dtype = torch.bfloat16`` (the bf16
policy).  ``devices`` (data parallelism) and ``graph_devices`` (graph
parallelism) make ``fit`` train on a (devices, graph_devices) mesh of the
ranks of the default process group, every rank calling ``fit``; ``fit``
raises before training when the group does not have that many ranks, or
when ``graph_devices > 1`` asks for what graph parallelism does not run
yet (a family other than MuS-GNN, or bf16).
"""
from __future__ import annotations

from typing import Callable, List, Optional, Union


class TrainConfig:
    """Plain config object with dict-style access.

    name, folder, checkpoint (resume path), tensor_board (metric log dir),
    chk_interval, training_loss, validation_loss, epochs, num_steps
    (rollout curriculum: int or increasing list), add_steps
    ({'tolerance', 'loss'}), batch_size, lr, grad_clip ({'epoch', 'limit'}
    or None), scheduler ({'factor', 'patience', 'loss'} or None), stopping
    (lr floor), mixed_precision, device (kept for the reference's surface:
    ``fit`` runs on the device of the model's parameters), seed, devices,
    graph_devices, checkpoint_format.
    """

    def __init__(self,
                 name: str,
                 folder: str = "./",
                 checkpoint: Optional[str] = None,
                 tensor_board: Optional[str] = None,
                 chk_interval: int = 1,
                 training_loss: Callable = None,
                 validation_loss: Callable = None,
                 epochs: int = 1,
                 num_steps: Union[int, List[int]] = [1],
                 add_steps: dict = {"tolerance": 0, "loss": "training"},
                 batch_size: int = 1,
                 lr: float = 1e-3,
                 grad_clip: Optional[dict] = None,
                 scheduler: Optional[dict] = None,
                 stopping: float = 0.0,
                 mixed_precision: bool = False,
                 device=None,
                 seed: int = 0,
                 devices: int = 1,
                 graph_devices: int = 1,
                 checkpoint_format: str = "pickle"):
        if checkpoint_format not in ("pickle", "orbax"):
            raise ValueError(
                f"checkpoint_format must be 'pickle' or 'orbax', got "
                f"{checkpoint_format!r}")
        if checkpoint_format == "orbax":
            raise ValueError("checkpoint_format='orbax' is not available in "
                             "the PyTorch port (Orbax is a JAX library); "
                             "use 'pickle'")
        self.name = name
        self.folder = folder
        self.checkpoint = checkpoint
        self.tensor_board = tensor_board
        self.chk_interval = chk_interval
        self.training_loss = training_loss
        self.validation_loss = validation_loss
        self.epochs = epochs
        self.num_steps = ([num_steps] if isinstance(num_steps, int)
                          else list(num_steps))
        self.add_steps = add_steps
        self.batch_size = batch_size
        self.lr = lr
        self.grad_clip = grad_clip
        self.scheduler = scheduler
        self.stopping = stopping
        self.mixed_precision = mixed_precision
        self.device = device
        self.seed = seed
        self.devices = devices
        self.graph_devices = graph_devices
        self.checkpoint_format = checkpoint_format

    def __repr__(self):
        return repr(self.__dict__)

    def __getitem__(self, key):
        return self.__dict__.get(key)
