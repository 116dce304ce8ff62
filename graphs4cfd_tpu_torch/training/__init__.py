"""The runtime: rollout, the training step, ``fit`` with its config,
schedule and metric writer, and checkpoints in the JAX package's format
(with the converter from the original graphs4cfd's)."""
from .checkpoint import (adam_state_from_checkpoint,
                         convert_reference_checkpoint,
                         import_torch_state_dict, load_checkpoint,
                         load_weights, save_checkpoint)
from .config import TrainConfig
from .metrics_writer import MetricsWriter
from .rollout import solve
from .schedule import ReduceLROnPlateau
from .trainer import (AdamState, adam_init, adam_state_from_jax,
                      adam_update_, fit, make_train_step, make_val_step)

__all__ = ["load_checkpoint", "load_weights", "save_checkpoint",
           "convert_reference_checkpoint", "import_torch_state_dict",
           "adam_state_from_checkpoint", "TrainConfig", "MetricsWriter",
           "ReduceLROnPlateau", "solve", "AdamState", "adam_init",
           "adam_state_from_jax", "adam_update_", "fit", "make_train_step",
           "make_val_step"]
