"""``mfu.train``: The model's products of the window's training steps (3x the forward) over the window's seconds times the bf16 or TF32 peak, in %."""
from benchmark.readers import mfu as read  # noqa: F401
