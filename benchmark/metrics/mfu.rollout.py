"""``mfu.rollout``: The model's products of the window's rollout steps over the window's seconds times the bf16 or TF32 peak, in %."""
from benchmark.readers import mfu as read  # noqa: F401
