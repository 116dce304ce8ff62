"""``launches_per_step.rollout``: Kernel launches the port counts (ops.launch_counts) in the window, per rollout step."""
from benchmark.readers import launches_per_step as read  # noqa: F401
