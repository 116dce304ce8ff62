"""``kernel_roofline.rollout``: Least time of the work of the port's kernels (benchmark/counts) over their device time, the profiled request's steps, in %."""
from benchmark.readers import kernel_roofline as read  # noqa: F401
