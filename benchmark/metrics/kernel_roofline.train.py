"""``kernel_roofline.train``: Least time of the work of the port's kernels (benchmark/counts) over their device time, training steps of the profiled segment, in %."""
from benchmark.readers import kernel_roofline as read  # noqa: F401
