"""``plain_torch_ms.train``: Device ms per training step of the kernels that are not the port's, in the profiled segment."""
from benchmark.readers import plain_torch_ms as read  # noqa: F401
