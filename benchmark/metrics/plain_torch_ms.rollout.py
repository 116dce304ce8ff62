"""``plain_torch_ms.rollout``: Device ms per rollout step of the kernels that are not the port's, in the profiled request."""
from benchmark.readers import plain_torch_ms as read  # noqa: F401
