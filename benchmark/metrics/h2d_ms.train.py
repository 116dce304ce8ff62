"""``h2d_ms.train``: Mean ms of fit's host_to_device range (model.prepare_batch and Graph.from_numpy) in the profiled segment."""
from benchmark.readers import h2d_ms as read  # noqa: F401
