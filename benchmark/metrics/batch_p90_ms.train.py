"""``batch_p90_ms.train``: The 90th percentile of the device intervals between fit's asks for a batch, over the window."""
from benchmark.readers import batch_p90_ms as read  # noqa: F401
