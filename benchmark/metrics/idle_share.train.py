"""``idle_share.train``: Share of the profiled segment's wall time in which no kernel or copy ran on the card, in %."""
from benchmark.readers import idle_share as read  # noqa: F401
