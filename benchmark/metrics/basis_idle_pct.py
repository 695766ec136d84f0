"""Device (H100) in the basis cell: the share of the traced window in which
no kernel, copy or memset ran, in percent, as ``device_idle_pct`` reads it."""
from benchmark.metrics.device_idle_pct import read  # noqa: F401
