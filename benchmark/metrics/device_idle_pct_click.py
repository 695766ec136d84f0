"""Device (H100) in the click-to-dispersion cell: the idle share of
``device_idle_pct``, which there moves the tail of a click (``call_s_p95``)."""
from benchmark.metrics.device_idle_pct import read  # noqa: F401
