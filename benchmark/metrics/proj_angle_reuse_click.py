"""Kernel in the click-to-dispersion cell: ``proj_angle_reuse``, which there
moves the tail of a click (``call_s_p95``)."""
from benchmark.metrics.proj_angle_reuse import read  # noqa: F401
