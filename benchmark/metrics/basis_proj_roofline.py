"""Kernel (``ops/sed_projection.py`` → ``csrc/sed_projection.cu``, 'parity')
in the basis cell: the projection stage's share of its roofline, in percent,
as ``proj_roofline`` reads it (the bound of every group's projection at its
own atoms, summed over the window's calls, over the device time of every
kernel but cuFFT's), here with a quarter of the atoms per launch."""
from benchmark.metrics.proj_roofline import read  # noqa: F401
