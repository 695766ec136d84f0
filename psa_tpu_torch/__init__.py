"""psa_tpu_torch — phonon Spectral Energy Density analysis on PyTorch and CUDA.

The PyTorch port of :mod:`psa_tpu`'s SED main path: ``Trajectory`` →
``SEDCalculator`` (``get_k_path``/``get_k_grid``) → ``calculate`` over
k-chunks → chiral phase and iSED; and of the direct engine's on-device grid
reductions: ``calculate_kgrid_browse``, ``calculate_kgrid_peaks``,
``calculate_lt``, ``calculate_welch``, with group velocities and the
kinetic thermal conductivity on top of the peaks; the vibrational DOS;
and the out-of-core and on-disk path: groups larger than the device budget
stream from the host, sweeps checkpoint per k-chunk and resume, trajectory
files load through ``TrajectoryLoader`` (LAMMPS dump with a C parser,
extxyz, OUTCAR, H5MD), and ``sed_from_dump_streaming`` projects a dump
without holding it; the NPT family (a breathing cell, phases anchored in
fractional space) and the instantaneous-phase family (DSF and current
spectra, S(k), the intermediate scattering function and their self parts);
the k-independent observables (MSD, VACF, g(r) by brute and linked-cell
sweeps); and the command line, ``python -m psa_tpu_torch.cli``, with its
configuration schema (YAML or JSON) and plots (matplotlib and PyYAML are
imported only where a figure is drawn or a YAML file is read).
The projection runs, at the precision tier the calculator names, in
hand-written CUDA kernels (``csrc/sed_projection.cu`` at 'parity',
``csrc/sed_projection_tiers.cu`` at 'balanced' and 'fast', built with
``nvcc`` at first use) on a GPU, and in their plain PyTorch versions on CPU
tensors;
the reductions are torch ops on the same device.  This package imports
``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from .core.trajectory import Trajectory
from .core.sed import SED, average_seds
from .core.calculator import SEDCalculator
from .core.streaming import sed_from_dump_streaming
from .io.loader import TrajectoryLoader
from .io.writer import TrajectoryWriter, out_to_qdump
from .utils.config_manager import ConfigManager
from .utils.helpers import parse_direction
from .visualization import SEDPlotter

__all__ = ["Trajectory", "SED", "average_seds", "SEDCalculator", "TrajectoryLoader",
           "TrajectoryWriter", "out_to_qdump", "parse_direction", "sed_from_dump_streaming",
           "ConfigManager", "SEDPlotter", "__version__"]
