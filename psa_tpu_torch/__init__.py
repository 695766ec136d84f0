"""psa_tpu_torch — phonon Spectral Energy Density analysis on PyTorch and CUDA.

The PyTorch port of :mod:`psa_tpu`'s SED main path: ``Trajectory`` →
``SEDCalculator`` (``get_k_path``/``get_k_grid``) → ``calculate`` over
k-chunks → chiral phase and iSED.  The projection runs in a hand-written
CUDA kernel (``csrc/sed_projection.cu``, built with ``nvcc`` at first use)
on a GPU, and in its plain PyTorch version on CPU tensors.  This package
imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from .core.trajectory import Trajectory
from .core.sed import SED
from .core.calculator import SEDCalculator
from .io.writer import out_to_qdump
from .utils.helpers import parse_direction

__all__ = ["Trajectory", "SED", "SEDCalculator", "out_to_qdump", "parse_direction",
           "__version__"]
