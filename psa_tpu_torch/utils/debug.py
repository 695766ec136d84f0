"""Developer-mode numerics sanitizers.

Counterpart of :mod:`psa_tpu.utils.debug`, same names and arguments.  The
JAX package flips ``jax_debug_nans``/``jax_debug_infs``, which recompile
every program with result checks.  PyTorch has no such switch, so the
port's mode checks where its numbers surface:

  * the outputs of the projection kernel's wrapper
    (:func:`psa_tpu_torch.ops.sed_projection.sed_projection`, kernel and
    plain version alike), with ``torch.isnan``/``torch.isinf`` on the device;
  * every result the calculator and the gridded engine bring back to the
    host (``calculator._to_host`` and the
    :class:`psa_tpu_torch.utils.transfer.DeviceToHost` readback), with
    NumPy on the host copy.

A hit raises ``FloatingPointError`` naming the call.  ``disable_jit`` is
accepted and ignored: nothing in the port is jitted, every op already runs
one by one.

Off (the default), a hook is one read of the module attribute
:data:`active`: no tensor op, no synchronization.  On, the device check
synchronizes once per kernel launch — use in development, never in
production sweeps.  The mode is process-wide, not per thread.
"""
from __future__ import annotations

import contextlib
import logging
import sys

logger = logging.getLogger(__name__)

#: True while NaN or Inf trapping is on; the hooks read this and nothing else.
active = False
_nans = False
_infs = False


def enable_debug_mode(nans: bool = True, infs: bool = True,
                      disable_jit: bool = False) -> None:
    """Trap NaNs/Infs in kernel outputs and results (see the module text).

    ``disable_jit`` is accepted for the JAX package's signature and ignored.
    """
    global active, _nans, _infs
    _nans, _infs = bool(nans), bool(infs)
    active = _nans or _infs
    logger.info("Debug mode: nans=%s infs=%s disable_jit=%s (ignored)", nans, infs, disable_jit)


def disable_debug_mode() -> None:
    global active, _nans, _infs
    active = _nans = _infs = False


@contextlib.contextmanager
def debug_numerics(nans: bool = True, infs: bool = True):
    """Context-scoped NaN/Inf trapping."""
    enable_debug_mode(nans=nans, infs=infs)
    try:
        yield
    finally:
        disable_debug_mode()


def caller(depth: int = 1) -> str:
    """Name of the call ``depth`` frames above the one that asks: from there
    up, the first function with a public name, so a result that a private
    helper reads back (the calculator's shared k-chunk loop) names the
    surface that asked for it."""
    frame = sys._getframe(depth + 1)
    while frame.f_code.co_name[0] in '_<' and frame.f_back is not None:
        frame = frame.f_back
    return frame.f_code.co_name


def _raise(where: str, kind: str, index: int) -> None:
    raise FloatingPointError(f"{kind} in output {index} of {where} (debug_numerics)")


def check_tensors(where: str, tensors) -> None:
    """Raise if a tensor holds what the mode traps (synchronizes the device)."""
    import torch
    for i, t in enumerate(tensors):
        if not (t.is_floating_point() or t.is_complex()):
            continue
        if _nans and bool(torch.isnan(t).any()):
            _raise(where, 'NaN', i)
        if _infs and bool(torch.isinf(t).any()):
            _raise(where, 'Inf', i)


def check_arrays(where: str, arrays) -> None:
    """Raise if a host array holds what the mode traps."""
    import numpy as np
    for i, a in enumerate(arrays):
        if not np.issubdtype(a.dtype, np.inexact):
            continue
        if _nans and np.isnan(a).any():
            _raise(where, 'NaN', i)
        if _infs and np.isinf(a).any():
            _raise(where, 'Inf', i)
