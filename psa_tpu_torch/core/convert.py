"""Carry a JAX-package calculator's host state into the port.

Reads the attributes of a ``psa_tpu.core.calculator.SEDCalculator`` by duck
typing (this module never imports ``psa_tpu``), so both packages compute
from identical NumPy state: the trajectory, the lattice, the float64 mean
positions and the options.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

from .calculator import SEDCalculator
from .trajectory import Trajectory

_TRAJ_FIELDS = ('positions', 'velocities', 'types', 'timesteps', 'box_matrix',
                'box_lengths', 'box_tilts', 'dt_ps', 'masses', 'box_matrices')


def from_reference_calculator(ref, device: Union[str, torch.device] = 'cuda'
                              ) -> SEDCalculator:
    """Port :class:`SEDCalculator` with ``ref``'s trajectory, lattice
    (a1..a3, b1..b3), float64 mean positions (Cartesian, and fractional
    where ``ref`` has computed them), phase anchor, ``phase_mode``,
    ``use_displacements``, ``mass_weighted``, ``precision``,
    ``max_device_bytes`` and ``dt_ps``."""
    traj = Trajectory(**{f: getattr(ref.traj, f) for f in _TRAJ_FIELDS})
    calc = SEDCalculator.__new__(SEDCalculator)
    calc._configure(traj, ref.use_displacements, ref.precision, ref.max_device_bytes,
                    ref.mass_weighted, device, ref.phase_mode)
    calc.dt_ps = ref.dt_ps
    for name in ('a1', 'a2', 'a3', 'b1', 'b2', 'b3'):
        setattr(calc, name, np.array(getattr(ref, name)))
    calc.recip_vecs_prim = np.vstack([calc.b1, calc.b2, calc.b3]).astype(np.float32)
    cartesian = ref._mean_pos64 if ref._phase_anchor == 'fractional' else ref.mean_positions64
    if cartesian is not None:
        calc._mean_pos64 = np.array(cartesian, dtype=np.float64)
    if ref._frac_mean64 is not None:
        calc._frac_mean64 = np.array(ref._frac_mean64, dtype=np.float64)
    calc._phase_anchor = ref._phase_anchor
    return calc
