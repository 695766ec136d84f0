"""Spectral Energy Density (SED) result container with .npy persistence.

File-format compatible with the reference result layer (reference:
src/psa/core/sed.py:12-69): a SED saved by the reference loads here and vice
versa.  Two deliberate extensions over the reference:

  * optional ``dt_ps`` / ``trajectory_metadata`` fields — the reference CLI
    passed these kwargs to a SED that did not accept them (reference
    cli.py:143-151 vs sed.py:12-21); we accept them so that code path is valid.
  * ``save``/``load`` avoid the reference's ``Path.with_suffix`` pitfall, which
    clobbered the final dot-segment of base names like ``sed_1.00_0.00``
    (reference sed.py:29).  We append suffixes to the full name instead, while
    ``load`` still falls back to the reference naming for old files.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_REQUIRED = ('sed', 'freqs', 'k_points', 'k_vectors')
_OPTIONAL = ('k_grid_shape', 'phase')


def _sidecar(base_path: Path, suffix: str, legacy: bool = False) -> Path:
    """Path of one component file. ``legacy=True`` reproduces the reference's
    Path.with_suffix naming (which eats a trailing dot-segment of the stem)."""
    if legacy:
        return base_path.with_suffix(f'.{suffix}.npy')
    return base_path.parent / f"{base_path.name}.{suffix}.npy"


@dataclass
class SED:
    """SED result.

    Attributes:
        sed:       (n_freq, n_k, 3) complex64 amplitudes Φ_α(ω,k) in coherent
                   mode, or (n_freq, n_k) float32 summed intensities in
                   incoherent mode.
        freqs:     (n_freq,) frequencies in THz (signed, np.fft.fftfreq order).
        k_points:  (n_k,) k magnitudes for a path (empty for grids).
        k_vectors: (n_k, 3) full 3D k-vectors (2π/Å).
        k_grid_shape: (n_kx, n_ky) for 2D k-grids, None for paths.
        phase:     optional (n_freq, n_k) chiral phase map.
        is_complex: whether ``sed`` holds complex amplitudes.
        dt_ps:     optional originating timestep (extension; see module doc).
        trajectory_metadata: optional free-form provenance dict (extension).
    """
    sed: np.ndarray
    freqs: np.ndarray
    k_points: np.ndarray
    k_vectors: np.ndarray
    k_grid_shape: Optional[Tuple[int, ...]] = None
    phase: Optional[np.ndarray] = None
    is_complex: bool = True
    dt_ps: Optional[float] = None
    trajectory_metadata: Optional[Dict[str, Any]] = None

    @property
    def intensity(self) -> np.ndarray:
        """Intensity I(ω, k).

        Coherent storage: Σ_α |Φ_α|² over the trailing polarization axis
        (reference: sed.py:22-24).  Incoherent storage already IS the summed
        intensity and is returned as-is — the reference property reduced it
        over the k axis instead (a latent defect its own code never hits;
        deliberate fix, see module docstring)."""
        if not self.is_complex and self.sed.ndim == 2:
            return np.asarray(self.sed, dtype=np.float32)
        return np.sum(np.abs(self.sed) ** 2, axis=-1).astype(np.float32)

    def save(self, base_path: Path) -> None:
        """Persist as sibling ``<name>.<component>.npy`` files."""
        base_path = Path(base_path)
        base_path.parent.mkdir(parents=True, exist_ok=True)
        np.save(_sidecar(base_path, 'sed'), self.sed)
        np.save(_sidecar(base_path, 'freqs'), self.freqs)
        np.save(_sidecar(base_path, 'k_points'), self.k_points)
        np.save(_sidecar(base_path, 'k_vectors'), self.k_vectors)
        if self.k_grid_shape is not None:
            np.save(_sidecar(base_path, 'k_grid_shape'), np.array(self.k_grid_shape))
        if self.phase is not None:
            np.save(_sidecar(base_path, 'phase'), self.phase)
        logger.info("SED data saved: %s.*.npy", base_path.name)

    @staticmethod
    def load(base_path: Path) -> 'SED':
        """Load a SED saved by :meth:`save` (or by the reference layout)."""
        base_path = Path(base_path)

        legacy = False
        if not all(_sidecar(base_path, s).exists() for s in _REQUIRED):
            if all(_sidecar(base_path, s, legacy=True).exists() for s in _REQUIRED):
                legacy = True
            else:
                raise FileNotFoundError(f"Required SED files missing for base: {base_path.name}")

        def _load(suffix: str) -> np.ndarray:
            return np.load(_sidecar(base_path, suffix, legacy=legacy))

        sed_val = _load('sed')
        freqs_val = _load('freqs')
        k_points_val = _load('k_points')
        k_vectors_val = _load('k_vectors')

        phase_val = None
        phase_file = _sidecar(base_path, 'phase', legacy=legacy)
        if phase_file.exists():
            try:
                phase_val = np.load(phase_file)
            except Exception as e:  # corrupt sidecar should not kill the load
                logger.warning("Could not load phase data from %s: %s", phase_file.name, e)

        k_grid_shape_val = None
        kgs_file = _sidecar(base_path, 'k_grid_shape', legacy=legacy)
        if kgs_file.exists():
            try:
                k_grid_shape_val = tuple(map(int, np.load(kgs_file)))
            except Exception as e:
                logger.warning("Could not load k_grid_shape data from %s: %s", kgs_file.name, e)

        return SED(sed_val, freqs_val, k_points_val, k_vectors_val,
                   k_grid_shape=k_grid_shape_val, phase=phase_val,
                   is_complex=bool(np.iscomplexobj(sed_val)))
