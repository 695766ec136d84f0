"""H5MD trajectory reader (the HDF5 MD-interchange standard).

Carried over from :mod:`psa_tpu.io.h5md`; ``h5py`` is imported only when a
file is read.

Covers the format LAMMPS's ``dump h5md``, ESPResSo, and HOOMD emit — which
the reference could only reach through OVITO's importer (reference:
src/psa/io/loader.py:81-361).  Layout (de Buyl, Colberg & Höfling, H5MD
v1.x)::

    /particles/<group>/position/value        (n_t, N, 3)
    /particles/<group>/position/{step,time}  optional
    /particles/<group>/velocity/value        (n_t, N, 3), optional
    /particles/<group>/species[/value]       (N,) or (n_t, N), optional
    /particles/<group>/mass[/value]          (N,), optional
    /particles/<group>/box/edges[/value]     (3,), (3, 3), or time-dependent

Time-independent elements may be stored as plain datasets (no ``value``
child); both spellings are accepted.  For a time-dependent box, the frame-0
cell is used (the SED engine assumes a fixed box, like the reference) with a
logged warning.  ``h5py`` is an optional dependency — the loader raises a
clear error when it is missing.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)


def _fixed_or_value(node, name: str):
    """(dataset, time_dependent) for ``name`` whether stored
    time-independent (plain dataset) or time-dependent (group with a
    ``value`` child); (None, False) when absent.  The SPELLING decides
    time-dependence — H5MD prepends a frame axis to ``value`` datasets."""
    if name not in node:
        return None, False
    item = node[name]
    if hasattr(item, 'keys') and 'value' in item:
        return item['value'], True
    return (item if hasattr(item, 'shape') else None), False


def _box_matrix(edges: np.ndarray) -> np.ndarray:
    """H5MD box edges -> 3x3 cell matrix, columns = cell vectors.

    A (3,) vector is an orthorhombic diagonal; a (3, 3) matrix stores the
    cell vectors as ROWS (H5MD convention) and is transposed into this
    package's column convention.
    """
    edges = np.asarray(edges, dtype=np.float64)
    if edges.shape == (3,):
        return np.diag(edges).astype(np.float32)
    if edges.shape == (3, 3):
        return edges.T.astype(np.float32)
    raise ValueError(f"H5MD box edges have shape {edges.shape}; "
                     "expected (3,) or (3, 3)")


def read_h5md(filepath: Path, particles_group: Optional[str] = None,
              unwrap: bool = False, with_boxes: bool = False
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                         np.ndarray, Optional[np.ndarray]]:
    """Read an H5MD file into (positions, velocities, types, timesteps,
    box_matrix, masses) — the same tuple as the LAMMPS reader (+ masses).
    ``with_boxes`` appends per-frame (n_t, 3, 3) cell matrices (or None
    when the box is fixed) for NPT runs.

    Args:
        filepath: path to the .h5/.h5md file.
        particles_group: name under ``/particles`` (default: the first group,
            alphabetically, that has a ``position``).
        unwrap: unwrap periodic positions across frames.  An ``image``
            element, when present, gives the EXACT unwrap (r + H·image);
            otherwise minimum-image accumulation is used (same as the
            LAMMPS reader).
    """
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            "Reading H5MD trajectories requires the h5py package, which is not "
            "installed."
        ) from e

    with h5py.File(filepath, 'r') as f:
        if 'particles' not in f:
            raise ValueError(f"{filepath}: no /particles group (not H5MD?)")
        particles = f['particles']
        if particles_group is None:
            candidates = [g for g in sorted(particles.keys())
                          if 'position' in particles[g]]
            if not candidates:
                raise ValueError(f"{filepath}: no particles group with a "
                                 "position element")
            particles_group = candidates[0]
        if particles_group not in particles:
            raise ValueError(f"{filepath}: no /particles/{particles_group}")
        grp = particles[particles_group]

        pos_ds, _ = _fixed_or_value(grp, 'position')
        if pos_ds is None:
            raise ValueError(f"{filepath}: /particles/{particles_group} has "
                             "no position data")
        positions = np.asarray(pos_ds, dtype=np.float32)
        if positions.ndim != 3 or positions.shape[2] != 3:
            raise ValueError(f"{filepath}: position has shape "
                             f"{positions.shape}; expected (n_t, N, 3)")
        n_t, n_atoms = positions.shape[:2]

        vel_ds, _ = _fixed_or_value(grp, 'velocity')
        if vel_ds is not None:
            velocities = np.asarray(vel_ds, dtype=np.float32)
            if velocities.shape != positions.shape:
                raise ValueError(f"{filepath}: velocity shape "
                                 f"{velocities.shape} != position shape")
        else:
            velocities = np.zeros_like(positions)
            logger.warning("No velocity data found in %s. Velocities set to "
                           "zero.", filepath)

        sp_ds, _ = _fixed_or_value(grp, 'species')
        if sp_ds is not None:
            species = np.asarray(sp_ds)
            if species.ndim == 2:           # time-dependent: use frame 0
                species = species[0]
            types = species.astype(np.int32)
            if types.shape != (n_atoms,):
                raise ValueError(f"{filepath}: species shape mismatch")
        else:
            types = np.ones(n_atoms, dtype=np.int32)

        mass_ds, _ = _fixed_or_value(grp, 'mass')
        masses = None
        if mass_ds is not None:
            masses = np.asarray(mass_ds, dtype=np.float64)
            if masses.ndim == 2:
                masses = masses[0]

        if 'box' not in grp:
            raise ValueError(f"{filepath}: no box element")
        edges_ds, edges_timedep = _fixed_or_value(grp['box'], 'edges')
        if edges_ds is None:
            raise ValueError(f"{filepath}: box has no edges")
        edges = np.asarray(edges_ds)
        box_matrices = None
        if edges_timedep:
            # value datasets carry a leading frame axis: (n_t', 3) or
            # (n_t', 3, 3) — fixed-cell engines use the frame-0 cell (like
            # the reference); per-frame cells are kept on
            # Trajectory.box_matrices for the NPT path when they vary and
            # align with the position frames.
            if edges.ndim not in (2, 3) or edges.shape[-1] != 3:
                raise ValueError(f"{filepath}: time-dependent box edges have "
                                 f"shape {edges.shape}; expected (n_t, 3) or "
                                 "(n_t, 3, 3)")
            if not np.allclose(edges, edges[0]):
                if edges.shape[0] == n_t:
                    box_matrices = np.stack(
                        [_box_matrix(e) for e in edges]).astype(np.float32)
                    logger.info("Per-frame box found in %s (NPT run); kept "
                                "on Trajectory.box_matrices, fixed-cell "
                                "engines use frame 0.", filepath)
                else:
                    logger.warning("Box changes across frames in %s (NPT "
                                   "run?) but its %d box frames don't match "
                                   "%d position frames; using the frame-0 "
                                   "cell.", filepath, edges.shape[0], n_t)
            edges = edges[0]
        box_matrix = _box_matrix(edges)

        image_ds, _ = _fixed_or_value(grp, 'image')
        images = (np.asarray(image_ds, dtype=np.float64)
                  if unwrap and image_ds is not None else None)
        if images is not None and images.shape != positions.shape:
            raise ValueError(f"{filepath}: image shape {images.shape} != "
                             "position shape")

        step_ds = None
        if 'position' in grp and hasattr(grp['position'], 'keys'):
            step_ds = grp['position'].get('step')
        timesteps = (np.asarray(step_ds, dtype=np.int64) if step_ds is not None
                     and len(step_ds) == n_t
                     else np.arange(n_t, dtype=np.int64))

    if unwrap and n_t > 1:
        if images is not None:       # exact: r_unwrapped = r + H @ image
            h = box_matrix.astype(np.float64)
            positions = (positions.astype(np.float64)
                         + images @ h.T).astype(np.float32)
        else:
            from .lammps import unwrap_positions
            positions = unwrap_positions(positions, box_matrix)
    if with_boxes:
        return (positions, velocities, types, timesteps, box_matrix, masses,
                box_matrices)
    return positions, velocities, types, timesteps, box_matrix, masses
