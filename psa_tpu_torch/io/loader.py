"""Trajectory loading with .npy sidecar caching.

Carried over from :mod:`psa_tpu.io.loader` (NumPy only; OVITO and h5py are
imported only when their formats are read).

Cache layout is byte-compatible with the reference loader (reference:
src/psa/io/loader.py:48-79, 363-387): ``<stem>.{positions,velocities,types,
box_matrix}.npy`` next to the input file, plus ``mean_positions`` /
``displacements`` sidecars on save.  The parsing backend differs by design:

  * default — the native vectorized LAMMPS/OUTCAR readers in
    :mod:`psa_tpu_torch.io.lammps` (no OVITO, no subprocess isolation needed: the
    reference's subprocess path existed only to keep OVITO's Qt runtime away
    from Tkinter, loader.py:98-109);
  * optional — OVITO, if installed, for exotic formats (``backend='ovito'``).
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

from ..core.trajectory import Trajectory, make_box_arrays
from ..utils.profiling import progress_iter
from . import lammps as lammps_io

logger = logging.getLogger(__name__)


_VALID_FORMATS = ('auto', 'lammps', 'vasp_outcar', 'extxyz', 'h5md')
_CACHE_PARTS = ('positions', 'velocities', 'types', 'box_matrix')


class TrajectoryLoader:
    """Load an MD trajectory file into a :class:`Trajectory`.

    Args:
        filename: path to a LAMMPS dump, VASP OUTCAR, extended-XYZ, or H5MD
            trajectory.
        dt: timestep between stored frames, in ps.
        file_format: 'auto' (by extension), 'lammps', 'vasp_outcar',
            'extxyz', or 'h5md'.
        backend: 'native' (default) or 'ovito' (requires the ovito package).
        unwrap: unwrap periodic positions across frames (native backend).
    """

    def __init__(self, filename: str, dt: float = 1.0, file_format: str = 'auto',
                 backend: str = 'native', unwrap: bool = True, mmap: bool = False,
                 progress=None):
        """``progress``: optional ``(done, total) -> None`` callback fired
        during slow per-frame parse loops (OVITO backend); without it a tqdm
        bar is shown when tqdm is available (reference loader.py:313)."""
        if dt <= 0:
            raise ValueError("dt (timestep size) must be positive.")
        self.filepath = Path(filename)
        if not self.filepath.exists():
            raise FileNotFoundError(f"Trajectory file not found: {filename}")
        self.dt = dt
        if file_format not in _VALID_FORMATS:
            raise ValueError(f"Unsupported file format. Must be one of: {list(_VALID_FORMATS)}")
        self.file_format = file_format
        if backend not in ('native', 'ovito'):
            raise ValueError("backend must be 'native' or 'ovito'")
        self.backend = backend
        self.unwrap = unwrap
        self.mmap = mmap
        self.progress = progress

    # -- format detection (reference loader.py:41-46) ----------------------
    def _detect_file_format(self) -> str:
        if self.file_format != 'auto':
            return self.file_format
        suffix = self.filepath.suffix.lower()
        if suffix == '.outcar':
            return 'vasp_outcar'
        if suffix in ('.xyz', '.extxyz'):
            return 'extxyz'
        if suffix in ('.h5', '.hdf5', '.h5md'):
            return 'h5md'
        return 'lammps'

    def _cache_files(self) -> dict:
        stem = self.filepath.parent / self.filepath.stem
        return {p: stem.with_suffix(f'.{p}.npy') for p in _CACHE_PARTS}

    # -- public API ---------------------------------------------------------
    def load(self) -> Trajectory:
        """Load via the .npy cache fast path, else parse and cache."""
        npy_files = self._cache_files()
        if all(f.exists() for f in npy_files.values()):
            logger.info("Loading trajectory from cached .npy files for %s.", self.filepath.name)
            try:
                # mmap mode keeps pod-scale trajectories on disk; the engine's
                # atom-streaming path reads slices on demand.
                mode = 'r' if self.mmap else None
                pos = np.load(npy_files['positions'], mmap_mode=mode)
                vel = np.load(npy_files['velocities'], mmap_mode=mode)
                atom_types = np.load(npy_files['types'])
                box_mat = np.load(npy_files['box_matrix'])
                if box_mat.shape != (3, 3):
                    raise ValueError(f"Cached box_matrix has shape {box_mat.shape}, expected (3,3).")
                stem = self.filepath.parent / self.filepath.stem
                masses_file = stem.with_suffix('.masses.npy')
                masses = np.load(masses_file) if masses_file.exists() else None
                boxes_file = stem.with_suffix('.box_matrices.npy')
                boxes = (np.load(boxes_file, mmap_mode=mode)
                         if boxes_file.exists() else None)
                box_len, box_tilt = make_box_arrays(box_mat)
                ts = np.arange(pos.shape[0], dtype=np.float32) * self.dt
                return Trajectory(pos, vel, atom_types, ts, box_matrix=box_mat,
                                  box_lengths=box_len, box_tilts=box_tilt,
                                  dt_ps=self.dt, masses=masses,
                                  box_matrices=boxes)
            except Exception as e:
                logger.warning("Loading .npy cache failed: %s. Falling back to parser.", e)

        logger.info("No complete .npy cache for %s; parsing.", self.filepath.name)
        traj = self._parse()
        try:
            self.save_trajectory_npy(traj)
        except Exception as e:
            logger.warning("Failed to save .npy cache for %s: %s", self.filepath.name, e)
        return traj

    def _parse(self) -> Trajectory:
        if self.backend == 'ovito':
            return self._load_via_ovito()
        fmt = self._detect_file_format()
        masses = None
        boxes = None
        if fmt == 'lammps':
            pos, vel, types, steps, box, masses, boxes = \
                lammps_io.read_lammps_dump(self.filepath, unwrap=self.unwrap,
                                           with_masses=True, with_boxes=True)
        elif fmt == 'extxyz':
            pos, vel, types, steps, box = lammps_io.read_extxyz(self.filepath)
        elif fmt == 'h5md':
            from . import h5md as h5md_io
            pos, vel, types, steps, box, masses, boxes = h5md_io.read_h5md(
                self.filepath, unwrap=self.unwrap, with_boxes=True)
        else:
            pos, vel, types, steps, box = lammps_io.read_vasp_outcar(self.filepath)
        box_len, box_tilt = make_box_arrays(box)
        ts = np.arange(pos.shape[0], dtype=np.float32) * self.dt
        logger.info("Trajectory '%s' loaded natively: %d frames, %d atoms.",
                    self.filepath.name, pos.shape[0], pos.shape[1])
        return Trajectory(pos, vel, types, ts, box_matrix=box,
                          box_lengths=box_len, box_tilts=box_tilt, dt_ps=self.dt,
                          masses=masses, box_matrices=boxes)

    def _load_via_ovito(self) -> Trajectory:
        """Optional OVITO backend for formats the native parsers don't cover."""
        try:
            from ovito.io import import_file
            from ovito.modifiers import UnwrapTrajectoriesModifier
        except ImportError as e:
            raise ImportError(
                "backend='ovito' requested but the ovito package is not installed; "
                "use the default native backend for LAMMPS/OUTCAR files.") from e

        fmt = self._detect_file_format()
        ovito_fmt = {'lammps': 'lammps/dump', 'vasp_outcar': 'vasp/outcar'}.get(fmt)
        pipeline = import_file(str(self.filepath), input_format=ovito_fmt)
        if self.unwrap:
            pipeline.modifiers.append(UnwrapTrajectoriesModifier())
        n_frames = pipeline.source.num_frames
        if n_frames == 0:
            raise ValueError("OVITO: 0 frames in trajectory.")
        frame0 = pipeline.compute(0)
        n_atoms = len(frame0.particles.positions)
        has_vel = getattr(frame0.particles, 'velocities', None) is not None

        pos_all = np.zeros((n_frames, n_atoms, 3), dtype=np.float32)
        vel_all = np.zeros((n_frames, n_atoms, 3), dtype=np.float32)
        h_matrix = np.array(frame0.cell.matrix, dtype=np.float32)[:3, :3]
        for i in progress_iter(range(n_frames), total=n_frames,
                               desc=f"OVITO {self.filepath.name}", callback=self.progress):
            data = pipeline.compute(i)
            pos_all[i] = np.array(data.particles.positions, dtype=np.float32)
            if has_vel:
                vel_all[i] = np.array(data.particles.velocities, dtype=np.float32)
        types_data = getattr(frame0.particles, 'particle_types', None)
        types = (np.array(types_data, dtype=np.int32) if types_data is not None
                 and len(types_data) == n_atoms else np.ones(n_atoms, dtype=np.int32))

        box_len, box_tilt = make_box_arrays(h_matrix)
        ts = np.arange(n_frames, dtype=np.float32) * self.dt
        return Trajectory(pos_all, vel_all, types, ts, box_matrix=h_matrix,
                          box_lengths=box_len, box_tilts=box_tilt, dt_ps=self.dt)

    def save_trajectory_npy(self, traj: Trajectory) -> None:
        """Write the .npy sidecar cache (skips if complete; reference
        loader.py:363-387, including mean_positions/displacements extras)."""
        npy_files = self._cache_files()
        if all(f.exists() for f in npy_files.values()):
            logger.info(".npy cache for %s exists; skipping save.", self.filepath.name)
            return
        cache_stem = self.filepath.parent / self.filepath.stem
        cache_stem.parent.mkdir(parents=True, exist_ok=True)
        np.save(npy_files['positions'], traj.positions)
        np.save(npy_files['velocities'], traj.velocities)
        np.save(npy_files['types'], traj.types)
        np.save(npy_files['box_matrix'], traj.box_matrix)
        if traj.masses is not None:   # optional 5th sidecar; absence = None
            np.save(cache_stem.with_suffix('.masses.npy'), traj.masses)
        if traj.box_matrices is not None:  # optional NPT sidecar
            np.save(cache_stem.with_suffix('.box_matrices.npy'),
                    traj.box_matrices)
        mean_pos = np.mean(traj.positions, axis=0)
        np.save(cache_stem.with_suffix('.mean_positions.npy'), mean_pos)
        np.save(cache_stem.with_suffix('.displacements.npy'),
                traj.positions - mean_pos[None, :, :])
        logger.info("Trajectory data for %s saved to .npy.", self.filepath.name)
