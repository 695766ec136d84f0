"""SEDCalculator on PyTorch — the SED main path of :mod:`psa_tpu.core.calculator`.

Same public API and numbers as the JAX class for what is ported: lattice
setup, ``get_k_path``, ``get_k_grid``, ``calculate`` (coherent and
incoherent, velocities or displacements, optional mass weighting),
``calculate_chiral_phase`` and fixed-cell ``ised``.  Group bookkeeping and
k generation run on the host in NumPy; per (group, k-chunk) spectra run on
``device`` through :mod:`psa_tpu_torch.ops.spectral`, and each chunk's
result is copied back into a host array.

Not ported here (each raises ``NotImplementedError``; see ROADMAP.md): the
shard cache (``cache_dir``), groups larger than ``max_device_bytes`` (the
atom-streamed path), NPT iSED and iSED plotting.  The JAX class's other
public methods are absent.
"""
from __future__ import annotations

import logging
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import spectral
from ..utils.helpers import DirectionSpec, parse_direction
from .sed import SED
from .trajectory import Trajectory

logger = logging.getLogger(__name__)

_DEFAULT_MAX_DEVICE_BYTES = int(8e9)


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``device``; raises for CUDA when no card is present."""
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not "
                           "available; pass device='cpu' explicitly to run on the host")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    return dev


class SEDCalculator:
    """Spectral-energy-density engine over a :class:`Trajectory`.

    Args:
        traj: trajectory to analyze.
        nx, ny, nz: supercell counts defining primitive vectors a_i = L_i / n_i.
        use_displacements: project displacements u(t)=r(t)−r̄ instead of velocities.
        dt_ps: optional override of the trajectory timestep (deprecated in the
            reference, kept for compatibility).
        precision: 'parity' (IEEE float32 contraction; holds 1e-6 against the
            float64 oracle).  'balanced' and 'fast' are not ported yet.
        max_device_bytes: largest group (n_t·n_atoms·3·4 bytes) held on the device.
        mass_weighted: weight each atom's data by √m_a (requires ``traj.masses``).
        device: 'cuda' (default; raises when CUDA is absent) or 'cpu'.
    """

    def __init__(self, traj: Trajectory, nx: int, ny: int, nz: int,
                 use_displacements: bool = False, dt_ps: Optional[float] = None,
                 precision: str = 'parity',
                 max_device_bytes: int = _DEFAULT_MAX_DEVICE_BYTES,
                 mass_weighted: bool = False,
                 device: Union[str, torch.device] = 'cuda'):
        if not (nx > 0 and ny > 0 and nz > 0):
            raise ValueError("System dimensions (nx, ny, nz) must be positive.")
        self._configure(traj, use_displacements, precision, max_device_bytes,
                        mass_weighted, device)
        if dt_ps is not None:
            logger.warning("Explicitly providing dt_ps to SEDCalculator is deprecated; "
                           "it overrides the Trajectory's dt_ps.")
            self.dt_ps = dt_ps
        elif getattr(self.traj, 'dt_ps', None) is not None:
            self.dt_ps = self.traj.dt_ps
        else:
            raise ValueError("Timestep dt_ps not found in Trajectory object and not provided to SEDCalculator.")
        if self.dt_ps <= 0:
            raise ValueError("Timestep dt_ps must be positive.")

        # Primitive cell a_i = box row i / n_i; reciprocal b_i = 2π (a_j × a_k)/V
        # (reference sed_calculator.py:40-56).
        L1, L2, L3 = (self.traj.box_matrix[0, :], self.traj.box_matrix[1, :],
                      self.traj.box_matrix[2, :])
        self.a1, self.a2, self.a3 = L1 / nx, L2 / ny, L3 / nz
        if any(np.linalg.norm(v) < 1e-9 for v in (self.a1, self.a2, self.a3)):
            raise ValueError("One or more primitive vectors (a1,a2,a3) near zero. "
                             "Check nx,ny,nz or box matrix.")

        vol_prim = np.abs(np.dot(self.a1, np.cross(self.a2, self.a3)))
        if np.isclose(vol_prim, 0):
            mat_a = np.vstack([self.a1, self.a2, self.a3])
            if np.linalg.matrix_rank(mat_a) < 3 or np.isclose(np.linalg.det(mat_a), 0):
                raise ValueError(
                    f"Primitive cell vectors coplanar/collinear; volume zero ({vol_prim:.2e}).")
            logger.warning("Primitive cell volume very small (%.2e).", vol_prim)

        self.b1 = (2 * np.pi / vol_prim) * np.cross(self.a2, self.a3)
        self.b2 = (2 * np.pi / vol_prim) * np.cross(self.a3, self.a1)
        self.b3 = (2 * np.pi / vol_prim) * np.cross(self.a1, self.a2)
        self.recip_vecs_prim = np.vstack([self.b1, self.b2, self.b3]).astype(np.float32)

    def _configure(self, traj: Trajectory, use_displacements: bool, precision: str,
                   max_device_bytes: int, mass_weighted: bool,
                   device: Union[str, torch.device]) -> None:
        """Everything but the lattice and the timestep (shared with
        :func:`psa_tpu_torch.core.convert.from_reference_calculator`)."""
        spectral.check_precision(precision)
        if mass_weighted and traj.masses is None:
            raise ValueError("mass_weighted=True requires Trajectory.masses.")
        self.device = resolve_device(device)
        self.traj = traj
        self.use_displacements = use_displacements
        self.precision = precision
        self.max_device_bytes = max_device_bytes
        self.mass_weighted = mass_weighted
        # The lock guards the device cache: worker threads may call calculate()
        # concurrently.
        self._mean_pos64: Optional[np.ndarray] = None
        self._device_cache: Dict[bytes, tuple] = {}
        self._device_cache_order: List[bytes] = []
        self._cache_lock = threading.Lock()

    # ------------------------------------------------------------------
    # k-space generators (host side)
    # ------------------------------------------------------------------

    def get_k_path(self, direction_spec: DirectionSpec, bz_coverage: float, n_k: int,
                   lat_param: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
        """Linear k-path from Γ along ``direction_spec``.

        k extent defaults to the largest |b_i · k̂| projection (directional BZ
        coverage), falling back to 2π/|a1|, or 2π/lat_param when provided
        (reference sed_calculator.py:86-125).
        Returns (k_magnitudes (n_k,), k_vectors (n_k, 3)), float32.
        """
        k_dir_unit = parse_direction(direction_spec)

        if lat_param is None or lat_param <= 1e-6:
            projections = [abs(np.dot(k_dir_unit, b)) for b in (self.b1, self.b2, self.b3)]
            max_projection = max(projections)
            if max_projection > 1e-6:
                recip_extent = max_projection
                logger.info("Using directional reciprocal lattice projection (%.3f 2π/Å) for k-path.",
                            recip_extent)
            else:
                norm_a1 = np.linalg.norm(self.a1)
                if norm_a1 > 1e-6:
                    recip_extent = 2 * np.pi / norm_a1
                    logger.warning("Reciprocal projections too small, using |a1| fallback "
                                   "(%.3f Å → %.3f 2π/Å).", norm_a1, recip_extent)
                else:
                    raise ValueError("Invalid/small lattice_param for k-path & reciprocal "
                                     "projections too small for auto-detection.")
        else:
            recip_extent = 2 * np.pi / lat_param
            logger.info("Using provided lattice parameter (%.3f Å → %.3f 2π/Å) for k-path.",
                        lat_param, recip_extent)

        k_max_val = bz_coverage * recip_extent
        if n_k < 1:
            raise ValueError("n_k (k-points) must be >= 1.")
        if n_k > 1:
            k_mags = np.linspace(0, k_max_val, n_k, dtype=np.float32)
        else:
            k_mags = np.array([0.0 if np.isclose(k_max_val, 0) else k_max_val], dtype=np.float32)
        k_vecs = np.outer(k_mags, k_dir_unit).astype(np.float32)
        return k_mags, k_vecs

    def get_k_grid(self, plane: str, k_range_x: Tuple[float, float],
                   k_range_y: Tuple[float, float], n_kx: int, n_ky: int,
                   k_fixed_val: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
        """2D grid of 3D k-vectors on an axis-aligned plane.

        Row-major ordering with the FIRST range varying slowest (reference
        sed_calculator.py:127-180 and sed_plotter.py:683,752).

        Returns (empty_k_mags, k_vectors (n_kx·n_ky, 3), (n_kx, n_ky)).
        """
        if n_kx <= 0 or n_ky <= 0:
            raise ValueError("Number of k-points (n_kx, n_ky) must be positive.")

        c1 = np.linspace(k_range_x[0], k_range_x[1], n_kx, dtype=np.float32)
        c2 = np.linspace(k_range_y[0], k_range_y[1], n_ky, dtype=np.float32)
        outer = np.repeat(c1, n_ky)          # first component varies slowest
        inner = np.tile(c2, n_kx)
        fixed = np.full(n_kx * n_ky, k_fixed_val, dtype=np.float32)

        plane_l = plane.lower()
        if plane_l == 'xy':
            cols = (outer, inner, fixed)     # (kx, ky, k_fixed)
        elif plane_l == 'yz':
            cols = (fixed, outer, inner)     # (k_fixed, ky, kz)
        elif plane_l == 'zx':
            cols = (inner, fixed, outer)     # (kx, k_fixed, kz); first range is kz
        else:
            raise ValueError(f"Invalid plane specified: {plane}. Must be 'xy', 'yz', or 'zx'.")

        k_vectors_3d = np.stack(cols, axis=1).astype(np.float32)
        return np.array([], dtype=np.float32), k_vectors_3d, (n_kx, n_ky)

    # ------------------------------------------------------------------
    # Group resolution (host side; exact reference semantics)
    # ------------------------------------------------------------------

    def _resolve_atom_groups(self,
                             basis_atom_indices,
                             basis_atom_types,
                             summation_mode: str) -> List[np.ndarray]:
        """Resolve basis specs to index groups (reference sed_calculator.py:209-266).

        * types as list-of-lists -> one group per sublist
        * types as flat int list -> incoherent: one singleton group per type;
          coherent: a single union group
        * indices as list / list-of-lists / 1-D ndarray, bounds-checked
        * neither (or all empty) -> all atoms as one group
        """
        n_atoms_tot = self.traj.n_atoms
        atom_groups: List[np.ndarray] = []

        if basis_atom_types is not None:
            if basis_atom_indices is not None:
                logger.warning("basis_atom_types and basis_atom_indices were both given; "
                               "the type spec takes priority.")
            processed: List[List[int]] = []
            if isinstance(basis_atom_types, list) and len(basis_atom_types) > 0:
                if all(isinstance(item, list) for item in basis_atom_types):
                    processed = basis_atom_types
                elif all(isinstance(item, (int, np.integer)) for item in basis_atom_types):
                    if summation_mode == 'incoherent':
                        processed = [[int(t)] for t in basis_atom_types]
                    else:
                        processed = [[int(t) for t in basis_atom_types]]
                else:
                    raise ValueError("basis_atom_types: expected ints, or nested lists of ints, "
                                     "one sublist per group.")
            elif isinstance(basis_atom_types, (int, np.integer)):
                processed = [[int(basis_atom_types)]]

            for type_group in processed:
                indices = np.where(np.isin(self.traj.types, type_group))[0]
                if indices.size > 0:
                    atom_groups.append(indices)
                else:
                    logger.warning("Type group %s matches no atoms in this trajectory; "
                                   "dropping it.", type_group)

        elif basis_atom_indices is not None:
            processed_idx: List[np.ndarray] = []
            if isinstance(basis_atom_indices, list):
                if len(basis_atom_indices) == 0:
                    pass
                elif all(isinstance(item, list) for item in basis_atom_indices):
                    for sublist in basis_atom_indices:
                        arr = np.asarray(sublist, dtype=int)
                        if arr.size > 0:
                            processed_idx.append(arr)
                elif all(isinstance(item, (int, np.integer)) for item in basis_atom_indices):
                    arr = np.asarray(basis_atom_indices, dtype=int)
                    if arr.size > 0:
                        processed_idx.append(arr)
                else:
                    raise ValueError("basis_atom_indices: expected ints, or nested lists of ints, "
                                     "one sublist per group.")
            elif isinstance(basis_atom_indices, np.ndarray):
                if basis_atom_indices.ndim == 1 and basis_atom_indices.size > 0:
                    processed_idx.append(basis_atom_indices.astype(int))
                else:
                    logger.warning("basis_atom_indices array must be 1-D and non-empty; "
                                   "falling back to the all-atoms group.")

            for grp_idx in processed_idx:
                if np.any(grp_idx >= n_atoms_tot) or np.any(grp_idx < 0):
                    raise ValueError(f"Basis atom indices out of bounds for {n_atoms_tot} atoms.")
                if grp_idx.size > 0:
                    atom_groups.append(grp_idx)

        if not atom_groups:
            logger.debug("No basis spec given — the single group spans all %d atoms.",
                         n_atoms_tot)
            atom_groups.append(np.arange(n_atoms_tot))
            if summation_mode == 'incoherent' and n_atoms_tot > 0:
                logger.info("Incoherent mode over the all-atoms group degenerates to "
                            "one coherent sum.")
        return atom_groups

    # ------------------------------------------------------------------
    # Device data management
    # ------------------------------------------------------------------

    @property
    def mean_positions64(self) -> np.ndarray:
        """Time-averaged positions r̄ in float64, cached (shipped to the
        device as a split (hi, lo) float32 pair)."""
        if self._mean_pos64 is None:
            # dtype=float64 accumulates in f64 without materializing a copy of
            # the (possibly huge / broadcast-view) positions array.
            self._mean_pos64 = np.mean(self.traj.positions, axis=0, dtype=np.float64)
        return self._mean_pos64

    @property
    def mean_positions(self) -> np.ndarray:
        """Time-averaged positions r̄ as float32 (API-compatible view)."""
        return self.mean_positions64.astype(np.float32)

    def _host_group_data(self, group_idx: np.ndarray):
        """Host (data, mp_hi, mp_lo) for one group."""
        mp_hi_all, mp_lo_all = spectral.split_f64(self.mean_positions64)
        full = group_idx.size == self.traj.n_atoms and np.array_equal(
            group_idx, np.arange(self.traj.n_atoms))
        if full:
            mp_hi, mp_lo = mp_hi_all, mp_lo_all
            data = self.traj.positions if self.use_displacements else self.traj.velocities
        else:
            mp_hi, mp_lo = mp_hi_all[group_idx], mp_lo_all[group_idx]
            data = (self.traj.positions[:, group_idx, :] if self.use_displacements
                    else self.traj.velocities[:, group_idx, :])
        return data, mp_hi, mp_lo

    def _to_device(self, host: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.array(host, dtype=np.float32, order='C')).to(self.device)

    def clear_device_cache(self) -> None:
        """Drop cached device-resident group data (frees device memory)."""
        with self._cache_lock:
            self._device_cache.clear()
            self._device_cache_order.clear()

    def _group_cache_key(self, group_idx: np.ndarray) -> bytes:
        return group_idx.tobytes() + (b'D' if self.use_displacements else b'V') \
            + (b'M' if self.mass_weighted else b'')

    def _cache_put(self, key: bytes, entry: tuple) -> tuple:
        """Insert into the 2-slot LRU (caller holds the lock)."""
        if key not in self._device_cache:
            self._device_cache_order.append(key)
        self._device_cache[key] = entry
        while len(self._device_cache_order) > 2:
            evict = self._device_cache_order.pop(0)
            self._device_cache.pop(evict, None)
        return entry

    def preload_device_group_data(self, data_dev: torch.Tensor, mp_hi_dev: torch.Tensor,
                                  mp_lo_dev: torch.Tensor,
                                  group_idx: Optional[np.ndarray] = None) -> None:
        """Install device-resident SED input data for a group directly.

        For data that already lives on the device (generated there, or the
        output of an upstream computation) this skips the host→device upload.
        The caller asserts ``data_dev`` equals what the calculator would have
        uploaded for this group — velocities (or displacement data when
        ``use_displacements``), with mass weights already applied — and
        ``mp_hi_dev``/``mp_lo_dev`` are the group's split mean positions.
        All three are float32 tensors on this calculator's device.  Entries
        share the 2-slot LRU with uploaded groups.
        """
        if group_idx is None:
            group_idx = np.arange(self.traj.n_atoms)
        expect = (self.traj.n_frames, int(group_idx.size), 3)
        if tuple(data_dev.shape) != expect:
            raise ValueError(f"data_dev must have shape {expect}, "
                             f"got {tuple(data_dev.shape)}")
        if (tuple(mp_hi_dev.shape) != (expect[1], 3)
                or tuple(mp_lo_dev.shape) != (expect[1], 3)):
            raise ValueError(f"mean-position splits must have shape "
                             f"({expect[1]}, 3)")
        for t in (data_dev, mp_hi_dev, mp_lo_dev):
            if t.dtype != torch.float32 or t.device.type != self.device.type:
                raise ValueError(f"preloaded tensors must be float32 on {self.device}, "
                                 f"got {t.dtype} on {t.device}")
        key = self._group_cache_key(group_idx)
        with self._cache_lock:
            self._cache_put(key, (data_dev, mp_hi_dev, mp_lo_dev))

    def _group_device_arrays(self, group_idx: np.ndarray):
        """Device-resident (data, mp_hi, mp_lo) for a group, 2-entry LRU cache."""
        key = self._group_cache_key(group_idx)
        with self._cache_lock:
            if key in self._device_cache:
                return self._device_cache[key]
        data_host, mp_hi_host, mp_lo_host = self._host_group_data(group_idx)
        data_dev = self._to_device(data_host)
        hi_dev = self._to_device(mp_hi_host)
        lo_dev = self._to_device(mp_lo_host)
        if self.use_displacements:
            data_dev = spectral.displacement_data(data_dev, hi_dev, lo_dev)
        if self.mass_weighted:
            w = torch.sqrt(self._to_device(self.traj.masses[group_idx]))
            data_dev = data_dev * w[None, :, None]
        with self._cache_lock:
            # Two threads can race past the miss check; the first insert wins.
            if key in self._device_cache:
                return self._device_cache[key]
            return self._cache_put(key, (data_dev, hi_dev, lo_dev))

    def _group_bytes(self, group_idx: np.ndarray) -> int:
        return 4 * self.traj.n_frames * int(group_idx.size) * 3

    # ------------------------------------------------------------------
    # Core spectrum computation for one group / one k-chunk
    # ------------------------------------------------------------------

    def _group_spectrum_np(self, group_idx: np.ndarray, k_chunk: np.ndarray,
                           want_intensity: bool) -> np.ndarray:
        """Spectrum (or intensity) of one atom group on one k-chunk, as NumPy."""
        n_t = self.traj.n_frames
        if group_idx.size == 0:
            if want_intensity:
                return np.zeros((n_t, len(k_chunk)), dtype=np.float32)
            return np.zeros((n_t, len(k_chunk), 3), dtype=np.complex64)
        if self._group_bytes(group_idx) > self.max_device_bytes:
            raise NotImplementedError(
                f"group of {self._group_bytes(group_idx)} bytes exceeds max_device_bytes="
                f"{self.max_device_bytes}; the atom-streamed path is not ported "
                "(ROADMAP A3, 'atom-streamed path'). Raise max_device_bytes if the group fits the device.")
        data_dev, hi_dev, lo_dev = self._group_device_arrays(group_idx)
        k_dev = self._to_device(k_chunk)
        if want_intensity:
            out = spectral.sed_intensity(data_dev, hi_dev, lo_dev, k_dev,
                                         precision=self.precision)
        else:
            out = spectral.sed_spectrum(data_dev, hi_dev, lo_dev, k_dev,
                                        precision=self.precision)
        return out.cpu().numpy()

    # ------------------------------------------------------------------
    # Public: calculate
    # ------------------------------------------------------------------

    def calculate(self, k_points_mags: np.ndarray, k_vectors_3d: np.ndarray,
                  basis_atom_indices: Optional[Union[List[int], List[List[int]], np.ndarray]] = None,
                  basis_atom_types: Optional[Union[List[int], List[List[int]]]] = None,
                  summation_mode: str = 'coherent',
                  k_grid_shape: Optional[Tuple[int, int]] = None,
                  k_chunk_size: int = 500,
                  cache_dir: Optional[Union[str, Path]] = None) -> SED:
        """Compute the SED over the given k-set.

        Semantics match the reference (sed_calculator.py:182-336): coherent
        mode (or a single group) returns complex Φ (n_freq, n_k, 3); incoherent
        mode returns Σ_groups Σ_α |Φ|² (n_freq, n_k) float32.  ``k_chunk_size``
        bounds device memory; the last chunk is ragged (the kernel masks it).
        ``cache_dir`` (the shard cache) is not ported.
        """
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError(f"summation_mode must be 'coherent' or 'incoherent', got {summation_mode}")
        if cache_dir is not None:
            raise NotImplementedError("cache_dir (the per-chunk shard cache) is not "
                                      "ported (ROADMAP A3, 'shard cache')")

        n_t, n_atoms_tot = self.traj.n_frames, self.traj.n_atoms
        if n_t == 0 or n_atoms_tot == 0:
            logger.warning("Cannot calculate SED: 0 frames or 0 atoms.")
            return SED(np.array([], dtype=np.complex64).reshape(0, 0, 3),
                       np.array([], dtype=np.float32), k_points_mags, k_vectors_3d,
                       k_grid_shape=k_grid_shape, is_complex=True, phase=None)

        freqs = spectral.fftfreq_thz(n_t, self.dt_ps)
        atom_groups = self._resolve_atom_groups(basis_atom_indices, basis_atom_types,
                                                summation_mode)

        num_k = len(k_vectors_3d)
        block = min(max(1, k_chunk_size), num_k) if num_k > 0 else 1
        num_chunks = (num_k + block - 1) // block if num_k > 0 else 0

        is_complex_output = summation_mode == 'coherent' or len(atom_groups) <= 1
        if is_complex_output:
            full_sed = np.zeros((len(freqs), num_k, 3), dtype=np.complex64)
            if len(atom_groups) > 1:
                union = np.unique(np.concatenate(atom_groups)).astype(int)
            elif len(atom_groups) == 1:
                union = atom_groups[0]
            else:
                union = np.array([], dtype=int)
        else:
            full_sed = np.zeros((len(freqs), num_k), dtype=np.float32)

        if num_k == 0:
            logger.warning("k_vectors_3d is empty. Returning SED object with empty SED data.")

        for i_chunk in range(num_chunks):
            start = i_chunk * block
            end = min(start + block, num_k)
            k_chunk = np.asarray(k_vectors_3d[start:end], dtype=np.float32)
            logger.debug("Processing k-chunk %d/%d (indices %d-%d)", i_chunk + 1, num_chunks,
                         start, end - 1)
            if is_complex_output:
                if union.size == 0:
                    logger.warning("Final atom group for SED k-chunk %d is empty; chunk stays zero.",
                                   i_chunk + 1)
                    continue
                full_sed[:, start:end, :] = self._group_spectrum_np(
                    union, k_chunk, want_intensity=False)
            else:
                acc = np.zeros((len(freqs), end - start), dtype=np.float32)
                for grp_idx in atom_groups:
                    if grp_idx.size == 0:
                        continue
                    acc += self._group_spectrum_np(grp_idx, k_chunk, want_intensity=True)
                full_sed[:, start:end] = acc

        return SED(full_sed, freqs, k_points_mags, k_vectors_3d,
                   k_grid_shape=k_grid_shape, is_complex=is_complex_output, phase=None,
                   dt_ps=self.dt_ps)

    # ------------------------------------------------------------------
    # Chiral phase
    # ------------------------------------------------------------------

    def calculate_chiral_phase(self, Z1: np.ndarray, Z2: np.ndarray,
                               angle_range_opt: str = 'C') -> np.ndarray:
        """Phase difference map of two complex spectra (reference
        sed_calculator.py:338-371; options A and B vectorized)."""
        if Z1.shape != Z2.shape:
            raise ValueError("Z1 and Z2 shapes must match for chiral phase.")
        if Z1.size == 0:
            return np.array([], dtype=np.float32).reshape(Z1.shape)
        if angle_range_opt not in ('A', 'B', 'C'):
            logger.warning("Unknown angle_range_opt '%s'. Angle=0.", angle_range_opt)
            return np.zeros(Z1.shape, dtype=np.float32)
        z1 = torch.from_numpy(np.asarray(Z1, dtype=np.complex64)).to(self.device)
        z2 = torch.from_numpy(np.asarray(Z2, dtype=np.complex64)).to(self.device)
        return spectral.chiral_phase(z1, z2, angle_range_opt=angle_range_opt).cpu().numpy()

    # ------------------------------------------------------------------
    # iSED reconstruction
    # ------------------------------------------------------------------

    def ised(self, k_dir_spec: DirectionSpec, k_target: float, w_target: float,
             char_len_k_path: float, nk_on_path: int = 100, bz_cov_ised: float = 1.0,
             basis_atom_idx_ised: Optional[List[int]] = None,
             basis_atom_types_ised: Optional[List[int]] = None,
             rescale_factor: Union[str, float] = 1.0, n_recon_frames: int = 100,
             dump_filepath: str = 'iSED_reconstruction.dump',
             plot_dir_ised: Optional[Path] = None, plot_max_freq: Optional[float] = None,
             plot_theme: str = 'light', npt: bool = False) -> None:
        """Inverse SED: reconstruct real-space motion of the mode nearest
        (k_target, w_target) and export a LAMMPS dump animation (reference
        sed_calculator.py:373-589).  Fixed cell only: ``npt=True`` and
        ``plot_dir_ised`` are not ported."""
        if npt:
            raise NotImplementedError("ised(npt=True) is not ported (ROADMAP A9, NPT family)")
        if plot_dir_ised:
            raise NotImplementedError("ised(plot_dir_ised=...) is not ported "
                                      "(ROADMAP A7, plotting)")
        from ..io.writer import out_to_qdump  # local import: io layer sits above core

        logger.info("iSED reconstruction starting.")
        avg_pos = self.mean_positions
        sys_atom_types = self.traj.types.astype(int)
        n_atoms_total = self.traj.n_atoms
        k_dir_unit = parse_direction(k_dir_spec)

        recon_atom_groups = self._resolve_ised_groups(basis_atom_idx_ised,
                                                      basis_atom_types_ised, n_atoms_total,
                                                      sys_atom_types)
        if not recon_atom_groups:
            logger.error("iSED aborted: the reconstruction basis resolved to no groups.")
            return

        k_mags_ised, k_vecs_ised = self.get_k_path(
            direction_spec=k_dir_unit, bz_coverage=bz_cov_ised,
            n_k=nk_on_path, lat_param=char_len_k_path)

        wiggles = np.zeros((n_recon_frames, n_atoms_total, 4), dtype=np.float32)
        time_p = np.linspace(0, 2 * np.pi, n_recon_frames, endpoint=False).astype(np.float32)
        pos_proj_k_dir = np.dot(avg_pos, k_dir_unit)

        k_match_idx = int(np.argmin(np.abs(k_mags_ised - k_target)))
        k_actual = float(k_mags_ised[k_match_idx])
        logger.info("iSED matched requested k=%.4f to path point %.4f 2π/Å (index %d)",
                    k_target, k_actual, k_match_idx)

        recon_done, max_wiggle_amp_all = False, 0.0
        std_dev_sum, n_atoms_recon_sum = 0.0, 0
        time_dev = torch.from_numpy(time_p).to(self.device)

        for i_grp, grp_atom_idx in enumerate(recon_atom_groups):
            if grp_atom_idx.size == 0:
                continue
            logger.info("iSED reconstructing group %d of %d — %d atoms, types %s.", i_grp + 1,
                        len(recon_atom_groups), len(grp_atom_idx),
                        np.unique(sys_atom_types[grp_atom_idx]))
            sed_obj = self.calculate(k_points_mags=k_mags_ised,
                                     k_vectors_3d=k_vecs_ised,
                                     basis_atom_indices=grp_atom_idx,
                                     k_grid_shape=None,
                                     summation_mode='coherent')
            freqs_group = sed_obj.freqs
            w_match_idx = int(np.argmin(np.abs(freqs_group - w_target)))
            w_actual = float(freqs_group[w_match_idx])
            logger.info("  iSED group %d matched requested ω=%.3f to %.3f THz (index %d)",
                        i_grp + 1, w_target, w_actual, w_match_idx)

            amps = np.ascontiguousarray(sed_obj.sed[w_match_idx, k_match_idx, :],
                                        dtype=np.complex64)
            proj_grp = pos_proj_k_dir[grp_atom_idx].astype(np.float32)
            motion = spectral.synthesize_mode_motion(
                torch.from_numpy(amps).to(self.device),
                torch.from_numpy(proj_grp).to(self.device), k_actual, time_dev)
            wiggles[:, grp_atom_idx, :3] += motion.cpu().numpy()

            recon_done = True
            if isinstance(rescale_factor, str) and rescale_factor.lower() == 'auto':
                max_amp_grp = float(np.amax(np.abs(wiggles[:, grp_atom_idx, :3])))
                max_wiggle_amp_all = max(max_wiggle_amp_all, max_amp_grp)
                orig_disp_grp = (self.traj.positions[:, grp_atom_idx, :]
                                 - avg_pos[None, grp_atom_idx, :])
                std_dev_sum += float(np.std(orig_disp_grp)) * len(grp_atom_idx)
                n_atoms_recon_sum += len(grp_atom_idx)

        if not recon_done:
            logger.error("iSED produced no motion — every resolved group was empty.")
            return

        wiggles[0, :, 3] = sys_atom_types
        nonempty = [g for g in recon_atom_groups if g.size > 0]
        all_recon_idx = np.unique(np.concatenate(nonempty)) if nonempty else np.array([])

        if all_recon_idx.size > 0:
            if isinstance(rescale_factor, str) and rescale_factor.lower() == 'auto':
                if max_wiggle_amp_all > 1e-9:
                    wiggles[:, all_recon_idx, :3] /= max_wiggle_amp_all
                    avg_std = std_dev_sum / n_atoms_recon_sum if n_atoms_recon_sum > 0 else 0.0
                    if avg_std > 1e-9:
                        wiggles[:, all_recon_idx, :3] *= avg_std
                    logger.info("iSED auto-rescale: peak amplitude %.3e scaled to the mean "
                                "displacement stddev %.3e",
                                max_wiggle_amp_all, avg_std)
                else:
                    logger.warning("iSED auto-rescale skipped: peak amplitude is ~0.")
            elif isinstance(rescale_factor, (int, float)):
                wiggles[:, all_recon_idx, :3] *= rescale_factor
                logger.info("iSED amplitudes scaled by the fixed factor %s.", rescale_factor)
        else:
            logger.warning("iSED rescale skipped: no atoms were reconstructed.")

        final_pos_dump = avg_pos[None, :, :] + wiggles[:, :, :3]
        atom_types_dump = wiggles[0, :, 3].astype(int)
        out_to_qdump(dump_filepath, final_pos_dump, atom_types_dump, self.traj.box_matrix)
        logger.info("iSED motion dump written to %s", dump_filepath)

    def _resolve_ised_groups(self, basis_atom_idx_ised, basis_atom_types_ised,
                             n_atoms_total: int, sys_atom_types: np.ndarray) -> List[np.ndarray]:
        """iSED group resolution (reference sed_calculator.py:389-433).

        Differs from :meth:`_resolve_atom_groups`: a flat type list yields one
        group PER TYPE (not a union), and index lists take precedence.
        """
        groups: List[np.ndarray] = []
        if basis_atom_idx_ised and len(basis_atom_idx_ised) > 0:
            if isinstance(basis_atom_idx_ised[0], list):
                for grp_idx in basis_atom_idx_ised:
                    grp_arr = np.asarray(grp_idx, dtype=int)
                    if np.any(grp_arr >= n_atoms_total) or np.any(grp_arr < 0):
                        raise ValueError(f"Atom indices in group {grp_idx} out of bounds.")
                    if grp_arr.size > 0:
                        groups.append(grp_arr)
            else:
                grp_arr = np.asarray(basis_atom_idx_ised, dtype=int)
                if np.any(grp_arr >= n_atoms_total) or np.any(grp_arr < 0):
                    raise ValueError("Atom indices out of bounds.")
                if grp_arr.size > 0:
                    groups.append(grp_arr)
            if basis_atom_types_ised and len(basis_atom_types_ised) > 0:
                logger.warning("iSED got both index and type bases; indices take priority.")
        elif basis_atom_types_ised and len(basis_atom_types_ised) > 0:
            if isinstance(basis_atom_types_ised[0], list):
                for type_grp in basis_atom_types_ised:
                    grp_idx = np.where(np.isin(sys_atom_types, type_grp))[0]
                    if grp_idx.size > 0:
                        groups.append(grp_idx)
                    else:
                        logger.warning("iSED type group %s matches no atoms; dropped.", type_grp)
            else:
                for atom_type_val in basis_atom_types_ised:
                    grp_idx = np.where(np.isin(sys_atom_types, [atom_type_val]))[0]
                    if grp_idx.size > 0:
                        groups.append(grp_idx)
                    else:
                        logger.warning("iSED type %s matches no atoms; dropped.", atom_type_val)
        else:
            logger.info("iSED basis defaulting to one group spanning all atoms.")
            groups.append(np.arange(n_atoms_total))
        return groups
