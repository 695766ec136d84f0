"""SEDCalculator on PyTorch — the SED main path of :mod:`psa_tpu.core.calculator`.

Same public API and numbers as the JAX class for what is ported: lattice
setup, ``get_k_path``, ``get_k_grid``, ``calculate`` (coherent and
incoherent, velocities or displacements, optional mass weighting),
``calculate_chiral_phase``, fixed-cell ``ised``, the direct engine's
on-device grid reductions: ``calculate_welch``, ``calculate_kgrid_browse``,
``calculate_lt``, ``calculate_kgrid_peaks``, and on top of the peaks
``calculate_group_velocity_path``/``_surface`` and
``calculate_thermal_conductivity``; ``calculate_dos``; the NPT family
(``calculate_npt``, ``calculate_npt_browse``, ``calculate_npt_peaks``,
``ised(npt=True)``: the fractional phase anchor exp(2πi m·s̄)); and the
instantaneous-phase family (``calculate_dsf``, ``calculate_sk``,
``calculate_isf``, ``calculate_isf_self``, ``calculate_dsf_self``: phases
exp(i k·r_a(t)), :mod:`psa_tpu_torch.ops.instantaneous`); and the
k-independent observables ``calculate_msd``, ``calculate_vacf``
(:mod:`psa_tpu_torch.ops.timecorr`) and ``calculate_rdf`` (brute and
linked-cell sweeps, :mod:`psa_tpu_torch.ops.structure`).  Every precision
tier of the projection kernel ('parity', 'balanced', 'fast') runs on every
projecting surface.  Group bookkeeping and k generation run on the host in
NumPy; per (group, k-chunk) projections and their reductions run on
``device`` through :mod:`psa_tpu_torch.ops.spectral`.

Out of core: a group larger than ``max_device_bytes`` streams from the host
in atom blocks through pinned staging buffers (the next block's copy
overlaps this block's kernel), accumulating into the projection on the
device.  Per-chunk results cross back through a one-deep pinned readback:
the host assembles chunk i while the device computes chunk i+1.
``cache_dir`` checkpoints each k-chunk (``io/shard_cache.py``, keys shared
with the JAX package), so a killed sweep resumes.

The gridded NUFFT engine (:mod:`psa_tpu_torch.ops.gridded`) serves
``calculate_gridded`` and ``engine='gridded'`` of ``calculate_kgrid_browse``
and ``calculate_kgrid_peaks``; the 'factored' and 'incremental' phase engines
serve the instantaneous-phase family (``phase_mode``).  Neither is what
'auto' picks.

Device meshes: the ``*_sharded`` methods and every ``mesh=`` argument run
the sweeps over a (t, a, k) mesh of :mod:`psa_tpu_torch.parallel` (several
cards, positions repeated on one card, or ranks of a process group), every
shard's projection through the same kernel.
"""
from __future__ import annotations

import functools
import logging
import threading
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops import instantaneous, spectral
from ..ops.sed_projection import sed_projection
from ..utils import debug
from ..utils.helpers import DirectionSpec, miller_line, parse_direction
from ..utils.profiling import count, span
from ..utils.transfer import DeviceToHost, HostToDevice, copy_rows
from .sed import SED
from .trajectory import Trajectory

logger = logging.getLogger(__name__)

_DEFAULT_MAX_DEVICE_BYTES = int(8e9)
#: Largest atom block, in bytes, of a group streamed from the host (two are staged).
STREAM_BLOCK_BYTES = 1 << 28
#: Largest host result of ``calculate``, in bytes, held in pinned pages on CUDA.
#: PyTorch's pinned cache keeps a dropped result's block (rounded up to a power
#: of two) mapped and resident for the next call, so the call neither faults a
#: fresh array's pages in nor copies out of a staging block.  But the cache
#: never gives its page-locked blocks back to the OS, so the cap bounds what one
#: result size leaves locked.  It holds one chunk of the default 500 k up to
#: ~22,000 frames; a larger result is several chunks, whose assembly the
#: readback pipeline already overlaps with the next chunk's kernel, all but the
#: last's.  (H100 host: a fresh 256 MB pinned block 54 ms, np.zeros + fill 109.)
PINNED_RESULT_BYTES = 1 << 28
#: Instantaneous-phase engines; 'auto' resolves to 'exact' in every family.
PHASE_MODES = ('auto', 'incremental', 'exact', 'factored')
#: Frames per chunk of the fractional mean, in position elements.
FRAC_MEAN_CHUNK_ELEMS = int(2e8)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Copy a result tensor to a host NumPy array (waits for the device)."""
    if t.is_cuda:
        count('dtoh_bytes', t.nbytes)
    with span('psa.readback.wait'):
        host = t.cpu().numpy()
    if debug.active:
        debug.check_arrays(debug.caller(), (host,))
    return host


def _chunk_block(k_chunk_size: int, num_k: int) -> int:
    """k-points per chunk of a sweep over ``num_k`` (at least one): the
    chunk size the shard caches' keys hold."""
    return max(1, min(int(k_chunk_size), num_k))


def _union_group(atom_groups: List[np.ndarray]) -> np.ndarray:
    """The one atom group of a coherent sum: several groups' union, each
    atom once, ascending; one group as it is; no group, no atom."""
    if len(atom_groups) > 1:
        return np.unique(np.concatenate(atom_groups)).astype(int)
    return atom_groups[0] if atom_groups else np.array([], dtype=int)


class _Projections:
    """(re, im) projections of a sweep's spectrum groups on its k-chunks.

    A group within ``max_device_bytes`` is projected per chunk from its
    resident device arrays.  A larger group streams from the host: once for
    each pass of consecutive chunks still to compute whose (n_t, 3, K)
    accumulator pairs fit half the budget (split between the oversize
    groups), every atom block feeding every accumulator of the pass.  At
    the working size (10⁴ steps, 2,500 k) one pass takes the whole grid:
    0.6 GB of accumulators.  Each chunk's pair is handed out once.
    """

    def __init__(self, calc: 'SEDCalculator', groups: List[np.ndarray], k_dev: torch.Tensor,
                 bounds: List[Tuple[int, int]], todo: List[int]):
        self.calc, self.groups, self.k_dev, self.bounds = calc, groups, k_dev, bounds
        self.todo = list(todo)
        n_oversize = sum(calc._oversize(g) for g in groups)
        self.pass_bytes = calc.max_device_bytes // 2 // max(1, n_oversize)
        self._ready: Dict[Tuple[int, int], tuple] = {}

    def get(self, gi: int, ci: int):
        group = self.groups[gi]
        s, e = self.bounds[ci]
        if not self.calc._oversize(group):
            data, hi, lo = self.calc._group_device_arrays(group)
            return sed_projection(data, hi, lo, self.k_dev[s:e], precision=self.calc.precision)
        if (gi, ci) not in self._ready:
            chunks = self._pass(ci)
            outs = self.calc._streamed_projections(
                group, [self.k_dev[self.bounds[c][0]:self.bounds[c][1]] for c in chunks])
            self._ready.update({(gi, c): out for c, out in zip(chunks, outs)})
        return self._ready.pop((gi, ci))

    def _pass(self, ci: int) -> List[int]:
        """Chunks from ``ci`` on, in sweep order, whose accumulators fit."""
        per_k = 24 * self.calc.traj.n_frames
        chunks, total = [], 0
        for c in self.todo[self.todo.index(ci):]:
            need = per_k * (self.bounds[c][1] - self.bounds[c][0])
            if chunks and total + need > self.pass_bytes:
                break
            chunks.append(c)
            total += need
        return chunks


def peaks_np(intensity: np.ndarray, freqs_kept: np.ndarray, n_peaks: int = 1,
             exclusion_bins: int = 4, width_method: str = 'rms'):
    """NumPy float64 mirror of :func:`psa_tpu_torch.ops.spectral.peak_reduce`
    over (n_freq_kept, n_k) intensity planes: the oracle of the device path."""
    if width_method not in ('rms', 'lorentzian'):
        raise ValueError(f"width_method must be 'rms' or 'lorentzian', "
                         f"got {width_method!r}")
    inten = np.array(intensity, dtype=np.float64, copy=True)
    fk = np.asarray(freqs_kept, dtype=np.float64)
    n_f, n_k = inten.shape
    row = np.arange(n_f)
    pf = np.zeros((n_peaks, n_k), dtype=np.float32)
    ph = np.zeros((n_peaks, n_k), dtype=np.float32)
    pw = np.zeros((n_peaks, n_k), dtype=np.float32)
    for p in range(n_peaks):
        idx = np.argmax(inten, axis=0)
        ph[p] = inten[idx, np.arange(n_k)]
        in_win = np.abs(row[:, None] - idx[None, :]) <= exclusion_bins
        w = np.where(in_win, inten, 0.0)
        pf[p] = fk[idx]
        if width_method == 'rms':
            wsum = np.maximum(w.sum(axis=0), 1e-30)
            mu = (w * fk[:, None]).sum(axis=0) / wsum
            var = (w * (fk[:, None] - mu[None, :]) ** 2).sum(axis=0) / wsum
            pw[p] = np.sqrt(np.maximum(var, 0.0))
        else:
            # closed-form Lorentzian FWHM: I²-weighted regression of 1/I on
            # (ν−ν₀)², peak-height-normalized like the device path
            x = (fk[:, None] - pf[p][None, :].astype(np.float64)) ** 2
            wn = w / np.maximum(ph[p], 1e-30)[None, :]
            y = 1.0 / np.maximum(wn, 1e-30)
            wt = np.where(in_win, wn * wn, 0.0)
            sw = wt.sum(axis=0)
            sx = (wt * x).sum(axis=0)
            sy = (wt * y).sum(axis=0)
            sxx = (wt * x * x).sum(axis=0)
            sxy = (wt * x * y).sum(axis=0)
            det = sw * sxx - sx * sx
            with np.errstate(invalid='ignore', divide='ignore'):
                slope = np.where(np.abs(det) > 1e-30,
                                 (sw * sxy - sx * sy) / det, 0.0)
                intercept = np.where(sw > 1e-30, (sy - slope * sx) / sw, 0.0)
                gsq = np.where(slope > 1e-30,
                               np.maximum(intercept, 0.0) / slope, np.inf)
            df = (fk[-1] - fk[0]) / (n_f - 1) if n_f > 1 else 1.0
            pw[p] = np.minimum(2.0 * np.sqrt(gsq), 2.0 * exclusion_bins * df)
        inten[in_win] = 0.0
    return pf, ph, pw


def resolve_device(device: Union[str, torch.device]) -> torch.device:
    """``torch.device`` for ``device``; raises for CUDA when no card is present.

    A bare 'cuda' is pinned to the calling thread's current card: PyTorch's
    current device is per thread, and a calculator built on one thread is
    used from others (the GUI's workers), which must land on the same card.
    """
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} requested but CUDA is not "
                           "available; pass device='cpu' explicitly to run on the host")
    if dev.type not in ('cuda', 'cpu'):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


class SEDCalculator:
    """Spectral-energy-density engine over a :class:`Trajectory`.

    Args:
        traj: trajectory to analyze.
        nx, ny, nz: supercell counts defining primitive vectors a_i = L_i / n_i.
        use_displacements: project displacements u(t)=r(t)−r̄ instead of velocities.
        dt_ps: optional override of the trajectory timestep (deprecated in the
            reference, kept for compatibility).
        precision: the projection kernel's tier: 'parity' (3xTF32 products,
            IEEE float32 sums; holds 1e-6 against the float64 oracle),
            'balanced' (3xBF16, ~1e-5) or 'fast' (1xTF32, ~1e-3).
        max_device_bytes: largest group (n_t·n_atoms·3·4 bytes) held on the
            device; a larger group streams from the host in atom blocks.  It
            bounds one array: the 2-slot cache may hold two such arrays, and a
            sweep's transients come on top (a quarter of it per block).
        mass_weighted: weight each atom's data by √m_a (requires ``traj.masses``).
        phase_mode: engine of the instantaneous-phase family (DSF, S(k), ISF,
            self parts): 'exact' (float64 angle per element; 'auto' resolves
            to it in every family), 'factored' (lattice k-chunks that factor
            as anchors ⊕ deltas take the float64 chain on the base columns
            only) or 'incremental' (one exact phasor per 32 frames, small
            float32 phases between).  Off-lattice k, chunks that do not
            factor and a singular box run 'exact', bit for bit.
        device: 'cuda' (default; raises when CUDA is absent) or 'cpu'.
    """

    def __init__(self, traj: Trajectory, nx: int, ny: int, nz: int,
                 use_displacements: bool = False, dt_ps: Optional[float] = None,
                 precision: str = 'parity',
                 max_device_bytes: int = _DEFAULT_MAX_DEVICE_BYTES,
                 mass_weighted: bool = False,
                 phase_mode: str = 'auto',
                 device: Union[str, torch.device] = 'cuda'):
        if not (nx > 0 and ny > 0 and nz > 0):
            raise ValueError("System dimensions (nx, ny, nz) must be positive.")
        self._configure(traj, use_displacements, precision, max_device_bytes,
                        mass_weighted, device, phase_mode)
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
                   device: Union[str, torch.device], phase_mode: str = 'auto') -> None:
        """Everything but the lattice and the timestep (shared with
        :func:`psa_tpu_torch.core.convert.from_reference_calculator`)."""
        spectral.check_precision(precision)
        if phase_mode not in PHASE_MODES:
            raise ValueError("phase_mode must be 'auto', 'factored', "
                             "'incremental' or 'exact'.")
        if mass_weighted and traj.masses is None:
            raise ValueError("mass_weighted=True requires Trajectory.masses.")
        self.device = resolve_device(device)
        self.traj = traj
        self.use_displacements = use_displacements
        self.precision = precision
        self.max_device_bytes = max_device_bytes
        self.mass_weighted = mass_weighted
        self.phase_mode = phase_mode
        # Phase anchor: 'cartesian' (exp(i k·r̄), the reference formula) or
        # 'fractional' (exp(2πi m·s̄), set while an NPT path runs); part of
        # the device-cache and shard-cache keys.
        self._phase_anchor = 'cartesian'
        self._frac_mean64: Optional[np.ndarray] = None
        self._phase_box_dev: Optional[torch.Tensor] = None
        self._grid_plans: Dict[tuple, object] = {}      # the gridded engine's last two plans
        # The lock guards the device cache: worker threads may call calculate()
        # concurrently.
        self._mean_pos64: Optional[np.ndarray] = None
        self._device_cache: Dict[bytes, tuple] = {}
        self._device_cache_order: List[bytes] = []
        self._cache_lock = threading.Lock()
        self._resident_shards = None        # preload_mesh_group_data's ResidentShards
        #: Bytes of groups over max_device_bytes streamed to the device so far.
        self.streamed_bytes = 0
        #: Per k-chunk of the 'factored' sweeps so far: (Na, Nb), or None for
        #: a chunk that did not factor and ran the exact engine.
        self.factored_chunks: List[Optional[Tuple[int, int]]] = []

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
        device as a split (hi, lo) float32 pair); while an NPT path runs,
        the fractional mean s̄ (:meth:`_fractional_mean_positions64`)."""
        if self._phase_anchor == 'fractional':
            return self._fractional_mean_positions64()
        if self._mean_pos64 is None:
            # dtype=float64 accumulates in f64 without materializing a copy of
            # the (possibly huge / broadcast-view) positions array.
            self._mean_pos64 = np.mean(self.traj.positions, axis=0, dtype=np.float64)
        return self._mean_pos64

    def _fractional_mean_positions64(self) -> np.ndarray:
        """Time-averaged fractional coordinates s̄ = mean_t h(t)⁻¹ r(t), float64.

        The NPT phase anchor: exp(2πi m·s̄) does not move with the cell's
        breathing, where the fixed-cell exp(i k·r̄) smears.  Frame chunks
        cross to the device through the pinned staging and are summed there
        in float64 (h⁻¹ from the host's float64 inverse), so the (n_t, N, 3)
        float64 fractional array never exists whole.  Cached.
        """
        if self._frac_mean64 is None:
            if self.traj.box_matrices is None:
                raise ValueError("Fractional phase anchor requires "
                                 "Trajectory.box_matrices (per-frame cells).")
            n_t, n_a = self.traj.n_frames, self.traj.n_atoms
            hinv = torch.from_numpy(np.linalg.inv(
                np.asarray(self.traj.box_matrices, dtype=np.float64))).to(self.device)
            chunk = max(1, min(n_t, FRAC_MEAN_CHUNK_ELEMS // max(1, n_a * 3)))
            stager = HostToDevice(self.device, chunk * n_a * 3)
            acc = torch.zeros((n_a, 3), dtype=torch.float64, device=self.device)
            for t0 in range(0, n_t, chunk):
                t1 = min(t0 + chunk, n_t)
                r = stager.put(lambda dst, t0=t0, t1=t1: copy_rows(
                    dst, self.traj.positions[t0:t1]), (t1 - t0, n_a, 3))
                # columns are cell vectors: r = h @ s  =>  s = h⁻¹ r
                acc += torch.einsum('tij,taj->ai', hinv[t0:t1], r.double())
            self._frac_mean64 = _to_host(acc / n_t)
        return self._frac_mean64

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

    def _to_device(self, host: np.ndarray, dtype=np.float32) -> torch.Tensor:
        # An upload from pageable memory is staged before the call returns, so
        # non_blocking never reads a freed buffer; it only skips a stream sync.
        host = np.array(host, dtype=dtype, order='C')
        if self.device.type == 'cuda':
            count('htod_bytes', host.nbytes)
        return torch.from_numpy(host).to(self.device, non_blocking=True)

    def clear_device_cache(self) -> None:
        """Drop cached device-resident group data, the mesh's resident shards
        included (frees device memory)."""
        with self._cache_lock:
            self._device_cache.clear()
            self._device_cache_order.clear()
            self._resident_shards = None

    def _group_cache_key(self, group_idx: np.ndarray) -> bytes:
        return group_idx.tobytes() + (b'D' if self.use_displacements else b'V') \
            + (b'M' if self.mass_weighted else b'') \
            + (b'F' if self._phase_anchor == 'fractional' else b'')

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

    def preload_mesh_group_data(self, mesh, shards: Dict[tuple, torch.Tensor],
                                mp_hi: Dict[tuple, torch.Tensor],
                                mp_lo: Dict[tuple, torch.Tensor]) -> None:
        """Install the trajectory's data resident on the devices of ``mesh``:
        :meth:`preload_device_group_data` for a mesh, all atoms.

        ``shards``, ``mp_hi`` and ``mp_lo`` map each position (t, a, k) that
        this process owns to its float32 tensors on that position's device,
        as :class:`psa_tpu_torch.parallel.ResidentShards` lays them out: the
        (n_t/T, A_a, 3) window of time slice t and atom shard a, and that
        shard's (A_a, 3) split mean positions.  The windows hold what the
        mesh's direct SED would read from the trajectory: the velocities,
        or the positions in displacement mode (the mean is subtracted on
        the devices); group weights and √mass apply as they do to a host
        source.  Afterwards ``calculate_kgrid_peaks_sharded``,
        ``calculate_kgrid_browse_sharded`` and ``calculate_lt_sharded`` on
        ``mesh`` with no ``data`` read these windows where they lie:
        nothing of the trajectory crosses the host, and the k-vectors are a
        call's only upload; on another mesh they raise.  Raises for a window
        missing, of the wrong shape or type, or on another device.  One mesh
        at a time; cleared by :meth:`clear_device_cache`.
        """
        from ..parallel.sharded import ResidentShards
        resident = ResidentShards(mesh, shards, mp_hi, mp_lo, self.traj.n_frames,
                                  self.traj.n_atoms)
        with self._cache_lock:
            self._resident_shards = resident

    @property
    def resident_mesh(self):
        """The mesh whose positions hold the trajectory's data
        (:meth:`preload_mesh_group_data`), else None."""
        return None if self._resident_shards is None else self._resident_shards.mesh

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

    def _oversize(self, group_idx: np.ndarray) -> bool:
        """True for a group larger than ``max_device_bytes``: it streams."""
        return self._group_bytes(group_idx) > self.max_device_bytes

    # ------------------------------------------------------------------
    # Groups over max_device_bytes: atom blocks streamed from the host
    # ------------------------------------------------------------------

    def stream_block_atoms(self, n_atoms: int) -> int:
        """Atoms per streamed block: a quarter of ``max_device_bytes``, at
        most :data:`STREAM_BLOCK_BYTES` (two such blocks are staged)."""
        budget = min(self.max_device_bytes // 4, STREAM_BLOCK_BYTES)
        return max(1, min(n_atoms, budget // (12 * max(1, self.traj.n_frames))))

    @staticmethod
    def _host_blocks(group_idx: np.ndarray):
        """take(src, a0, a1): the (n_t, a1 − a0, 3) host rows of atoms
        ``group_idx[a0:a1]`` of a trajectory array; a slice, not a gather,
        when the group is a run of consecutive atoms."""
        n = int(group_idx.size)
        if n and int(group_idx[-1]) - int(group_idx[0]) == n - 1 and bool(
                np.all(np.diff(group_idx) == 1)):
            first = int(group_idx[0])
            return lambda src, a0, a1: src[:, first + a0:first + a1]
        return lambda src, a0, a1: src[:, group_idx[a0:a1]]

    def _stream_group(self, group_idx: np.ndarray, block_atoms: Optional[int] = None):
        """Yield (a0, a1, data, mp_hi, mp_lo) device tensors for consecutive
        atom blocks [a0, a1) of a group, read from the host trajectory.

        The blocks cross as :meth:`_staged_blocks` stages them, so the host
        gathers and copies block b+1 while the kernels of block b run; the
        displacement and mass transforms then run on the device exactly as
        :meth:`_group_device_arrays` runs them on a resident group.  A
        block's tensors are valid until the next block but one.
        """
        block = block_atoms or self.stream_block_atoms(int(group_idx.size))
        hi_host, lo_host = spectral.split_f64(self.mean_positions64[group_idx])
        hi_dev, lo_dev = self._to_device(hi_host), self._to_device(lo_host)
        weights = (torch.sqrt(self._to_device(self.traj.masses[group_idx]))
                   if self.mass_weighted else None)
        src = self.traj.positions if self.use_displacements else self.traj.velocities
        for a0, a1, (data,) in self._staged_blocks(group_idx, block, [src]):
            hi, lo = hi_dev[a0:a1], lo_dev[a0:a1]
            if self.use_displacements:
                data = spectral.displacement_data(data, hi, lo)
            if weights is not None:
                data = data * weights[a0:a1][None, :, None]
            yield a0, a1, data, hi, lo

    def _staged_blocks(self, group_idx: np.ndarray, block: int, srcs):
        """Yield (a0, a1, blocks) for consecutive blocks [a0, a1) of ``block``
        atoms of a group: of each host array of ``srcs`` (None: none read),
        the (n_t, a1 − a0, 3) float32 rows on the device, staged through
        pinned memory on a side stream
        (:class:`~psa_tpu_torch.utils.transfer.HostToDevice`).  The bytes
        staged add to ``streamed_bytes`` once the last block is taken."""
        n, n_t = int(group_idx.size), self.traj.n_frames
        take = self._host_blocks(group_idx)
        stagers = [None if src is None else HostToDevice(self.device, n_t * block * 3)
                   for src in srcs]
        logger.info("Streaming %d atoms in blocks of %d from the host.", n, block)
        for a0 in range(0, n, block):
            a1 = min(a0 + block, n)
            yield a0, a1, tuple(None if src is None else st.put(
                lambda dst, src=src: copy_rows(dst, take(src, a0, a1)), (n_t, a1 - a0, 3))
                for st, src in zip(stagers, srcs))
        self.streamed_bytes += sum(st.bytes_moved for st in stagers if st is not None)

    def _streamed_projections(self, group_idx: np.ndarray, k_chunks: List[torch.Tensor]):
        """(re, im) projections of an oversize group on each device k-chunk.

        The group streams once: every atom block feeds every chunk's
        (n_t, 3, K) accumulator (the kernel's ``accumulate=True``), so each
        k-point's sum runs over the blocks in atom order, as when the group
        is streamed once per chunk.
        """
        n_t = self.traj.n_frames
        outs = [tuple(torch.empty((n_t, 3, len(kv)), dtype=torch.float32, device=self.device)
                      for _ in range(2)) for kv in k_chunks]
        for i, (_, _, data, hi, lo) in enumerate(self._stream_group(group_idx)):
            for out, kv in zip(outs, k_chunks):
                sed_projection(data, hi, lo, kv, out=out, accumulate=i > 0,
                               precision=self.precision)
        return outs

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
        Chunk i+1's kernel is enqueued before chunk i is read back (into
        pinned memory, on a side stream), so the host assembles chunk i while
        the device computes chunk i+1.  On CUDA a result of at most
        ``PINNED_RESULT_BYTES`` is itself pinned, drawn from PyTorch's pinned
        cache (a dropped result's pages come back warm), and a chunk that
        spans the k axis is read back straight into it; each call still
        returns an array of its own.  A group over ``max_device_bytes``
        streams from the host in atom blocks (:meth:`_stream_group`).

        ``cache_dir`` checkpoints each finished chunk under a content-derived
        key (:class:`psa_tpu_torch.io.shard_cache.ShardedSEDCache`, the JAX
        package's key and layout): an interrupted sweep resumes by computing
        only the missing chunks.
        """
        atom_groups, groups, reduction = self._reduction(
            'spectrum', basis_atom_indices, basis_atom_types, summation_mode)
        n_t, n_atoms_tot = self.traj.n_frames, self.traj.n_atoms
        if n_t == 0 or n_atoms_tot == 0:
            logger.warning("Cannot calculate SED: 0 frames or 0 atoms.")
            return SED(np.array([], dtype=np.complex64).reshape(0, 0, 3),
                       np.array([], dtype=np.float32), k_points_mags, k_vectors_3d,
                       k_grid_shape=k_grid_shape, is_complex=True, phase=None)

        freqs = spectral.fftfreq_thz(n_t, self.dt_ps)
        is_complex_output = reduction.kind == 'spectrum'
        num_k = len(k_vectors_3d)
        shape = (len(freqs), num_k, 3) if is_complex_output else (len(freqs), num_k)
        dtype = torch.complex64 if is_complex_output else torch.float32
        with span('psa.host.assemble'):
            # pinned only where a chunk or the cache's resume writes every element
            pinned = (bool(groups) and self.device.type == 'cuda'
                      and 0 < dtype.itemsize * int(np.prod(shape)) <= PINNED_RESULT_BYTES)
            full_t = torch.empty(shape, dtype=dtype, pin_memory=True) if pinned else None
            full_sed = (full_t.numpy() if pinned
                        else np.zeros(shape, dtype=np.complex64 if is_complex_output else np.float32))
        if num_k == 0:
            logger.warning("k_vectors_3d is empty. Returning SED object with empty SED data.")

        cache = None
        if cache_dir is not None and num_k > 0:
            from ..io.shard_cache import ShardedSEDCache, trajectory_fingerprint
            cache = ShardedSEDCache(Path(cache_dir), workload={
                'traj': trajectory_fingerprint(self.traj),
                'k_vectors': np.asarray(k_vectors_3d, dtype=np.float32),
                'groups': [g.tolist() for g in atom_groups],
                'mode': summation_mode,
                'use_displacements': self.use_displacements,
                'mass_weighted': self.mass_weighted,
                'precision': self.precision,
                'dt_ps': float(self.dt_ps),
                'k_chunk_size': _chunk_block(k_chunk_size, num_k),
                'anchor': self._phase_anchor,
            })

        def into(s, e):
            # a chunk that spans the k axis is read back straight into the pinned Φ
            dst = None if full_t is None else full_t[:, s:e]
            return [dst] if dst is not None and dst.is_contiguous() else None

        self._project(groups, reduction, k_vectors_3d, k_chunk_size, [full_sed], cache,
                      into=into)
        return SED(full_sed, freqs, k_points_mags, k_vectors_3d,
                   k_grid_shape=k_grid_shape, is_complex=is_complex_output, phase=None,
                   dt_ps=self.dt_ps)

    # ------------------------------------------------------------------
    # Shared set-up and the k-chunk loop: spectrum groups, the reduction,
    # k-chunks, resume, the sweep
    # ------------------------------------------------------------------

    @staticmethod
    def _spectrum_groups(atom_groups: List[np.ndarray], summation_mode: str):
        """(groups, single_spectrum): coherent mode (or one group) reduces the
        union group's spectrum once; incoherent mode sums per-group planes.
        Only a 0-atom trajectory resolves to an empty group; it is dropped,
        so a sweep over no groups leaves its planes at zero."""
        if summation_mode == 'coherent' or len(atom_groups) <= 1:
            union = _union_group(atom_groups)
            return ([union] if union.size else []), True
        return atom_groups, False

    def _reduction(self, kind: str, basis_atom_indices, basis_atom_types,
                   summation_mode: str, **checked):
        """(atom_groups, groups, reduction) of a projection surface: the
        resolved groups, the spectrum groups (:meth:`_spectrum_groups`) and
        :meth:`spectral.Reduction.for_surface` of ``kind`` with the surface's
        other arguments ``checked`` (shared by each surface and its mesh
        twin)."""
        atom_groups = self._resolve_atom_groups(basis_atom_indices, basis_atom_types,
                                                summation_mode)
        groups, single = self._spectrum_groups(atom_groups, summation_mode)
        return atom_groups, groups, spectral.Reduction.for_surface(
            kind, self.traj.n_frames, self.dt_ps, summation_mode, single, **checked)

    def _host_outputs(self, reduction: spectral.Reduction, num_k: int) -> List[np.ndarray]:
        """A surface's zeroed float32 host outputs, (*lead, num_k) for each
        lead of ``reduction``."""
        with span('psa.host.assemble'):
            return [np.zeros(lead + (num_k,), dtype=np.float32)
                    for lead in reduction.leads(self.traj.n_frames)]

    @staticmethod
    def _chunk_bounds(num_k: int, k_chunk_size: int) -> List[Tuple[int, int]]:
        """(start, end) of each k-chunk; the last may be ragged (the kernel
        masks it, so nothing is padded)."""
        block = _chunk_block(k_chunk_size, num_k)
        return [(s, min(s + block, num_k)) for s in range(0, num_k, block)]

    def _chunk_cache(self, cache_dir, observable: str, k_vectors_3d, k_chunk_size: int,
                     extra: Optional[Dict] = None):
        """Per-k-chunk resumable-sweep cache, or None: the JAX package's
        content key (trajectory fingerprint, k set, observable, calculator
        transforms, ``phase_mode``, phase anchor, chunk size, observable
        parameters), so a cache written by either package resumes in the
        other."""
        if cache_dir is None:
            return None
        from ..io.shard_cache import ShardedSEDCache, trajectory_fingerprint
        workload = {
            'traj': trajectory_fingerprint(self.traj),
            'observable': observable,
            'k_vectors': np.asarray(k_vectors_3d, dtype=np.float32),
            'use_displacements': self.use_displacements,
            'mass_weighted': self.mass_weighted,
            'precision': self.precision,
            'phase_mode': self.phase_mode,
            'anchor': self._phase_anchor,
            'dt_ps': float(self.dt_ps),
            'k_chunk_size': _chunk_block(k_chunk_size, len(k_vectors_3d)),
        }
        if extra:
            workload.update(extra)
        return ShardedSEDCache(Path(cache_dir), workload=workload)

    def _sweep(self, num_k: int, k_chunk_size: int, cache, fits, chunks, reduce, store,
               into=None, read_once: bool = False) -> None:
        """The k-chunk loop of every chunked surface.  A chunk stored in
        ``cache`` that ``fits(chunk, s, e)`` goes to ``store(chunk, None, s,
        e, cached=True)``; for the others, ``chunks(bounds, todo)`` yields
        (ci, s, e, *device results), ``reduce(s, e, *results)`` gives the
        device arrays to read back, and ``store(arrays, ci, s, e)`` takes
        them on the host (one-deep pinned readback: the host stores chunk i
        while the device computes chunk i+1).  ``into(s, e)`` may name
        pinned host tensors for a chunk's arrays to land in
        (:class:`DeviceToHost`).  With ``read_once`` every chunk's arrays
        stay on the device and are read back after the last, concatenated
        along k: one wait, then ``store(arrays, None, 0, num_k)``."""
        bounds, todo = self._chunk_bounds(num_k, k_chunk_size), []
        for ci, (s, e) in enumerate(bounds):
            stored = cache.load(ci) if cache is not None else None
            if stored is not None and fits(stored, s, e):
                store(stored, None, s, e, cached=True)
            else:
                todo.append(ci)
        if cache is not None and len(todo) < len(bounds):
            logger.info("shard cache %s: %d/%d chunks resumed.", cache.key,
                        len(bounds) - len(todo), len(bounds))
        if not todo:
            return
        if read_once:
            found = [reduce(s, e, *res) for _, s, e, *res in chunks(bounds, todo)]
            if found:
                arrays = [_to_host(torch.cat(col, dim=-1)) for col in zip(*found)]
                with span('psa.host.assemble'):
                    store(arrays, None, 0, num_k)
            return
        readback = DeviceToHost(self.device)
        for ci, s, e, *res in chunks(bounds, todo):
            readback.push(list(reduce(s, e, *res)), functools.partial(store, ci=ci, s=s, e=e),
                          into=into(s, e) if into is not None else None)
        readback.finish()

    def _project(self, groups: List[np.ndarray], reduction: spectral.Reduction, k_vectors_3d,
                 k_chunk_size: int, outs: List[np.ndarray], cache=None, **sweep) -> None:
        """:meth:`_sweep` of a projection surface into its host outputs
        ``outs`` (k on axis 1): each k-chunk's groups projected in turn
        (:class:`_Projections`), drawn one at a time by ``reduction``, whose
        :meth:`~spectral.Reduction.host` takes the readback; no groups, no
        chunk.  ``cache`` keeps a chunk as the outputs stacked (one output:
        itself), and a stored chunk of that shape resumes."""
        def chunks(bounds, todo):
            if not groups:
                return
            on = reduction.inputs(self.device, self._to_device)
            proj = _Projections(self, groups, self._to_device(k_vectors_3d), bounds, todo)

            def pairs(ci):
                return (proj.get(gi, ci) for gi in range(len(groups)))
            for ci in todo:
                s, e = bounds[ci]
                logger.debug("Processing k-chunk %d/%d (indices %d-%d)", ci + 1, len(bounds),
                             s, e - 1)
                yield ci, s, e, pairs(ci), on

        def store(arrays, ci, s, e, cached=False):
            planes = ((list(arrays) if len(outs) > 1 else [arrays]) if cached
                      else reduction.host(arrays))
            for o, p in zip(outs, planes):
                if not np.may_share_memory(o, p):       # else read back in place
                    o[:, s:e] = p
            if cache is not None and not cached:
                chunk = [o[:, s:e] for o in outs]
                cache.store(ci, np.stack(chunk) if len(outs) > 1 else chunk[0])

        def fits(c, s, e):
            stack = (len(outs),) if len(outs) > 1 else ()
            return c.shape == stack + outs[0].shape[:1] + (e - s,) + outs[0].shape[2:]
        self._sweep(len(k_vectors_3d), k_chunk_size, cache, fits, chunks, reduction.reduce,
                    store, **sweep)

    # ------------------------------------------------------------------
    # Welch/Bartlett segment-averaged spectra
    # ------------------------------------------------------------------

    def calculate_welch(self, k_points_mags: np.ndarray,
                        k_vectors_3d: np.ndarray, segments: int,
                        window: str = 'hann',
                        basis_atom_indices=None, basis_atom_types=None,
                        summation_mode: str = 'coherent',
                        k_grid_shape: Optional[Tuple[int, int]] = None,
                        k_chunk_size: int = 500) -> SED:
        """Welch/Bartlett estimate: the SED intensity averaged over ``segments``
        non-overlapping time windows of n_t // segments frames.

        Averaging S windows cuts the per-bin relative variance by ~1/S at
        n_t // S frequency bins.  ``window='hann'`` tapers each segment (unit
        coherent gain); ``'rect'`` is the plain Bartlett split.  Group
        semantics follow :meth:`calculate`.  Returns an intensity SED
        (``is_complex=False``) with n_t // segments frequency rows.  A group
        over ``max_device_bytes`` streams: the taper multiplies the projected
        signal, so the atom blocks stream once for all segments.
        """
        _, groups, reduction = self._reduction(
            'welch', basis_atom_indices, basis_atom_types, summation_mode,
            welch_segments=segments, welch_window=window)
        if self.traj.n_frames == 0 or self.traj.n_atoms == 0:
            logger.warning("Cannot calculate Welch SED: 0 frames or 0 atoms.")
            return SED(np.zeros((0, len(k_vectors_3d)), dtype=np.float32),
                       np.array([], dtype=np.float32), k_points_mags,
                       k_vectors_3d, k_grid_shape=k_grid_shape,
                       is_complex=False)
        (full,) = self._host_outputs(reduction, len(k_vectors_3d))
        self._project(groups, reduction, k_vectors_3d, k_chunk_size, [full])
        return SED(full, spectral.fftfreq_thz(len(full), self.dt_ps), k_points_mags,
                   k_vectors_3d, k_grid_shape=k_grid_shape, is_complex=False, dt_ps=self.dt_ps,
                   trajectory_metadata={'welch_segments': reduction.segments, 'window': window})

    # ------------------------------------------------------------------
    # Device-reduced k-grid browsing
    # ------------------------------------------------------------------

    def calculate_kgrid_browse(self, k_vectors_3d: np.ndarray,
                               basis_atom_indices=None, basis_atom_types=None,
                               summation_mode: str = 'coherent',
                               max_freq: Optional[float] = None,
                               chiral: bool = False, chiral_axis: str = 'z',
                               angle_range_opt: str = 'C',
                               k_chunk_size: int = 2048,
                               engine: str = 'direct',
                               k_grid_shape: Optional[Tuple[int, int]] = None,
                               welch_segments: Optional[int] = None,
                               welch_window: str = 'hann',
                               readback_dtype: str = 'float32',
                               cache_dir=None):
        """K-grid sweep reduced on the device to what a heat-map browser reads.

        Only the ω ≥ 0 (and ≤ ``max_freq``) intensity planes, plus the chiral
        phase when ``chiral`` is set, leave the device, one k-chunk at a
        time, through the same one-deep pinned readback as :meth:`calculate`.
        Group semantics follow :meth:`calculate`: coherent (or single-group)
        reduces the union group's spectrum; incoherent sums per-group
        intensities (chiral then raises).  A group over ``max_device_bytes``
        streams from the host.

        ``welch_segments`` switches to the segment-averaged estimator (the
        chiral phase becomes the segment-averaged cross-spectral phase).
        ``readback_dtype='float16'`` ships each chunk's intensity as
        sqrt-domain float16 with one float32 scale per group and the phase as
        float16; the returned arrays are float32 either way.  ``cache_dir``
        checkpoints each chunk's planes (see :meth:`calculate`).

        ``engine`` is 'direct' ('auto' resolves to it) or 'gridded': a
        uniform grid goes through the NUFFT engine
        (:func:`psa_tpu_torch.ops.gridded.gridded_kgrid_browse`) with the
        same reduction fused on the device.  It needs ``k_grid_shape``, sums
        coherently (one spectrum), takes float32 readback only, no Welch
        segments and no ``cache_dir``; a group over ``max_device_bytes``
        streams through it in time superchunks.

        Returns:
            (freqs_kept (n_keep,), intensity (n_keep, n_k) float32,
             phase (n_keep, n_k) float32 or None)
        """
        _, groups, reduction = self._reduction(
            'browse', basis_atom_indices, basis_atom_types, summation_mode, engine=engine,
            cache_dir=cache_dir, max_freq=max_freq, chiral=chiral, chiral_axis=chiral_axis,
            angle_range_opt=angle_range_opt, welch_segments=welch_segments,
            welch_window=welch_window, readback_dtype=readback_dtype)
        if engine == 'gridded':
            intensity, phase = self._gridded_sweep(
                k_vectors_3d, k_grid_shape, groups, reduction.freq_idx,
                comp_pair=reduction.comp_pair, angle_range_opt=angle_range_opt)
            return reduction.freqs_kept, intensity, phase
        if engine not in ('direct', 'auto'):
            raise ValueError(f"engine must be 'direct' or 'gridded', got {engine!r}")
        outs = self._host_outputs(reduction, len(k_vectors_3d))
        comp_pair = reduction.comp_pair
        cache = self._chunk_cache(
            cache_dir, 'browse', k_vectors_3d, k_chunk_size,
            {'groups': [g.tolist() for g in groups], 'mode': summation_mode,
             'max_freq': max_freq, 'chiral': list(comp_pair) if comp_pair else None,
             'angle': angle_range_opt, 'welch': [reduction.segments, welch_window],
             'readback': readback_dtype})
        self._project(groups, reduction, k_vectors_3d, k_chunk_size, outs, cache)
        return reduction.freqs_kept, outs[0], (outs[1] if comp_pair is not None else None)

    # ------------------------------------------------------------------
    # Longitudinal / transverse polarization decomposition
    # ------------------------------------------------------------------

    def calculate_lt(self, k_vectors_3d: np.ndarray,
                     basis_atom_indices=None, basis_atom_types=None,
                     summation_mode: str = 'coherent',
                     max_freq: Optional[float] = None,
                     k_chunk_size: int = 2048):
        """Longitudinal and transverse SED intensities, reduced on the device:

            I_L(ω,k) = |Σ_c k̂_c Φ_c(ω,k)|²,   I_T = Σ_c |Φ_c|² − I_L.

        I_L carries the longitudinal branches, I_T the two transverse ones;
        I_L + I_T is :meth:`calculate_kgrid_browse`'s intensity.  At Γ
        (|k| = 0) the convention is I_L = 0, I_T = total.  Group semantics
        follow :meth:`calculate`; incoherent mode sums per-group planes; a
        group over ``max_device_bytes`` streams from the host.

        Returns:
            (freqs_kept (n_keep,), I_L (n_keep, n_k) float32,
             I_T (n_keep, n_k) float32)
        """
        _, groups, reduction = self._reduction(
            'lt', basis_atom_indices, basis_atom_types, summation_mode, max_freq=max_freq,
            k_vectors=k_vectors_3d)
        outs = self._host_outputs(reduction, len(k_vectors_3d))
        self._project(groups, reduction, k_vectors_3d, k_chunk_size, outs)
        return (reduction.freqs_kept,) + tuple(outs)

    # ------------------------------------------------------------------
    # On-device peak extraction (dispersion surfaces)
    # ------------------------------------------------------------------

    def calculate_kgrid_peaks(self, k_vectors_3d: np.ndarray,
                              basis_atom_indices=None, basis_atom_types=None,
                              summation_mode: str = 'coherent',
                              max_freq: Optional[float] = None,
                              n_peaks: int = 1, exclusion_bins: int = 4,
                              k_chunk_size: int = 2048,
                              engine: str = 'auto',
                              k_grid_shape: Optional[Tuple[int, int]] = None,
                              chiral: bool = False, chiral_axis: str = 'z',
                              angle_range_opt: str = 'C',
                              width_method: str = 'rms',
                              welch_segments: Optional[int] = None,
                              welch_window: str = 'hann',
                              cache_dir=None):
        """Top-``n_peaks`` spectral peaks per k-point, extracted on the device.

        Computes the planes of :meth:`calculate_kgrid_browse` chunk by chunk
        and finds their peaks (:func:`psa_tpu_torch.ops.spectral.peak_reduce`)
        where they lie: the planes never leave the device, the chunk loop
        never waits for it, and only the 3·n_peaks·n_k peak floats are read
        back, once, at the end.  Incoherent mode sums the per-group
        intensities on the device before the peaks are found.  ``chiral``
        (coherent) also gathers the chiral phase at each peak and appends a
        fourth array.  ``width_method`` is 'rms' (a spread proxy) or
        'lorentzian' (calibrated FWHM); ``welch_segments`` takes the peaks of
        the segment-averaged planes.

        ``cache_dir`` checkpoints each chunk's peaks (one readback per chunk,
        through the pinned readback pipeline).  A group over
        ``max_device_bytes`` streams from the host into the same on-device
        reduction.  (The JAX package takes such a group's peaks from host
        browse planes instead, and caches those planes, so its cache of an
        oversize peaks sweep does not resume here.)

        ``engine='auto'`` runs the direct engine.  (The JAX package routes
        big uniform grids to its NUFFT engine on TPU measurements; the port
        does not carry that rule over.)  ``engine='gridded'`` takes a uniform
        grid through the NUFFT engine
        (:func:`psa_tpu_torch.ops.gridded.gridded_kgrid_browse`) with the
        same on-device peak reduction: it needs ``k_grid_shape``, sums
        coherently, and takes no chiral phase, Welch segments or
        ``cache_dir``; a group over ``max_device_bytes`` streams through it
        in time superchunks.

        Returns:
            (peak_freqs, peak_heights, peak_widths[, peak_phase]): each
            (n_peaks, n_k) float32, by descending height per k-column.
        """
        _, groups, reduction = self._reduction(
            'peaks', basis_atom_indices, basis_atom_types, summation_mode, engine=engine,
            cache_dir=cache_dir, max_freq=max_freq, chiral=chiral, chiral_axis=chiral_axis,
            angle_range_opt=angle_range_opt, welch_segments=welch_segments,
            welch_window=welch_window, n_peaks=n_peaks, exclusion_bins=exclusion_bins,
            width_method=width_method)
        if engine == 'gridded':
            return self._gridded_sweep(
                k_vectors_3d, k_grid_shape, groups, reduction.freq_idx,
                n_peaks=n_peaks, exclusion_bins=exclusion_bins,
                freqs_kept=reduction.freqs_kept, width_method=width_method)
        if engine not in ('direct', 'auto'):
            raise ValueError(f"engine must be 'auto', 'direct' or 'gridded', got {engine!r}")
        num_k = len(k_vectors_3d)
        outs = self._host_outputs(reduction, num_k)
        if num_k == 0 or not groups:
            return tuple(outs)
        comp_pair = reduction.comp_pair
        cache = self._chunk_cache(
            cache_dir, 'peaks', k_vectors_3d, k_chunk_size,
            {'groups': [g.tolist() for g in groups], 'mode': summation_mode,
             'max_freq': max_freq, 'n_peaks': int(n_peaks),
             'exclusion_bins': int(exclusion_bins), 'width_method': width_method,
             'chiral': list(comp_pair) if comp_pair else None,
             'angle': angle_range_opt, 'welch': [reduction.segments, welch_window]})
        # uncached, the peaks stay on the device until one read after the last chunk
        self._project(groups, reduction, k_vectors_3d, k_chunk_size, outs, cache,
                             read_once=cache is None)
        return tuple(outs)

    # ------------------------------------------------------------------
    # Gridded (NUFFT-accelerated) k-grid sweeps
    # ------------------------------------------------------------------

    @staticmethod
    def _detect_grid_axes(k_vectors_3d: np.ndarray, k_grid_shape):
        """Classify a tensor-product k-grid's columns as (slow, fast, fixed).

        Detection is by which grid axis each component varies along.  A
        degenerate grid (n1 == 1 or n2 == 1 from ``get_k_grid``) leaves its
        plane column constant, like the fixed column: roles left open are
        filled by the cyclic plane convention of ``get_k_grid`` (xy → (0, 1,
        2), yz → (1, 2, 0), zx → (2, 0, 1)).

        Returns (kx_vals f64, ky_vals f64, k_fixed, (slow, fast, fixed)).
        """
        n1, n2 = k_grid_shape
        if n1 * n2 != len(k_vectors_3d):
            raise ValueError("k_grid_shape does not match k_vectors_3d")
        mat = np.asarray(k_vectors_3d, dtype=np.float32).reshape(n1, n2, 3)
        slow_col = fast_col = None
        for c in range(3):
            col = mat[:, :, c]
            varies_slow = not np.allclose(col, col[:1, :], atol=1e-7)
            varies_fast = not np.allclose(col, col[:, :1], atol=1e-7)
            if varies_slow and varies_fast:
                raise ValueError(
                    "k_vectors_3d is not a tensor-product grid from get_k_grid")
            if varies_slow:
                if slow_col is not None:
                    raise ValueError(
                        "k_vectors_3d is not a tensor-product grid from get_k_grid")
                slow_col = c
            elif varies_fast:
                if fast_col is not None:
                    raise ValueError(
                        "k_vectors_3d is not a tensor-product grid from get_k_grid")
                fast_col = c
        if slow_col is not None and fast_col is not None:
            fixed_col = 3 - slow_col - fast_col
        elif fast_col is not None:          # 1 x n2 grid
            slow_col, fixed_col = (fast_col - 1) % 3, (fast_col + 1) % 3
        elif slow_col is not None:          # n1 x 1 grid
            fast_col, fixed_col = (slow_col + 1) % 3, (slow_col + 2) % 3
        else:                               # 1 x 1 grid
            slow_col, fast_col, fixed_col = 0, 1, 2
        return (mat[:, 0, slow_col].astype(np.float64),
                mat[0, :, fast_col].astype(np.float64),
                float(mat[0, 0, fixed_col]),
                (slow_col, fast_col, fixed_col))

    def _group_block_source(self, group_idx: np.ndarray, raw: Optional[str] = None):
        """Streamed host-side view of one group's SED input data, for the
        gridded sweep of a group over ``max_device_bytes``:
        ``read_block(t0, t1, a0, a1)`` applies the transforms of
        :meth:`_group_device_arrays` (displacement-mode mean subtraction, in
        float64 against the stored means, and mass weights) per block read.
        ``raw`` ('positions' or 'velocities') reads that array untransformed."""
        traj, disp = self.traj, self.use_displacements and raw is None
        mean64 = self.mean_positions64[group_idx] if disp else None
        weights = (np.sqrt(traj.masses[group_idx]).astype(np.float32)
                   if self.mass_weighted and raw is None else None)
        plain = traj.positions if raw == 'positions' else traj.velocities
        take = self._host_blocks(group_idx)

        class _Source:
            n_frames = traj.n_frames
            n_atoms = int(group_idx.size)

            @staticmethod
            def read_block(t0, t1, a0, a1):
                if disp:
                    block = take(traj.positions[t0:t1], a0, a1).astype(np.float64)
                    block = (block - mean64[a0:a1]).astype(np.float32)
                else:
                    block = np.asarray(take(plain[t0:t1], a0, a1), dtype=np.float32)
                if weights is not None:
                    block = block * weights[None, a0:a1, None]
                return block

        return _Source()

    def _gridded_plan(self, union: np.ndarray, k_vectors_3d, k_grid_shape):
        """The gridded engine's host plan (:func:`psa_tpu_torch.ops.gridded.plan_kgrid`)
        of a group on a k-grid.  The plan depends on the mean positions and
        the grid alone and takes about 0.15 s of NumPy at 10⁵ atoms, so the
        last two are kept: a browse and a peaks sweep of one grid plan once."""
        from ..ops import gridded
        kx_vals, ky_vals, k_fixed, axes = self._detect_grid_axes(
            np.asarray(k_vectors_3d, dtype=np.float32), k_grid_shape)
        key = (union.tobytes(), kx_vals.tobytes(), ky_vals.tobytes(), k_fixed, axes,
               self._phase_anchor)
        plan = self._grid_plans.pop(key, None)
        if plan is None:
            plan = gridded.plan_kgrid(self.mean_positions64[union], kx_vals, ky_vals,
                                      k_fixed=k_fixed, axes=axes)
        self._grid_plans[key] = plan                      # most recent last
        while len(self._grid_plans) > 2:
            self._grid_plans.pop(next(iter(self._grid_plans)))
        return plan

    def _gridded_grid_budget(self) -> Optional[int]:
        """Bytes for the gridded engine's full-time grid accumulators of one
        ky block: on the card, a quarter of the device memory that is free
        now (a 200×200 grid's accumulators are 96 MB per ky column at 10⁴
        frames, so a constant would not do); None (the engine's defaults) on
        the CPU."""
        if self.device.type != 'cuda':
            return None
        with span('psa.gridded.budget'):
            free, _ = torch.cuda.mem_get_info(self.device)
            free += (torch.cuda.memory_reserved(self.device)
                     - torch.cuda.memory_allocated(self.device))
        return int(free) // 4

    def _gridded_input(self, groups: List[np.ndarray], k_vectors_3d, k_grid_shape, data=None):
        """Checks, plan and data of ``engine='gridded'`` on the one (union)
        group of a coherent sweep (``groups``: its spectrum groups): the
        group's resident device data, its streamed host view when it is over
        ``max_device_bytes``, or a mesh's ``data`` source that already holds
        SED-ready data (velocities, or mean-subtracted, mass-weighted
        displacements)."""
        if len(groups) > 1:
            raise ValueError("engine='gridded' supports coherent "
                             "(single-spectrum) sweeps only.")
        if k_grid_shape is None:
            raise ValueError("engine='gridded' needs k_grid_shape.")
        if data is not None and not hasattr(data, 'read_block'):
            raise ValueError("engine='gridded' takes the trajectory's group data or a "
                             "BlockSource; array overrides run on the direct engine.")
        union = _union_group(groups)
        plan = self._gridded_plan(union, k_vectors_3d, k_grid_shape)
        if data is not None:
            if data.n_atoms != union.size:
                raise ValueError(f"engine='gridded' BlockSource has {data.n_atoms} atoms "
                                 f"but the group selects {union.size}")
            if data.n_frames != self.traj.n_frames:
                raise ValueError(f"engine='gridded' BlockSource has {data.n_frames} frames "
                                 f"but the trajectory has {self.traj.n_frames}")
            if self.use_displacements or self.mass_weighted:
                raise ValueError("engine='gridded' consumes a BlockSource as-is; "
                                 "displacement mode / mass weighting are not applied "
                                 "on this path: stream pre-transformed data or use "
                                 "engine='direct'")
            return plan, data
        if not union.size:
            return plan, np.zeros((self.traj.n_frames, 0, 3), dtype=np.float32)
        if self._oversize(union):
            return plan, self._group_block_source(union)
        return plan, self._group_device_arrays(union)[0]

    def _gridded_sweep(self, k_vectors_3d, k_grid_shape, groups: List[np.ndarray],
                       freq_idx: np.ndarray, **reduce_kwargs):
        """:func:`psa_tpu_torch.ops.gridded.gridded_kgrid_browse` on the one
        (union) group of a coherent sweep (:meth:`_gridded_input`)."""
        from ..ops import gridded
        budget = self._gridded_grid_budget()
        plan, data = self._gridded_input(groups, k_vectors_3d, k_grid_shape)
        stats = {}
        out = gridded.gridded_kgrid_browse(
            data, plan, freq_idx, precision=self.precision, grid_budget_bytes=budget,
            device=self.device, stats=stats, **reduce_kwargs)
        self.streamed_bytes += stats['bytes_streamed']
        return out

    def calculate_gridded(self, k_vectors_3d: np.ndarray,
                          k_grid_shape: Tuple[int, int],
                          basis_atom_indices=None, basis_atom_types=None,
                          t_chunk: Optional[int] = None,
                          cell_chunk: Optional[int] = None,
                          gy_chunk: Optional[int] = None,
                          cache_dir: Optional[Union[str, Path]] = None) -> SED:
        """Coherent SED over a uniform k-grid by the hybrid gridded engine.

        About Gx/12 fewer products than :meth:`calculate` at about 1e-6
        accuracy (exact phases along the fast grid axis, a Kaiser-Bessel
        NUFFT along the slow one; :mod:`psa_tpu_torch.ops.gridded`).
        Restrictions: tensor-product uniformly spaced grids (anything from
        :meth:`get_k_grid`), coherent summation, one (union) atom group,
        resident on the device.

        ``cell_chunk`` (packing rows per chunk) bounds the spreading-weight
        tensor (default 2 GB per chunk), ``gy_chunk`` the ky columns whose
        full-time grids are held at once, ``t_chunk`` the frames per spread.
        The time FFT of each ky block runs on the device; the blocks cross
        to the host through a one-deep pinned readback.  ``cache_dir``
        checkpoints the result (the engine is one-shot, so the cache is
        all-or-nothing: a complete cached result is returned without
        computing), under the JAX package's key.
        """
        from ..ops import gridded
        n_t = self.traj.n_frames
        k_vectors_3d = np.asarray(k_vectors_3d, dtype=np.float32)
        n1, n2 = k_grid_shape
        self._detect_grid_axes(k_vectors_3d, k_grid_shape)       # refuses what is no grid
        union = _union_group(self._resolve_atom_groups(basis_atom_indices, basis_atom_types,
                                                       'coherent'))
        freqs = spectral.fftfreq_thz(n_t, self.dt_ps)

        def result(full_sed):
            return SED(full_sed, freqs, np.array([], dtype=np.float32), k_vectors_3d,
                       k_grid_shape=tuple(k_grid_shape), is_complex=True, phase=None,
                       dt_ps=self.dt_ps)

        cache = None
        if cache_dir is not None:
            from ..io.shard_cache import ShardedSEDCache, trajectory_fingerprint
            cache = ShardedSEDCache(Path(cache_dir), workload={
                'traj': trajectory_fingerprint(self.traj),
                'k_vectors': np.asarray(k_vectors_3d, dtype=np.float32),
                'group': union.tolist(),
                'engine': 'gridded',
                'use_displacements': self.use_displacements,
                'mass_weighted': self.mass_weighted,
                'precision': self.precision,
                'dt_ps': float(self.dt_ps),
            })
            cached = cache.load(0)
            if cached is not None and cached.shape == (n_t, n1 * n2, 3):
                logger.info("gridded SED cache %s: complete result reused.", cache.key)
                return result(cached)

        plan = self._gridded_plan(union, k_vectors_3d, k_grid_shape)
        # the calculator's device-resident group data: the displacement and
        # mass transforms already applied, shared with the direct engine
        if union.size > 0:
            data, _, _ = self._group_device_arrays(union)
        else:
            data = np.zeros((n_t, 0, 3), dtype=np.float32)
        full_sed = gridded.gridded_kgrid_spectrum(
            data, plan, t_chunk=t_chunk, cell_chunk=cell_chunk, gy_chunk=gy_chunk,
            precision=self.precision, time_fft=True,
            grid_budget_bytes=self._gridded_grid_budget(), device=self.device)
        if cache is not None:
            cache.store(0, full_sed)
        return result(full_sed)

    # ------------------------------------------------------------------
    # NPT: a time-dependent cell, phases anchored in fractional space
    # ------------------------------------------------------------------

    def _npt_k_setup(self, k_miller: np.ndarray):
        """(k_eff, k_cart, k_mags) for the fractional-anchor NPT paths:
        k_eff = 2π·m (the kernel's k against s̄), k_cart = B̄·m with
        B̄ = 2π h̄⁻ᵀ of the mean cell, and |k_cart|."""
        if self.traj.box_matrices is None:
            raise ValueError("NPT paths require Trajectory.box_matrices "
                             "(per-frame cells); this trajectory has none.")
        if self.use_displacements:
            raise ValueError("NPT paths support velocity projection only; "
                             "use_displacements entangles the Cartesian "
                             "mean with the moving cell.")
        m = np.asarray(k_miller, dtype=np.float64)
        if m.ndim != 2 or m.shape[1] != 3:
            raise ValueError(f"k_miller must be (n_k, 3) fractional "
                             f"wavevectors, got {m.shape}")
        k_eff = (2.0 * np.pi * m).astype(np.float32)
        hbar = np.mean(np.asarray(self.traj.box_matrices, dtype=np.float64), axis=0)
        bbar = 2.0 * np.pi * np.linalg.inv(hbar).T
        k_cart = (m @ bbar.T).astype(np.float32)
        return k_eff, k_cart, np.linalg.norm(k_cart, axis=1).astype(np.float32)

    def _fractional(self, run):
        """``run()`` with the fractional phase anchor; Cartesian again after,
        whatever happens."""
        self._phase_anchor = 'fractional'
        try:
            return run()
        finally:
            self._phase_anchor = 'cartesian'

    def calculate_npt(self, k_miller: np.ndarray,
                      basis_atom_indices=None, basis_atom_types=None,
                      summation_mode: str = 'coherent',
                      k_chunk_size: int = 500,
                      cache_dir: Optional[Union[str, Path]] = None) -> SED:
        """SED for a time-dependent (NPT) cell, anchored in fractional space.

        Projects onto exp(2πi m·s̄_a), s_a(t) = h(t)⁻¹ r_a(t) the per-frame
        fractional coordinates and ``m`` wavevectors in fractional units
        (integer rows = box-commensurate modes): the phases do not move with
        the cell's volume or shape, where the fixed-cell exp(i k·r̄) smears.
        Velocities are projected unchanged (Cartesian).  Runs
        :meth:`calculate` at k = 2π·m against s̄, through the same kernel.

        Requires ``Trajectory.box_matrices``; ``use_displacements`` is not
        supported (the Cartesian mean is entangled with the moving cell).
        Returns an :class:`SED` whose ``k_vectors`` are the mean-cell
        Cartesian images B̄·m and ``k_points`` their magnitudes.
        """
        k_eff, k_cart, k_mags = self._npt_k_setup(k_miller)
        sed = self._fractional(lambda: self.calculate(
            k_mags, k_eff, basis_atom_indices=basis_atom_indices,
            basis_atom_types=basis_atom_types, summation_mode=summation_mode,
            k_chunk_size=k_chunk_size, cache_dir=cache_dir))
        sed.k_vectors = k_cart     # physical axes for plotting/export
        return sed

    def calculate_npt_browse(self, k_miller: np.ndarray, mesh=None, **browse_kwargs):
        """Device-reduced browse planes for a time-dependent (NPT) cell: the
        fractional anchor of :meth:`calculate_npt` on
        :meth:`calculate_kgrid_browse`, or with ``mesh`` on
        :meth:`calculate_kgrid_browse_sharded` (``browse_kwargs`` pass through).

        Returns:
            (freqs_kept, intensity (n_keep, n_k) float32, phase or None,
             k_cart (n_k, 3) mean-cell Cartesian images).
        """
        k_eff, k_cart, _ = self._npt_k_setup(k_miller)
        freqs, inten, phase = self._fractional(
            lambda: self.calculate_kgrid_browse(k_eff, **browse_kwargs) if mesh is None
            else self.calculate_kgrid_browse_sharded(mesh, k_eff, **browse_kwargs))
        return freqs, inten, phase, k_cart

    def calculate_npt_peaks(self, k_miller: np.ndarray, mesh=None, **peaks_kwargs):
        """On-device peaks for a time-dependent (NPT) cell: the fractional
        anchor of :meth:`calculate_npt` on :meth:`calculate_kgrid_peaks`, or
        with ``mesh`` on :meth:`calculate_kgrid_peaks_sharded`
        (``peaks_kwargs`` pass through).

        Returns the peaks result plus ``k_cart``:
        (freq_surfaces, intensity_surfaces, width_surfaces[, phase], k_cart).
        """
        k_eff, k_cart, _ = self._npt_k_setup(k_miller)
        out = self._fractional(
            lambda: self.calculate_kgrid_peaks(k_eff, **peaks_kwargs) if mesh is None
            else self.calculate_kgrid_peaks_sharded(mesh, k_eff, **peaks_kwargs))
        return tuple(out) + (k_cart,)

    # ------------------------------------------------------------------
    # Instantaneous-phase observables: DSF, current spectra, S(k), ISF
    # ------------------------------------------------------------------

    def _instant_streams(self, group_idx: np.ndarray, with_velocities: bool) -> bool:
        """True when a group's positions (and velocities) exceed
        ``max_device_bytes``: the instantaneous-phase paths then stream it."""
        return (1 + with_velocities) * self._group_bytes(group_idx) > self.max_device_bytes

    def _dsf_box(self) -> Optional[torch.Tensor]:
        """Device (3, 3) float32 cell matrix for the incremental engine's
        minimum image, or None when the box is singular (degenerate axes)."""
        if self._phase_box_dev is None:
            box = np.asarray(self.traj.box_matrix, dtype=np.float64)
            if abs(np.linalg.det(box)) < 1e-12:
                return None
            self._phase_box_dev = self._to_device(box)
        return self._phase_box_dev

    def _phase_cfg(self, k_vectors_3d, mesh: bool = False
                   ) -> Tuple[Optional[torch.Tensor], str]:
        """(box, mode) of the instantaneous-phase engine on this k set.

        'auto' is 'exact' in every family.  The incremental engine's
        minimum image shifts phases by whole turns only for box-commensurate
        k, and the factored engine's anchor ⊕ delta algebra needs lattice k
        outright: off-lattice k (``commensurate_deviation`` > 1e-3) runs
        'exact'.  A singular box (no minimum image) turns 'incremental'
        into 'exact', and so does a ``mesh`` 'factored'.  ``box`` is the
        device cell matrix for 'incremental', else None."""
        mode = 'exact' if self.phase_mode == 'auto' else self.phase_mode
        if mode == 'factored' and mesh:
            mode = 'exact'
        if mode != 'exact' and len(k_vectors_3d) and instantaneous.commensurate_deviation(
                k_vectors_3d, self.traj.box_matrix) > 1e-3:
            mode = 'exact'
        box = self._dsf_box() if mode == 'incremental' else None
        if mode == 'incremental' and box is None:
            mode = 'exact'
        return box, mode

    def _chunk_k_arg(self, k_rows: np.ndarray, k_dev: torch.Tensor, ph_mode: str):
        """(k_arg, mode, col_idx) of the phase producer on one k-chunk.

        'factored' tries :func:`psa_tpu_torch.ops.instantaneous.factor_k_chunk`
        on the chunk (each chunk of a lattice line is itself a lattice
        line): the producer then runs over the Na·Nb product columns and
        ``col_idx`` (a device index) maps each requested k to its column;
        the caller selects those columns from the reduced output, never from
        the phasors.  A chunk that does not factor runs the exact engine on
        the plain device rows ``k_dev`` with ``col_idx`` None."""
        if ph_mode == 'factored':
            out = instantaneous.factor_k_chunk(k_rows, self.traj.box_matrix)
            if out is not None:
                fk, col_idx = out
                self.factored_chunks.append((fk[0].shape[0], fk[1].shape[0]))
                return (tuple(x.to(self.device) for x in fk), 'factored',
                        self._to_device(col_idx, np.int64))
            self.factored_chunks.append(None)
            ph_mode = 'exact'
        return k_dev, ph_mode, None

    def _dsf_plan(self, num_k: int, group_idx: np.ndarray,
                  with_velocities: bool, mode: str = 'exact') -> Tuple[int, int]:
        """(atom_chunk, t_chunk) of the mode stacks' tiles: the phasor
        transients of a (t_chunk, atom_chunk, num_k) tile, PHASOR_BYTES[mode]
        per element, within a quarter of ``max_device_bytes``; a streamed
        group's atom chunk is its staged block, and the time tiles fill the
        budget for that block.  ``num_k`` counts the producer's columns (the
        product columns of a factored chunk).  The fused kernel
        (``instantaneous.fuses``) holds no transient: the whole group, or
        each staged block, in one launch over every frame."""
        n = int(group_idx.size)
        streams = self._instant_streams(group_idx, with_velocities)
        if instantaneous.fuses(self.device, mode):
            return (self.stream_block_atoms(n) if streams else n), self.traj.n_frames
        budget = max(1 << 22,
                     int(self.max_device_bytes) // (4 * instantaneous.PHASOR_BYTES[mode]))
        atom_chunk = max(1, min(n, budget // max(1, num_k)))
        if streams:
            atom_chunk = min(atom_chunk, self.stream_block_atoms(n))
        t_chunk = int(np.clip(budget // (atom_chunk * max(1, num_k)), 1, self.traj.n_frames))
        return atom_chunk, t_chunk

    def _dsf_freqs(self, max_freq: Optional[float], segments: int = 1):
        """(freqs_kept float64, freq_idx) of the ω ≥ 0 (and ≤ max_freq) rows
        of the n_t // segments spectrum, as the JAX package's DSF paths
        return them."""
        n_rows = self.traj.n_frames // segments
        _, idx = spectral._kept_rows(n_rows, self.dt_ps, max_freq)
        return spectral.fftfreq_thz(n_rows, self.dt_ps)[idx], idx

    def _dsf_union_group(self, basis_atom_indices, basis_atom_types) -> np.ndarray:
        """The one atom set of the instantaneous-phase paths: the union of the
        resolved groups, duplicates collapsed (each atom enters ρ once)."""
        groups = self._resolve_atom_groups(basis_atom_indices, basis_atom_types, 'coherent')
        # one group's repeats collapse too
        return np.unique(_union_group([np.asarray(g).ravel() for g in groups])).astype(int)

    def _dsf_commensurate_warn(self, k_vectors_3d) -> None:
        dev = instantaneous.commensurate_deviation(k_vectors_3d, self.traj.box_matrix)
        if dev > 1e-4:
            logger.warning(
                "DSF k-vectors are off the box reciprocal lattice (max fractional "
                "deviation %.3g): exp(i k·r(t)) is not invariant under periodic "
                "wrapping and box-periodicity discontinuities will leak into the "
                "spectra — snap with psa_tpu_torch.ops.instantaneous.nearest_commensurate.",
                dev)

    def _raw_device_arrays(self, group_idx: np.ndarray, need: str):
        """Device-resident raw (positions or None, velocities or None) of a
        group, no displacement or mass transform: ``need`` is 'P', 'V' or
        'PV'.  Entries live in the calculator's 2-slot LRU, so warm
        DSF/S(k)/ISF/self/MSD/VACF calls upload nothing, and an entry with
        both arrays serves every caller."""
        base = group_idx.tobytes() + b'I'
        with self._cache_lock:
            for have in ('PV', need):
                if base + have.encode() in self._device_cache:
                    pos, vel = self._device_cache[base + have.encode()]
                    return (pos if 'P' in need else None), (vel if 'V' in need else None)
        take = self._host_blocks(group_idx)
        n = int(group_idx.size)

        def upload(src):
            host = np.ascontiguousarray(take(src, 0, n), dtype=np.float32)
            if not host.flags.writeable:        # torch.from_numpy needs a writable buffer
                host = host.copy()
            return torch.from_numpy(host).to(self.device)
        entry = (upload(self.traj.positions) if 'P' in need else None,
                 upload(self.traj.velocities) if 'V' in need else None)
        with self._cache_lock:
            return self._cache_put(base + need.encode(), entry)

    def _raw_blocks(self, group_idx: np.ndarray, atom_chunk: int, need: str, streams: bool):
        """Yield raw (positions or None, velocities or None) device tensors
        of consecutive blocks of at most ``atom_chunk`` atoms of a group,
        each (n_t, a, 3) float32; ``need`` as in :meth:`_raw_device_arrays`.
        Unless it ``streams``, the group is sliced from its resident copy;
        else it comes from the host through pinned staging
        (:meth:`_staged_blocks`), in blocks of at most
        :meth:`stream_block_atoms`, once per call."""
        n = int(group_idx.size)
        if not streams:
            arrays = self._raw_device_arrays(group_idx, need)
            for a0 in range(0, n, atom_chunk):
                yield tuple(None if x is None else x[:, a0:a0 + atom_chunk] for x in arrays)
            return
        srcs = [self.traj.positions if 'P' in need else None,
                self.traj.velocities if 'V' in need else None]
        block = min(atom_chunk, self.stream_block_atoms(n))
        for *_, blocks in self._staged_blocks(group_idx, block, srcs):
            yield blocks

    def _dsf_blocks(self, group_idx: np.ndarray, atom_chunk: int, with_velocities: bool):
        """:meth:`_raw_blocks` for the instantaneous-phase paths: (positions,
        velocities or None) blocks, streamed when the arrays read exceed
        ``max_device_bytes``."""
        return self._raw_blocks(group_idx, atom_chunk, 'PV' if with_velocities else 'P',
                                self._instant_streams(group_idx, with_velocities))

    def _dsf_mode_chunks(self, group_idx: np.ndarray, k_vectors_3d, bounds, todo,
                         density_only: bool = False):
        """Yield (ci, s, e, acc_re, acc_im, k_unit, col_idx) for each k-chunk
        ``ci`` in ``todo``: the mode stack (n_t, K, C) accumulated on the
        device over every atom block of the group.  Channels [ρ, j_x, j_y,
        j_z], or [ρ] alone with ``density_only`` (S(k), ISF), which reads no
        velocities.  K = e − s and ``col_idx`` is None, except for a chunk
        the 'factored' engine took (:meth:`_chunk_k_arg`): then K counts its
        product columns, ``col_idx`` is the device index of the requested k
        among them, and ``k_unit`` (the chunk's device unit vectors) is in
        product order.  Shared by :meth:`calculate_dsf`, :meth:`calculate_sk`
        and :meth:`calculate_isf`."""
        n_t = self.traj.n_frames
        ph_box, ph_mode = self._phase_cfg(k_vectors_3d)
        k_dev = self._to_device(k_vectors_3d)
        k_unit = self._to_device(spectral.unit_k_vectors(k_vectors_3d))
        n_ch = 1 if density_only else 4
        for ci in todo:
            s, e = bounds[ci]
            k_arg, mode, col_idx = self._chunk_k_arg(k_vectors_3d[s:e], k_dev[s:e], ph_mode)
            n_cols = instantaneous.k_count(k_arg)
            atom_chunk, t_chunk = self._dsf_plan(n_cols, group_idx, not density_only, mode)
            logger.info("DSF: k-chunk %d/%d, %d columns (%s); atom_chunk=%d t_chunk=%d.",
                        ci + 1, len(bounds), n_cols, mode, atom_chunk, t_chunk)
            ku = k_unit[s:e]
            if col_idx is not None:
                ku = torch.zeros((n_cols, 3), dtype=torch.float32,
                                 device=self.device).index_copy_(0, col_idx, ku)
            acc = [torch.zeros((n_t, n_cols, n_ch), dtype=torch.float32, device=self.device)
                   for _ in range(2)]
            with span('psa.phases'):             # closed before the yield
                for pos, vel in self._dsf_blocks(group_idx, atom_chunk, not density_only):
                    instantaneous.accumulate_modes(*acc, pos, vel, k_arg, t_chunk, ph_box, mode)
            yield ci, s, e, acc[0], acc[1], ku, col_idx

    @staticmethod
    def _requested_columns(reduced, col_idx: Optional[torch.Tensor]):
        """The requested k of each reduced device array (k on the last
        axis): all columns, or ``col_idx`` of a factored chunk's product
        columns."""
        if col_idx is None:
            return list(reduced)
        return [r.index_select(-1, col_idx) for r in reduced]

    def calculate_dsf(self, k_vectors_3d: np.ndarray,
                      basis_atom_indices=None, basis_atom_types=None,
                      max_freq: Optional[float] = None,
                      k_chunk_size: int = 512,
                      welch_segments: Optional[int] = None,
                      welch_window: str = 'hann',
                      cache_dir=None):
        """Dynamic structure factor and current spectra, on the device.

        Projects onto the instantaneous phases exp(i k·r_a(t)):

            S(k,ω)   = |FFT_t Σ_a e^{i k·r_a(t)}|² / (n_t² N)
            C_L(k,ω) = |k̂ · FFT_t Σ_a v_a e^{i k·r_a(t)}|² / (n_t² N)
            C_T(k,ω) = (Σ_α |FFT_t j_α|² − |k̂ · ĵ|²) / (n_t² N)

        Σ_ω S(k,ω) over all rows is S(k) (this returns the ω ≥ 0 rows); at Γ
        C_L = 0.  k must be box-commensurate for wrap invariance (snap with
        :func:`psa_tpu_torch.ops.instantaneous.nearest_commensurate`).  The
        basis selects one (union) atom set.  ``welch_segments`` averages the
        planes over that many windows (``welch_window`` taper) at
        n_t // welch_segments frequency rows.  A group whose positions and
        velocities exceed ``max_device_bytes`` streams from the host in atom
        blocks, once per k-chunk.  ``cache_dir`` checkpoints each k-chunk
        under the JAX package's key.

        Returns:
            (freqs_kept, S, C_L, C_T): freqs (n_keep,); planes (n_keep, n_k)
            float32.
        """
        self._dsf_commensurate_warn(k_vectors_3d)
        segments = spectral._welch_segments(welch_segments, welch_window, self.traj.n_frames)
        freqs_kept, freq_idx = self._dsf_freqs(max_freq, segments)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        num_k = len(k_vectors_3d)
        with span('psa.host.assemble'):
            planes = np.zeros((3, len(freq_idx), num_k), dtype=np.float32)
        if num_k == 0 or group_idx.size == 0:
            return (freqs_kept,) + tuple(planes)
        inv_n = 1.0 / float(group_idx.size)
        cache = self._chunk_cache(cache_dir, 'dsf', k_vectors_3d, k_chunk_size,
                                  {'group': group_idx, 'max_freq': max_freq,
                                   'welch': [segments, welch_window]})
        freq_idx_dev = self._to_device(freq_idx, np.int64)
        window = welch_window if segments > 1 else 'rect'

        def store(arrays, ci, s, e, cached=False):
            planes[:, :, s:e] = arrays if cached else [a * inv_n for a in arrays]
            if cache is not None and not cached:
                cache.store(ci, planes[:, :, s:e])
        self._sweep(
            num_k, k_chunk_size, cache,
            lambda c, s, e: c.shape == (3, len(freq_idx), e - s),
            lambda bounds, todo: self._dsf_mode_chunks(group_idx, k_vectors_3d, bounds, todo),
            lambda s, e, re, im, ku, col_idx: self._requested_columns(
                instantaneous.dsf_reduce(re, im, ku, freq_idx_dev, segments, window), col_idx),
            store)
        return (freqs_kept,) + tuple(planes)

    def _density_sweep(self, observable: str, k_vectors_3d, basis_atom_indices,
                       basis_atom_types, k_chunk_size: int, cache_dir, rows: Optional[int],
                       reduce, extra: Optional[Dict] = None) -> np.ndarray:
        """S(k) (``rows`` None: out (n_k,)) or the ISF (out (rows, n_k)) from
        the density-only mode stacks: ``reduce(re, im)`` gives one chunk's
        device result, divided by N on the host."""
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        num_k = len(k_vectors_3d)
        with span('psa.host.assemble'):
            out = np.zeros((num_k,) if rows is None else (rows, num_k), dtype=np.float32)
        if num_k == 0 or group_idx.size == 0:
            return out
        inv_n = 1.0 / float(group_idx.size)
        cache = self._chunk_cache(cache_dir, observable, k_vectors_3d, k_chunk_size,
                                  dict({'group': group_idx}, **(extra or {})))

        def store(arrays, ci, s, e, cached=False):
            out[..., s:e] = arrays if cached else arrays[0] * inv_n
            if cache is not None and not cached:
                cache.store(ci, out[..., s:e])
        self._sweep(
            num_k, k_chunk_size, cache, lambda c, s, e: c.shape == out[..., s:e].shape,
            lambda bounds, todo: self._dsf_mode_chunks(group_idx, k_vectors_3d, bounds, todo,
                                                       density_only=True),
            lambda s, e, re, im, _, col_idx: self._requested_columns([reduce(re, im)], col_idx),
            store)
        return out

    def calculate_sk(self, k_vectors_3d: np.ndarray,
                     basis_atom_indices=None, basis_atom_types=None,
                     k_chunk_size: int = 512, cache_dir=None) -> np.ndarray:
        """Static structure factor S(k) = ⟨|ρ_k(t)|²⟩_t / N, on the device.

        Bragg peaks at reciprocal-lattice k for crystals, S(k) → 1 at large k
        for uncorrelated positions; equals Σ_ω S(k,ω) over all frequency rows
        of :meth:`calculate_dsf` without the FFT, from the density mode alone
        (no velocities are read).  k box-commensurate; group semantics as in
        :meth:`calculate_dsf`.

        Returns:
            S: (n_k,) float32.
        """
        return self._density_sweep('sk', k_vectors_3d, basis_atom_indices, basis_atom_types,
                                   k_chunk_size, cache_dir, None, instantaneous.sk_reduce)

    def _isf_lags(self, n_lags: Optional[int]) -> int:
        n_t = self.traj.n_frames
        if n_lags is None:
            n_lags = n_t // 2          # beyond n_t/2 the overlap statistics thin out
        return int(np.clip(n_lags, 1, n_t))

    def calculate_isf(self, k_vectors_3d: np.ndarray,
                      basis_atom_indices=None, basis_atom_types=None,
                      n_lags: Optional[int] = None,
                      k_chunk_size: int = 512, cache_dir=None):
        """Coherent intermediate scattering function F(k,τ), on the device.

        F(k,τ) = Re ⟨ρ_k(t')* ρ_k(t'+τ)⟩_{t'} / N, the time-domain companion
        of :meth:`calculate_dsf`: linear (non-circular) autocorrelation, each
        lag divided by its overlap count; F(k,0) = S(k).  From the density
        mode alone; k box-commensurate; group semantics as in
        :meth:`calculate_dsf`.

        Args:
            n_lags: τ rows returned (default n_t // 2).

        Returns:
            (lags_ps (n_lags,), F (n_lags, n_k) float32), τ in ps.
        """
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        return lags_ps, self._density_sweep(
            'isf', k_vectors_3d, basis_atom_indices, basis_atom_types, k_chunk_size, cache_dir,
            n_lags, lambda re, im: instantaneous.isf_reduce(re, im, n_lags),
            {'n_lags': int(n_lags)})

    def _self_sweep(self, observable: str, k_vectors_3d, basis_atom_indices,
                    basis_atom_types, k_chunk_size: int, cache_dir, rows: int,
                    bytes_per_atom_k: int, kernel, extra: Dict) -> np.ndarray:
        """(rows, n_k) float32 of a per-atom-FFT ("self") observable:
        ``kernel(pos, k_arg, box, mode)`` gives the (rows, K) partial of one
        atom block (the full time axis of its atoms) under the phase engine
        ``mode`` (:meth:`_chunk_k_arg`; K counts a factored chunk's product
        columns, of which the requested ones are selected after the sum).  The partials are added on the device
        in block order, in float32, and each k-chunk is read back once,
        divided by N.  ``bytes_per_atom_k`` is the block's device transient
        per (atom, k); it sizes the blocks within a quarter of
        ``max_device_bytes``.  Velocities are never read."""
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        num_k = len(k_vectors_3d)
        with span('psa.host.assemble'):
            out = np.zeros((rows, num_k), dtype=np.float32)
        if num_k == 0 or group_idx.size == 0:
            return out
        budget = max(1 << 24, int(self.max_device_bytes) // 4)
        cache = self._chunk_cache(cache_dir, observable, k_vectors_3d, k_chunk_size,
                                  dict({'group': group_idx}, **extra))
        k_dev = self._to_device(k_vectors_3d)
        ph_box, ph_mode = self._phase_cfg(k_vectors_3d)

        def chunks(bounds, todo):
            for ci in todo:
                s, e = bounds[ci]
                k_arg, mode, col_idx = self._chunk_k_arg(k_vectors_3d[s:e], k_dev[s:e], ph_mode)
                n_cols = instantaneous.k_count(k_arg)
                atom_chunk = int(np.clip(budget // max(1, bytes_per_atom_k * n_cols), 1,
                                         group_idx.size))
                logger.info("%s: k-chunk %d/%d, %d columns (%s); atom_chunk=%d.", observable,
                            ci + 1, len(bounds), n_cols, mode, atom_chunk)
                acc = torch.zeros((rows, n_cols), dtype=torch.float32, device=self.device)
                for pos, _ in self._dsf_blocks(group_idx, atom_chunk, False):
                    acc += kernel(pos, k_arg, ph_box, mode)
                yield ci, s, e, self._requested_columns([acc], col_idx)[0]

        def store(arrays, ci, s, e, cached=False):
            out[:, s:e] = arrays if cached else arrays[0] / float(group_idx.size)
            if cache is not None and not cached:
                cache.store(ci, out[:, s:e])
        self._sweep(num_k, k_chunk_size, cache, lambda c, s, e: c.shape == (rows, e - s), chunks,
                    lambda s, e, acc: [acc], store)
        return out

    def calculate_isf_self(self, k_vectors_3d: np.ndarray,
                           basis_atom_indices=None, basis_atom_types=None,
                           n_lags: Optional[int] = None,
                           k_chunk_size: int = 256, cache_dir=None):
        """Self intermediate scattering function F_s(k,τ), on the device.

        F_s(k,τ) = (1/N) Σ_a Re ⟨e^{i k·(r_a(t'+τ) − r_a(t'))}⟩_{t'}, the
        single-particle relaxation function (F_s(k,0) = 1; for Fickian
        diffusion e^{−k² D τ}).  Each atom's phase signal is autocorrelated
        by an FFT of length :func:`~psa_tpu_torch.ops.instantaneous._autocorr_fft_len`
        over the full time axis, so atoms go in blocks.

        Returns:
            (lags_ps (n_lags,), F_s (n_lags, n_k) float32).
        """
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        # the padded complex spectrum, its power and its inverse transform
        # beside the phase signal
        fft_len = instantaneous._autocorr_fft_len(self.traj.n_frames)
        return lags_ps, self._self_sweep(
            'isf_self', k_vectors_3d, basis_atom_indices, basis_atom_types, k_chunk_size,
            cache_dir, n_lags, 32 * fft_len,
            lambda pos, k, box, mode: instantaneous.isf_self_block(pos, k, n_lags, box, mode),
            {'n_lags': int(n_lags)})

    def calculate_dsf_self(self, k_vectors_3d: np.ndarray,
                           basis_atom_indices=None, basis_atom_types=None,
                           max_freq: Optional[float] = None,
                           k_chunk_size: int = 256, cache_dir=None):
        """Self (incoherent) dynamic structure factor, on the device:

            S_s(k,ω) = Σ_a |FFT_t e^{i k·r_a(t)}|² / (n_t² N)

        (Σ_ω over all rows = 1; this returns the ω ≥ 0 rows), whose
        quasi-elastic width measures self-diffusion.  The per-atom FFT needs
        the full time axis, so atoms go in blocks.

        Returns:
            (freqs_kept (n_keep,), S_s (n_keep, n_k) float32).
        """
        freqs_kept, freq_idx = self._dsf_freqs(max_freq)
        freq_idx_dev = self._to_device(freq_idx, np.int64)
        n_t = self.traj.n_frames
        # the phasors' float64 angle and turns, then the complex signal and its FFT
        return freqs_kept, self._self_sweep(
            'dsf_self', k_vectors_3d, basis_atom_indices, basis_atom_types, k_chunk_size,
            cache_dir, len(freq_idx), 32 * n_t,
            lambda pos, k, box, mode: instantaneous.dsf_self_block(pos, k, freq_idx_dev, box,
                                                                   mode),
            {'max_freq': max_freq})

    # ------------------------------------------------------------------
    # Vibrational density of states
    # ------------------------------------------------------------------

    def calculate_dos(self, basis_atom_indices=None, basis_atom_types=None,
                      max_freq: Optional[float] = None,
                      atom_chunk_size: Optional[int] = None):
        """Vibrational density of states, computed on the device.

        DOS(ν) = Σ_{a,α} |FFT_t v_aα(ν)|² / n_t², the Fourier transform of
        the velocity autocorrelation (:func:`spectral.dos_accumulate`).
        Group semantics follow the incoherent mode of :meth:`calculate`: a
        flat ``basis_atom_types`` list yields one DOS per type; displacement
        mode and mass weighting apply as configured.  A group over
        ``max_device_bytes`` streams from the host in blocks of
        ``atom_chunk_size`` atoms, the same chunks a resident group is
        summed in, so the two give the same numbers.

        Args:
            max_freq: cap on retained frequencies (THz); ω ≥ 0 always.
            atom_chunk_size: atoms per FFT batch (None = sized so the
                complex transient stays under ~1 GB).

        Returns:
            (freqs (n_keep,) THz, dos (n_groups, n_keep) float32): one row
            per resolved atom group, in group order.
        """
        n_t = self.traj.n_frames
        freqs = spectral.fftfreq_thz(n_t, self.dt_ps)
        mask = freqs >= 0
        if max_freq is not None:
            mask &= freqs <= max_freq
        freq_idx = np.flatnonzero(mask)
        if freq_idx.size == 0:
            raise ValueError("No frequencies retained; check max_freq.")
        if atom_chunk_size is None:
            atom_chunk_size = max(1, (1 << 30) // (24 * n_t))
        groups = self._resolve_atom_groups(basis_atom_indices, basis_atom_types, 'incoherent')
        freq_idx_dev = self._to_device(freq_idx, np.int64)
        out = np.zeros((len(groups), freq_idx.size), dtype=np.float32)
        for gi, group in enumerate(groups):
            group = np.asarray(group, dtype=int)
            if group.size == 0:
                continue
            dos = torch.zeros(freq_idx.size, dtype=torch.float32, device=self.device)
            if self._oversize(group):
                for _, _, data, _, _ in self._stream_group(group, block_atoms=atom_chunk_size):
                    dos = spectral.dos_accumulate(dos, data, freq_idx_dev)
            else:
                data_dev, _, _ = self._group_device_arrays(group)
                for a0 in range(0, group.size, atom_chunk_size):
                    dos = spectral.dos_accumulate(dos, data_dev[:, a0:a0 + atom_chunk_size],
                                                  freq_idx_dev)
            out[gi] = _to_host(dos)
        return freqs[mask], out

    # ------------------------------------------------------------------
    # Time correlation (MSD, VACF) and real-space structure (g(r))
    # ------------------------------------------------------------------

    def _timecorr_sweep(self, kind: str, basis_atom_indices, basis_atom_types,
                        n_lags: Optional[int], atom_chunk_size: Optional[int]):
        """Shared sweep of the k-independent time-correlation observables
        (``kind`` = 'msd' | 'vacf'); groups resolve incoherently (a flat type
        list gives one row per type, as in :meth:`calculate_dos`).  Data is
        read raw from the trajectory: no displacement or mass transform.

        A group within ``max_device_bytes`` is sliced from the raw resident
        copy the instantaneous-phase paths also use
        (:meth:`_raw_device_arrays`), so a warm call uploads nothing; a
        larger one streams atom blocks through the pinned staging.  Block
        partials are added on the device in float64 and each group is read
        back once.

        ``max_device_bytes`` bounds one resident array, as everywhere in the
        calculator: the 2-slot cache may hold a group's positions (after an
        MSD) and its velocities (after a VACF) at once, each up to the
        budget, and a block's transients take another quarter of it.
        :meth:`clear_device_cache` between the two calls frees the first."""
        from ..ops import timecorr
        n_t = self.traj.n_frames
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        if atom_chunk_size is None:
            # the block's transients within a quarter of the budget
            atom_chunk_size = max(1, (int(self.max_device_bytes) // 4)
                                  // timecorr.block_bytes_per_atom(n_t))
        which = 0 if kind == 'msd' else 1          # positions or velocities
        groups = self._resolve_atom_groups(basis_atom_indices, basis_atom_types, 'incoherent')
        out = np.zeros((len(groups), n_lags), dtype=np.float32)
        for gi, group in enumerate(groups):
            group = np.asarray(group, dtype=int)
            if group.size == 0:
                continue
            chunk = int(min(atom_chunk_size, group.size))
            blocks = (pv[which] for pv in self._raw_blocks(group, chunk, 'PV'[which],
                                                           self._oversize(group)))
            acc = timecorr.timecorr_sum(blocks, n_lags, kind)
            out[gi] = (_to_host(acc) / group.size).astype(np.float32)
        return lags_ps, out

    def calculate_msd(self, basis_atom_indices=None, basis_atom_types=None,
                      n_lags: Optional[int] = None,
                      atom_chunk_size: Optional[int] = None):
        """Mean-squared displacement ⟨|r(t+τ) − r(t)|²⟩, on the device.

        All time origins at O(n_t log n_t) per atom (FFT autocorrelation and
        a cumulative-sum identity, :func:`psa_tpu_torch.ops.timecorr.msd_block`).
        The Einstein relation MSD(τ) → 6·D·τ (3D) makes the long-τ slope the
        standard self-diffusion estimate; positions must be unwrapped.
        Group semantics follow :meth:`calculate_dos` (a flat type list gives
        one row per type).  ``atom_chunk_size`` is the atoms per FFT batch
        (None: sized from ``max_device_bytes``).

        Returns:
            (lags_ps (n_lags,), msd (n_groups, n_lags) float32 in Å²).
        """
        return self._timecorr_sweep('msd', basis_atom_indices, basis_atom_types,
                                    n_lags, atom_chunk_size)

    def calculate_vacf(self, basis_atom_indices=None, basis_atom_types=None,
                       n_lags: Optional[int] = None,
                       atom_chunk_size: Optional[int] = None):
        """Velocity autocorrelation function ⟨v(t)·v(t+τ)⟩, on the device.

        The time-domain twin of :meth:`calculate_dos` (Wiener–Khinchin);
        VACF(0) = ⟨|v|²⟩ (∝ 3·k_B·T/m at equilibrium), its oscillation
        frequencies are the vibrational modes, and the Green–Kubo integral
        ∫VACF dτ / 3 is another D estimate.  Group semantics and
        ``atom_chunk_size`` as in :meth:`calculate_msd`.

        Returns:
            (lags_ps (n_lags,), vacf (n_groups, n_lags) float32, (Å/ps)²).
        """
        return self._timecorr_sweep('vacf', basis_atom_indices, basis_atom_types,
                                    n_lags, atom_chunk_size)

    @staticmethod
    def _cell_widths(h: np.ndarray) -> List[float]:
        """Perpendicular widths V / face area of the cell whose columns are ``h``'s."""
        vol = float(abs(np.linalg.det(h)))
        cols = [h[:, i] for i in range(3)]
        return [vol / np.linalg.norm(np.cross(cols[j], cols[k]))
                for j, k in ((1, 2), (2, 0), (0, 1))]

    def calculate_rdf(self, r_max: Optional[float] = None, n_bins: int = 200,
                      basis_atom_indices=None, basis_atom_types=None,
                      basis_atom_indices_b=None, basis_atom_types_b=None,
                      max_frames: int = 64,
                      atom_block: int = 1024, mesh=None,
                      method: str = 'auto', cell_block: int = 64):
        """Radial distribution function g(r), computed on the device.

        The real-space twin of :meth:`calculate_sk`: coordination shells for
        crystals, short-range order for liquids; for an ideal gas g(r) = 1.
        Pair distances are minimum-imaged through the full cell matrix
        (triclinic-safe) and histogrammed per (frames, A-block, B-block)
        tile; the brute sweep costs n_frames_used · N_A · N_B.  For large
        systems with a short histogram range (r_max ≪ box) a linked-cell
        path cuts the pair count by about n_cells/27 (``method``): pairs go
        only to the 27 wrapped neighbour cells, and the result equals the
        brute sweep's bin for bin on positions inside the cell (the path
        wraps the others into it in float64 and rounds to float32, so a pair
        within a float32 rounding of a bin edge may change bin).

        The second basis (``*_b``) selects a partial (cross) RDF g_AB(r)
        between two species or groups; without it, the same-group g(r) with
        self pairs excluded.

        Args:
            r_max: histogram range (default: half the minimum perpendicular
                cell width, the minimum-image validity radius).
            n_bins: bins in [0, r_max).
            max_frames: frames sampled (evenly strided).
            atom_block: A-side tile edge; with ``max_device_bytes`` it bounds
                the (t, A, B) distance tiles.
            mesh: optional (t, a, k) device mesh: the A atoms shard over all
                its positions, B goes whole to each device, and the integer
                counts are summed (:func:`psa_tpu_torch.parallel.rdf_sweep_step`);
                per-position tiles keep the one-device sizes.
            method: 'brute' | 'cells' | 'auto'.  'auto' (default) builds the
                cell grid, measures the actual bucket occupancy, and takes
                the cell path only when its padded pair count is at most
                half the brute sweep's (one device only: a mesh always runs
                the brute sweep).  The choice taken is recorded on
                ``self._last_rdf_method``.
            cell_block: cells per device tile on the 'cells' path.

        Returns:
            (r_centers (n_bins,), g (n_bins,) float32).
        """
        h = np.asarray(self.traj.box_matrix, dtype=np.float64)
        vol = float(abs(np.linalg.det(h)))
        if vol <= 0:
            raise ValueError("degenerate cell — g(r) needs a 3D box")
        r_valid = 0.5 * min(self._cell_widths(h))
        if r_max is None:
            r_max = r_valid
        elif r_max > r_valid + 1e-9:
            logger.warning("r_max=%.3f exceeds the minimum-image validity "
                           "radius %.3f; shells beyond it are undercounted.",
                           r_max, r_valid)

        group_a = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        same = basis_atom_indices_b is None and basis_atom_types_b is None
        group_b = group_a if same else self._dsf_union_group(
            basis_atom_indices_b, basis_atom_types_b)
        edges = np.linspace(0.0, float(r_max), n_bins + 1)
        centers = 0.5 * (edges[:-1] + edges[1:]).astype(np.float32)
        if group_a.size == 0 or group_b.size == 0:
            return centers, np.zeros(n_bins, dtype=np.float32)

        n_t = self.traj.n_frames
        stride = max(1, -(-n_t // max_frames))
        frames = np.arange(0, n_t, stride)
        if method not in ('auto', 'brute', 'cells'):
            raise ValueError("method must be 'auto', 'brute', or 'cells'")
        if method == 'cells' and mesh is not None:
            raise ValueError("method='cells' is single-device; drop mesh= "
                             "(the mesh path shards the brute sweep)")
        self._last_rdf_method = None   # set at the start of whichever path runs
        counts = None
        if method != 'brute' and mesh is None:
            counts = self._rdf_counts_cells(
                group_a, group_b, same, frames, h, float(r_max), n_bins,
                cell_block, force=(method == 'cells'))
        if counts is None:
            self._last_rdf_method = 'brute'
            counts = self._rdf_counts_brute(
                group_a, group_b, same, frames, stride, h, float(r_max),
                n_bins, atom_block, mesh)

        shell_vol = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
        # equal-global-id pairs are dropped, so subtract |A ∩ B| (= N for
        # the same-group case) from the ideal pair count
        n_overlap = (group_a.size if same
                     else np.intersect1d(group_a, group_b).size)
        n_pairs = group_a.size * group_b.size - n_overlap
        ideal = len(frames) * n_pairs * shell_vol / vol
        g = np.where(ideal > 0, counts / np.maximum(ideal, 1e-300), 0.0)
        return centers, g.astype(np.float32)

    def _rdf_pair_budget(self) -> int:
        """Pairs of one distance tile: ``max_device_bytes`` over the bytes
        the histogram chain holds per pair."""
        from ..ops import structure
        return max(1 << 22, int(self.max_device_bytes) // structure.PAIR_BYTES)

    def _rdf_counts_brute(self, group_a, group_b, same, frames, stride, h,
                          r_max, n_bins, atom_block, mesh=None) -> np.ndarray:
        """Pair counts (float64) by the full A×B tile sweep, on this
        calculator's device or over ``mesh``."""
        from ..ops import structure
        # ragged tiles need no padding, so the clamp only bounds memory
        atom_block = max(1, min(atom_block, max(group_a.size, group_b.size)))
        budget = self._rdf_pair_budget()
        t_chunk = int(np.clip(budget // (atom_block * atom_block), 1, len(frames)))
        # the B side of a tile widens while the tile stays within the budget
        b_block = int(np.clip(budget // (t_chunk * atom_block), atom_block,
                              max(atom_block, group_b.size)))
        h_inv = np.linalg.inv(h)
        logger.info("RDF: %d frames (stride %d), %dx%d atoms, tiles %dx%d, t_chunk=%d.",
                    len(frames), stride, group_a.size, group_b.size, atom_block, b_block,
                    t_chunk)
        if mesh is not None:
            from ..parallel.sharded import rdf_sweep_step
            step = rdf_sweep_step(mesh, n_bins, atom_block, b_block)
            total = np.zeros(n_bins, dtype=np.float64)
            for f0 in range(0, len(frames), t_chunk):
                pos_t = self.traj.positions[frames[f0:f0 + t_chunk]]
                pa = pos_t[:, group_a, :]
                total += step(pa, group_a, pa if same else pos_t[:, group_b, :], group_b,
                              h, h_inv, r_max)
            return total
        ida = self._to_device(group_a, np.int64)
        idb = ida if same else self._to_device(group_b, np.int64)
        counts = torch.zeros(n_bins, dtype=torch.int64, device=self.device)
        for f0 in range(0, len(frames), t_chunk):
            pos_t = self.traj.positions[frames[f0:f0 + t_chunk]]
            pa = self._to_device(pos_t[:, group_a, :])
            pb = pa if same else self._to_device(pos_t[:, group_b, :])
            counts += structure.rdf_sweep(pa, ida, pb, idb, h, h_inv, r_max, n_bins,
                                          atom_block, b_block)
        return _to_host(counts).astype(np.float64)

    def _rdf_counts_cells(self, group_a, group_b, same, frames, h, r_max,
                          n_bins, cell_block, force) -> Optional[np.ndarray]:
        """Pair counts (float64) by the linked-cell sweep, or None: use brute.

        Builds the cell grid (cell width ≥ r_max per dim, so the wrapped
        27-stencil is exact), measures the actual max bucket occupancy in a
        host pre-pass, and, unless ``force``, gives way to the brute sweep
        when the padded cell pair count is more than half of N_A · N_B.
        """
        from ..ops import structure
        n_xyz = [max(1, int(w / r_max)) for w in self._cell_widths(h)]
        # a very short r_max can make the grid far finer than the atom
        # count: coarsen (wider cells keep the stencil exact) until the
        # occupancy is sane
        n_big = max(group_a.size, group_b.size)
        while np.prod(n_xyz) > 4 * n_big and max(n_xyz) > 1:
            i = int(np.argmax(n_xyz))
            n_xyz[i] = (n_xyz[i] + 1) // 2
        n_xyz = tuple(n_xyz)
        nc = int(np.prod(n_xyz))
        if nc < 27 and not force:
            return None                  # the stencil is the whole box: no win
        h_inv = np.linalg.inv(h)

        def frac_of(pos):
            fr = np.einsum('ij,taj->tai', h_inv, pos.astype(np.float64))
            return fr - np.floor(fr)

        def occupancy_caps(frame_sel):
            """Max per-cell bucket occupancy over the given frames (host)."""
            cap_a = cap_b = 0
            chunk = max(1, (1 << 22) // max(1, group_a.size))
            with span('psa.rdf.host'):
                for f0 in range(0, len(frame_sel), chunk):
                    pos_t = self.traj.positions[frame_sel[f0:f0 + chunk]]
                    lin = structure.cell_counts(frac_of(pos_t[:, group_a, :]), n_xyz)
                    cap_a = max(cap_a, max(int(np.bincount(l, minlength=nc).max())
                                           for l in lin))
                    if not same:
                        lin = structure.cell_counts(frac_of(pos_t[:, group_b, :]), n_xyz)
                        cap_b = max(cap_b, max(int(np.bincount(l, minlength=nc).max())
                                               for l in lin))
            cap_a = -(-max(cap_a, 1) // 8) * 8
            cap_b = cap_a if same else -(-max(cap_b, 1) // 8) * 8
            return cap_a, cap_b

        brute_pairs = float(group_a.size) * group_b.size
        if not force:
            # the decision from a small frame subsample: occupancy only steers
            # the choice here; the exact capacity is measured below once the
            # cells path is committed
            probe = frames[np.unique(np.linspace(
                0, len(frames) - 1, min(len(frames), 4)).astype(int))]
            cap_a, cap_b = occupancy_caps(probe)
            if 27.0 * nc * cap_a * cap_b > 0.5 * brute_pairs:
                return None
        # committed: exact caps over every sampled frame (a bucket overflow
        # would drop pairs, so the capacity must be the true max)
        cap_a, cap_b = occupancy_caps(frames)
        cell_pairs = 27.0 * nc * cap_a * cap_b
        if not force and cell_pairs > 0.5 * brute_pairs:
            return None
        self._last_rdf_method = 'cells'

        nc_pad = nc + 1                  # one empty sentinel cell; blocks are ragged
        neigh = self._to_device(structure.neighbor_table(n_xyz, nc_pad), np.int64)
        gid_a = self._to_device(group_a, np.int64)
        gid_b = gid_a if same else self._to_device(group_b, np.int64)
        # one step's (t, cell_block, Ca, 27·Cb) tile against the pair budget
        t_chunk = int(np.clip(
            self._rdf_pair_budget() // max(1, cell_block * cap_a * 27 * cap_b),
            1, len(frames)))
        logger.info("RDF cells: grid %s, caps (%d, %d), t_chunk=%d: %.1fx fewer padded "
                    "pairs than brute.", n_xyz, cap_a, cap_b, t_chunk,
                    brute_pairs / max(cell_pairs, 1.0))

        def buckets(pos_t, group, cap):
            fr = frac_of(pos_t[:, group, :])
            idx = structure.bucketize_frames(structure.cell_counts(fr, n_xyz), group.size,
                                             nc, nc_pad, cap)
            return np.einsum('ij,taj->tai', h, fr).astype(np.float32), idx

        counts = torch.zeros(n_bins, dtype=torch.int64, device=self.device)
        for f0 in range(0, len(frames), t_chunk):
            with span('psa.rdf.host'):
                pos_t = self.traj.positions[frames[f0:f0 + t_chunk]]
                pa_host, ia_host = buckets(pos_t, group_a, cap_a)
                pb_host, ib_host = (pa_host, ia_host) if same else buckets(pos_t, group_b, cap_b)
            pa, ia = self._to_device(pa_host), self._to_device(ia_host, np.int32)
            pb, ib = (pa, ia) if same else (self._to_device(pb_host),
                                            self._to_device(ib_host, np.int32))
            counts += structure.rdf_cells_sweep(pa, ia, gid_a, pb, ib, gid_b, neigh, h, h_inv,
                                                r_max, n_bins, cell_block)
        return _to_host(counts).astype(np.float64)

    def calculate_group_velocity_path(self, k_points_mags: np.ndarray,
                                      k_vectors_3d: np.ndarray,
                                      n_bands: int = 1,
                                      sort_bands: bool = True,
                                      **peaks_kwargs):
        """Band frequencies and group velocities v_g = 2π·∂ν/∂k along a k-path.

        Runs :meth:`calculate_kgrid_peaks` (``peaks_kwargs`` pass through),
        reorders the per-k peaks into continuous branches
        (:func:`psa_tpu_torch.ops.dispersion.sort_bands_path`) and takes
        central differences over ``k_points_mags``.

        Returns:
            (band_freqs, v_g, band_heights): each (n_bands, n_k) float32;
            v_g in Å/ps (1 Å/ps = 100 m/s).
        """
        from ..ops import dispersion
        if peaks_kwargs.get('chiral'):
            raise ValueError("group-velocity extraction reads intensity "
                             "peaks; drop chiral=True.")
        k_mags = np.asarray(k_points_mags, dtype=np.float64)
        freqs, heights, _ = self.calculate_kgrid_peaks(
            k_vectors_3d, n_peaks=n_bands, **peaks_kwargs)
        if sort_bands:
            freqs, heights = dispersion.sort_bands_path(freqs, heights)
        return freqs, dispersion.group_velocity_path(freqs, k_mags), heights

    def calculate_group_velocity_surface(self, k_vectors_3d: np.ndarray,
                                         k_grid_shape: Tuple[int, int],
                                         n_bands: int = 1,
                                         sort_bands: bool = True,
                                         **peaks_kwargs):
        """Band sheets and group-velocity fields (v_x, v_y) = 2π·∇_k ν over a
        tensor-product k-grid (axes from :meth:`_detect_grid_axes`), with the
        peaks band-sorted into continuous sheets before differencing.

        Returns:
            (band_freqs, v_x, v_y, band_heights): each (n_bands, gx, gy)
            float32; velocities in Å/ps along the plane's slow and fast axes.
        """
        from ..ops import dispersion
        if peaks_kwargs.get('chiral'):
            raise ValueError("group-velocity extraction reads intensity "
                             "peaks; drop chiral=True.")
        kx_vals, ky_vals, _, _ = self._detect_grid_axes(
            np.asarray(k_vectors_3d, dtype=np.float32), k_grid_shape)
        freqs, heights, _ = self.calculate_kgrid_peaks(
            k_vectors_3d, n_peaks=n_bands, k_grid_shape=tuple(k_grid_shape),
            **peaks_kwargs)
        gx, gy = int(k_grid_shape[0]), int(k_grid_shape[1])
        freqs = freqs.reshape(n_bands, gx, gy)
        heights = heights.reshape(n_bands, gx, gy)
        if sort_bands:
            freqs, heights = dispersion.sort_bands_grid(freqs, heights)
        vx, vy = dispersion.group_velocity_grid(freqs, kx_vals, ky_vals)
        return freqs, vx, vy, heights

    def calculate_thermal_conductivity(self, k_vectors_3d: np.ndarray,
                                       k_grid_shape: Tuple[int, int],
                                       n_bands: int = 1,
                                       volume_a3: Optional[float] = None,
                                       mode_weights=None,
                                       resolution_factor: float = 2.0,
                                       mesh=None,
                                       **peaks_kwargs):
        """Kinetic-theory in-plane thermal conductivity from one k-grid sweep
        (the SED method of Thomas et al., PRB 81, 081411 (2010)).

        On-device peaks with calibrated Lorentzian FWHMs → band sorting →
        group-velocity fields → τ = 1/(2π·FWHM) → κ_αβ = (k_B/V)·Σ v_α v_β τ
        (classical per-mode heat capacity).  See
        :mod:`psa_tpu_torch.ops.transport` for conventions and units.  Modes
        whose linewidth is at or below ``resolution_factor``/(n_t·dt) are
        skipped (``KappaResult.n_modes_used``).  ``volume_a3`` defaults to
        det(box_matrix); ``width_method`` is pinned to 'lorentzian'; with
        ``mesh`` the peaks come from :meth:`calculate_kgrid_peaks_sharded`.

        Returns:
            (result, band_freqs, v_x, v_y): a
            :class:`psa_tpu_torch.ops.transport.KappaResult` plus the
            band-sorted (n_bands, gx, gy) frequency sheets and velocity fields.
        """
        from ..ops import dispersion, transport
        if peaks_kwargs.get('chiral'):
            raise ValueError("thermal conductivity reads intensity peaks; "
                             "drop chiral=True.")
        if peaks_kwargs.pop('width_method', 'lorentzian') != 'lorentzian':
            raise ValueError("thermal conductivity requires the calibrated "
                             "width_method='lorentzian'.")
        kx_vals, ky_vals, _, _ = self._detect_grid_axes(
            np.asarray(k_vectors_3d, dtype=np.float32), k_grid_shape)
        peaks = (self.calculate_kgrid_peaks if mesh is None
                 else functools.partial(self.calculate_kgrid_peaks_sharded, mesh))
        pf, ph, pw = peaks(k_vectors_3d, n_peaks=n_bands, k_grid_shape=tuple(k_grid_shape),
                           width_method='lorentzian', **peaks_kwargs)
        gx, gy = int(k_grid_shape[0]), int(k_grid_shape[1])
        pf = pf.reshape(n_bands, gx, gy)
        ph = ph.reshape(n_bands, gx, gy)
        pw = pw.reshape(n_bands, gx, gy)
        pf, ph, pw = dispersion.sort_bands_grid(pf, ph, pw)
        vx, vy = dispersion.group_velocity_grid(pf, kx_vals, ky_vals)
        df = 1.0 / (self.traj.n_frames * self.dt_ps)
        tau = transport.phonon_lifetimes(
            pw, resolution_fwhm_thz=resolution_factor * df)
        if volume_a3 is None:
            volume_a3 = float(abs(np.linalg.det(
                self.traj.box_matrix.astype(np.float64))))
        result = transport.kinetic_kappa(vx, vy, tau, volume_a3,
                                         mode_weights=mode_weights)
        return result, pf, vx, vy

    # ------------------------------------------------------------------
    # Device meshes: the sweeps over a (t, a, k) mesh, full group semantics
    # ------------------------------------------------------------------

    def _group_weights(self, atom_groups: List[np.ndarray], summation_mode: str):
        """Group index lists → per-atom weight vectors for the mesh sweeps.

        Returns (weights or None, single_spectrum): None is the unweighted
        all-atoms sweep; a weight counts an atom once per occurrence in its
        group (as the one-device gather does) and carries √mass when the
        calculator is mass-weighted.
        """
        groups, single = self._spectrum_groups(atom_groups, summation_mode)
        return self._atom_weights(groups), single

    def _atom_weights(self, groups: List[np.ndarray]) -> Optional[List[np.ndarray]]:
        """:meth:`_group_weights` of the spectrum groups ``groups``."""
        n_atoms = self.traj.n_atoms
        if not groups or (len(groups) == 1 and groups[0].size == n_atoms
                          and not self.mass_weighted
                          and np.array_equal(np.sort(groups[0]), np.arange(n_atoms))):
            return None
        weights = []
        for g in groups:
            w = np.bincount(g, minlength=n_atoms).astype(np.float32)
            if self.mass_weighted:
                w *= np.sqrt(self.traj.masses).astype(np.float32)
            weights.append(w)
        return weights

    def _membership(self, group_idx: np.ndarray) -> Optional[np.ndarray]:
        """0/1 weights of the instantaneous-phase mesh sweeps; None for all atoms."""
        if group_idx.size == self.traj.n_atoms and np.array_equal(
                group_idx, np.arange(self.traj.n_atoms)):
            return None
        w = np.zeros(self.traj.n_atoms, dtype=np.float32)
        w[group_idx] = 1.0
        return w

    def _mesh_phase(self, k_vectors_3d):
        """(host cell or None, mode) of the mesh's instantaneous-phase sweeps:
        :meth:`_phase_cfg` with 'factored' run as 'exact' (its product
        columns are a one-device chunk mechanism, as in the JAX package)."""
        _, mode = self._phase_cfg(k_vectors_3d, mesh=True)
        return (self.traj.box_matrix if mode == 'incremental' else None), mode

    def _sharded_data(self, mesh, data):
        """(data, mean positions, subtract_mean) of the mesh's SED: the
        shards resident on ``mesh`` (:meth:`preload_mesh_group_data`, which
        hold their mean positions), else the velocities, or in displacement
        mode the positions with the mean subtracted on the devices; a given
        ``data`` is taken as the calculator's mode says.  Raises for no
        ``data`` on another mesh than the resident shards'."""
        if data is None and self._resident_shards is not None:
            if mesh is not self.resident_mesh:
                raise ValueError("the trajectory's data are resident on another mesh "
                                 "(preload_mesh_group_data): pass that mesh, or data=")
            return self._resident_shards, None, self.use_displacements
        if data is None:
            data = self.traj.positions if self.use_displacements else self.traj.velocities
        return data, self.mean_positions64, self.use_displacements

    def _sharded(self, mesh, groups: List[np.ndarray], k_vectors_3d,
                 reduction: spectral.Reduction, t_superchunk: Optional[int], data):
        """A projection surface's ``reduction`` over the k stripes of ``mesh``:
        the direct path of :func:`psa_tpu_torch.parallel.sharded_sed_spectrum`
        on the groups' weights (:meth:`_atom_weights`).  Returns the host
        outputs of :meth:`spectral.Reduction.leads`."""
        from ..parallel.sharded import _sed_stripes
        src, mean64, subtract = self._sharded_data(mesh, data)
        return _sed_stripes(mesh, src, mean64, k_vectors_3d, reduction, precision=self.precision,
                            t_superchunk=t_superchunk, atom_weights=self._atom_weights(groups),
                            subtract_mean=subtract)

    def _gridded_sharded(self, mesh, groups, k_vectors_3d, k_grid_shape, data, freq_idx,
                         **kwargs):
        """:func:`psa_tpu_torch.ops.gridded.gridded_kgrid_sharded` over the
        devices of the mesh's positions, one process's."""
        from ..ops import gridded
        if mesh.world > 1:
            raise ValueError("engine='gridded' runs its ky stripes in one process; "
                             "use engine='direct' on a mesh of several processes")
        plan, payload = self._gridded_input(groups, k_vectors_3d, k_grid_shape, data)
        stats = {}
        out = gridded.gridded_kgrid_sharded(
            payload, plan, freq_idx, [d for *_, d in mesh.local_positions()],
            precision=self.precision, grid_budget_bytes=self._gridded_grid_budget(),
            stats=stats, **kwargs)
        self.streamed_bytes += stats['bytes_streamed']
        return out

    def calculate_kgrid_browse_sharded(self, mesh, k_vectors_3d: np.ndarray,
                                       basis_atom_indices=None, basis_atom_types=None,
                                       summation_mode: str = 'coherent',
                                       max_freq: Optional[float] = None,
                                       chiral: bool = False, chiral_axis: str = 'z',
                                       angle_range_opt: str = 'C',
                                       t_superchunk: Optional[int] = None,
                                       data=None, engine: str = 'direct',
                                       k_grid_shape: Optional[Tuple[int, int]] = None,
                                       welch_segments: Optional[int] = None,
                                       welch_window: str = 'hann'):
        """:meth:`calculate_kgrid_browse` over a (t, a, k) device mesh
        (:func:`psa_tpu_torch.parallel.sharded_sed_spectrum`).

        The group semantics of the one-device path: the coherent union or
        incoherent groups (their intensities summed in the mesh while the
        data streams once), displacement mode, mass weighting, the chiral
        phase, Welch segments; only the filtered float32 planes leave the
        devices.  Every shard's projection is the kernel's.

        Args:
            mesh: from :func:`psa_tpu_torch.parallel.make_mesh`.
            t_superchunk: frames per superchunk streamed through the mesh.
            data: optional (n_t, n_atoms, 3) array-like or BlockSource in
                place of the trajectory's velocities (positions in
                displacement mode).
            engine: 'direct' or 'gridded': the NUFFT engine with ky stripes
                over the mesh's devices (coherent, uniform grids, needs
                ``k_grid_shape``; a group over ``max_device_bytes``, or a
                SED-ready BlockSource given as ``data``, streams in
                superchunks, one pass feeding every stripe).

        Returns:
            (freqs_kept, intensity (n_keep, n_k) float32, phase or None).
        """
        _, groups, reduction = self._reduction(
            'browse', basis_atom_indices, basis_atom_types, summation_mode, engine=engine,
            max_freq=max_freq, chiral=chiral, chiral_axis=chiral_axis,
            angle_range_opt=angle_range_opt, welch_segments=welch_segments,
            welch_window=welch_window)
        if engine == 'gridded':
            intensity, phase = self._gridded_sharded(
                mesh, groups, k_vectors_3d, k_grid_shape, data, reduction.freq_idx,
                comp_pair=reduction.comp_pair, angle_range_opt=angle_range_opt,
                t_superchunk=t_superchunk)
            return reduction.freqs_kept, intensity, phase
        if engine != 'direct':
            raise ValueError(f"engine must be 'direct' or 'gridded', got {engine!r}")
        outs = self._sharded(mesh, groups, k_vectors_3d, reduction, t_superchunk, data)
        return reduction.freqs_kept, outs[0], (outs[1] if len(outs) > 1 else None)

    def calculate_kgrid_peaks_sharded(self, mesh, k_vectors_3d: np.ndarray,
                                      basis_atom_indices=None, basis_atom_types=None,
                                      summation_mode: str = 'coherent',
                                      max_freq: Optional[float] = None,
                                      n_peaks: int = 1, exclusion_bins: int = 4,
                                      chiral: bool = False, chiral_axis: str = 'z',
                                      angle_range_opt: str = 'C',
                                      width_method: str = 'rms',
                                      t_superchunk: Optional[int] = None,
                                      data=None, engine: str = 'direct',
                                      k_grid_shape: Optional[Tuple[int, int]] = None,
                                      welch_segments: Optional[int] = None,
                                      welch_window: str = 'hann'):
        """:meth:`calculate_kgrid_peaks` over a device mesh: the peak triplet
        per k (the phase at each peak appended with ``chiral``), found on the
        stripes' devices.  ``engine='gridded'`` runs the NUFFT engine's ky
        stripes over the mesh's devices (coherent, no chiral phase).  See
        :meth:`calculate_kgrid_browse_sharded` for the other arguments."""
        _, groups, reduction = self._reduction(
            'peaks', basis_atom_indices, basis_atom_types, summation_mode, engine=engine,
            max_freq=max_freq, chiral=chiral, chiral_axis=chiral_axis,
            angle_range_opt=angle_range_opt, welch_segments=welch_segments,
            welch_window=welch_window, n_peaks=n_peaks, exclusion_bins=exclusion_bins,
            width_method=width_method)
        if engine == 'gridded':
            return self._gridded_sharded(
                mesh, groups, k_vectors_3d, k_grid_shape, data, reduction.freq_idx,
                freqs_kept=reduction.freqs_kept, n_peaks=n_peaks, exclusion_bins=exclusion_bins,
                width_method=width_method, t_superchunk=t_superchunk)
        if engine != 'direct':
            raise ValueError(f"engine must be 'direct' or 'gridded', got {engine!r}")
        return tuple(self._sharded(mesh, groups, k_vectors_3d, reduction, t_superchunk, data))

    def calculate_lt_sharded(self, mesh, k_vectors_3d: np.ndarray,
                             basis_atom_indices=None, basis_atom_types=None,
                             summation_mode: str = 'coherent',
                             max_freq: Optional[float] = None,
                             t_superchunk: Optional[int] = None, data=None):
        """:meth:`calculate_lt` over a (t, a, k) device mesh: the split runs
        on each stripe's device; incoherent groups sum their (I_L, I_T)
        pairs in the mesh while the data streams once.  Arguments as in
        :meth:`calculate_kgrid_browse_sharded`.

        Returns:
            (freqs_kept, I_L (n_keep, n_k) float32, I_T (n_keep, n_k) float32).
        """
        _, groups, reduction = self._reduction(
            'lt', basis_atom_indices, basis_atom_types, summation_mode, max_freq=max_freq,
            k_vectors=k_vectors_3d)
        return (reduction.freqs_kept,) + tuple(
            self._sharded(mesh, groups, k_vectors_3d, reduction, t_superchunk, data))

    def calculate_dsf_sharded(self, mesh, k_vectors_3d: np.ndarray,
                              basis_atom_indices=None, basis_atom_types=None,
                              max_freq: Optional[float] = None,
                              t_superchunk: Optional[int] = None,
                              welch_segments: Optional[int] = None,
                              welch_window: str = 'hann'):
        """:meth:`calculate_dsf` over a (t, a, k) device mesh
        (:func:`psa_tpu_torch.parallel.sharded_dsf`): positions and
        velocities stream in lockstep superchunks, only the three filtered
        planes leave the devices.  'factored' runs as 'exact' on a mesh.

        Returns:
            (freqs_kept, S, C_L, C_T), as :meth:`calculate_dsf`.
        """
        from ..parallel.sharded import sharded_dsf
        self._dsf_commensurate_warn(k_vectors_3d)
        segments = spectral._welch_segments(welch_segments, welch_window, self.traj.n_frames)
        freqs_kept, freq_idx = self._dsf_freqs(max_freq, segments)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        box, mode = self._mesh_phase(k_vectors_3d)
        s, c_l, c_t = sharded_dsf(
            mesh, self.traj.positions, self.traj.velocities, k_vectors_3d,
            freq_indices=freq_idx, precision=self.precision, t_superchunk=t_superchunk,
            atom_weights=self._membership(group_idx), box=box, phase_mode=mode,
            welch_segments=segments, welch_window=welch_window if segments > 1 else 'rect')
        return freqs_kept, s, c_l, c_t

    def calculate_dsf_self_sharded(self, mesh, k_vectors_3d: np.ndarray,
                                   basis_atom_indices=None, basis_atom_types=None,
                                   max_freq: Optional[float] = None,
                                   atom_chunk: Optional[int] = None):
        """:meth:`calculate_dsf_self` over a (t, a, k) device mesh: atoms
        over the combined (t, a) positions, the whole time axis on each,
        streamed in chunks of ``atom_chunk``.  Returns (freqs_kept, S_s)."""
        from ..parallel.sharded import sharded_dsf_self
        self._dsf_commensurate_warn(k_vectors_3d)
        freqs_kept, freq_idx = self._dsf_freqs(max_freq)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        if len(k_vectors_3d) == 0 or group_idx.size == 0:
            return freqs_kept, np.zeros((len(freq_idx), len(k_vectors_3d)), dtype=np.float32)
        box, mode = self._mesh_phase(k_vectors_3d)
        return freqs_kept, sharded_dsf_self(
            mesh, self.traj.positions, k_vectors_3d, freq_indices=freq_idx,
            atom_weights=self._membership(group_idx), atom_chunk=atom_chunk, box=box,
            phase_mode=mode)

    def calculate_sk_sharded(self, mesh, k_vectors_3d: np.ndarray,
                             basis_atom_indices=None, basis_atom_types=None,
                             t_superchunk: Optional[int] = None) -> np.ndarray:
        """:meth:`calculate_sk` over a (t, a, k) device mesh: only positions
        stream and only the density channel accumulates.  Returns (n_k,)."""
        from ..parallel.sharded import sharded_sk
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        if len(k_vectors_3d) == 0 or group_idx.size == 0:
            return np.zeros(len(k_vectors_3d), dtype=np.float32)
        box, mode = self._mesh_phase(k_vectors_3d)
        return sharded_sk(mesh, self.traj.positions, k_vectors_3d, precision=self.precision,
                          t_superchunk=t_superchunk, atom_weights=self._membership(group_idx),
                          box=box, phase_mode=mode)

    def calculate_isf_sharded(self, mesh, k_vectors_3d: np.ndarray,
                              basis_atom_indices=None, basis_atom_types=None,
                              n_lags: Optional[int] = None,
                              t_superchunk: Optional[int] = None):
        """:meth:`calculate_isf` over a (t, a, k) device mesh: the density
        stacks of :meth:`calculate_sk_sharded`, each stripe's linear FFT
        autocorrelation as the reduction.  Returns (lags_ps, F (n_lags, n_k))."""
        from ..parallel.sharded import sharded_isf
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        if len(k_vectors_3d) == 0 or group_idx.size == 0:
            return lags_ps, np.zeros((n_lags, len(k_vectors_3d)), dtype=np.float32)
        box, mode = self._mesh_phase(k_vectors_3d)
        return lags_ps, sharded_isf(
            mesh, self.traj.positions, k_vectors_3d, n_lags, precision=self.precision,
            t_superchunk=t_superchunk, atom_weights=self._membership(group_idx), box=box,
            phase_mode=mode)

    def calculate_isf_self_sharded(self, mesh, k_vectors_3d: np.ndarray,
                                   basis_atom_indices=None, basis_atom_types=None,
                                   n_lags: Optional[int] = None,
                                   atom_chunk: Optional[int] = None):
        """:meth:`calculate_isf_self` over a (t, a, k) device mesh: the
        sharding of :meth:`calculate_dsf_self_sharded` with the
        autocorrelation.  Returns (lags_ps, F_s (n_lags, n_k))."""
        from ..parallel.sharded import sharded_isf_self
        self._dsf_commensurate_warn(k_vectors_3d)
        group_idx = self._dsf_union_group(basis_atom_indices, basis_atom_types)
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        if len(k_vectors_3d) == 0 or group_idx.size == 0:
            return lags_ps, np.zeros((n_lags, len(k_vectors_3d)), dtype=np.float32)
        box, mode = self._mesh_phase(k_vectors_3d)
        return lags_ps, sharded_isf_self(
            mesh, self.traj.positions, k_vectors_3d, n_lags,
            atom_weights=self._membership(group_idx), atom_chunk=atom_chunk, box=box,
            phase_mode=mode)

    def _timecorr_sharded(self, mesh, kind: str, basis_atom_indices, basis_atom_types,
                          n_lags: Optional[int], atom_chunk: Optional[int]):
        """MSD/VACF over a mesh, one row per incoherent group: each group's
        columns are read through a host view (no copy of the trajectory)."""
        from ..parallel.sharded import sharded_timecorr
        n_lags = self._isf_lags(n_lags)
        lags_ps = np.arange(n_lags, dtype=np.float32) * float(self.dt_ps)
        groups = self._resolve_atom_groups(basis_atom_indices, basis_atom_types, 'incoherent')
        out = np.zeros((len(groups), n_lags), dtype=np.float32)
        raw = 'positions' if kind == 'msd' else 'velocities'
        for gi, group in enumerate(groups):
            group = np.asarray(group, dtype=int)
            if group.size:
                out[gi] = sharded_timecorr(mesh, self._group_block_source(group, raw=raw),
                                           kind, n_lags, atom_chunk=atom_chunk)
        return lags_ps, out

    def calculate_msd_sharded(self, mesh, basis_atom_indices=None, basis_atom_types=None,
                              n_lags: Optional[int] = None,
                              atom_chunk: Optional[int] = None):
        """:meth:`calculate_msd` over a (t, a, k) device mesh: atoms over
        all the positions (the observable has no k), one sum over them per
        atom chunk.  Same (lags_ps, (n_groups, n_lags)) result."""
        return self._timecorr_sharded(mesh, 'msd', basis_atom_indices, basis_atom_types,
                                      n_lags, atom_chunk)

    def calculate_vacf_sharded(self, mesh, basis_atom_indices=None, basis_atom_types=None,
                               n_lags: Optional[int] = None,
                               atom_chunk: Optional[int] = None):
        """:meth:`calculate_vacf` over a (t, a, k) device mesh (see
        :meth:`calculate_msd_sharded`)."""
        return self._timecorr_sharded(mesh, 'vacf', basis_atom_indices, basis_atom_types,
                                      n_lags, atom_chunk)

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
        sed_calculator.py:373-589).

        ``npt=True``: the path sweeps fractional Miller space along
        ``k_dir_spec`` up to ``bz_cov_ised`` Miller orders
        (:func:`psa_tpu_torch.utils.helpers.miller_line`), spectra anchor on
        the per-frame fractional coordinates (:meth:`calculate_npt`), and the
        mode phase is synthesized from 2π m·s̄.  ``k_target`` stays physical
        (mean-cell |B̄·m|); ``char_len_k_path`` is ignored.
        ``plot_dir_ised`` adds a figure of the input spectrum summed over
        the groups, with the target marked (needs matplotlib)."""
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

        if npt:
            # the unnormalized Miller direction, the NPT sweeps' line
            m_rows = miller_line(k_dir_spec, nk_on_path, float(bz_cov_ised))
            m_dir = m_rows[-1] / np.linalg.norm(m_rows[-1])
            k_vecs_ised, _, k_mags_ised = self._npt_k_setup(m_rows)
        else:
            k_mags_ised, k_vecs_ised = self.get_k_path(
                direction_spec=k_dir_unit, bz_coverage=bz_cov_ised,
                n_k=nk_on_path, lat_param=char_len_k_path)

        wiggles = np.zeros((n_recon_frames, n_atoms_total, 4), dtype=np.float32)
        time_p = np.linspace(0, 2 * np.pi, n_recon_frames, endpoint=False).astype(np.float32)
        if npt:
            # mode phase 2π m·s̄ = (2π|m|)·(s̄·m̂)
            pos_proj_k_dir = np.dot(self._fractional_mean_positions64(), m_dir).astype(np.float32)
        else:
            pos_proj_k_dir = np.dot(avg_pos, k_dir_unit)

        k_match_idx = int(np.argmin(np.abs(k_mags_ised - k_target)))
        k_actual = float(k_mags_ised[k_match_idx])
        k_synth = float(2.0 * np.pi * np.linalg.norm(m_rows[k_match_idx])) if npt else k_actual
        logger.info("iSED matched requested k=%.4f to path point %.4f 2π/Å (index %d)",
                    k_target, k_actual, k_match_idx)

        recon_done, max_wiggle_amp_all = False, 0.0
        std_dev_sum, n_atoms_recon_sum = 0.0, 0
        input_intensity, input_freqs = None, None      # the figure's summed spectrum
        time_dev = torch.from_numpy(time_p).to(self.device)

        for i_grp, grp_atom_idx in enumerate(recon_atom_groups):
            if grp_atom_idx.size == 0:
                continue
            logger.info("iSED reconstructing group %d of %d — %d atoms, types %s.", i_grp + 1,
                        len(recon_atom_groups), len(grp_atom_idx),
                        np.unique(sys_atom_types[grp_atom_idx]))
            def run(grp_atom_idx=grp_atom_idx):
                return self.calculate(k_points_mags=k_mags_ised, k_vectors_3d=k_vecs_ised,
                                      basis_atom_indices=grp_atom_idx, k_grid_shape=None,
                                      summation_mode='coherent')
            sed_obj = self._fractional(run) if npt else run()
            freqs_group = sed_obj.freqs
            if plot_dir_ised:
                grp_intensity = np.sum(np.abs(sed_obj.sed) ** 2, axis=-1)
                if input_intensity is None:
                    input_intensity, input_freqs = grp_intensity, freqs_group
                else:
                    input_intensity = input_intensity + grp_intensity
            w_match_idx = int(np.argmin(np.abs(freqs_group - w_target)))
            w_actual = float(freqs_group[w_match_idx])
            logger.info("  iSED group %d matched requested ω=%.3f to %.3f THz (index %d)",
                        i_grp + 1, w_target, w_actual, w_match_idx)

            amps = np.ascontiguousarray(sed_obj.sed[w_match_idx, k_match_idx, :],
                                        dtype=np.complex64)
            proj_grp = pos_proj_k_dir[grp_atom_idx].astype(np.float32)
            motion = spectral.synthesize_mode_motion(
                torch.from_numpy(amps).to(self.device),
                torch.from_numpy(proj_grp).to(self.device), k_synth, time_dev)
            wiggles[:, grp_atom_idx, :3] += motion.cpu().numpy()

            recon_done = True
            if isinstance(rescale_factor, str) and rescale_factor.lower() == 'auto':
                max_amp_grp = float(np.amax(np.abs(wiggles[:, grp_atom_idx, :3])))
                max_wiggle_amp_all = max(max_wiggle_amp_all, max_amp_grp)
                if npt:
                    # under a breathing cell the Cartesian displacement is the
                    # drift (λ(t) − λ̄)·r: detrend in fractional space and map
                    # back with the mean cell, so 'auto' scales to the vibration
                    h = np.asarray(self.traj.box_matrices, dtype=np.float64)
                    s_grp = np.einsum('tij,taj->tai', np.linalg.inv(h),
                                      self.traj.positions[:, grp_atom_idx, :].astype(np.float64))
                    orig_disp_grp = (s_grp - s_grp.mean(axis=0, keepdims=True)) @ h.mean(axis=0).T
                else:
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

        if plot_dir_ised:
            self._plot_ised_spectrum(plot_dir_ised, input_intensity, input_freqs, k_mags_ised,
                                     k_vecs_ised, k_dir_spec, k_target, w_target, k_actual,
                                     plot_max_freq, plot_theme)

    def _plot_ised_spectrum(self, plot_dir_ised, intensity, freqs, k_mags, k_vecs,
                            k_dir_spec, k_target, w_target, k_actual,
                            plot_max_freq, plot_theme) -> None:
        """Figure of the iSED input spectrum, summed incoherently over the
        groups, with the target marked (reference sed_calculator.py:540-588)."""
        from ..visualization import SEDPlotter  # local import: viz sits above core

        logger.info("Rendering the iSED input spectrum (incoherent sum over groups).")
        mock = np.zeros((*intensity.shape, 3), dtype=np.complex64)
        mock[:, :, 0] = np.sqrt(intensity + 1e-20)
        plot_obj = SED(sed=mock, freqs=freqs, k_points=k_mags, k_vectors=k_vecs,
                       is_complex=True)

        if isinstance(k_dir_spec, str):
            k_dir_str = k_dir_spec.replace(" ", "_").replace("/", "-")
        elif isinstance(k_dir_spec, (list, tuple, np.ndarray)):
            k_dir_str = f"({','.join(f'{x:.2f}' for x in np.asarray(k_dir_spec))})"
        elif isinstance(k_dir_spec, dict):
            k_dir_str = (f"(h{k_dir_spec.get('h', 0)}_k{k_dir_spec.get('k', 0)}"
                         f"_l{k_dir_spec.get('l', 0)})")
        else:
            k_dir_str = str(k_dir_spec)
        for ch in '[]()':
            k_dir_str = k_dir_str.replace(ch, '')

        k_target_str = f"{k_target:.2f}".replace('.', 'p')
        w_target_str = f"{w_target:.2f}".replace('.', 'p')
        fname = Path(plot_dir_ised) / f"iSED_{k_dir_str}_{k_target_str}_{w_target_str}.png"

        w_actual = float(freqs[int(np.argmin(np.abs(freqs - w_target)))])
        max_freq = plot_max_freq
        if max_freq is None and freqs.size > 0:
            max_freq = float(np.max(freqs))

        SEDPlotter(plot_obj, '2d_intensity', str(fname),
                   title=f"Summed iSED Input Spectrum (k≈{k_actual:.3f}, ω≈{w_actual:.3f})",
                   direction_label=k_dir_str,
                   highlight_region={'k_point_target': k_actual, 'freq_point_target': w_actual},
                   max_freq=max_freq, intensity_scale='sqrt', theme=plot_theme).generate_plot()
        logger.info("iSED input spectrum figure written: %s", fname.name)

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
