"""GUI analysis controller — all state and compute logic, no Tk.

Carried over from :mod:`psa_tpu.gui.controller`.  The reference GUI
interleaves Tkinter widget access with analysis logic in one 3,000-line class
(reference: src/psa/gui/psa_gui.py:139-3057), making it untestable headless.
Here the controller owns trajectory/SED/k-grid state and every computation
the GUI triggers; the Tk layer (psa_tpu_torch.gui.app) is a thin view that
calls into it from worker threads and marshals results back with
``root.after``.  Everything in this module runs without a display, and
imports neither Tk nor matplotlib.

The controller computes on ``device`` ('cuda' by default; it raises at
construction when there is no card, and never moves to the CPU by itself).
The view's worker threads share PyTorch's default stream with the thread
that loaded the trajectory, so a group uploaded by one thread is ordered
before the kernels another thread launches on it; the side streams of the
pinned transfers are tied to that stream by events.

The state objects (:class:`KGridState`, :class:`KGridPeaksState`,
:class:`DSFState`, :class:`LiquidState`) are dataclasses of NumPy arrays in
both packages: they compare field by field and need no converter
(:func:`psa_tpu_torch.core.convert.from_reference_calculator` carries a
calculator's arrays across).
"""
from __future__ import annotations

import ast
import functools
import logging
import threading
import os
import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.calculator import SEDCalculator, resolve_device
from ..core.sed import SED
from ..core.trajectory import Trajectory
from ..io.loader import TrajectoryLoader
from ..ops import spectral
from ..ops.instantaneous import commensurate_kpath
from ..utils.helpers import miller_line

logger = logging.getLogger(__name__)

# Chiral axis -> polarization component pair (reference psa_gui.py:976-982):
# the two components PERPENDICULAR to the chosen axis.
CHIRAL_AXIS_COMPONENTS = spectral.CHIRAL_AXIS_COMPONENTS


def parse_direction_input(text: str):
    """Parse the GUI direction entry: python literals first, bare words after
    (reference psa_gui.py:930-945 uses ast.literal_eval with fallbacks)."""
    text = text.strip()
    if not text:
        raise ValueError("Direction must not be empty.")
    try:
        return ast.literal_eval(text)
    except (ValueError, SyntaxError):
        return text  # named direction ('x', '110', ...) or CSV string


@dataclass
class KGridState:
    """Post-compute k-grid state with the ω ≥ 0 / max-freq filtered views the
    heatmap browser uses (reference psa_gui.py:2195-2232)."""
    sed: SED
    plane: str
    freqs: np.ndarray                 # filtered, ω >= 0 (and <= max_freq)
    intensity: np.ndarray             # (n_freq_filtered, n_kx*n_ky)
    phase: Optional[np.ndarray]       # filtered with the SAME mask (bug fix:
                                      # the reference indexed the unfiltered
                                      # phase with filtered indices, :2382)
    k1_axis: np.ndarray
    k2_axis: np.ndarray
    labels: Tuple[str, str]
    _vrange_cache: Dict[str, Tuple[float, float]] = field(default_factory=dict)

    def slice_at(self, freq_idx: int, use_phase: bool = False) -> np.ndarray:
        data = self.phase if (use_phase and self.phase is not None) else self.intensity
        n_kx, n_ky = self.sed.k_grid_shape
        return data[freq_idx].reshape(n_kx, n_ky).T

    def global_vrange(self, use_phase: bool = False, scale: str = 'linear'):
        """Global (vmin, vmax) across all frequency slices, cached — so the
        heatmap color scale is stable while scrubbing the slider
        (reference psa_gui.py:2414-2441)."""
        key = f"{'phase' if use_phase else 'intensity'}:{scale}"
        if key not in self._vrange_cache:
            data = self.phase if (use_phase and self.phase is not None) else self.intensity
            vals = apply_scale(data, scale)
            self._vrange_cache[key] = (float(np.min(vals)), float(np.max(vals)))
        return self._vrange_cache[key]


@dataclass
class KGridPeaksState:
    """Dispersion-surface state from on-device peak extraction: per-rank
    peak frequency / intensity / linewidth surfaces over the k-plane: three
    (n_peaks, n_k) float32 arrays cross to the host instead of the
    (n_freq, n_k) browse planes."""
    plane: str
    freq_surfaces: np.ndarray         # (n_peaks, n_kx, n_ky) THz
    intensity_surfaces: np.ndarray    # (n_peaks, n_kx, n_ky)
    linewidth_surfaces: np.ndarray    # (n_peaks, n_kx, n_ky) THz — RMS
                                      # spread proxy, or calibrated
                                      # Lorentzian FWHM with
                                      # width_method='lorentzian' (see
                                      # ops.spectral.peak_reduce)
    k1_axis: np.ndarray
    k2_axis: np.ndarray
    labels: Tuple[str, str]
    phase_surfaces: Optional[np.ndarray] = None   # (n_peaks, n_kx, n_ky)
                                                  # chiral phase at each peak
    width_method: str = 'rms'                     # 'rms' | 'lorentzian'

    def surface(self, rank: int = 0, kind: str = 'freq') -> np.ndarray:
        """(n_ky, n_kx) plot-oriented surface (transposed like slice_at)."""
        data = {'freq': self.freq_surfaces,
                'intensity': self.intensity_surfaces,
                'linewidth': self.linewidth_surfaces,
                'phase': self.phase_surfaces}[kind]
        if data is None:
            raise ValueError("no phase surfaces (compute with chiral=True)")
        return data[rank].T


@dataclass
class DSFState:
    """Last instantaneous-phase map (GUI DSF view): one (n_freq, n_k)
    plane over a commensurate k-path — exportable as a wide CSV."""
    k_mags: np.ndarray                # (n_k,)
    freqs: np.ndarray                 # (n_freq,)
    plane: np.ndarray                 # (n_freq, n_k) float32
    observable: str                   # 'total' | 'longitudinal' | 'transverse'
    direction_text: str


@dataclass
class LiquidState:
    """Last liquid-workflow curve set (GUI Liquid view) — exportable as a
    long CSV (x + one column per curve)."""
    kind: str                         # 'sk' | 'rdf' | 'msd' | 'vacf'
    x: np.ndarray                     # (n,)
    curves: np.ndarray                # (n_curves, n)
    labels: Tuple[str, ...]           # axis names: (xlabel, ylabel)
    curve_labels: Tuple[str, ...]     # one per row


def plane_axes(plane: str, k_vecs: np.ndarray, shape: Tuple[int, int]):
    """(k1_axis, k2_axis, labels) for a k-grid plane — unique component
    values, with a linspace fallback when float noise breaks uniqueness."""
    comp = {'xy': (0, 1, 'k_x', 'k_y'), 'yz': (1, 2, 'k_y', 'k_z'),
            'zx': (2, 0, 'k_z', 'k_x')}[plane.lower()]
    axes = []
    for ci, n in zip(comp[:2], shape):
        vals = np.unique(k_vecs[:, ci])
        if len(vals) != n:
            vals = np.linspace(k_vecs[:, ci].min(), k_vecs[:, ci].max(), n)
        axes.append(vals)
    return axes[0], axes[1], (comp[2], comp[3])


def apply_scale(values: np.ndarray, scale: str) -> np.ndarray:
    """GUI intensity scaling (reference psa_gui.py:2988-2997)."""
    scale = (scale or 'linear').lower()
    if scale == 'log':
        return np.log10(np.maximum(values, 1e-12))
    if scale == 'sqrt':
        return np.sqrt(np.maximum(values, 0))
    if scale == 'dsqrt':
        return np.sqrt(np.sqrt(np.maximum(values, 0)))
    return values


def _serialized(fn):
    """Serialize compute entry points on the controller's lock.

    The GUI runs computes on worker threads while every button stays
    clickable; the calculator carries per-sweep mutable state (the NPT
    fractional phase anchor, device-LRU bookkeeping), so two concurrent
    sweeps on one calculator could interleave anchor set/reset and produce
    silently wrong spectra.  One lock per controller makes concurrent
    clicks queue instead."""
    @functools.wraps(fn)
    def wrapper(self, *args, **kwargs):
        with self._compute_lock:
            return fn(self, *args, **kwargs)
    return wrapper


class AnalysisController:
    """Holds the loaded trajectory, calculator, and computed results."""

    def __init__(self, device: Union[str, torch.device] = 'cuda'):
        #: where every calculator this controller builds computes: 'cuda'
        #: (default; raises here when no card is present) or 'cpu'
        self.device = resolve_device(device)
        #: d2h dtype for the reduced display planes: 'float32' (exact,
        #: default) or 'float16' (sqrt-domain compressed — halves the
        #: dominant device→host bytes at ≤ ~1e-3 relative error per pixel,
        #: see ops.spectral.compress_plane).  Opt in for slow host links
        #: via the GUI preference or PSA_DISPLAY_READBACK=float16 (exact
        #: display is the default so the display≡full contracts hold
        #: bit-for-bit out of the box).
        self.readback_dtype: str = os.environ.get(
            'PSA_DISPLAY_READBACK', 'float32')
        self._compute_lock = threading.Lock()
        self.trajectory: Optional[Trajectory] = None
        self.calculator: Optional[SEDCalculator] = None
        self.sed_result: Optional[SED] = None          # k-path result
        self.kpath_mags: Optional[np.ndarray] = None
        self._kpath_reduced: bool = False
        self._kpath_recompute: Optional[dict] = None
        self.kgrid: Optional[KGridState] = None
        self.kgrid_peaks: Optional[KGridPeaksState] = None
        #: which k-grid result was produced last ('browse' | 'peaks' | None):
        #: CSV export follows this so "Calculate k-grid" → "Peak surface" →
        #: export writes the peak surface, not the stale browse grid.
        self.last_grid_kind: Optional[str] = None
        self.dsf: Optional[DSFState] = None
        self.liquid: Optional[LiquidState] = None
        #: most recent compute overall
        #: ('kpath'|'browse'|'peaks'|'dsf'|'liquid'|None) — CSV export
        #: prefers the DSF plane / liquid curves only when they were last
        self.last_compute: Optional[str] = None
        self.selected_point: Optional[Tuple[float, float]] = None  # (k, ω)
        self.ised_dump_path: Optional[Path] = None
        self.temp_dirs: List[tempfile.TemporaryDirectory] = []

    # -- trajectory ---------------------------------------------------------

    def has_cache(self, filename: str) -> bool:
        """True if the .npy sidecar cache exists (reference psa_gui.py:863-870)."""
        stem = Path(filename).parent / Path(filename).stem
        parts = ('positions', 'velocities', 'types', 'box_matrix')
        return all(stem.with_suffix(f'.{p}.npy').exists() for p in parts)

    def load_trajectory(self, filename: str, dt: float, file_format: str,
                        nx: int, ny: int, nz: int,
                        use_displacements: bool = False) -> Trajectory:
        loader = TrajectoryLoader(filename, dt=dt, file_format=file_format)
        self.trajectory = loader.load()
        self.calculator = SEDCalculator(self.trajectory, nx=nx, ny=ny, nz=nz,
                                        use_displacements=use_displacements,
                                        device=self.device)
        self.sed_result = None
        self._kpath_reduced = False
        self._kpath_recompute = None
        self.kgrid = None
        self.kgrid_peaks = None
        self.last_grid_kind = None
        self.dsf = None
        self.liquid = None
        self.last_compute = None
        self.selected_point = None
        return self.trajectory

    def _require_calc(self) -> SEDCalculator:
        if self.calculator is None:
            raise RuntimeError("Load a trajectory first.")
        return self.calculator

    # -- k-path SED (reference psa_gui.py:923-1013) --------------------------

    @_serialized
    def compute_kpath_sed(self, direction_text: str, n_k: int, bz_coverage: float,
                          lattice_param: Optional[float] = None,
                          basis_atom_types: Optional[list] = None,
                          summation_mode: str = 'coherent',
                          chiral: bool = False, chiral_axis: str = 'z',
                          angle_range_opt: str = 'C',
                          reduced: bool = True,
                          welch_segments: Optional[int] = None,
                          welch_window: str = 'hann',
                          polarization: str = 'total') -> SED:
        """Compute the k-path SED for display.

        ``reduced`` (default): intensity — and the chiral phase when asked —
        are reduced ON DEVICE and only the ω ≥ 0 float32 planes transfer
        (a twelfth of the full complex spectrum's bytes: one float32 plane
        of half the rows instead of three complex64 ones; the display never
        reads the rest).  iSED is unaffected:
        it recomputes its own spectrum at the clicked mode
        (:meth:`SEDCalculator.ised`).  ``reduced=False`` restores the full
        complex SED on the state object (library/export workflows).

        ``welch_segments`` switches the estimate to
        :meth:`SEDCalculator.calculate_welch` (segment-averaged intensity;
        smoother lines at n_frames // segments resolution).  Welch output
        has no complex spectra, so it is rejected in combination with
        ``chiral``.

        ``polarization``: 'total' (default, Σ_α|Φ_α|²), or 'longitudinal' /
        'transverse' — the on-device L/T split
        (:meth:`SEDCalculator.calculate_lt`) that isolates LA / TA
        branches.  Exclusive with ``chiral`` and ``welch_segments``.
        """
        calc = self._require_calc()
        if polarization not in ('total', 'longitudinal', 'transverse'):
            raise ValueError(f"polarization must be 'total', 'longitudinal' "
                             f"or 'transverse', got {polarization!r}")
        if polarization != 'total' and chiral:
            raise ValueError("Chiral phase applies to the Cartesian "
                             "components; set polarization to 'total'.")
        if polarization != 'total' and welch_segments:
            raise ValueError("Welch averaging is not available for the "
                             "L/T split; set polarization to 'total'.")
        direction = parse_direction_input(direction_text)
        k_mags, k_vecs = calc.get_k_path(direction, bz_coverage=bz_coverage,
                                         n_k=n_k, lat_param=lattice_param)
        if chiral and summation_mode != 'coherent':
            logger.info("Chiral analysis requires coherent summation; forcing coherent.")
            summation_mode = 'coherent'
        if polarization != 'total':
            freqs, i_long, i_trans = calc.calculate_lt(
                k_vecs, basis_atom_types=basis_atom_types,
                summation_mode=summation_mode)
            plane = i_long if polarization == 'longitudinal' else i_trans
            sed = SED(plane, freqs, k_mags, k_vecs, is_complex=False,
                      dt_ps=calc.dt_ps)
        elif welch_segments:
            if chiral:
                raise ValueError("Chiral analysis needs complex spectra; "
                                 "disable Welch averaging.")
            sed = calc.calculate_welch(k_mags, k_vecs,
                                       segments=int(welch_segments),
                                       window=welch_window,
                                       basis_atom_types=basis_atom_types,
                                       summation_mode=summation_mode)
        elif reduced:
            # display path: exact f32 by default; self.readback_dtype
            # opts into the sqrt-domain f16 readback on slow links.
            # Exact f32 is recomputed for saves/iSED either way.
            freqs, intensity, phase = calc.calculate_kgrid_browse(
                k_vecs, basis_atom_types=basis_atom_types,
                summation_mode=summation_mode, chiral=chiral,
                chiral_axis=chiral_axis, angle_range_opt=angle_range_opt,
                readback_dtype=self.readback_dtype)
            sed = SED(intensity, freqs, k_mags, k_vecs, is_complex=False,
                      phase=phase, dt_ps=calc.dt_ps)
        else:
            sed = self._full_kpath_calculate(
                k_mags, k_vecs, basis_atom_types, summation_mode, chiral,
                chiral_axis, angle_range_opt)
        self.sed_result = sed
        self.kpath_mags = k_mags
        # Welch and L/T results carry no complex spectra either, so exports
        # that need Φ_α recompute the full spectrum like the reduced path.
        self._kpath_reduced = (reduced or bool(welch_segments)
                               or polarization != 'total')
        self._kpath_recompute = dict(
            k_mags=k_mags, k_vecs=k_vecs, basis_atom_types=basis_atom_types,
            summation_mode=summation_mode, chiral=chiral,
            chiral_axis=chiral_axis, angle_range_opt=angle_range_opt)
        self.selected_point = None
        self.last_compute = 'kpath'
        return sed

    @_serialized
    def compute_npt_sed(self, direction_text: str, n_k: int,
                        max_order: float = 1.0,
                        basis_atom_types: Optional[list] = None,
                        summation_mode: str = 'coherent',
                        chiral: bool = False, chiral_axis: str = 'z',
                        angle_range_opt: str = 'C',
                        welch_segments: Optional[int] = None,
                        welch_window: str = 'hann',
                        reduced: bool = True) -> SED:
        """k-path SED for a time-dependent (NPT) cell — the GUI surface of
        :meth:`SEDCalculator.calculate_npt_browse` (beyond the reference,
        whose engine assumes a constant box, sed_calculator.py:30-56).

        The path lives in FRACTIONAL (Miller) space: ``direction_text`` is
        parsed like the fixed-cell form but interpreted as an integer
        Miller vector, swept in ``n_k`` steps up to ``max_order`` multiples
        (the NPT analog of BZ coverage).  Phases anchor on per-frame
        fractional coordinates, so phonon lines stay sharp under cell
        breathing/drift; the displayed k axis carries the mean-cell
        Cartesian magnitudes |B̄·m| for physical Å⁻¹ units.

        ``reduced`` (default) keeps the sweep device-reduced exactly like
        :meth:`compute_kpath_sed`; exports needing complex Φ_α recompute
        via :meth:`SEDCalculator.calculate_npt` (see :meth:`full_kpath_sed`).
        """
        calc = self._require_calc()
        if self.trajectory is None or self.trajectory.box_matrices is None:
            raise RuntimeError(
                "NPT SED needs per-frame cells: load an NPT dump whose "
                "reader fills Trajectory.box_matrices (LAMMPS/H5MD do).")
        if chiral and summation_mode != 'coherent':
            logger.info("Chiral analysis requires coherent summation; "
                        "forcing coherent.")
            summation_mode = 'coherent'
        if chiral and welch_segments:
            raise ValueError("Chiral analysis needs complex spectra; "
                             "disable Welch averaging.")
        # free-form direction entry resolved to an UNNORMALIZED Miller
        # vector ('xy' -> [1,1,0], '[2,0,0]' raw) so integer multiples stay
        # box-commensurate — identical to the CLI npt.direction semantics
        m = miller_line(parse_direction_input(direction_text), n_k,
                        max_order)
        if reduced:
            freqs, intensity, phase, k_cart = calc.calculate_npt_browse(
                m, basis_atom_types=basis_atom_types,
                summation_mode=summation_mode, chiral=chiral,
                chiral_axis=chiral_axis, angle_range_opt=angle_range_opt,
                welch_segments=welch_segments, welch_window=welch_window,
                readback_dtype=self.readback_dtype)
            k_mags = np.linalg.norm(k_cart, axis=1).astype(np.float32)
            sed = SED(intensity, freqs, k_mags, k_cart, is_complex=False,
                      phase=phase, dt_ps=calc.dt_ps)
        else:
            sed = calc.calculate_npt(m, basis_atom_types=basis_atom_types,
                                     summation_mode=summation_mode)
            if chiral and sed.is_complex:
                c1, c2 = CHIRAL_AXIS_COMPONENTS[chiral_axis]
                sed.phase = calc.calculate_chiral_phase(
                    sed.sed[:, :, c1], sed.sed[:, :, c2], angle_range_opt)
        self.sed_result = sed
        self.kpath_mags = sed.k_points
        self._kpath_reduced = not sed.is_complex
        self._kpath_recompute = dict(
            npt_k_miller=m, basis_atom_types=basis_atom_types,
            summation_mode=summation_mode, chiral=chiral,
            chiral_axis=chiral_axis, angle_range_opt=angle_range_opt)
        self.selected_point = None
        self.last_compute = 'kpath'
        return sed

    @_serialized
    def compute_kpath_dsf(self, direction_text: str, n_k: int,
                          bz_coverage: float,
                          lattice_param: Optional[float] = None,
                          basis_atom_types: Optional[list] = None,
                          max_freq: Optional[float] = None,
                          observable: str = 'longitudinal'):
        """Instantaneous-phase map over a k-path (the GUI's DSF view).

        The path is snapped onto the box reciprocal lattice
        (:func:`commensurate_kpath` — instantaneous phases are only
        wrap-invariant there) and de-duplicated after snapping.
        ``observable``: 'total' → S(k,ω) (density / dynamic structure
        factor), 'longitudinal' → C_L, 'transverse' → C_T current spectra,
        'self' → S_s(k,ω) (incoherent part; quasi-elastic width measures
        self-diffusion).

        Returns (k_mags, freqs, plane) for display; the SED state is NOT
        touched — iSED keeps operating on the last SED result.
        """
        if observable not in ('total', 'longitudinal', 'transverse', 'self'):
            raise ValueError(f"observable must be 'total', 'longitudinal', "
                             f"'transverse' or 'self', got {observable!r}")
        calc = self._require_calc()
        direction = parse_direction_input(direction_text)
        _, k_vecs = calc.get_k_path(direction, bz_coverage=bz_coverage,
                                    n_k=n_k, lat_param=lattice_param)
        k_vecs = commensurate_kpath(k_vecs, calc.traj.box_matrix)
        k_mags = np.linalg.norm(k_vecs, axis=1)
        if observable == 'self':
            freqs, plane = calc.calculate_dsf_self(
                k_vecs, basis_atom_types=basis_atom_types, max_freq=max_freq)
        else:
            freqs, s, c_l, c_t = calc.calculate_dsf(
                k_vecs, basis_atom_types=basis_atom_types, max_freq=max_freq)
            plane = {'total': s, 'longitudinal': c_l,
                     'transverse': c_t}[observable]
        self.dsf = DSFState(k_mags=k_mags, freqs=freqs, plane=plane,
                            observable=observable,
                            direction_text=direction_text)
        self.last_compute = 'dsf'
        return k_mags, freqs, plane

    def _full_kpath_calculate(self, k_mags, k_vecs, basis_atom_types,
                              summation_mode, chiral, chiral_axis,
                              angle_range_opt) -> SED:
        calc = self._require_calc()
        sed = calc.calculate(k_mags, k_vecs,
                             basis_atom_types=basis_atom_types,
                             summation_mode=summation_mode)
        if chiral and sed.is_complex:
            c1, c2 = CHIRAL_AXIS_COMPONENTS[chiral_axis]
            sed.phase = calc.calculate_chiral_phase(
                sed.sed[:, :, c1], sed.sed[:, :, c2], angle_range_opt)
        return sed

    @_serialized
    def full_kpath_sed(self) -> SED:
        """The k-path SED WITH complex amplitudes, for .npy export.

        The display default is device-reduced (float32 intensity planes);
        exports that historically carried the complex Φ_α recompute the
        full spectrum once here (the device-resident group data is cached,
        so only the extra d2h transfer is paid)."""
        if self.sed_result is None:
            raise RuntimeError("Compute a k-path SED first.")
        if not self._kpath_reduced or self.sed_result.is_complex:
            return self.sed_result
        rc = dict(self._kpath_recompute)
        m = rc.pop('npt_k_miller', None)
        if m is not None:
            calc = self._require_calc()
            chiral = rc.pop('chiral', False)
            chiral_axis = rc.pop('chiral_axis', 'z')
            angle_opt = rc.pop('angle_range_opt', 'C')
            sed = calc.calculate_npt(m, **rc)
            if chiral and sed.is_complex:   # same contract as fixed-cell
                c1, c2 = CHIRAL_AXIS_COMPONENTS[chiral_axis]
                sed.phase = calc.calculate_chiral_phase(
                    sed.sed[:, :, c1], sed.sed[:, :, c2], angle_opt)
            return sed
        return self._full_kpath_calculate(**rc)

    def kpath_plot_arrays(self, scale: str = 'dsqrt', max_freq: Optional[float] = None,
                          show_phase: bool = False):
        """(k, ω, C) arrays for the dispersion pcolormesh, ω ≥ 0 masked."""
        sed = self.sed_result
        if sed is None:
            raise RuntimeError("Compute a k-path SED first.")
        mask = sed.freqs >= 0
        freqs = sed.freqs[mask]
        if show_phase and sed.phase is not None:
            c = sed.phase[mask]
        else:
            # non-complex SEDs already hold intensities (reduced k-path /
            # incoherent); .intensity would mis-reduce them over k
            inten = sed.intensity if sed.is_complex else sed.sed
            c = apply_scale(inten[mask], scale)
        if max_freq is not None:
            fm = freqs <= max_freq
            freqs, c = freqs[fm], c[fm]
        return sed.k_points, freqs, c

    def select_nearest(self, k_click: float, w_click: float) -> Tuple[float, float]:
        """Snap a plot click to the nearest (k, ω) sample (reference
        psa_gui.py:1215-1216)."""
        sed = self.sed_result
        if sed is None:
            raise RuntimeError("Compute a k-path SED first.")
        k_idx = int(np.argmin(np.abs(sed.k_points - k_click)))
        pos = sed.freqs[sed.freqs >= 0]
        w_idx = int(np.argmin(np.abs(pos - w_click)))
        self.selected_point = (float(sed.k_points[k_idx]), float(pos[w_idx]))
        return self.selected_point

    # -- k-grid SED (reference psa_gui.py:2099-2232) -------------------------

    def _npt_grid_guard(self, reduced: bool = True, engine: str = 'auto',
                        polarization: str = 'total') -> None:
        """Shared validation for the NPT grid forms (fractional anchor)."""
        if self.trajectory is None or self.trajectory.box_matrices is None:
            raise RuntimeError(
                "NPT grids need per-frame cells: load an NPT dump whose "
                "reader fills Trajectory.box_matrices (LAMMPS/H5MD do).")
        if polarization != 'total':
            raise ValueError("The L/T split is fixed-cell only; set "
                             "polarization to 'total' for NPT grids.")
        if not reduced:
            raise ValueError("NPT grids are device-reduced; use "
                             "reduced=True.")
        if engine == 'gridded':
            raise ValueError("NPT grids run on the direct engine (the "
                             "NUFFT plan assumes a fixed Cartesian cell).")

    @_serialized
    def compute_kgrid_sed(self, plane: str, k_range_1: Tuple[float, float],
                          k_range_2: Tuple[float, float], n_k1: int, n_k2: int,
                          k_fixed: float = 0.0, max_freq: Optional[float] = None,
                          basis_atom_types: Optional[list] = None,
                          summation_mode: str = 'coherent',
                          chiral: bool = False, chiral_axis: str = 'z',
                          k_chunk_size: int = 2048,
                          engine: str = 'auto',
                          reduced: bool = True,
                          polarization: str = 'total',
                          npt: bool = False) -> KGridState:
        """``engine``: 'direct', 'gridded' (NUFFT), or 'auto'.

        'auto' resolves to DIRECT at every size, as the calculator's own
        'auto' does: which engine wins depends on the grid and the card (see
        PERF.md for the walls of both at 50×50 and 200×200), and no
        crossover rule is chosen yet.  The gridded engine is selected by
        name.

        ``reduced`` (default): intensity and chiral phase are reduced on
        device and only the ω-filtered float32 planes transfer to host —
        the complex spectrum never crosses the device boundary (it is not
        needed for browsing; iSED recomputes its own k-path).  Set
        ``reduced=False`` to keep the full complex SED on the state object.

        ``polarization``: 'total' (default), or 'longitudinal' /
        'transverse' — the on-device L/T split (:meth:`SEDCalculator.
        calculate_lt`) per k-point of the grid; direct engine, reduced
        planes only, incompatible with chiral.

        ``npt``: interpret the grid ranges as FRACTIONAL Miller
        coordinates and anchor phases on per-frame fractional positions
        (:meth:`SEDCalculator.calculate_npt_browse`) — dispersion
        surfaces for a time-dependent (NPT) cell.  Direct engine,
        reduced planes, polarization='total' only; the state's axes are
        Miller (m) coordinates.
        """
        calc = self._require_calc()
        if npt:
            self._npt_grid_guard(reduced=reduced, engine=engine,
                                 polarization=polarization)
        if polarization not in ('total', 'longitudinal', 'transverse'):
            raise ValueError(f"polarization must be 'total', 'longitudinal' "
                             f"or 'transverse', got {polarization!r}")
        if polarization != 'total':
            if chiral:
                raise ValueError("chiral phase compares Cartesian "
                                 "components; set polarization to 'total'.")
            if engine == 'gridded':
                raise ValueError("the L/T split runs on the direct engine; "
                                 "set engine to 'auto' or 'direct'.")
            if not reduced:
                raise ValueError("the L/T split is a device-reduced path; "
                                 "use reduced=True.")
        _, k_vecs, shape = calc.get_k_grid(plane, k_range_1, k_range_2,
                                           n_k1, n_k2, k_fixed_val=k_fixed)
        if chiral:
            summation_mode = 'coherent'
        if npt:
            # the same row-major grid rows, reinterpreted as Miller m
            freqs, intensity, phase, _ = calc.calculate_npt_browse(
                k_vecs.astype(np.float64),
                basis_atom_types=basis_atom_types,
                summation_mode=summation_mode, max_freq=max_freq,
                chiral=chiral, chiral_axis=chiral_axis,
                k_chunk_size=k_chunk_size,
                readback_dtype=self.readback_dtype)
            sed = SED(intensity, freqs, np.array([], dtype=np.float32),
                      k_vecs, k_grid_shape=shape, is_complex=False,
                      phase=phase, dt_ps=calc.dt_ps)
            k1_axis, k2_axis, labels = plane_axes(plane, k_vecs, shape)
            labels = tuple(l.replace('k_', 'm_') for l in labels)
            self.kgrid = KGridState(sed=sed, plane=plane.lower(),
                                    freqs=freqs, intensity=intensity,
                                    phase=phase, k1_axis=k1_axis,
                                    k2_axis=k2_axis, labels=labels)
            self.last_grid_kind = 'browse'
            self.last_compute = 'browse'
            return self.kgrid
        use_gridded = engine == 'gridded'
        if polarization != 'total':
            freqs, i_l, i_t = calc.calculate_lt(
                k_vecs, basis_atom_types=basis_atom_types,
                summation_mode=summation_mode, max_freq=max_freq,
                k_chunk_size=k_chunk_size)
            intensity = i_l if polarization == 'longitudinal' else i_t
            sed = SED(intensity, freqs, np.array([], dtype=np.float32),
                      k_vecs, k_grid_shape=shape, is_complex=False,
                      dt_ps=calc.dt_ps)
            k1_axis, k2_axis, labels = plane_axes(plane, k_vecs, shape)
            self.kgrid = KGridState(sed=sed, plane=plane.lower(), freqs=freqs,
                                    intensity=intensity, phase=None,
                                    k1_axis=k1_axis, k2_axis=k2_axis,
                                    labels=labels)
            self.last_grid_kind = 'browse'
            self.last_compute = 'browse'
            return self.kgrid
        if reduced:
            freqs, intensity, phase = calc.calculate_kgrid_browse(
                k_vecs, basis_atom_types=basis_atom_types,
                summation_mode=summation_mode, max_freq=max_freq,
                chiral=chiral, chiral_axis=chiral_axis,
                k_chunk_size=k_chunk_size,
                engine='gridded' if use_gridded else 'direct',
                k_grid_shape=shape,
                # sqrt-domain f16 readback only when opted in AND on the
                # direct engine (the gridded reduction has no compressed form)
                readback_dtype=('float32' if use_gridded
                                else self.readback_dtype))
            # Reduced container: carries the filtered intensity as a
            # non-complex SED (the browser only reads k_grid_shape from it).
            sed = SED(intensity, freqs, np.array([], dtype=np.float32), k_vecs,
                      k_grid_shape=shape, is_complex=False, phase=phase,
                      dt_ps=calc.dt_ps)
        else:
            if use_gridded:
                sed = calc.calculate_gridded(k_vecs, shape,
                                             basis_atom_types=basis_atom_types)
            else:
                sed = calc.calculate(np.array([], dtype=np.float32), k_vecs,
                                     basis_atom_types=basis_atom_types,
                                     summation_mode=summation_mode,
                                     k_grid_shape=shape, k_chunk_size=k_chunk_size)
            phase_full = None
            if chiral and sed.is_complex:
                c1, c2 = CHIRAL_AXIS_COMPONENTS[chiral_axis]
                phase_full = calc.calculate_chiral_phase(sed.sed[:, :, c1],
                                                         sed.sed[:, :, c2])
                sed.phase = phase_full

            mask = sed.freqs >= 0
            if max_freq is not None:
                mask &= sed.freqs <= max_freq
            freqs = sed.freqs[mask]
            # incoherent results already ARE intensities; .intensity would
            # re-square them (its Σ_α|·|² is defined for complex amplitudes)
            intensity = sed.intensity[mask] if sed.is_complex else sed.sed[mask]
            # Phase filtered with the SAME mask — the reference indexed the
            # unfiltered phase array with filtered indices (psa_gui.py:2382).
            phase = phase_full[mask] if phase_full is not None else None

        k1_axis, k2_axis, labels = plane_axes(plane, k_vecs, shape)
        self.kgrid = KGridState(sed=sed, plane=plane.lower(), freqs=freqs,
                                intensity=intensity, phase=phase,
                                k1_axis=k1_axis, k2_axis=k2_axis,
                                labels=labels)
        self.last_grid_kind = 'browse'
        self.last_compute = 'browse'
        return self.kgrid

    @_serialized
    def compute_kgrid_peaks(self, plane: str, k_range_1: Tuple[float, float],
                            k_range_2: Tuple[float, float], n_k1: int,
                            n_k2: int, k_fixed: float = 0.0, n_peaks: int = 1,
                            max_freq: Optional[float] = None,
                            basis_atom_types: Optional[list] = None,
                            summation_mode: str = 'coherent',
                            k_chunk_size: int = 2048,
                            engine: str = 'auto',
                            chiral: bool = False,
                            chiral_axis: str = 'z',
                            width_method: str = 'rms',
                            npt: bool = False) -> KGridPeaksState:
        """Dispersion surface(s) over a k-plane via on-device peak
        extraction (:meth:`SEDCalculator.calculate_kgrid_peaks`): only the
        (n_peaks, n_k) float32 triplet crosses the host link.
        ``engine``: 'auto' (the calculator's rule: the direct engine),
        'direct', or 'gridded' (the NUFFT engine; coherent only).  ``chiral=True``
        also gathers the chiral phase at each peak (direct engine).
        ``npt``: Miller-space grid with the fractional phase anchor
        (:meth:`SEDCalculator.calculate_npt_peaks`; direct engine)."""
        calc = self._require_calc()
        if npt:
            self._npt_grid_guard(engine=engine)   # 'auto' resolves direct
        _, k_vecs, shape = calc.get_k_grid(plane, k_range_1, k_range_2,
                                           n_k1, n_k2, k_fixed_val=k_fixed)
        if chiral:
            summation_mode = 'coherent'
            engine = 'direct'
        if npt:
            out = calc.calculate_npt_peaks(
                k_vecs.astype(np.float64), n_peaks=n_peaks,
                max_freq=max_freq, basis_atom_types=basis_atom_types,
                summation_mode=summation_mode, k_chunk_size=k_chunk_size,
                engine='direct', chiral=chiral, chiral_axis=chiral_axis,
                width_method=width_method)
            res = out[:-1]                     # trailing element is k_cart
        else:
            res = calc.calculate_kgrid_peaks(
                k_vecs, n_peaks=n_peaks, max_freq=max_freq,
                basis_atom_types=basis_atom_types,
                summation_mode=summation_mode,
                k_chunk_size=k_chunk_size, engine=engine,
                k_grid_shape=shape if engine != 'direct' else None,
                chiral=chiral, chiral_axis=chiral_axis,
                width_method=width_method)
        pf, pi, pw = res[:3]
        pphase = res[3] if len(res) == 4 else None
        k1_axis, k2_axis, labels = plane_axes(plane, k_vecs, shape)
        if npt:
            labels = tuple(l.replace('k_', 'm_') for l in labels)
        self.kgrid_peaks = KGridPeaksState(
            plane=plane.lower(),
            freq_surfaces=pf.reshape((-1,) + tuple(shape)),
            intensity_surfaces=pi.reshape((-1,) + tuple(shape)),
            linewidth_surfaces=pw.reshape((-1,) + tuple(shape)),
            k1_axis=k1_axis, k2_axis=k2_axis, labels=labels,
            phase_surfaces=(pphase.reshape((-1,) + tuple(shape))
                            if pphase is not None else None),
            width_method=width_method)
        self.last_grid_kind = 'peaks'
        self.last_compute = 'peaks'
        return self.kgrid_peaks

    @_serialized
    def compute_liquid_curve(self, kind: str, direction_text: str = 'x',
                             n_k: int = 50, bz_coverage: float = 1.0,
                             lattice_param: Optional[float] = None,
                             basis_atom_types: Optional[list] = None):
        """One of the liquid-workflow curve observables, on device.

        ``kind``: 'sk' → static structure factor over the (snapped)
        current k-path; 'rdf' → radial distribution function; 'msd' /
        'vacf' → time-correlation functions (one curve per type when a
        flat type list is set); 'isf_self' → F_s(k,τ) decay curves, one
        per k sampled along the snapped current k-path (≤ 6).

        Returns (x, curves (n_curves, n), xlabel, ylabel) ready to plot.
        """
        calc = self._require_calc()
        if kind == 'sk':
            direction = parse_direction_input(direction_text)
            _, k_vecs = calc.get_k_path(direction, bz_coverage=bz_coverage,
                                        n_k=n_k, lat_param=lattice_param)
            k_vecs = commensurate_kpath(k_vecs, calc.traj.box_matrix)
            sk = calc.calculate_sk(k_vecs,
                                   basis_atom_types=basis_atom_types)
            x, curves = np.linalg.norm(k_vecs, axis=1), sk[None, :]
            xlabel, ylabel = "k (2π/Å)", "S(k)"
        elif kind == 'rdf':
            x, g = calc.calculate_rdf(basis_atom_types=basis_atom_types)
            curves, xlabel, ylabel = g[None, :], "r (Å)", "g(r)"
        elif kind == 'msd':
            x, curves = calc.calculate_msd(basis_atom_types=basis_atom_types)
            xlabel, ylabel = "τ (ps)", "MSD (Å²)"
        elif kind == 'vacf':
            x, curves = calc.calculate_vacf(
                basis_atom_types=basis_atom_types)
            xlabel, ylabel = "τ (ps)", "VACF ((Å/ps)²)"
        elif kind == 'isf_self':
            direction = parse_direction_input(direction_text)
            _, k_vecs = calc.get_k_path(direction, bz_coverage=bz_coverage,
                                        n_k=n_k, lat_param=lattice_param)
            k_vecs = commensurate_kpath(k_vecs, calc.traj.box_matrix)
            sel = np.unique(np.linspace(0, len(k_vecs) - 1,
                                        min(6, len(k_vecs))).astype(int))
            k_vecs = k_vecs[sel]
            x, f_s = calc.calculate_isf_self(
                k_vecs, basis_atom_types=basis_atom_types)
            curves = f_s.T                       # one decay curve per k
            xlabel, ylabel = "τ (ps)", "F_s(k,τ)"
            k_mags = np.linalg.norm(k_vecs, axis=1)
            curve_labels = tuple(f"k = {k:.2f}" for k in k_mags)
            self.liquid = LiquidState(kind=kind, x=x, curves=curves,
                                      labels=(xlabel, ylabel),
                                      curve_labels=curve_labels)
            self.last_compute = 'liquid'
            return x, curves, xlabel, ylabel
        else:
            raise ValueError(f"kind must be 'sk', 'rdf', 'msd', 'vacf' or "
                             f"'isf_self', got {kind!r}")
        if (basis_atom_types and curves.shape[0] == len(basis_atom_types)
                and curves.shape[0] > 1):
            curve_labels = tuple(f"type {t}" for t in basis_atom_types)
        elif curves.shape[0] > 1:
            curve_labels = tuple(f"group {i + 1}"
                                 for i in range(curves.shape[0]))
        else:
            curve_labels = ("total",)
        self.liquid = LiquidState(kind=kind, x=x, curves=curves,
                                  labels=(xlabel, ylabel),
                                  curve_labels=curve_labels)
        self.last_compute = 'liquid'
        return x, curves, xlabel, ylabel

    @_serialized
    def compute_dos(self, basis_atom_types: Optional[list] = None,
                    max_freq: Optional[float] = None):
        """(freqs, dos (n_groups, n_keep)) — on-device vibrational DOS,
        type-projected when ``basis_atom_types`` is a flat type list."""
        calc = self._require_calc()
        return calc.calculate_dos(basis_atom_types=basis_atom_types,
                                  max_freq=max_freq)

    # -- iSED (reference psa_gui.py:1265-1368) -------------------------------

    @_serialized
    def reconstruct_ised(self, direction_text: str, char_len: float,
                         n_k: int = 100, bz_coverage: float = 1.0,
                         rescale: Any = 'auto', n_frames: int = 100,
                         basis_atom_types: Optional[list] = None,
                         out_dir: Optional[Path] = None,
                         npt: Optional[bool] = None) -> Path:
        """Run iSED at the selected (k, ω); returns the dump path.

        ``npt``: None (default) follows the last k-path compute — a mode
        clicked on an NPT dispersion reconstructs with the fractional
        anchor, AND the Miller path range widens to at least the computed
        sweep's (the reconstruction tab's separate BZ-coverage default of
        1.0 would otherwise silently snap a clicked m=3 mode to the path
        end).  Pass True/False to override the detection; an explicit
        True keeps ``bz_coverage`` as given (max Miller order)."""
        calc = self._require_calc()
        if self.selected_point is None:
            raise RuntimeError("Select a (k, ω) point on the dispersion plot first.")
        if npt is None:
            stored = (self._kpath_recompute or {}).get('npt_k_miller')
            npt = stored is not None
            if npt:
                d = miller_line(parse_direction_input(direction_text), 1,
                                1.0)[0]
                mo_seen = (float(np.linalg.norm(stored[-1]))
                           / float(np.linalg.norm(d)))
                if mo_seen > bz_coverage:
                    logger.info("iSED auto-NPT: widening the Miller path "
                                "to the computed sweep's max order %.3g "
                                "(recon field had %.3g).",
                                mo_seen, bz_coverage)
                    bz_coverage = mo_seen
        k_target, w_target = self.selected_point
        if out_dir is None:
            tmp = tempfile.TemporaryDirectory(prefix='psa_ised_')
            self.temp_dirs.append(tmp)
            out_dir = Path(tmp.name)
        out_dir = Path(out_dir)
        dump = out_dir / "ised_reconstruction.dump"
        calc.ised(k_dir_spec=parse_direction_input(direction_text),
                  k_target=k_target, w_target=w_target,
                  char_len_k_path=char_len, nk_on_path=n_k,
                  bz_cov_ised=bz_coverage, rescale_factor=rescale,
                  n_recon_frames=n_frames,
                  basis_atom_types_ised=basis_atom_types,
                  dump_filepath=str(dump), npt=npt)
        self.ised_dump_path = dump
        return dump

    def load_ised_motion(self):
        """Re-read the reconstruction dump for the 3D animation viewer
        (reference re-parses its own dump, psa_gui.py:1396-1455)."""
        from ..io.lammps import read_lammps_dump
        if self.ised_dump_path is None:
            raise RuntimeError("No iSED reconstruction available.")
        pos, _, types, _, box = read_lammps_dump(self.ised_dump_path, unwrap=False)
        return pos, types, box

    def cleanup(self) -> None:
        for tmp in self.temp_dirs:
            try:
                tmp.cleanup()
            except Exception:
                pass
        self.temp_dirs.clear()
