"""SED compute core on PyTorch (counterpart of :mod:`psa_tpu.ops.spectral`).

The math (reference formula, src/psa/core/sed_calculator.py:58-84):

    r̄_a      = mean_t r_a(t)
    P[a,k]   = exp(i k_vec[k] · r̄_a)
    S_α(t,k) = Σ_a data[t,a,α] · P[a,k]
    Φ_α(ω,k) = FFT_t[S_α](ω) / n_t

Steps 1-3 (angles, cos/sin, the atom contraction) run in
:func:`psa_tpu_torch.ops.sed_projection.sed_projection`; step 4 is
``torch.fft.fft`` over time (:func:`finalize_spectrum`).  Complex results
are complex64 tensors.

The grid reductions (browse planes, Welch segments, the L/T split, peak
extraction) are plain torch ops on the device: the complex spectrum of a
k-chunk never leaves it, only the reduced planes or peak triplets do.
:class:`Reduction` is the one place that decides what a projection
surface makes of a k-slice's projections, on one device and on a mesh.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span
from .sed_projection import sed_projection

PRECISIONS = ('parity', 'balanced', 'fast')


def check_precision(precision: str) -> None:
    """Accept the projection kernel's tiers: 'parity', 'balanced', 'fast'."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")


def fftfreq_thz(n_t: int, dt_ps: float) -> np.ndarray:
    """Signed FFT frequencies in THz (host-side; reference sed_calculator.py:206)."""
    if n_t <= 0:
        return np.array([], dtype=np.float32)
    return np.fft.fftfreq(n_t, d=dt_ps)


def split_f64(x64: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Split a float64 host array into a (hi, lo) float32 pair with
    hi + lo == x64 to ~2⁻⁴⁸ relative.  Host-side (NumPy)."""
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def sed_spectrum(data: torch.Tensor, mp_hi: torch.Tensor, mp_lo: torch.Tensor,
                 k_vectors: torch.Tensor, precision: str = 'parity') -> torch.Tensor:
    """Complex SED spectrum Φ_α(ω, k) of one atom group.

    Args:
        data:      (n_t, n_atoms, 3) float32 velocities or displacements.
        mp_hi, mp_lo: (n_atoms, 3) float32 split of the float64 mean positions
            (see :func:`split_f64`).
        k_vectors: (n_k, 3) float32.
        precision: the projection kernel's tier, 'parity' (3xTF32 products,
            IEEE float32 sums), 'balanced' (3xBF16) or 'fast' (1xTF32).

    Returns:
        (n_t, n_k, 3) complex64.
    """
    check_precision(precision)
    return finalize_spectrum(*sed_projection(data, mp_hi, mp_lo, k_vectors,
                                             precision=precision))


def finalize_spectrum(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Φ (n_t, K, 3) complex64 of a (n_t, 3, K) projection pair: the FFT
    over time divided by n_t (a view; the polarization axis is last)."""
    spec = torch.fft.fft(torch.complex(re, im), dim=0) / re.shape[0]
    return spec.transpose(1, 2)


def dos_accumulate(dos: torch.Tensor, data_chunk: torch.Tensor,
                   freq_idx: torch.Tensor) -> torch.Tensor:
    """dos + Σ_{a∈chunk, α} |FFT_t data|²/n_t² at the kept frequency rows.

    The vibrational density of states DOS(ν) = Σ_a,α |v̂_aα(ν)|², the
    Fourier transform of the velocity autocorrelation; normalized like the
    SED (FFT/n_t), so a one-atom DOS equals that atom's k=0 incoherent SED.
    (n_keep,) float32 accumulator; atoms come in chunks.
    """
    n_t = data_chunk.shape[0]
    spec = torch.fft.fft(data_chunk.to(torch.complex64), dim=0) / n_t
    inten = (spec.real * spec.real + spec.imag * spec.imag).sum(dim=(1, 2))
    return dos + inten.index_select(0, freq_idx).float()


def _power(spec: torch.Tensor) -> torch.Tensor:
    """Σ over the last (polarization) axis of |spec|², float32."""
    return (spec.real * spec.real + spec.imag * spec.imag).sum(dim=-1)


# ---------------------------------------------------------------------------
# Welch/Bartlett segment averaging
# ---------------------------------------------------------------------------

def welch_window(seg: int, window: str, device=None) -> Optional[torch.Tensor]:
    """Per-segment taper with unit coherent gain (mean 1), float32, or None
    for 'rect'.  'hann' is the periodic Hann 0.5·(1 − cos) divided by its
    mean 0.5, i.e. 1 − cos(2πn/seg)."""
    if window == 'rect':
        return None
    if window == 'hann':
        n = torch.arange(seg, dtype=torch.float64, device=device)
        return (1.0 - torch.cos(2.0 * torch.pi * n / seg)).float()
    raise ValueError(f"window must be 'rect' or 'hann', got {window!r}")


def _segment_spectra(re: torch.Tensor, im: torch.Tensor, segments: int,
                     window: str) -> torch.Tensor:
    """Per-segment spectra of (n_t, 3, K) projections, (S, seg, K, 3) complex64.

    The time axis is cut into ``segments`` windows of n_t // segments frames
    (the trailing n_t % segments frames are dropped), each tapered by
    :func:`welch_window` and FFT'd with the same FFT/seg normalization as the
    full spectrum.  The taper multiplies the projected signal: windowing
    commutes with the atom contraction, so the kernel runs once per k-chunk.
    """
    n_t, _, n_k = re.shape
    seg = n_t // segments
    sig = torch.complex(re[:seg * segments], im[:seg * segments]).reshape(segments, seg, 3, n_k)
    w = welch_window(seg, window, device=re.device)
    if w is not None:
        sig = sig * w[None, :, None, None]
    spec = torch.fft.fft(sig, dim=1) / seg
    return spec.transpose(2, 3)


def welch_browse_reduce(re: torch.Tensor, im: torch.Tensor, freq_idx: torch.Tensor,
                        segments: int, window: str,
                        comp_pair: Optional[Tuple[int, int]] = None,
                        angle_range_opt: str = 'C'):
    """Segment-averaged browse planes from (n_t, 3, K) projections.

    Intensity is mean_S Σ_α |Φ_α|² on the kept rows (``freq_idx`` indexes
    the segment spectrum); the chiral phase, when ``comp_pair`` is given,
    is that of the segment-averaged cross-spectrum ⟨Z₁·Z₂*⟩_S, which is the
    single-window phase difference at segments=1.

    Returns (intensity (n_keep, K) float32, phase (n_keep, K) float32 or None).
    """
    spec = _segment_spectra(re, im, segments, window).index_select(1, freq_idx)
    inten = _power(spec).mean(dim=0)
    if comp_pair is None:
        return inten, None
    c1, c2 = comp_pair
    cross = (spec[..., c1] * spec[..., c2].conj()).mean(dim=0)
    return inten, chiral_phase(cross, torch.ones_like(cross), angle_range_opt=angle_range_opt)


def welch_intensity_reduce(re: torch.Tensor, im: torch.Tensor, segments: int,
                           window: str) -> torch.Tensor:
    """Segment-averaged intensity (n_t // segments, K) float32 of a
    (n_t, 3, K) projection pair."""
    return _power(_segment_spectra(re, im, segments, window)).mean(dim=0)


# ---------------------------------------------------------------------------
# Device-reduced grid browsing: only the planes a heat-map browser reads
# ---------------------------------------------------------------------------

#: Chiral axis -> the two polarization components perpendicular to it.
CHIRAL_AXIS_COMPONENTS = {'x': (1, 2), 'y': (0, 2), 'z': (0, 1)}


def browse_reduce(spec: torch.Tensor, freq_idx: torch.Tensor,
                  comp_pair: Optional[Tuple[int, int]] = None,
                  angle_range_opt: str = 'C'):
    """Browse planes of a complex spectrum, on its device.

    Args:
        spec: (n_t, K, 3) complex64 spectrum.
        freq_idx: (n_keep,) int64 indices of the kept frequency rows.
        comp_pair: polarization pair for the chiral phase, or None.

    Returns:
        (intensity (n_keep, K) float32, phase (n_keep, K) float32 or None).
    """
    kept = spec.index_select(0, freq_idx)
    inten = _power(kept)
    if comp_pair is None:
        return inten, None
    c1, c2 = comp_pair
    return inten, chiral_phase(kept[..., c1], kept[..., c2], angle_range_opt=angle_range_opt)


def compress_plane(plane: torch.Tensor):
    """(float16 sqrt-domain plane, float32 scale): the display readback form.

    Raw intensities overflow float16, so the plane is divided by its maximum
    and shipped as sqrt(plane/max) in float16.  The decompressed intensity's
    relative error is ≤ ~2·2⁻¹¹ for every pixel ≥ ~4e-9 of the plane max;
    below that the absolute error is ≤ 4e-9 of max.
    """
    m = plane.max()
    scale = torch.where(m > 0, m, torch.ones_like(m)).float()
    return torch.sqrt(torch.clamp(plane / scale, min=0.0)).half(), scale


def decompress_plane(plane16, scale) -> np.ndarray:
    """Host inverse of :func:`compress_plane` (NumPy float32 out)."""
    root = np.asarray(plane16, dtype=np.float32)
    return root * root * np.float32(scale)


def compress_browse(inten: torch.Tensor, phase: Optional[torch.Tensor] = None):
    """Browse planes packed for the float16 readback: the intensity as
    :func:`compress_plane`, the chiral phase (within ±π/2) as plain float16.
    Returns (i16, scale) or (i16, scale, p16)."""
    i16, scale = compress_plane(inten)
    if phase is None:
        return i16, scale
    return i16, scale, phase.half()


# ---------------------------------------------------------------------------
# Longitudinal / transverse split:  Φ_L = Σ_c k̂_c Φ_c,  I_L = |Φ_L|²,
# I_T = Σ_c |Φ_c|² − I_L
# ---------------------------------------------------------------------------

def lt_reduce(spec: torch.Tensor, k_unit: torch.Tensor, freq_idx: torch.Tensor):
    """Longitudinal and transverse intensity planes of a complex spectrum.

    Args:
        spec: (n_t, K, 3) complex64 spectrum.
        k_unit: (K, 3) float32 unit k-vectors.  An all-zero row (Γ, where
            the split is undefined) gives I_L = 0 and I_T = the total.
        freq_idx: (n_keep,) int64 kept frequency rows.

    Returns:
        (I_L (n_keep, K) float32, I_T (n_keep, K) float32).
    """
    kept = spec.index_select(0, freq_idx)
    ku = k_unit[None]
    re_l = (kept.real * ku).sum(dim=-1)
    im_l = (kept.imag * ku).sum(dim=-1)
    i_l = re_l * re_l + im_l * im_l
    # total − I_L ≥ 0 by Cauchy-Schwarz; clamp the float32 rounding
    return i_l, torch.clamp(_power(kept) - i_l, min=0.0)


def unit_k_vectors(k_vectors: np.ndarray) -> np.ndarray:
    """k/|k| with all-zero rows left at zero (host, NumPy float32)."""
    kv = np.asarray(k_vectors, dtype=np.float32)
    norms = np.linalg.norm(kv, axis=-1, keepdims=True)
    return np.where(norms > 0, kv / np.where(norms > 0, norms, 1.0), 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# Peak extraction on the device: the dispersion surface without the planes
# ---------------------------------------------------------------------------

def peak_reduce(inten: torch.Tensor, freqs_kept: torch.Tensor, n_peaks: int = 1,
                exclusion_bins: int = 4, phase: Optional[torch.Tensor] = None,
                width_method: str = 'rms'):
    """Top-``n_peaks`` spectral peaks of each k-column, on the planes' device.

    Greedy per column: take the argmax (the first of equal maxima), record
    (frequency, height, width), zero the rows within ±``exclusion_bins`` of
    it, repeat.  Widths:

    * ``'rms'``: the intensity-weighted RMS frequency spread inside the
      window, a linewidth proxy.
    * ``'lorentzian'``: the FWHM of a closed-form I²-weighted least-squares
      fit of 1/I = 1/h + (ν−ν₀)²/(hγ²) over the window, γ² = intercept /
      slope, FWHM = 2γ, clamped to the window span.  The window is divided
      by the peak height first: γ does not change under I → cI, and raw
      intensities near 1e10 would overflow the float32 I⁴-sized sums.
      ν − ν₀ is the rows' distance times the rows' spacing, not the
      difference of two float32 frequencies, which at 22 THz and a 5 GHz
      spacing loses up to 2e-4 of a row.

    Args:
        inten: (n_f, K) intensity planes of one k-chunk; columns are
            independent.
        freqs_kept: (n_f,) float32 frequencies of the rows (THz).
        phase: optional planes of ``inten``'s shape; the phase at each peak
            row is gathered too.

    Returns:
        (peak_freq, peak_height, peak_width[, peak_phase]), each
        (n_peaks, K) float32.
    """
    with span('psa.spectrum.peaks'):
        if width_method not in ('rms', 'lorentzian'):
            raise ValueError(f"width_method must be 'rms' or 'lorentzian', got {width_method!r}")
        n_f = inten.shape[0]
        fk = freqs_kept.float()[:, None]
        row = torch.arange(n_f, device=inten.device)[:, None]
        if width_method == 'lorentzian':
            df = (fk[-1, 0] - fk[0, 0]) / (n_f - 1) if n_f > 1 else torch.ones_like(fk[0, 0])
            fwhm_cap = 2.0 * exclusion_bins * df
        cur = inten.float()
        outs = []
        for _ in range(n_peaks):
            idx = torch.argmax(cur, dim=0)
            height = cur.gather(0, idx[None])[0]
            in_win = (row - idx[None]).abs() <= exclusion_bins
            w = torch.where(in_win, cur, 0.0)
            peak_f = fk[:, 0].index_select(0, idx)
            if width_method == 'rms':
                wsum = torch.clamp(w.sum(dim=0), min=1e-30)
                mu = (w * fk).sum(dim=0) / wsum
                var = (w * (fk - mu[None]) ** 2).sum(dim=0) / wsum
                width = torch.sqrt(torch.clamp(var, min=0.0))
            else:
                x = ((row - idx[None]).float() * df) ** 2
                wn = w / torch.clamp(height, min=1e-30)[None]
                y = 1.0 / torch.clamp(wn, min=1e-30)
                wt = torch.where(in_win, wn * wn, 0.0)
                sw, sx, sy = wt.sum(dim=0), (wt * x).sum(dim=0), (wt * y).sum(dim=0)
                sxx, sxy = (wt * x * x).sum(dim=0), (wt * x * y).sum(dim=0)
                det = sw * sxx - sx * sx
                slope = torch.where(det.abs() > 1e-30, (sw * sxy - sx * sy) / det, 0.0)
                intercept = torch.where(sw > 1e-30, (sy - slope * sx) / sw, 0.0)
                gamma_sq = torch.where(slope > 1e-30, torch.clamp(intercept, min=0.0) / slope,
                                       torch.inf)
                width = torch.minimum(2.0 * torch.sqrt(gamma_sq), fwhm_cap)
            found = [peak_f, height, width]
            if phase is not None:
                found.append(phase.gather(0, idx[None])[0].float())
            outs.append(found)
            cur = torch.where(in_win, 0.0, cur)
        return tuple(torch.stack(col) for col in zip(*outs))


def displacement_data(positions: torch.Tensor, mp_hi: torch.Tensor,
                      mp_lo: torch.Tensor) -> torch.Tensor:
    """u_a(t) = r_a(t) − r̄_a in float32 (reference sed_calculator.py:69-70).

    (r − hi) is exact by Sterbenz's lemma when displacements are small next to
    the coordinates, so subtracting the split mean gives float64-accurate
    displacements in float32.
    """
    r = positions.float()
    return (r - mp_hi.float()[None]) - mp_lo.float()[None]


def chiral_phase(z1: torch.Tensor, z2: torch.Tensor,
                 angle_range_opt: str = 'C') -> torch.Tensor:
    """Phase difference between two complex polarization spectra, float32.

    Option 'C': wrap ∠Z1−∠Z2 to [−π, π], fold quadrants 2/3 into [−π/2, π/2].
    Option 'A': arccos of the normalized real dot product, in [0, π].
    Option 'B': arcsin of the normalized cross product, in [−π/2, π/2].
    A/B give 0 where either magnitude² < 1e-18 (reference
    sed_calculator.py:338-371).
    """
    z1_re, z1_im, z2_re, z2_im = z1.real, z1.imag, z2.real, z2.imag
    if angle_range_opt == 'C':
        pi = torch.pi
        delta = torch.atan2(z1_im, z1_re) - torch.atan2(z2_im, z2_re)
        delta = torch.remainder(delta + pi, 2 * pi) - pi
        delta = torch.where(delta > pi / 2, pi - delta, delta)
        delta = torch.where(delta < -pi / 2, -pi - delta, delta)
        return delta.float()

    m1sq = z1_re ** 2 + z1_im ** 2
    m2sq = z2_re ** 2 + z2_im ** 2
    ok = (m1sq >= 1e-18) & (m2sq >= 1e-18)
    one = torch.ones_like(m1sq)
    denom = torch.sqrt(torch.where(ok, m1sq, one)) * torch.sqrt(torch.where(ok, m2sq, one))
    if angle_range_opt == 'A':
        angle = torch.arccos(torch.clamp((z1_re * z2_re + z1_im * z2_im) / denom, -1.0, 1.0))
    elif angle_range_opt == 'B':
        angle = torch.arcsin(torch.clamp((z1_re * z2_im - z1_im * z2_re) / denom, -1.0, 1.0))
    else:
        raise ValueError(f"Unknown angle_range_opt {angle_range_opt!r}; use 'A', 'B' or 'C'.")
    return torch.where(ok, angle, torch.zeros_like(angle)).float()


def synthesize_mode_motion(amp: torch.Tensor, proj_pos: torch.Tensor,
                           k_actual: float, frame_phases: torch.Tensor) -> torch.Tensor:
    """Real-space motion of one (k, ω) mode (reference sed_calculator.py:494-499).

    u[τ, a, α] = Re[A_α · exp(i·phase_τ − i·k·(r̄_a·k̂))]

    Args:
        amp: (3,) complex64 — Φ_α at the selected (ω*, k*).
        proj_pos: (n_atoms,) float32 — r̄_a · k̂.
        k_actual: matched |k|.
        frame_phases: (n_frames,) float32 — τ grid over [0, 2π).

    Returns:
        (n_frames, n_atoms, 3) float32.
    """
    phase = frame_phases[:, None] - k_actual * proj_pos[None, :]
    c, s = torch.cos(phase), torch.sin(phase)
    return (c[:, :, None] * amp.real[None, None, :]
            - s[:, :, None] * amp.imag[None, None, :]).float()


# ---------------------------------------------------------------------------
# The reduction of the projection surfaces: what a k-slice's (re, im)
# projections become, on one device and on a mesh
# ---------------------------------------------------------------------------

def _welch_segments(welch_segments, window: str, n_frames: int) -> int:
    """Validate (welch_segments, window) on ``n_frames`` frames; returns
    segments (1 = single-window estimator)."""
    if welch_segments is None:
        return 1
    if (not isinstance(welch_segments, (int, np.integer))
            or welch_segments < 1):
        raise ValueError("welch_segments must be a positive int, got "
                         f"{welch_segments!r}")
    seg = n_frames // int(welch_segments)
    if seg < 2:
        raise ValueError(
            f"welch_segments={welch_segments} leaves {seg} frames per "
            f"segment (n_frames={n_frames}); need at least 2")
    welch_window(seg, window)  # validates the name
    return int(welch_segments)


def _kept_rows(n_rows: int, dt_ps: float, max_freq: Optional[float]):
    """(freqs_kept float32, freq_idx int64) of the ω ≥ 0 (and ≤ max_freq)
    rows of an ``n_rows``-frame spectrum."""
    freqs = fftfreq_thz(n_rows, dt_ps)
    mask = freqs >= 0
    if max_freq is not None:
        mask &= freqs <= max_freq
    return freqs[mask].astype(np.float32), np.flatnonzero(mask)


@dataclass
class Reduction:
    """What a k-slice's per-group (re, im) projections become on the device,
    for every projection surface, on one device and on a mesh's stripes.

    ``kind`` is 'spectrum' (Φ of the one coherent group, the rows
    ``freq_idx`` alone where given), 'power' (Σ_α |Φ|²), 'welch'
    (:func:`welch_intensity_reduce`), 'browse' (the planes of
    :func:`browse_reduce`, or :func:`welch_browse_reduce` with ``segments``
    > 1; ``float16`` packs each group's as :func:`compress_browse` does),
    'lt' (:func:`lt_reduce`) or 'peaks' (:func:`peak_reduce` of the browse
    planes).  Groups sum incoherently, in their order, each group's
    reduction in a ``psa.spectrum`` span, the peaks in one more.  One object
    serves one call and keeps its inputs' device copies (:meth:`inputs`).
    :meth:`for_surface` and :meth:`for_flags` build one, checking their
    arguments.
    """

    kind: str
    freq_idx: Optional[np.ndarray] = None
    freqs_kept: Optional[np.ndarray] = None
    segments: int = 1
    window: str = 'rect'
    comp_pair: Optional[Tuple[int, int]] = None
    angle_range_opt: str = 'C'
    k_unit: Optional[np.ndarray] = None
    n_peaks: int = 1
    exclusion_bins: int = 4
    width_method: str = 'rms'
    float16: bool = False
    _on: Dict[torch.device, Dict[str, torch.Tensor]] = field(default_factory=dict, repr=False)

    @classmethod
    def for_surface(cls, kind: str, n_frames: int, dt_ps: float, summation_mode: str,
                    single: bool, *, engine='direct', cache_dir=None, max_freq=None,
                    chiral=False, chiral_axis='z', angle_range_opt='C', welch_segments=None,
                    welch_window='hann', readback_dtype='float32', n_peaks=1,
                    exclusion_bins=4, width_method='rms', k_vectors=None) -> 'Reduction':
        """The reduction of a calculator surface and its mesh twin, their
        arguments checked in the surface's order.  ``single``: the groups
        make one spectrum (coherent, or one group); else 'spectrum' is
        'power'.  ``k_vectors`` give 'lt' its unit vectors."""
        if summation_mode not in ('coherent', 'incoherent'):
            raise ValueError(f"summation_mode must be 'coherent' or 'incoherent', "
                             f"got {summation_mode}")
        if kind == 'spectrum' and not single:
            kind = 'power'
        if kind == 'peaks':
            if n_peaks < 1:
                raise ValueError(f"n_peaks must be >= 1, got {n_peaks}")
            if width_method not in ('rms', 'lorentzian'):
                raise ValueError(f"width_method must be 'rms' or 'lorentzian', "
                                 f"got {width_method!r}")
        if readback_dtype not in ('float32', 'float16'):
            raise ValueError("readback_dtype must be 'float32' or 'float16', "
                             f"got {readback_dtype!r}")
        gridded = engine == 'gridded'
        if readback_dtype == 'float16' and gridded:
            raise ValueError("readback_dtype='float16' runs on the direct engine.")
        segments = _welch_segments(welch_segments, welch_window, n_frames)
        if segments > 1 and gridded:
            raise ValueError("welch_segments runs on the direct engine "
                             "(the NUFFT reduction carries no segment axis).")
        if cache_dir is not None and gridded:
            raise ValueError("cache_dir checkpointing runs on the direct "
                             "engine (the NUFFT sweep has no k-chunk axis).")
        red = cls(kind, segments=segments, window=welch_window,
                  angle_range_opt=angle_range_opt, n_peaks=n_peaks,
                  exclusion_bins=exclusion_bins, width_method=width_method,
                  float16=readback_dtype == 'float16')
        if kind in ('browse', 'lt', 'peaks'):
            red.freqs_kept, red.freq_idx = _kept_rows(n_frames // segments, dt_ps, max_freq)
            if kind == 'peaks' and red.freq_idx.size == 0:
                raise ValueError("No frequencies retained; check max_freq.")
        if kind == 'lt':
            red.k_unit = unit_k_vectors(k_vectors)
        if chiral:
            if not single:
                raise ValueError("chiral peaks need coherent summation." if kind == 'peaks'
                                 else "Chiral phase needs a single complex spectrum; "
                                 "use coherent summation.")
            red.comp_pair = CHIRAL_AXIS_COMPONENTS[chiral_axis]
            if kind == 'peaks' and gridded:
                raise ValueError("chiral peaks run on the direct engine "
                                 "(the gridded peaks path carries no phase).")
        return red

    @classmethod
    def for_flags(cls, n_groups: int, k_vectors: np.ndarray, want_intensity=False,
                  freq_indices=None, n_peaks=None, peak_freqs_thz=None, exclusion_bins=4,
                  comp_pair=None, angle_range_opt='C', width_method='rms', lt=False,
                  welch_segments=1, welch_window='rect') -> 'Reduction':
        """The reduction the flags of
        :func:`psa_tpu_torch.parallel.sharded_sed_spectrum` name, over
        ``n_groups`` weight vectors; raises for flags that name none."""
        if n_peaks is not None and (freq_indices is None or peak_freqs_thz is None):
            raise ValueError("n_peaks requires freq_indices and peak_freqs_thz")
        if lt:
            if freq_indices is None:
                raise ValueError("lt=True requires freq_indices")
            if comp_pair is not None or n_peaks is not None:
                raise ValueError("lt=True is exclusive with comp_pair/n_peaks")
        incoherent = n_groups > 1
        if incoherent and not (want_intensity or n_peaks is not None or lt):
            raise ValueError("multiple atom_weights mean incoherent summation: "
                             "set want_intensity=True, n_peaks, or lt")
        if incoherent and comp_pair is not None:
            raise ValueError("chiral phase needs a single (coherent) spectrum")
        if comp_pair is not None and n_peaks is None and not (
                want_intensity and freq_indices is not None):
            raise ValueError("comp_pair requires freq_indices + want_intensity "
                             "(browse planes) or n_peaks (phase at peak)")
        segments = int(welch_segments)
        if segments > 1:
            if lt:
                raise ValueError("welch_segments does not support lt=True")
            if freq_indices is None or not (want_intensity or n_peaks):
                raise ValueError("welch_segments requires freq_indices plus "
                                 "want_intensity or n_peaks")
        if lt:
            kind = 'lt'
        elif n_peaks is not None:
            kind = 'peaks'
        elif want_intensity:
            kind = 'power' if freq_indices is None else 'browse'
        else:
            kind = 'spectrum'
        return cls(kind, freq_idx=freq_indices, freqs_kept=peak_freqs_thz, segments=segments,
                   window=welch_window, comp_pair=comp_pair, angle_range_opt=angle_range_opt,
                   k_unit=unit_k_vectors(k_vectors) if lt else None, n_peaks=n_peaks,
                   exclusion_bins=exclusion_bins, width_method=width_method)

    def leads(self, n_t: int) -> List[Tuple[int, ...]]:
        """Each host output's shape but its last (k) axis, for n_t frames
        ('spectrum': the real and imaginary parts of the ``stripe`` form)."""
        n_f = n_t // self.segments if self.freq_idx is None else len(self.freq_idx)
        phase = self.comp_pair is not None
        if self.kind == 'spectrum':
            return [(n_f, 3)] * 2
        if self.kind == 'peaks':
            return [(self.n_peaks,)] * (3 + phase)
        return [(n_f,)] * {'lt': 2, 'browse': 1 + phase}.get(self.kind, 1)

    def inputs(self, device: torch.device, upload) -> Dict[str, torch.Tensor]:
        """The host arrays this kind reads (kept rows, unit k-vectors, the
        peaks' frequencies) on ``device``, each sent once by
        ``upload(array, dtype)``."""
        if device not in self._on:
            host = {'idx': (self.freq_idx, np.int64), 'ku': (self.k_unit, np.float32),
                    'freqs': (self.freqs_kept if self.kind == 'peaks' else None, np.float32)}
            self._on[device] = {name: upload(arr, dtype) for name, (arr, dtype) in host.items()
                                if arr is not None}
        return self._on[device]

    def reduce(self, s: int, e: int, pairs, on: Dict[str, torch.Tensor],
               stripe: bool = False) -> List[torch.Tensor]:
        """The device outputs of k-slice [s, e): ``pairs`` yields each
        group's (re, im) (n_t, 3, e − s) projections, drawn one at a time;
        ``on`` is :meth:`inputs` on their device.  For one device's readback
        (:meth:`host` takes it) Φ comes contiguous and the peaks stacked; a
        mesh ``stripe`` gets the outputs of :meth:`leads`, float32, k last."""
        out = None
        for re, im in pairs:
            with span('psa.spectrum'):
                part = self._group(re, im, s, e, on, stripe)
                if out is None:
                    out = part
                elif self.float16:
                    out = out + part
                else:
                    out = [a + b for a, b in zip(out, part)]
        if self.kind != 'peaks':
            return out
        with span('psa.spectrum'):
            found = peak_reduce(out[0], on['freqs'], n_peaks=self.n_peaks,
                                exclusion_bins=self.exclusion_bins,
                                phase=out[1] if len(out) > 1 else None,
                                width_method=self.width_method)
            return list(found) if stripe else [torch.stack(found)]

    def host(self, arrays: List[np.ndarray]) -> List[np.ndarray]:
        """One device's readback of :meth:`reduce` as the outputs of
        :meth:`leads`: the peaks unstacked, float16 planes unpacked and summed."""
        if self.kind == 'peaks':
            return list(arrays[0])
        if not self.float16:
            return list(arrays)
        per = 3 if self.comp_pair is not None else 2
        inten = np.zeros(arrays[0].shape, dtype=np.float32)
        for g0 in range(0, len(arrays), per):
            inten += decompress_plane(arrays[g0], arrays[g0 + 1])
        return [inten] + ([arrays[2].astype(np.float32)] if per == 3 else [])

    def _group(self, re, im, s, e, on, stripe: bool) -> List[torch.Tensor]:
        """One group's outputs (its browse planes for 'peaks')."""
        if self.kind == 'welch':
            return [welch_intensity_reduce(re, im, self.segments, self.window)]
        if self.kind in ('browse', 'peaks'):
            if self.segments > 1:
                planes = welch_browse_reduce(re, im, on['idx'], self.segments, self.window,
                                             comp_pair=self.comp_pair,
                                             angle_range_opt=self.angle_range_opt)
            else:
                planes = browse_reduce(finalize_spectrum(re, im), on['idx'],
                                       comp_pair=self.comp_pair,
                                       angle_range_opt=self.angle_range_opt)
            planes = [p for p in planes if p is not None]
            return list(compress_browse(*planes)) if self.float16 else planes
        spec = finalize_spectrum(re, im)
        if self.kind == 'power':
            return [_power(spec)]
        if self.kind == 'lt':
            return list(lt_reduce(spec, on['ku'][s:e], on['idx']))
        if 'idx' in on:
            spec = spec.index_select(0, on['idx'])
        if stripe:
            spec = spec.transpose(1, 2)
            return [spec.real, spec.imag]
        return [spec.contiguous()]
