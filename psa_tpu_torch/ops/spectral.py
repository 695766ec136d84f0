"""SED compute core on PyTorch (counterpart of :mod:`psa_tpu.ops.spectral`).

The math (reference formula, src/psa/core/sed_calculator.py:58-84):

    r̄_a      = mean_t r_a(t)
    P[a,k]   = exp(i k_vec[k] · r̄_a)
    S_α(t,k) = Σ_a data[t,a,α] · P[a,k]
    Φ_α(ω,k) = FFT_t[S_α](ω) / n_t

Steps 1-3 (angles, cos/sin, the atom contraction) run in
:func:`psa_tpu_torch.ops.sed_projection.sed_projection`; step 4 is
``torch.fft.fft`` over time.  Complex results are complex64 tensors.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .sed_projection import sed_projection

PRECISIONS = ('parity', 'balanced', 'fast')


def check_precision(precision: str) -> None:
    """Accept 'parity'; the reduced-precision tiers are not ported yet."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {sorted(PRECISIONS)}, got {precision!r}")
    if precision != 'parity':
        raise NotImplementedError(
            f"precision={precision!r} is not ported (ROADMAP B: TF32 / 3xTF32 "
            "tensor-core tiers); use 'parity'")


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
        precision: 'parity' (IEEE float32 contraction).

    Returns:
        (n_t, n_k, 3) complex64.
    """
    check_precision(precision)
    n_t = data.shape[0]
    re, im = sed_projection(data, mp_hi, mp_lo, k_vectors)      # (n_t, 3, K)
    spec = torch.fft.fft(torch.complex(re, im), dim=0) / n_t
    return spec.transpose(1, 2)


def sed_intensity(data: torch.Tensor, mp_hi: torch.Tensor, mp_lo: torch.Tensor,
                  k_vectors: torch.Tensor, precision: str = 'parity') -> torch.Tensor:
    """Σ_α |Φ_α(ω,k)|² of one atom group, (n_t, n_k) float32."""
    spec = sed_spectrum(data, mp_hi, mp_lo, k_vectors, precision=precision)
    return (spec.real * spec.real + spec.imag * spec.imag).sum(dim=-1)


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
