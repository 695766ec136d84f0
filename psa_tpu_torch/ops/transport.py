"""Phonon transport estimates: lifetimes and kinetic-theory conductivity.

The SED method's headline physics application (Thomas et al., PRB 81,
081411 (2010)): fit each mode's spectral peak to a Lorentzian, read the
linewidth as the inverse phonon lifetime, and accumulate the single-mode
relaxation-time thermal conductivity

    κ_αβ = (1/V) Σ_{k, branches} c_ph · v_α(k) · v_β(k) · τ(k)

with the classical per-mode heat capacity c_ph = k_B (the consistent
choice for classical MD input).  The reference framework computes none of
this — its SED output stops at the I(ω, k) arrays
(reference sed_calculator.py:182-336) — but every
ingredient ships in this package already: calibrated Lorentzian FWHMs
(``ops/spectral.peak_reduce(width_method='lorentzian')``) and
group-velocity fields (``ops/dispersion``).  This module is the thin,
unit-careful layer that turns them into τ and κ.

Conventions (pinned by the injected-decay oracle in
tests/test_calculator.py::test_lorentzian_fwhm_recovers_injected_linewidth):
a mode with amplitude decay e^{-γt} (γ in 1/ps) has an intensity FWHM of
Δν = γ/π THz; its energy decays as e^{-2γt}, so

    τ = 1/(2γ) = 1/(2π·Δν)   [ps, with Δν in THz].

Like ops/dispersion, this is host-side NumPy by design: inputs are the
device-reduced peak surfaces (n_bands × n_k floats), and the accumulation
is a weighted sum.  The code is that of :mod:`psa_tpu.ops.transport`,
carried over so the port needs no JAX.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

#: Boltzmann constant, J/K.
KB_J_PER_K = 1.380649e-23

#: (Å/ps)² · ps / Å³  →  (m/s)² · s / m³ unit factor for κ sums:
#: (1e2 m/s)² · 1e-12 s / 1e-30 m³ = 1e22.
_KAPPA_UNIT = 1.0e22


def phonon_lifetimes(peak_widths_fwhm_thz: np.ndarray,
                     resolution_fwhm_thz: Optional[float] = None
                     ) -> np.ndarray:
    """Mode lifetimes τ = 1/(2π·FWHM) in ps from Lorentzian FWHMs in THz.

    Args:
        peak_widths_fwhm_thz: any-shape array of intensity FWHMs (THz), as
            produced by ``width_method='lorentzian'``.  The RMS proxy width
            is NOT calibrated — feeding it here gives only a trend.
        resolution_fwhm_thz: optional measurability floor (typically the
            spectral bin width 1/(n_t·dt_ps), or a small multiple).  Widths
            at or below it are unresolved — their τ is returned as NaN
            rather than as a huge number masquerading as a measurement.

    Returns:
        float32 array of τ in ps, same shape; NaN where unresolved.
    """
    w = np.asarray(peak_widths_fwhm_thz, dtype=np.float64)
    with np.errstate(divide='ignore', invalid='ignore'):
        tau = 1.0 / (2.0 * np.pi * w)
    bad = ~np.isfinite(tau) | (w <= 0)
    if resolution_fwhm_thz is not None:
        bad |= w <= resolution_fwhm_thz
    tau = np.where(bad, np.nan, tau)
    return tau.astype(np.float32)


@dataclass
class KappaResult:
    """In-plane kinetic-theory conductivity from one k-grid sweep.

    ``kappa_xx/yy/xy`` are the plane-axis tensor components in W/(m·K);
    axes follow the sampled plane (the grid's slow and fast axes), not the
    lab frame.  ``n_modes_used`` counts (band, k) entries that contributed
    (finite τ and velocity); unresolved modes are skipped, so a sweep whose
    linewidths are mostly below resolution yields an honest undercount
    rather than an inflated κ.
    """
    kappa_xx: float
    kappa_yy: float
    kappa_xy: float
    lifetimes_ps: np.ndarray           # (n_bands, gx, gy), NaN = unresolved
    n_modes_used: int
    n_modes_total: int


def kinetic_kappa(vx: np.ndarray, vy: np.ndarray, tau_ps: np.ndarray,
                  volume_a3: float,
                  mode_weights: Optional[np.ndarray] = None,
                  heat_capacity_j_per_k: float = KB_J_PER_K) -> KappaResult:
    """Accumulate κ_αβ = (1/V) Σ c_ph·v_α·v_β·τ over sampled modes.

    Args:
        vx, vy: (…,) group-velocity components in Å/ps (from
            :func:`psa_tpu_torch.ops.dispersion.group_velocity_grid`).
        tau_ps: same-shape lifetimes in ps (NaN entries are skipped).
        volume_a3: the volume V the mode sum is normalized by, in Å³.  For
            a supercell MD run whose k-grid enumerates each allowed mode
            exactly once, this is the SUPERCELL volume
            (``det(box_matrix)``).
        mode_weights: optional same-shape multiplicity weights (e.g. 2.0
            for points representing a ±k pair when only half the zone was
            sampled).  Default 1 per entry.
        heat_capacity_j_per_k: per-mode heat capacity; default classical
            k_B, consistent with classical-MD spectra.

    Returns:
        :class:`KappaResult`; κ components in W/(m·K).
    """
    vx = np.asarray(vx, dtype=np.float64)
    vy = np.asarray(vy, dtype=np.float64)
    tau = np.asarray(tau_ps, dtype=np.float64)
    if vx.shape != vy.shape or vx.shape != tau.shape:
        raise ValueError(f"shape mismatch: vx {vx.shape}, vy {vy.shape}, "
                         f"tau {tau.shape}")
    if volume_a3 <= 0:
        raise ValueError(f"volume_a3 must be positive, got {volume_a3}")
    w = np.ones_like(tau) if mode_weights is None \
        else np.asarray(mode_weights, dtype=np.float64)
    if w.shape != tau.shape:
        raise ValueError(f"mode_weights shape {w.shape} != {tau.shape}")

    ok = np.isfinite(tau) & np.isfinite(vx) & np.isfinite(vy)
    scale = heat_capacity_j_per_k * _KAPPA_UNIT / float(volume_a3)
    wt = np.where(ok, w * tau, 0.0)
    kxx = float(scale * np.sum(wt * np.where(ok, vx * vx, 0.0)))
    kyy = float(scale * np.sum(wt * np.where(ok, vy * vy, 0.0)))
    kxy = float(scale * np.sum(wt * np.where(ok, vx * vy, 0.0)))
    return KappaResult(kappa_xx=kxx, kappa_yy=kyy, kappa_xy=kxy,
                       lifetimes_ps=tau.astype(np.float32),
                       n_modes_used=int(np.count_nonzero(ok)),
                       n_modes_total=int(tau.size))
