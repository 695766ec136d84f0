"""Relaxation-curve fits for the intermediate scattering functions.

Post-processing companions of :meth:`SEDCalculator.calculate_isf` /
:meth:`calculate_isf_self` (the reference package computes no liquid
observables): α-relaxation times τ_α, and per-k
Kohlrausch–Williams–Watts fits

    F(k,τ) ≈ A_k · exp(−(τ/τ_k)^β_k)

whose amplitude A_k is the plateau height (non-ergodicity factor) when
the fit window starts past the microscopic β-relaxation step.

These run on the host in float64 (NumPy, carried over from
:mod:`psa_tpu.utils.fits`): the inputs are tiny (n_lags × n_k curves
already reduced on the device) and a damped Gauss–Newton needs double
precision.
"""
from typing import Optional, Tuple

import numpy as np

__all__ = ['isf_relaxation_time', 'kww_fit']


def isf_relaxation_time(lags_ps: np.ndarray, f: np.ndarray,
                        threshold: float = 1.0 / np.e,
                        normalize: bool = True) -> np.ndarray:
    """α-relaxation time τ_α per k: first crossing of F below threshold.

    Args:
        lags_ps: (n_lags,) τ values (ps), ascending, lags_ps[0] == 0.
        f: (n_lags, n_k) ISF curves (raw or normalized).
        threshold: crossing level on the NORMALIZED curve (default 1/e).
        normalize: divide each column by its τ=0 value first (set False
            when ``f`` is already F/S(k)).

    Returns:
        (n_k,) float64 τ_α, log-linear interpolated between the bracketing
        lags; NaN where the curve never decays below the threshold inside
        the window.
    """
    lags = np.asarray(lags_ps, dtype=np.float64)
    y = np.asarray(f, dtype=np.float64)
    if y.ndim == 1:
        y = y[:, None]
    if normalize:
        y = y / np.where(np.abs(y[0]) > 0, y[0], 1.0)
    n_k = y.shape[1]
    tau = np.full(n_k, np.nan)
    for k in range(n_k):
        below = np.nonzero(y[:, k] < threshold)[0]
        if below.size == 0 or below[0] == 0:
            continue
        i = below[0]
        y0, y1 = y[i - 1, k], y[i, k]
        # interpolate log F (exponential-ish locally); guard y ≤ 0
        if y0 > 0 and y1 > 0:
            w = (np.log(y0) - np.log(threshold)) / (np.log(y0) - np.log(y1))
        else:
            w = (y0 - threshold) / (y0 - y1)
        tau[k] = lags[i - 1] + w * (lags[i] - lags[i - 1])
    return tau


def kww_fit(lags_ps: np.ndarray, f: np.ndarray,
            fit_window: Optional[Tuple[float, float]] = None,
            normalize: bool = True, max_iter: int = 60
            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-k KWW (stretched-exponential) fit A·exp(−(τ/τ₀)^β).

    Damped Gauss–Newton (Levenberg) on θ = (A, log τ₀, β) per k column,
    float64, bounded to A ∈ (0, 1.5·max(1, |F(k,0)|)], τ₀ > 0,
    β ∈ [0.1, 2.5].  Simple
    exponentials recover β = 1; two-step (glassy) curves fitted with a
    ``fit_window`` past the microscopic step give A_k = the plateau
    height (non-ergodicity factor).

    Args:
        lags_ps: (n_lags,) τ (ps), ascending, lags_ps[0] == 0.
        f: (n_lags, n_k) ISF curves.
        fit_window: optional (τ_min, τ_max) in ps restricting the fitted
            rows (default: all τ > 0).
        normalize: divide each column by its τ=0 value first (fit then
            describes F/F(0); set False for raw curves — the amplitude
            bounds then scale with each column's F(k,0), so S(k) > 1.5
            fits honestly instead of pinning A at the normalized cap).
        max_iter: Gauss–Newton iteration cap.

    Returns:
        (amp, tau_ps, beta, rms_resid) — each (n_k,) float64; NaN columns
        where fewer than 3 usable points exist, or (normalize=True) where
        |F(k,0)| is within noise of zero — normalizing those would just
        amplify noise into junk parameters indistinguishable from fits.
    """
    lags = np.asarray(lags_ps, dtype=np.float64)
    y_all = np.asarray(f, dtype=np.float64)
    if y_all.ndim == 1:
        y_all = y_all[:, None]
    dead = ~np.isfinite(y_all[0])
    if normalize:
        y0_abs = np.abs(np.where(np.isfinite(y_all[0]), y_all[0], 0.0))
        floor = 1e-6 * max(float(y0_abs.max(initial=0.0)), 1e-300)
        dead |= y0_abs < floor
        y_all = y_all / np.where(y0_abs > 0, y_all[0], 1.0)
    sel = lags > 0
    if fit_window is not None:
        sel &= (lags >= fit_window[0]) & (lags <= fit_window[1])
    t = lags[sel]
    n_k = y_all.shape[1]
    amp = np.full(n_k, np.nan)
    tau = np.full(n_k, np.nan)
    beta = np.full(n_k, np.nan)
    resid = np.full(n_k, np.nan)
    if t.size < 3:
        return amp, tau, beta, resid

    tau_init = isf_relaxation_time(lags, y_all, normalize=False)
    logt = np.log(t)
    for k in range(n_k):
        y = y_all[sel, k]
        if dead[k] or not np.all(np.isfinite(y)):
            continue
        # amplitude bounds scale with the raw column's initial value so
        # un-normalized F(k,0)=S(k) > 1.5 is fittable (normalized: scale=1)
        a_cap = 1.5 * max(1.0, abs(y_all[0, k]))
        a = float(np.clip(y_all[0, k] if not np.isnan(y_all[0, k]) else 1.0,
                          1e-3, a_cap))
        t0 = tau_init[k]
        if not np.isfinite(t0) or t0 <= 0:
            t0 = float(t[-1])            # barely-decayed curve: start slow
        th = np.array([a, np.log(t0), 1.0])
        lam = 1e-3
        prev_cost = np.inf
        for _ in range(max_iter):
            u = np.exp(th[2] * (logt - th[1]))       # (τ/τ₀)^β
            e = np.exp(-np.clip(u, 0.0, 50.0))
            m = th[0] * e
            r = m - y
            cost = float(r @ r)
            # Jacobian: ∂m/∂A, ∂m/∂logτ₀, ∂m/∂β
            j = np.stack([e,
                          th[0] * e * th[2] * u,
                          -th[0] * e * u * (logt - th[1])], axis=1)
            jtj = j.T @ j
            jtr = j.T @ r
            step_ok = False
            for _damp in range(8):
                try:
                    delta = np.linalg.solve(
                        jtj + lam * np.diag(np.maximum(np.diag(jtj), 1e-12)),
                        -jtr)
                except np.linalg.LinAlgError:
                    lam *= 10.0
                    continue
                cand = th + delta
                cand[0] = np.clip(cand[0], 1e-4, a_cap)
                cand[1] = np.clip(cand[1], np.log(t[0]) - 8.0,
                                  np.log(t[-1]) + 8.0)
                cand[2] = np.clip(cand[2], 0.1, 2.5)
                u_c = np.exp(cand[2] * (logt - cand[1]))
                r_c = cand[0] * np.exp(-np.clip(u_c, 0.0, 50.0)) - y
                if float(r_c @ r_c) < cost:
                    th, lam, step_ok = cand, max(lam * 0.3, 1e-12), True
                    break
                lam *= 10.0
            if not step_ok or abs(prev_cost - cost) <= 1e-14 * max(cost, 1.0):
                break
            prev_cost = cost
        amp[k] = th[0]
        tau[k] = float(np.exp(th[1]))
        beta[k] = th[2]
        u = np.exp(th[2] * (logt - th[1]))
        resid[k] = float(np.sqrt(np.mean(
            (th[0] * np.exp(-np.clip(u, 0.0, 50.0)) - y) ** 2)))
    return amp, tau, beta, resid
