"""Plain reference of the spectral energy density as Thomas et al. publish it
(Phys. Rev. B 81, 081411(R), 2010): summed over the basis atoms outside the
modulus, each term weighted by the atom's mass, and of its peaks with
Lorentzian widths.

    Φ_b,c(ω, k) = FFT_t[ Σ_{a ∈ b} √m_a · data[t, a, c] · exp(i k·r̄_a) ](ω) / n_t
    I(ω, k)     = Σ_b Σ_c |Φ_b,c(ω, k)|²

over the basis groups b (one per basis site), and the top peaks of each
k-column of I on the rows ω ≥ 0: the greedy argmax with an exclusion
window, and as width the FWHM 2γ of the Lorentzian 1/I = (1 + (ν − ν₀)²/γ²)/h
fitted in closed form over the window by least squares in 1/I weighted by
I², the window's values divided by the peak's height first; clamped to the
window's span.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.sed import ieee_matmul, kept_rows, on, round_tf32, where

#: Below this a fit's sums count as zero, as the closed form's guards do.
TINY = 1e-30


def projection(data, sites64: np.ndarray, masses: np.ndarray, group: np.ndarray,
               k_vectors: np.ndarray, tf32: bool = False, block_atoms: int = 4096,
               device=None):
    """(re, im), each (n_t, 3, K): Σ_{a ∈ group} √m_a·data[t, a, c]·cos/sin(k·r̄_a).

    ``data`` is the (n_t, A, 3) float32 array of the whole trajectory,
    where the program was given it; the group's atoms are gathered block by
    block onto ``device`` (by default where ``data`` lies).  Float64
    throughout, or with ``tf32`` the weighted data and the angle's cosine
    and sine rounded to TF32 and summed in float32."""
    dev = where(data, device)
    n_t = data.shape[0]
    group = np.asarray(group, np.int64)
    kv = torch.as_tensor(np.asarray(k_vectors, np.float32), device=dev).double()
    dtype = torch.float32 if tf32 else torch.float64
    re = torch.zeros((n_t * 3, kv.shape[0]), dtype=dtype, device=dev)
    im = torch.zeros_like(re)
    with ieee_matmul():
        for a0 in range(0, len(group), block_atoms):
            idx = group[a0:a0 + block_atoms]
            pos = torch.as_tensor(np.asarray(sites64, np.float64)[idx], device=dev)
            w = torch.as_tensor(np.sqrt(np.asarray(masses, np.float64)[idx]), device=dev)
            ang = pos @ kv.T                                           # (B, K) float64
            cos, sin = torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)
            sel = torch.as_tensor(idx, device=data.device) if torch.is_tensor(data) else idx
            blk = (on(dev, data[:, sel, :]).double() * w[None, :, None]).to(dtype)
            blk = blk.permute(0, 2, 1).reshape(n_t * 3, len(idx))
            if tf32:
                cos, sin, blk = round_tf32(cos), round_tf32(sin), round_tf32(blk)
            re.addmm_(blk, cos)
            im.addmm_(blk, sin)
    return re.view(n_t, 3, -1), im.view(n_t, 3, -1)


def power(data, sites64: np.ndarray, masses: np.ndarray, groups, k_vectors: np.ndarray,
          tf32: bool = False, device=None) -> torch.Tensor:
    """(n_t, K) float64 Σ_b Σ_c |Φ_b,c|² on every row, in FFT order."""
    total = None
    for group in groups:
        re, im = projection(data, sites64, masses, group, k_vectors, tf32, device=device)
        spec = torch.fft.fft(torch.complex(re.double(), im.double()), dim=0) / re.shape[0]
        part = (spec.real ** 2 + spec.imag ** 2).sum(dim=1)
        total = part if total is None else total + part
    return total


def lorentzian_peaks(inten: torch.Tensor, freqs: np.ndarray, df: float, n_peaks: int,
                     exclusion_bins: int):
    """(freq, height, width), each (n_peaks, K) float64, of each column of ``inten``.

    Greedy: take the row of the column's largest value (the first of equal
    ones), record its frequency and value; in the rows within
    ±``exclusion_bins`` of it, with the values divided by that height, fit
    y = 1/I = c₀ + c₁·(ν − ν₀)² by least squares with weights I², so that
    γ² = c₀/c₁ (c₀ taken as at least 0; no positive c₁: no peak shape, the
    cap); record 2γ, at most the window's span 2·``exclusion_bins``·``df``;
    zero the window; repeat.
    """
    cur = inten.double().clone()
    fk = torch.as_tensor(np.asarray(freqs, np.float64), device=cur.device)[:, None]
    row = torch.arange(cur.shape[0], device=cur.device)[:, None]
    cap = 2.0 * exclusion_bins * df
    out = []
    for _ in range(n_peaks):
        idx = torch.argmax(cur, dim=0)
        height = cur.gather(0, idx[None])[0]
        win = (row - idx[None]).abs() <= exclusion_bins
        val = torch.where(win, cur, torch.zeros_like(cur)) / torch.clamp(height, min=TINY)[None]
        x = (fk - fk[:, 0][idx][None]) ** 2
        y = 1.0 / torch.clamp(val, min=TINY)
        wt = torch.where(win, val * val, torch.zeros_like(val))
        s0, s1, s2 = wt.sum(0), (wt * x).sum(0), (wt * x * x).sum(0)
        t0, t1 = (wt * y).sum(0), (wt * x * y).sum(0)
        det = s0 * s2 - s1 * s1
        c1 = torch.where(det.abs() > TINY, (s0 * t1 - s1 * t0) / det, torch.zeros_like(det))
        c0 = torch.where(s0 > TINY, (t0 - c1 * s1) / s0, torch.zeros_like(s0))
        gamma_sq = torch.where(c1 > TINY, torch.clamp(c0, min=0.0) / c1,
                               torch.full_like(c1, float('inf')))
        width = torch.clamp(2.0 * torch.sqrt(gamma_sq), max=cap)
        out.append((fk[:, 0][idx], height, width))
        cur = torch.where(win, torch.zeros_like(cur), cur)
    return tuple(torch.stack(col) for col in zip(*out))


def kgrid_peaks(data, sites64: np.ndarray, masses: np.ndarray, groups, k_vectors: np.ndarray,
                dt_ps: float, n_peaks: int, exclusion_bins: int, tf32: bool = False,
                block_k: int = 1024, device=None):
    """Peaks of the mass-weighted basis-summed SED of every k in
    ``k_vectors``, computed on ``device`` (:func:`projection`): host float64
    arrays (freq, height, width), each (n_peaks, K)."""
    n_t = data.shape[0]
    rows = kept_rows(n_t)
    freqs = np.fft.fftfreq(n_t, d=dt_ps)[rows]
    cols = []
    for s in range(0, len(k_vectors), block_k):
        inten = power(data, sites64, masses, groups, k_vectors[s:s + block_k], tf32,
                      device=device)
        inten = inten.index_select(0, torch.as_tensor(rows, device=inten.device))
        found = lorentzian_peaks(inten, freqs, 1.0 / (n_t * dt_ps), n_peaks, exclusion_bins)
        cols.append([x.cpu().numpy() for x in found])
        del inten
    return tuple(np.concatenate(parts, axis=1) for parts in zip(*cols))
