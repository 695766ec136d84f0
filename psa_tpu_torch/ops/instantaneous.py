"""Instantaneous-phase spectral ops on PyTorch (counterpart of
:mod:`psa_tpu.ops.instantaneous`): the dynamic structure factor, the
current spectra, S(k), the intermediate scattering function and their self
parts.

The SED projects onto static phases exp(i k·r̄_a); this module projects
onto the instantaneous phase exp(i k·r_a(t)):

    ρ_k(t) = Σ_a exp(i k·r_a(t))              (density mode)
    j_k(t) = Σ_a v_a(t) exp(i k·r_a(t))       (current mode, 3 components)

and reduces the mode stacks on the device (FFT normalized by 1/n_t, like
the SED; the caller divides by the group size N):

    S(k,ω)   = |FFT_t ρ_k|² / (n_t² N)
    C_L(k,ω) = |k̂·FFT_t j_k|² / (n_t² N)
    C_T(k,ω) = (Σ_α|FFT_t j_α|² − |k̂·ĵ|²) / (n_t² N)
    S_s(k,ω) = Σ_a |FFT_t e^{i k·r_a}|² / (n_t² N)

Σ_ω S(k,ω) = S(k) and Σ_ω S_s(k,ω) = 1 (Parseval).

The phases come from the exact engine: k·r_a(t) formed and folded by 2π in
float64 (the float32 positions times the float32 k), cast to float32, then
cos and sin; the JAX package's double-single path with a zero low word.
The atom contraction of the mode stacks is ``torch.bmm`` in IEEE float32
(the JAX package leaves it to ``lax.dot_general``, outside any kernel).
The time axis is tiled by a Python loop so the (t, A, K) transients stay
within the caller's budget.  Nothing is padded: a ragged tile or atom block
is a slice, so no mask is needed.

``exp(i k·r)`` is invariant under periodic wrapping only for
box-commensurate k; :func:`nearest_commensurate` snaps k onto the box's
reciprocal lattice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .spectral import welch_window

#: Device bytes per (t, atom, k) element that the mode stacks' tiles are sized
#: by: :func:`instant_phasors` holds the float64 angle and its turns (16),
#: then the float32 angle beside them (4), then cos and sin (8).
PHASOR_BYTES = 24


# ---------------------------------------------------------------------------
# Box-commensurate k (host, NumPy)
# ---------------------------------------------------------------------------

def _box_fractional(kv: np.ndarray, box: np.ndarray):
    """k in box-reciprocal fractional coordinates, or None for the
    degenerate-axis orthorhombic form (handled per component)."""
    box = np.asarray(box, dtype=np.float64)
    if box.ndim == 2:
        if np.allclose(box, np.diag(np.diagonal(box))):
            box = np.diagonal(box).copy()
        else:
            return kv @ box.T / (2.0 * np.pi), box
    if np.all(box > 0):
        return kv * box / (2.0 * np.pi), np.diag(box)
    return None, box


def nearest_commensurate(k_vectors: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Snap k-vectors onto the box reciprocal lattice (wrap-invariant k).

    ``box`` is the (3,) edge lengths (orthorhombic) or the (3, 3) cell
    matrix H with rows a_i.  Wrapping moves r by integer combinations of the
    rows, so exp(i k·r) is wrap-invariant iff a_i·k = 2π·m_i: snapping
    rounds m = H·k/2π.  Zero edges (degenerate axes, orthorhombic form)
    leave that component untouched.  Returns float32.
    """
    kv = np.asarray(k_vectors, dtype=np.float64)
    frac, H = _box_fractional(kv, box)
    if frac is not None:
        try:
            h_inv = np.linalg.inv(H)
        except np.linalg.LinAlgError:
            raise ValueError("singular box matrix — k cannot be snapped "
                             "onto its reciprocal lattice")
        return (2.0 * np.pi * np.round(frac) @ h_inv.T).astype(np.float32)
    L = np.asarray(H, dtype=np.float64)
    step = np.where(L > 0, 2.0 * np.pi / np.where(L > 0, L, 1.0), 0.0)
    snapped = np.where(step > 0, np.round(kv / np.where(step > 0, step, 1.0)) * step, kv)
    return snapped.astype(np.float32)


def commensurate_deviation(k_vectors: np.ndarray, box: np.ndarray) -> float:
    """Max |frac − round(frac)| of k in box-reciprocal fractional
    coordinates; 0 means exactly wrap-invariant (degenerate axes give 0)."""
    kv = np.asarray(k_vectors, dtype=np.float64)
    if kv.size == 0:
        return 0.0
    frac, H = _box_fractional(kv, box)
    if frac is None:
        L = np.asarray(H, dtype=np.float64)
        frac = np.where(L > 0, kv * np.where(L > 0, L, 1.0), 0.0) / (2 * np.pi)
    return float(np.max(np.abs(frac - np.round(frac))))


def commensurate_kpath(k_vectors: np.ndarray, box: np.ndarray) -> np.ndarray:
    """Snap a k-path onto the box reciprocal lattice and drop the repeats
    (the first of each run kept, in path order).  Raises if fewer than 2
    distinct points survive."""
    k_vecs = nearest_commensurate(k_vectors, box)
    _, first = np.unique(np.round(k_vecs, 7), axis=0, return_index=True)
    k_vecs = k_vecs[np.sort(first)]
    if len(k_vecs) < 2:
        raise ValueError(
            "k-path snaps to fewer than 2 distinct box-commensurate "
            "k-points — widen bz_coverage or raise n_k (the box is too "
            "small along this direction for a DSF map)")
    return k_vecs


def k_count(k_vectors) -> int:
    """Output k-columns of a phase-producer k argument, (K, 3)."""
    return k_vectors.shape[0]


# ---------------------------------------------------------------------------
# The exact phase producer and the mode stacks
# ---------------------------------------------------------------------------

def instant_phasors(pos: torch.Tensor, k_vectors: torch.Tensor) -> torch.Tensor:
    """[cos | sin] of k·r_a(t): (t, A, 2K) float32 for (t, A, 3) float32
    positions and (K, 3) float32 k.

    The angle is formed and folded into [−π, π] in float64, then cast to
    float32 before cos and sin (about 1e-7 rad however large k·r is).
    """
    t, a, _ = pos.shape
    n_k = k_vectors.shape[0]
    ang = pos.reshape(t * a, 3).double() @ k_vectors.double().T
    turns = (ang / (2.0 * torch.pi)).round_()
    ang = ang.sub_(turns, alpha=2.0 * torch.pi).float()
    del turns
    cs = torch.empty((t * a, 2 * n_k), dtype=torch.float32, device=pos.device)
    torch.cos(ang, out=cs[:, :n_k])
    torch.sin(ang, out=cs[:, n_k:])
    return cs.view(t, a, 2 * n_k)


def accumulate_modes(acc_re: torch.Tensor, acc_im: torch.Tensor, pos: torch.Tensor,
                     vel: Optional[torch.Tensor], k_vectors: torch.Tensor,
                     t_chunk: int) -> None:
    """acc += the mode stack of one atom block, in place.

    ``acc_re``/``acc_im`` are (n_t, K, C) float32: C = 4 channels
    [ρ, j_x, j_y, j_z] with velocities, C = 1 (ρ alone) with ``vel=None``,
    the density-only path (S(k), ISF), which never reads velocities.  Per
    time tile of ``t_chunk`` frames the phasors are contracted with the
    weights [1, v_x, v_y, v_z] over the block's atoms by one IEEE float32
    ``torch.bmm``; the density-only path contracts with [1, 0, 0, 0], the
    same product, so its ρ is the DSF's density channel bit for bit.  (The
    four-row product is also the accurate one: on the H100 cuBLAS's
    one-row kernel summed the 10⁵ aligned phasors of a Bragg column to
    8.6e-6 of S(k), the four-row one to 8.5e-8.)
    """
    n_t, n_a, _ = pos.shape
    n_k, n_ch = k_vectors.shape[0], acc_re.shape[2]
    for t0 in range(0, n_t, t_chunk):
        t1 = min(t0 + t_chunk, n_t)
        cs = instant_phasors(pos[t0:t1], k_vectors)                   # (tc, A, 2K)
        w = torch.zeros((t1 - t0, 4, n_a), dtype=torch.float32, device=pos.device)
        w[:, 0] = 1.0
        if vel is not None:
            w[:, 1:] = vel[t0:t1].transpose(1, 2)
        f = torch.bmm(w, cs)[:, :n_ch]                                # (tc, C, 2K)
        del cs
        acc_re[t0:t1] += f[:, :, :n_k].transpose(1, 2)
        acc_im[t0:t1] += f[:, :, n_k:].transpose(1, 2)


def instant_modes(pos: torch.Tensor, vel: torch.Tensor, k_vectors: torch.Tensor,
                  t_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density + current modes of one atom block: (re, im), each
    (n_t, K, 4) float32, channels [ρ, j_x, j_y, j_z]."""
    acc = [torch.zeros((pos.shape[0], k_vectors.shape[0], 4), dtype=torch.float32,
                       device=pos.device) for _ in range(2)]
    accumulate_modes(*acc, pos, vel, k_vectors, t_chunk)
    return acc[0], acc[1]


def density_modes(pos: torch.Tensor, k_vectors: torch.Tensor,
                  t_chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density mode ρ_k(t) of one atom block: (re, im), each (n_t, K, 1)
    float32; the same contraction as :func:`instant_modes`' channel 0."""
    acc = [torch.zeros((pos.shape[0], k_vectors.shape[0], 1), dtype=torch.float32,
                       device=pos.device) for _ in range(2)]
    accumulate_modes(*acc, pos, None, k_vectors, t_chunk)
    return acc[0], acc[1]


# ---------------------------------------------------------------------------
# Reductions of the accumulated mode stacks
# ---------------------------------------------------------------------------

def dsf_reduce(f_re: torch.Tensor, f_im: torch.Tensor, k_unit: torch.Tensor,
               freq_idx: torch.Tensor, segments: int = 1, window: str = 'rect'
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mode stack (n_t, K, 4) → (S, C_L, C_T) planes, each (n_keep, K)
    float32, still missing the caller's 1/N.

    ``freq_idx`` holds the kept rows of the full spectrum (segments = 1) or
    of the segment spectrum.  With ``segments`` > 1 (Welch) the planes
    average over that many non-overlapping windows of n_t // segments
    frames (the trailing frames dropped), each tapered by ``window`` (unit
    coherent gain) and normalized FFT/seg.  A zero row of ``k_unit`` (Γ)
    gives C_L = 0.
    """
    n_t, n_k, n_ch = f_re.shape
    seg = n_t // segments
    sig = torch.complex(f_re[:seg * segments], f_im[:seg * segments])
    sig = sig.reshape(segments, seg, n_k, n_ch)
    w = welch_window(seg, window, device=f_re.device)
    if w is not None:
        sig = sig * w[None, :, None, None]
    spec = (torch.fft.fft(sig, dim=1) / seg).index_select(1, freq_idx)   # (S, F, K, 4)
    rho, j = spec[..., 0], spec[..., 1:]
    s_plane = (rho.real ** 2 + rho.imag ** 2).mean(dim=0)
    ku = k_unit.float()
    jl_re = (j.real * ku).sum(dim=-1)
    jl_im = (j.imag * ku).sum(dim=-1)
    c_l = (jl_re * jl_re + jl_im * jl_im).mean(dim=0)
    total = (j.real ** 2 + j.imag ** 2).sum(dim=-1).mean(dim=0)
    c_t = torch.clamp(total - c_l, min=0.0)                           # Cauchy-Schwarz
    return s_plane.float(), c_l.float(), c_t.float()


def sk_reduce(f_re: torch.Tensor, f_im: torch.Tensor) -> torch.Tensor:
    """Mode stack (n_t, K, C), channel 0 = ρ → S(k) = ⟨|ρ_k(t)|²⟩_t, (K,)
    float32, still missing the caller's 1/N (Σ_ω of the S(k,ω) plane)."""
    rho_re, rho_im = f_re[..., 0], f_im[..., 0]
    return (rho_re ** 2 + rho_im ** 2).mean(dim=0).float()


def _autocorr_fft_len(n_t: int) -> int:
    """FFT length of a linear (non-circular) autocorrelation: the next
    power of two ≥ 2·n_t − 1."""
    return 1 << (2 * n_t - 1).bit_length()


def _lagged_autocorr(sig: torch.Tensor, n_lags: int) -> torch.Tensor:
    """Re ⟨sig(t')* sig(t'+τ)⟩_{t'} along dim 0 for τ < ``n_lags``, each
    lag divided by its overlap count n_t − τ (Wiener–Khinchin, zero-padded
    to :func:`_autocorr_fft_len`)."""
    n_t = sig.shape[0]
    spec = torch.fft.fft(sig, n=_autocorr_fft_len(n_t), dim=0)
    power = (spec.real ** 2 + spec.imag ** 2).to(torch.complex64)
    del spec
    corr = torch.fft.ifft(power, dim=0)[:n_lags].real
    counts = (n_t - torch.arange(n_lags, device=sig.device)).float()
    return corr / counts.reshape((n_lags,) + (1,) * (corr.dim() - 1))


def isf_reduce(f_re: torch.Tensor, f_im: torch.Tensor, n_lags: int) -> torch.Tensor:
    """Mode stack (n_t, K, C), channel 0 = ρ → coherent intermediate
    scattering function F(k,τ) = Re ⟨ρ_k(t')* ρ_k(t'+τ)⟩_{t'}, (n_lags, K)
    float32, still missing the caller's 1/N; F(k,0) = S(k)."""
    return _lagged_autocorr(torch.complex(f_re[..., 0], f_im[..., 0]), n_lags).float()


def isf_self_block(pos: torch.Tensor, k_vectors: torch.Tensor, n_lags: int) -> torch.Tensor:
    """Self ISF of one atom block: Σ_a Re ⟨e^{i k·(r_a(t'+τ) − r_a(t'))}⟩_{t'},
    (n_lags, K) float32, still missing the caller's 1/N (F_s(k,0) = 1).
    ``pos`` is (n_t, A, 3) with the full time axis."""
    n_k = k_vectors.shape[0]
    cs = instant_phasors(pos, k_vectors)
    sig = torch.complex(cs[..., :n_k], cs[..., n_k:])
    del cs
    return _lagged_autocorr(sig, n_lags).sum(dim=1).float()


def dsf_self_block(pos: torch.Tensor, k_vectors: torch.Tensor,
                   freq_idx: torch.Tensor) -> torch.Tensor:
    """Self intensity of one atom block: Σ_a |FFT_t e^{i k·r_a}|² / n_t² at
    the kept rows, (n_keep, K) float32, still missing the caller's 1/N.
    ``pos`` is (n_t, A, 3) with the full time axis."""
    n_t, n_k = pos.shape[0], k_vectors.shape[0]
    cs = instant_phasors(pos, k_vectors)
    sig = torch.complex(cs[..., :n_k], cs[..., n_k:])
    del cs
    spec = (torch.fft.fft(sig, dim=0) / n_t).index_select(0, freq_idx)
    return (spec.real ** 2 + spec.imag ** 2).sum(dim=1).float()
