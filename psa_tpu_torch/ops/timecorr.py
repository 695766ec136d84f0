"""Time-correlation observables on PyTorch (counterpart of
:mod:`psa_tpu.ops.timecorr`): the mean-squared displacement and the
velocity autocorrelation function.

The k-independent companions of the instantaneous-phase family
(:mod:`psa_tpu_torch.ops.instantaneous`): MSD(τ) = ⟨|r(t+τ) − r(t)|²⟩ is
the transport observable of liquid MD (Einstein: MSD → 2·d·D·τ), and
VACF(τ) = ⟨v(t)·v(t+τ)⟩ is the time-domain twin of the on-device DOS
(:func:`psa_tpu_torch.ops.spectral.dos_accumulate`, its Fourier transform).

Both use the FFT trick for all time origins at O(n log n): per atom and
component, the lagged sums Σ_t x(t)·x(t+τ) come from one linear
(zero-padded) autocorrelation; the MSD also needs cumulative sums of
|r(t)|² (the Kneller/nMoldyn identity (n−τ)·MSD(τ) = S1(τ) − 2·S2(τ)).
Block partials are float32 on the device; :func:`timecorr_sum` adds them in
a float64 device accumulator, in block order.  Nothing is padded along the
atom axis: the last block is a ragged slice, so the functions take no mask.
"""
from __future__ import annotations

import torch

from .instantaneous import _autocorr_fft_len

__all__ = ['msd_block', 'vacf_block', 'timecorr_sum', 'block_bytes_per_atom']


def block_bytes_per_atom(n_t: int) -> int:
    """Device bytes one atom of a block holds at the peak of
    :func:`msd_block` (the larger of the two): five float32 arrays of 12
    bytes per point of the padded transform (its zero-padded input, cuFFT's
    reordered copy, the half spectrum, and for the inverse its working copy
    and its output), and the centred copy and its squares (24 bytes per
    frame).  An H100 measured 1.97e6 bytes per atom at n_t = 10⁴ (peak above
    the resident arrays over the block's atoms); this gives 2.21e6."""
    return 60 * _autocorr_fft_len(n_t) + 24 * n_t


def _lagged_products(x: torch.Tensor, n_lags: int) -> torch.Tensor:
    """Σ_t x(t)·x(t+τ) for τ < ``n_lags`` along dim 0, per trailing axis, by
    a real FFT of length :func:`_autocorr_fft_len` (linear autocorrelation).
    x: (n_t, ...) float32 → (n_lags, ...) float32."""
    m = _autocorr_fft_len(x.shape[0])
    spec = torch.fft.rfft(x, n=m, dim=0)
    # |spec|² in place, in the spectrum's own storage
    parts = torch.view_as_real(spec)
    parts[..., 0].square_().addcmul_(parts[..., 1], parts[..., 1])
    parts[..., 1].zero_()
    return torch.fft.irfft(spec, n=m, dim=0)[:n_lags]


def _counts(n_t: int, n_lags: int, device) -> torch.Tensor:
    """Overlap count n_t − τ of each lag, float32."""
    return (n_t - torch.arange(n_lags, device=device)).float()


def _msd_sum(x: torch.Tensor, n_lags: int) -> torch.Tensor:
    """Σ over atoms of the per-atom MSD; x: (n_t, A, 3) float32.

    (n_t−τ)·MSD = S1(τ) − 2·S2(τ) with S2 the FFT autocorrelation of r and
    S1(τ) = Σ_{t<n_t−τ} |r(t)|² + Σ_{t≥τ} |r(t)|² from two lookups into a
    cumulative sum."""
    n_t = x.shape[0]
    # Per-atom time-mean centring: the MSD is invariant under a constant
    # shift, but the float32 S1 − 2·S2 cancels catastrophically when |r| is
    # large next to the displacements; centring bounds |x| by their scale.
    x = x - x.mean(dim=0, keepdim=True)
    s2 = _lagged_products(x, n_lags).sum(dim=(-1, -2))             # (n_lags,)
    # S1 is linear in |x|², so the atoms are summed first and the cumulative
    # sum runs over one (n_t,) vector, in float64
    d = (x * x).sum(dim=(-1, -2)).double()                         # (n_t,)
    c = torch.cat([torch.zeros_like(d[:1]), torch.cumsum(d, dim=0)])   # (n_t + 1,)
    # c[n_t − τ] + (c[n_t] − c[τ]) for τ = 0 … n_lags − 1
    s1 = c.flip(0)[:n_lags] + (c[n_t] - c[:n_lags])
    return ((s1 - 2.0 * s2.double()) / _counts(n_t, n_lags, x.device)).float()


def _vacf_sum(x: torch.Tensor, n_lags: int) -> torch.Tensor:
    """Σ over atoms of the velocity autocorrelation; x: (n_t, A, 3) float32."""
    corr = _lagged_products(x, n_lags).sum(dim=(-1, -2))           # (n_lags,)
    return (corr / _counts(x.shape[0], n_lags, x.device)).float()


def msd_block(pos: torch.Tensor, n_lags: int) -> torch.Tensor:
    """Σ over an atom block of the per-atom MSD, all time origins.

    MSD_a(τ) = (1/(n_t−τ)) Σ_t |r_a(t+τ) − r_a(t)|², without the O(n²)
    origin loop (see :func:`_msd_sum`).  Positions must be unwrapped.

    Args:
        pos: (n_t, A, 3) float32.
        n_lags: τ rows returned (τ = 0 … n_lags−1 frames).

    Returns:
        (n_lags,) float32, Σ_a MSD_a(τ); the caller divides by the group size.
    """
    return _msd_sum(pos.float(), n_lags)


def vacf_block(vel: torch.Tensor, n_lags: int) -> torch.Tensor:
    """Σ over an atom block of the velocity autocorrelation
    VACF_a(τ) = (1/(n_t−τ)) Σ_t v_a(t)·v_a(t+τ).

    Args:
        vel: (n_t, A, 3) float32.
        n_lags: τ rows returned.

    Returns:
        (n_lags,) float32, Σ_a VACF_a(τ) in (Å/ps)²; the caller divides by
        the group size (VACF(0) is then the mean-square speed ⟨|v|²⟩).
    """
    return _vacf_sum(vel.float(), n_lags)


def timecorr_sum(blocks, n_lags: int, kind: str) -> torch.Tensor:
    """Σ over the atom blocks of a group: (n_lags,) float64 on the blocks'
    device.  ``blocks`` yields (n_t, a, 3) float32 tensors (slices of a
    resident group, or staged blocks of a streamed one); ``kind`` is 'msd'
    or 'vacf'.  Each block's float32 partial is added in float64, in block
    order."""
    fn = msd_block if kind == 'msd' else vacf_block
    acc = None
    for block in blocks:
        part = fn(block, n_lags).double()
        acc = part if acc is None else acc.add_(part)
    return acc
