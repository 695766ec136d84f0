"""Dispersion post-processing: band sorting and group-velocity fields.

The reference stops at the I(ω, k) heatmap and its frequency slider
(reference sed_calculator.py:127-180 and psa_gui.py:2357-2459); extracting ∂ω/∂k —
the phonon group velocity, the quantity thermal-transport analyses actually
need from a dispersion surface — is left to the user.  These helpers close
that gap on top of :meth:`SEDCalculator.calculate_kgrid_peaks`, whose
dispersion surfaces already arrive at peak-triplet readback cost.

Peaks are returned ordered by HEIGHT per k-point; phonon branches cross, so
finite differences along the raw peak rows would mix branches wherever the
ordering flips.  ``sort_bands_path`` / ``sort_bands_grid`` reorder the band
axis for spectral continuity — a greedy minimal-|Δν| assignment marching
outward from the most band-separated anchor column — and then
``group_velocity_path`` / ``group_velocity_grid`` apply (possibly
non-uniform) central differences.

This is host-side NumPy by design: the inputs are the peak surfaces
(n_bands × n_k floats, ~100 kB for a 200² grid), already reduced on device
by the sweep engines; sorting is a data-dependent sequential march with no
FLOPs worth a device launch.  The code is that of
:mod:`psa_tpu.ops.dispersion`, carried over so the port needs no JAX.

Units: frequencies ν in THz (cycles/ps), k in rad/Å, so

    v_g = ∂ω/∂k = 2π · ∂ν/∂k   [Å·THz = Å/ps;  1 Å/ps = 100 m/s].
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

TWO_PI = 2.0 * np.pi


def _assign(ref: np.ndarray, cand: np.ndarray) -> np.ndarray:
    """Permutation ``perm`` matching ``cand[perm]`` to ``ref`` greedily.

    Globally-greedy minimal |ref_i − cand_j| pairing (pick the smallest
    remaining cost, retire its row and column).  Exact assignment would be
    Hungarian; for the handful of bands a peaks call extracts (n ≤ ~16)
    the greedy pairing differs only on pathological near-ties and costs
    O(n³) with tiny constants.
    """
    n = ref.shape[0]
    cost = np.abs(ref[:, None] - cand[None, :])
    perm = np.empty(n, dtype=np.int64)
    row_free = np.ones(n, dtype=bool)
    col_free = np.ones(n, dtype=bool)
    big = np.inf
    for _ in range(n):
        masked = np.where(row_free[:, None] & col_free[None, :], cost, big)
        i, j = np.unravel_index(np.argmin(masked), masked.shape)
        perm[i] = j
        row_free[i] = False
        col_free[j] = False
    return perm


def _separation_score(freqs: np.ndarray) -> np.ndarray:
    """Per-column minimum pairwise band separation (… n_bands, n_cols).

    The anchor column for the sorting march should be where bands are most
    distinguishable; at degenerate columns (e.g. k = 0, where every branch
    collapses toward ν = 0) any ordering is as good as any other.
    """
    f = np.sort(freqs, axis=0)
    if f.shape[0] < 2:
        return np.full(f.shape[1:], np.inf)
    return np.min(np.diff(f, axis=0), axis=0)


def sort_bands_path(peak_freqs: np.ndarray, *companions: np.ndarray
                    ) -> Tuple[np.ndarray, ...]:
    """Reorder (n_bands, n_k) peak rows into continuous branches.

    Marches outward from the column with the largest minimum band
    separation, matching each column's peaks to its already-sorted
    neighbor by nearest frequency.  At the anchor, bands are ordered by
    ascending frequency.  ``companions`` (heights, widths, phases, …) are
    reordered with the same per-column permutations.

    Returns the same number of arrays it was given (freqs first), each a
    sorted copy.
    """
    f = np.asarray(peak_freqs)
    if f.ndim != 2:
        raise ValueError(f"peak_freqs must be (n_bands, n_k), got {f.shape}")
    comps = [np.asarray(c) for c in companions]
    for c in comps:
        if c.shape != f.shape:
            raise ValueError("companion shape mismatch: "
                             f"{c.shape} vs {f.shape}")
    n_bands, n_k = f.shape
    out_f = f.copy()
    out_c = [c.copy() for c in comps]
    if n_bands < 2 or n_k == 0:
        return (out_f, *out_c)

    anchor = int(np.argmax(_separation_score(f)))
    order = np.argsort(f[:, anchor], kind='stable')
    out_f[:, anchor] = f[order, anchor]
    for c, src in zip(out_c, comps):
        c[:, anchor] = src[order, anchor]

    for cols in (range(anchor + 1, n_k), range(anchor - 1, -1, -1)):
        prev = anchor
        for j in cols:
            perm = _assign(out_f[:, prev], f[:, j])
            out_f[:, j] = f[perm, j]
            for c, src in zip(out_c, comps):
                c[:, j] = src[perm, j]
            prev = j
    return (out_f, *out_c)


def sort_bands_grid(peak_freqs: np.ndarray, *companions: np.ndarray
                    ) -> Tuple[np.ndarray, ...]:
    """Reorder (n_bands, gx, gy) peak surfaces into continuous sheets.

    Two-stage march: the best-separated kx row is band-sorted along ky
    (a 1-D path sort); every ky column then marches along kx from that
    anchor row.  Greedy continuity cannot untangle a true conical
    degeneracy (band sheets are not globally orderable around a Dirac
    point), but it keeps finite differences on-branch everywhere the
    branches are separated — which is where a group velocity is
    well-defined in the first place.
    """
    f = np.asarray(peak_freqs)
    if f.ndim != 3:
        raise ValueError(f"peak_freqs must be (n_bands, gx, gy), got {f.shape}")
    comps = [np.asarray(c) for c in companions]
    for c in comps:
        if c.shape != f.shape:
            raise ValueError("companion shape mismatch: "
                             f"{c.shape} vs {f.shape}")
    n_bands, gx, gy = f.shape
    out_f = f.copy()
    out_c = [c.copy() for c in comps]
    if n_bands < 2 or gx == 0 or gy == 0:
        return (out_f, *out_c)

    row_score = _separation_score(
        f.reshape(n_bands, gx * gy)).reshape(gx, gy).mean(axis=1)
    ax = int(np.argmax(row_score))

    sorted_row = sort_bands_path(f[:, ax, :], *[c[:, ax, :] for c in comps])
    out_f[:, ax, :] = sorted_row[0]
    for c, s in zip(out_c, sorted_row[1:]):
        c[:, ax, :] = s

    for rows in (range(ax + 1, gx), range(ax - 1, -1, -1)):
        prev = ax
        for i in rows:
            for j in range(gy):
                perm = _assign(out_f[:, prev, j], f[:, i, j])
                out_f[:, i, j] = f[perm, i, j]
                for c, src in zip(out_c, comps):
                    c[:, i, j] = src[perm, i, j]
            prev = i
    return (out_f, *out_c)


def group_velocity_path(band_freqs: np.ndarray, k_mags: np.ndarray
                        ) -> np.ndarray:
    """v_g = 2π·∂ν/∂k along a 1-D k-path (central differences, Å/ps).

    ``band_freqs``: (n_bands, n_k) THz, band-sorted (see
    :func:`sort_bands_path`).  ``k_mags``: (n_k,) rad/Å, strictly
    monotonic (``np.gradient`` handles non-uniform spacing).
    """
    f = np.asarray(band_freqs, dtype=np.float64)
    k = np.asarray(k_mags, dtype=np.float64)
    if f.ndim != 2 or k.ndim != 1 or f.shape[1] != k.shape[0]:
        raise ValueError(f"shape mismatch: freqs {f.shape} vs k {k.shape}")
    if f.shape[1] < 2:
        raise ValueError("need at least 2 k-points for a gradient")
    return (TWO_PI * np.gradient(f, k, axis=1)).astype(np.float32)


def group_velocity_grid(band_freqs: np.ndarray, kx_vals: np.ndarray,
                        ky_vals: np.ndarray
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """(v_x, v_y) = 2π·∇_k ν over a k-grid (central differences, Å/ps).

    ``band_freqs``: (n_bands, gx, gy) THz band-sorted sheets in the
    row-major (kx slow) layout every k-grid path in this package uses.
    """
    f = np.asarray(band_freqs, dtype=np.float64)
    kx = np.asarray(kx_vals, dtype=np.float64)
    ky = np.asarray(ky_vals, dtype=np.float64)
    if f.ndim != 3 or f.shape[1] != kx.shape[0] or f.shape[2] != ky.shape[0]:
        raise ValueError(f"shape mismatch: freqs {f.shape} vs "
                         f"kx {kx.shape}, ky {ky.shape}")
    if kx.shape[0] < 2 or ky.shape[0] < 2:
        raise ValueError("need at least a 2x2 grid for gradients")
    vx = TWO_PI * np.gradient(f, kx, axis=1)
    vy = TWO_PI * np.gradient(f, ky, axis=2)
    return vx.astype(np.float32), vy.astype(np.float32)
