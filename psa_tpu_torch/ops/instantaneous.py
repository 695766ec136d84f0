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

Three engines make the phasors (:func:`instant_phasors`, ``phase_mode``):

* ``'exact'``: k·r_a(t) formed and folded by 2π in float64 (the float32
  positions times the float32 k), cast to float32, then cos and sin, per
  (t, atom, k) element; the JAX package's double-single path with a zero low
  word.
* ``'factored'``: a chunk of lattice k that is an outer sum {k_a} ⊕ {k_b} of
  two small base sets (:func:`factor_k_chunk`) takes that chain only on the
  Na + Nb base columns, from the float64 lattice vectors m·B; each of the
  Na·Nb product phasors is one complex multiply.  The output is in product
  order; the caller picks its k from the reduced planes by ``col_idx``.
* ``'incremental'``: one exact phasor per :data:`_ANCHOR_WINDOW` frames; the
  frames of a window advance it by the small phase δ = k·minimage(r(t) −
  r(anchor)), a float32 product, and one complex multiply.

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

import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import profiling
from .spectral import welch_window

#: Device bytes per (t, atom, k-column) element that the mode stacks' tiles
#: are sized by, per engine.  'exact' holds the float64 angle and its turns
#: (16), then the float32 angle beside them (4), then cos and sin (8).
#: 'factored' holds the complex product phasors (8) with room for the base
#: columns' float64 chain (4).  'incremental' holds δ (4) beside the complex
#: phasors (8) and the window differences and anchors (4).  Each was checked
#: against the card's peak memory (PERF.md §6).
PHASOR_BYTES = {'exact': 24, 'factored': 12, 'incremental': 16}


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
    """Output k-columns of a phase-producer k argument: a plain (K, 3)
    array, or a factored pair of base rows, whose output is the Na·Nb
    product space."""
    if isinstance(k_vectors, tuple):
        return k_vectors[0].shape[0] * k_vectors[1].shape[0]
    return k_vectors.shape[0]


# ---------------------------------------------------------------------------
# Factoring a chunk of lattice k into anchors ⊕ deltas (host, NumPy)
#
# Commensurate k lie on the box reciprocal lattice: k = m·B with integer
# Miller rows m and B = 2π·H⁻ᵀ, where exp(i (k_a + k_b)·r) = exp(i k_a·r) ·
# exp(i k_b·r) exactly.  A snapped k-path of K points factors as ~√K anchors
# ⊕ ~√K deltas along its primitive lattice direction.  Factorizations whose
# product space would exceed ~1.35× the requested k (staircases, residual
# tables) are rejected: the contraction's cost grows with the product
# columns, so they run the exact engine.
# ---------------------------------------------------------------------------

def _line_factors(c: np.ndarray, g: np.ndarray, m0: np.ndarray,
                  max_span_factor: float, n: int):
    """Anchor ⊕ delta Miller factor pair of the lattice line m0 + c·g.

    The coefficient span [c_min, c_max] splits as c = c_min + W·w + δ with
    W ≈ √span; returns [(anchor_millers, anchor_idx), (delta_millers,
    delta_idx)] or None when the line is too sparse."""
    c_min, c_max = int(c.min()), int(c.max())
    span = c_max - c_min + 1
    if span > max_span_factor * max(n, 1):
        return None                       # sparse line: base count balloons
    w = max(1, int(round(math.sqrt(span))))
    n_w = -(-span // w)
    cc = (c - c_min).astype(np.int64)
    anchors = (m0[None, :]
               + (c_min + w * np.arange(n_w))[:, None] * g[None, :])
    deltas = np.arange(w)[:, None] * g[None, :]
    return [(anchors, (cc // w).astype(np.int32)),
            (deltas, (cc % w).astype(np.int32))]


def _primitive(v: np.ndarray) -> Optional[np.ndarray]:
    """v // gcd(|v|) for a nonzero integer 3-vector, else None."""
    gg = math.gcd(math.gcd(abs(int(v[0])), abs(int(v[1]))), abs(int(v[2])))
    return None if gg == 0 else v // gg


def _coeffs_on_line(d: np.ndarray, g: np.ndarray) -> Optional[np.ndarray]:
    """Integer c with d == c·g row-wise, or None (exact collinearity)."""
    lead = int(np.argmax(np.abs(g)))
    c = d[:, lead] // g[lead]
    if np.any(d != c[:, None] * g[None, :]):
        return None
    return c


def _axis_factors(m: np.ndarray):
    """Per-axis factorization: m_n = Σ_a m_n[a]·e_a, each axis's value set
    either a direct table (few distinct values) or split anchors ⊕ deltas
    over its span; up to 6 factors (the staircase paths an arbitrary snapped
    direction produces)."""
    factors = []
    base0 = np.zeros(3, dtype=np.int64)
    for a in range(3):
        vals = m[:, a].astype(np.int64)
        vmin = int(vals.min())
        base0[a] = vmin
        u = vals - vmin
        span = int(u.max()) + 1
        if span == 1:
            continue                      # constant axis folds into base0
        e_a = np.zeros(3, dtype=np.int64)
        e_a[a] = 1
        uniq, inv = np.unique(u, return_inverse=True)
        if len(uniq) <= 8:
            factors.append((uniq[:, None] * e_a[None, :],
                            inv.astype(np.int32)))
            continue
        w = max(1, int(round(math.sqrt(span))))
        n_w = -(-span // w)
        factors.append(((w * np.arange(n_w))[:, None] * e_a[None, :],
                        (u // w).astype(np.int32)))
        factors.append((np.arange(w)[:, None] * e_a[None, :],
                        (u % w).astype(np.int32)))
    if not factors:
        return None                       # all rows identical
    rows0, idx0 = factors[0]
    factors[0] = (rows0 + base0[None, :], idx0)
    return factors


def _factor_millers(m: np.ndarray, max_span_factor: float):
    """Factor integer Miller rows into an outer sum of small base sets.

    Returns a list of (miller_rows (N_f, 3), idx (n,) int32) factors whose
    per-point base-row sums reconstruct every m row exactly, or None.
    Four detectors, fewest factors first:

    1. exact lattice line m = m0 + c·g (any order, gaps allowed)
       → anchors ⊕ deltas, 2 factors of ~√span rows each;
    2. contiguous row-major slice of a 2-D lattice grid (the step sequence
       alternates a column stride with a row-wrap step at a fixed period)
       → row values ⊕ column values;
    3. near-line: m = m0 + c·g + r with g the primitive end-to-end
       direction, c the nearest-integer projection and r a small residual
       (few distinct rows) → anchors ⊕ deltas ⊕ residual table;
    4. per-axis split (:func:`_axis_factors`), the general staircase
       fallback.

    The caller gates on the factor count and the base-row count, so a
    detector that "works" without compressing falls back to the exact
    engine.
    """
    n = len(m)
    d = m - m[0]
    nz = np.nonzero(np.any(d != 0, axis=1))[0]
    if nz.size == 0:
        return None                       # all k identical
    # -- 1: exact lattice line ------------------------------------------------
    g = _primitive(d[nz[0]])
    if g is not None:
        c = _coeffs_on_line(d, g)
        if c is not None:
            return _line_factors(c, g, m[0], max_span_factor, n)
    # -- 2: contiguous row-major grid slice -----------------------------------
    steps = np.diff(m, axis=0)            # (n-1, 3)
    col = steps[0]
    wraps = np.nonzero(np.any(steps != col[None, :], axis=1))[0]
    if wraps.size >= 1:
        first = int(wraps[0])
        if wraps.size == 1:
            # slice covers two partial rows: any width fitting both works
            period = max(first + 1, n - 1 - first)
        else:
            period = int(wraps[1] - wraps[0])
        ok = (period >= 2
              and np.array_equal(wraps, first + period
                                 * np.arange(wraps.size))
              and np.all(steps[wraps] == steps[wraps[0]][None, :]))
        if ok:
            row_step = steps[wraps[0]] + (period - 1) * col
            offset = (period - 1 - first) % period
            cseq = offset + np.arange(n)
            rows_i, cols_i = cseq // period, cseq % period
            base0 = m[0] - offset * col
            if np.all(m == base0[None, :] + rows_i[:, None] * row_step
                      + cols_i[:, None] * col):
                row_vals = np.unique(rows_i)
                anchors = base0[None, :] + row_vals[:, None] * row_step
                deltas = np.arange(period)[:, None] * col
                row_map = np.searchsorted(row_vals, rows_i)
                return [(anchors, row_map.astype(np.int32)),
                        (deltas, cols_i.astype(np.int32))]
    # -- 3: near-line + residual table ----------------------------------------
    g = _primitive(m[-1] - m[0])
    if g is not None:
        c = np.round(d @ g / float(g @ g)).astype(np.int64)
        r = d - c[:, None] * g[None, :]
        res_rows, res_map = np.unique(r, axis=0, return_inverse=True)
        if (len(res_rows) <= max(8, n // 16)
                and np.abs(res_rows).max() <= 4
                and c.max() > c.min()):
            line = _line_factors(c, g, m[0], max_span_factor, n)
            if line is not None:
                if len(res_rows) == 1 and np.all(res_rows[0] == 0):
                    return line
                return line + [(res_rows, res_map.astype(np.int32))]
    # -- 4: per-axis split (general staircase) --------------------------------
    return _axis_factors(m)


def factor_k_chunk(k_vectors: np.ndarray, box: np.ndarray,
                   max_span_factor: float = 1.35,
                   max_prod_factor: float = 1.35):
    """Factor a commensurate k-chunk as an anchor ⊕ delta outer sum.

    Args:
        k_vectors: (n, 3) snapped k rows.
        box: (3,) edge lengths or (3, 3) cell matrix H.
        max_span_factor: bail out when a line's coefficient span exceeds
            this multiple of n (sparse lines do not amortize).
        max_prod_factor: bail out when the product-column count Na·Nb
            exceeds this multiple of n rounded up to 64: the mode
            contraction runs over product columns.

    Returns:
        ((k_a, k_b), col_idx): the base vectors k = m @ B as float64 CPU
        tensors (Na, 3) and (Nb, 3), and the (n,) int32 host array mapping
        each input k row to its product column i·Nb + j; or None when the
        set is off-lattice, does not factor into exactly two base sets
        within the product bound, or is too small to profit.  (The JAX
        package ships each base set as a hi/lo float32 pair; the GPU has
        float64, so the port keeps one float64 array.)
    """
    kv = np.asarray(k_vectors, dtype=np.float64)
    n = len(kv)
    if n < 16:
        return None                       # base work would not amortize
    frac, H = _box_fractional(kv, box)
    if frac is None:                      # degenerate-axis orthorhombic box
        L = np.asarray(H, dtype=np.float64).diagonal() \
            if np.asarray(H).ndim == 2 else np.asarray(H, dtype=np.float64)
        if np.any((L <= 0) & (np.abs(kv).max(axis=0) > 0)):
            return None                   # continuous component: not lattice
        H = np.diag(np.where(L > 0, L, 1.0))
        frac = kv * np.diagonal(H) / (2.0 * np.pi)
    H = np.asarray(H, dtype=np.float64)
    if abs(np.linalg.det(H)) < 1e-12:
        return None
    m = np.round(frac)
    if np.max(np.abs(frac - m)) > 1e-3:
        return None                       # off-lattice k: exact path only
    factors = _factor_millers(m.astype(np.int64), max_span_factor)
    if factors is None or len(factors) != 2:
        return None                       # only pure outer sums: no gather
    (rows_a, ia), (rows_b, ib) = factors
    na, nb = len(rows_a), len(rows_b)
    if na + nb >= 0.75 * n:
        return None                       # not enough k per base column
    if na * nb > max(64, max_prod_factor * (-(-n // 64) * 64)):
        return None                       # product space too padded
    b_mat = 2.0 * np.pi * np.linalg.inv(H).T          # k = m @ B
    col_idx = (ia.astype(np.int64) * nb + ib.astype(np.int64)).astype(np.int32)
    return ((torch.from_numpy(rows_a.astype(np.float64) @ b_mat),
             torch.from_numpy(rows_b.astype(np.float64) @ b_mat)), col_idx)


# ---------------------------------------------------------------------------
# The phase producers and the mode stacks
# ---------------------------------------------------------------------------

#: Frames per anchor of the incremental engine: the exact chain runs on one
#: frame in 32; in the others the float32 product δ = k·Δr errs by about
#: |δ|·2⁻²⁴, and |δ| is k times the displacement within the window.
_ANCHOR_WINDOW = 32


def _folded_angles(flat: torch.Tensor, k64: torch.Tensor) -> torch.Tensor:
    """k·r folded into [−π, π]: (M, K) float32 of (M, 3) float32 positions
    and (K, 3) float64 k; formed and folded in float64 (about 1e-7 rad
    however large k·r is)."""
    ang = flat.double() @ k64.T
    turns = (ang / (2.0 * torch.pi)).round_()
    return ang.sub_(turns, alpha=2.0 * torch.pi).float()


def _exact_phasors(pos: torch.Tensor, k_vectors: torch.Tensor) -> torch.Tensor:
    t, a, _ = pos.shape
    n_k = k_vectors.shape[0]
    ang = _folded_angles(pos.reshape(t * a, 3), k_vectors.double())
    cs = torch.empty((t * a, 2 * n_k), dtype=torch.float32, device=pos.device)
    torch.cos(ang, out=cs[:, :n_k])
    torch.sin(ang, out=cs[:, n_k:])
    return cs.view(t, a, 2 * n_k)


def _unit_phasors(ang: torch.Tensor) -> torch.Tensor:
    """e^{i·ang} as complex64 (cos and sin of the float32 angles, one pass)."""
    return torch.polar(torch.ones((), dtype=torch.float32, device=ang.device).expand_as(ang),
                       ang)


def _factored_phasors(pos: torch.Tensor, fk) -> torch.Tensor:
    """e^{i k·r_a(t)} over the product columns of a factored chunk:
    (t, A, Na·Nb) complex64, column i·Nb + j holding k_a[i] + k_b[j].

    ``fk`` is :func:`factor_k_chunk`'s pair of float64 base rows on
    ``pos``'s device.  The float64 angle chain runs on the Na + Nb base
    columns; each product phasor is one complex multiply, (ac − bd) + i(ad +
    bc) in float32, written once by a broadcast product (no gather)."""
    k_a, k_b = fk
    t, a, _ = pos.shape
    flat = pos.reshape(t * a, 3)
    z_a = _unit_phasors(_folded_angles(flat, k_a))                     # (M, Na)
    z_b = _unit_phasors(_folded_angles(flat, k_b))                     # (M, Nb)
    return (z_a[:, :, None] * z_b[:, None, :]).view(t, a, -1)


def _incremental_phasors(pos: torch.Tensor, k_vectors: torch.Tensor,
                         box: Optional[torch.Tensor],
                         window: int = _ANCHOR_WINDOW) -> torch.Tensor:
    """e^{i k·r_a(t)} by anchored incremental phases: (t, A, K) complex64.

    The first frame of each ``window`` frames is an anchor with an exact
    phasor (:func:`_exact_phasors`).  Every frame of the window then needs
    the small phase δ = k·minimage(r(t) − r(anchor)): the difference is
    taken in float64 (a wrapped atom's is box-sized, and float32 would round
    it at ulp(L)), the lattice vector n·H nearest to it removed, and the
    small remainder multiplied with the float32 k in one IEEE float32
    product.  Float32 k sits about 2⁻²⁴ off the reciprocal lattice, so each
    removed image i adds back its residual phase φ_i(k) = fold(k·H_i), a
    (3, K) table.  e^{iδ} comes from ``torch.polar`` (cos and sin of the
    float32 δ; the JAX package's FMA-only minimax pair exists for the TPU's
    slow transcendentals), and e^{iθ} = e^{iθ_anchor}·e^{iδ} is one complex
    multiply, in place.  ``box`` is the (3, 3) float32 cell matrix (rows a_i), or
    None: no minimum image, right for unwrapped trajectories.  Valid for
    box-commensurate k.
    """
    n_t, n_a, _ = pos.shape
    n_k = k_vectors.shape[0]
    w = int(min(max(window, 1), n_t))
    n_w = -(-n_t // w)
    if n_w * w != n_t:                       # the last window repeats the last frame
        pos = torch.cat([pos, pos[-1:].expand(n_w * w - n_t, n_a, 3)], dim=0)
    pr = pos.view(n_w, w, n_a, 3)
    anchors = pr[:, 0]                                                # (n_w, A, 3)
    cs0 = _exact_phasors(anchors, k_vectors)                          # (n_w, A, 2K)
    d = pr.double() - anchors.double()[:, None]                       # (n_w, w, A, 3)
    table = k_vectors.float().T                                       # (3, K)
    if box is not None:
        h = box.double()
        n_img = torch.round(d @ torch.linalg.inv(h))
        d = (d - n_img @ h).float()
        phi = _folded_angles(box.float(), k_vectors.double())         # (3, K)
        d = torch.cat([d, n_img.float()], dim=-1)
        table = torch.cat([table, phi], dim=0)
    else:
        d = d.float()
    delta = (d.view(n_w * w * n_a, -1) @ table).view(n_w, w, n_a, n_k)
    del d
    z = _unit_phasors(delta)
    del delta
    z.mul_(torch.complex(cs0[..., :n_k], cs0[..., n_k:])[:, None])
    return z.view(n_w * w, n_a, n_k)[:n_t]


def instant_phasors(pos: torch.Tensor, k_vectors, box: Optional[torch.Tensor] = None,
                    phase_mode: str = 'exact') -> torch.Tensor:
    """The phasors of k·r_a(t) as a (t, A, 2K) float32 tensor for (t, A, 3)
    float32 positions; K = :func:`k_count` of ``k_vectors``.

    ``phase_mode='exact'`` takes (K, 3) float32 k: the angle is formed and
    folded into [−π, π] in float64, then cast to float32 before cos and sin
    (about 1e-7 rad however large k·r is); the last axis is [cos | sin], K
    of each.  ``'incremental'`` takes the same k and the cell ``box``
    (:func:`_incremental_phasors`); ``'factored'`` takes
    :func:`factor_k_chunk`'s pair of base rows (:func:`_factored_phasors`);
    both make complex64 phasors, so their last axis is (cos, sin) pairs, K
    of them.  :func:`phasor_parts` and :func:`complex_phasors` read either
    layout.
    """
    if phase_mode == 'exact':
        return _exact_phasors(pos, k_vectors)
    z = (_factored_phasors(pos, k_vectors) if phase_mode == 'factored'
         else _incremental_phasors(pos, k_vectors, box))
    return torch.view_as_real(z).reshape(z.shape[0], z.shape[1], -1)


def phasor_parts(x: torch.Tensor, phase_mode: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos part, sin part) views, K wide, of a tensor whose last axis is
    laid out as :func:`instant_phasors` lays it out under ``phase_mode``."""
    if phase_mode == 'exact':
        n_k = x.shape[-1] // 2
        return x[..., :n_k], x[..., n_k:]
    return x[..., 0::2], x[..., 1::2]


def complex_phasors(cs: torch.Tensor, phase_mode: str) -> torch.Tensor:
    """:func:`instant_phasors`' result as (t, A, K) complex64 (a view under
    the engines that make pairs)."""
    if phase_mode == 'exact':
        return torch.complex(*phasor_parts(cs, phase_mode))
    return torch.view_as_complex(cs.view(cs.shape[0], cs.shape[1], -1, 2))


def time_tile(t_chunk: int, phase_mode: str) -> int:
    """``t_chunk`` as the mode stacks cut it: the incremental engine's tiles
    are whole anchor windows, so a tiled run meets the anchors of an
    untiled one."""
    if phase_mode == 'incremental':
        return max(_ANCHOR_WINDOW, t_chunk // _ANCHOR_WINDOW * _ANCHOR_WINDOW)
    return t_chunk


def accumulate_modes(acc_re: torch.Tensor, acc_im: torch.Tensor, pos: torch.Tensor,
                     vel: Optional[torch.Tensor], k_vectors, t_chunk: int,
                     box: Optional[torch.Tensor] = None, phase_mode: str = 'exact',
                     weights: Optional[torch.Tensor] = None) -> None:
    """acc += the mode stack of one atom block, in place.

    ``acc_re``/``acc_im`` are (n_t, K, C) float32: C = 4 channels
    [ρ, j_x, j_y, j_z] with velocities, C = 1 (ρ alone) with ``vel=None``,
    the density-only path (S(k), ISF), which never reads velocities.  Per
    time tile of ``t_chunk`` frames (:func:`time_tile`) the phasors of
    ``phase_mode`` (:func:`instant_phasors`) are contracted with the weights
    [1, v_x, v_y, v_z] over the block's atoms by one IEEE float32
    ``torch.bmm``; the density-only path contracts with [1, 0, 0, 0], the
    same product, so its ρ is the DSF's density channel bit for bit.  (The
    four-row product is also the accurate one: on the H100 cuBLAS's
    one-row kernel summed the 10⁵ aligned phasors of a Bragg column to
    8.6e-6 of S(k), the four-row one to 8.5e-8.)  ``weights``, an optional
    (A,) per-atom weight (the mesh sweeps' membership), multiplies each
    atom's row of the contraction.
    """
    n_t, n_a, _ = pos.shape
    n_ch = acc_re.shape[2]
    t_chunk = time_tile(t_chunk, phase_mode)
    for t0 in range(0, n_t, t_chunk):
        t1 = min(t0 + t_chunk, n_t)
        cs = instant_phasors(pos[t0:t1], k_vectors, box, phase_mode)  # (tc, A, 2K)
        w = torch.zeros((t1 - t0, 4, n_a), dtype=torch.float32, device=pos.device)
        w[:, 0] = 1.0
        if vel is not None:
            w[:, 1:] = vel[t0:t1].transpose(1, 2)
        if weights is not None:
            w *= weights[None, None, :]
        f = torch.bmm(w, cs)[:, :n_ch]                                # (tc, C, 2K)
        del cs
        f_re, f_im = phasor_parts(f, phase_mode)
        acc_re[t0:t1] += f_re.transpose(1, 2)
        acc_im[t0:t1] += f_im.transpose(1, 2)


def instant_modes(pos: torch.Tensor, vel: torch.Tensor, k_vectors, t_chunk: int,
                  box: Optional[torch.Tensor] = None, phase_mode: str = 'exact'
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density + current modes of one atom block: (re, im), each
    (n_t, K, 4) float32, channels [ρ, j_x, j_y, j_z]."""
    acc = [torch.zeros((pos.shape[0], k_count(k_vectors), 4), dtype=torch.float32,
                       device=pos.device) for _ in range(2)]
    accumulate_modes(*acc, pos, vel, k_vectors, t_chunk, box, phase_mode)
    return acc[0], acc[1]


def density_modes(pos: torch.Tensor, k_vectors, t_chunk: int,
                  box: Optional[torch.Tensor] = None, phase_mode: str = 'exact'
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Density mode ρ_k(t) of one atom block: (re, im), each (n_t, K, 1)
    float32; the same contraction as :func:`instant_modes`' channel 0."""
    acc = [torch.zeros((pos.shape[0], k_count(k_vectors), 1), dtype=torch.float32,
                       device=pos.device) for _ in range(2)]
    accumulate_modes(*acc, pos, None, k_vectors, t_chunk, box, phase_mode)
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
    with profiling.span('psa.spectrum'):
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


def _atom_sum(x: torch.Tensor, weights: Optional[torch.Tensor]) -> torch.Tensor:
    """Σ over the atom axis (dim 1) of (rows, A, K), each atom weighted."""
    if weights is None:
        return x.sum(dim=1)
    return torch.einsum('rak,a->rk', x, weights.to(x.dtype))


def isf_self_block(pos: torch.Tensor, k_vectors, n_lags: int,
                   box: Optional[torch.Tensor] = None, phase_mode: str = 'exact',
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self ISF of one atom block: Σ_a Re ⟨e^{i k·(r_a(t'+τ) − r_a(t'))}⟩_{t'},
    (n_lags, K) float32, still missing the caller's 1/N (F_s(k,0) = 1).
    ``pos`` is (n_t, A, 3) with the full time axis; ``box``/``phase_mode``
    as in :func:`instant_phasors`; ``weights`` an optional (A,) per-atom
    weight of the sum."""
    sig = complex_phasors(instant_phasors(pos, k_vectors, box, phase_mode), phase_mode)
    return _atom_sum(_lagged_autocorr(sig, n_lags), weights).float()


def dsf_self_block(pos: torch.Tensor, k_vectors, freq_idx: torch.Tensor,
                   box: Optional[torch.Tensor] = None, phase_mode: str = 'exact',
                   weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Self intensity of one atom block: Σ_a |FFT_t e^{i k·r_a}|² / n_t² at
    the kept rows, (n_keep, K) float32, still missing the caller's 1/N.
    ``pos`` is (n_t, A, 3) with the full time axis; ``box``/``phase_mode``
    as in :func:`instant_phasors`; ``weights`` an optional (A,) per-atom
    weight of the sum."""
    n_t = pos.shape[0]
    sig = complex_phasors(instant_phasors(pos, k_vectors, box, phase_mode), phase_mode)
    spec = (torch.fft.fft(sig, dim=0) / n_t).index_select(0, freq_idx)
    return _atom_sum(spec.real ** 2 + spec.imag ** 2, weights).float()
