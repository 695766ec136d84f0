"""Real-space structure on PyTorch (counterpart of
:mod:`psa_tpu.ops.structure`): the radial distribution function g(r).

The equal-time pair-correlation companion of the reciprocal-space S(k)
(:func:`psa_tpu_torch.ops.instantaneous.sk_reduce`): coordination shells
for crystals and the short-range order of liquids and glasses.

Pair separations of a (frames × A-block × B-block) tile are formed as three
(t, A, B) float32 planes, minimum-imaged through the full cell matrix
(triclinic-safe: the fractional separation is rounded) with scalar
multiplies of the 3×3 entries, which are IEEE float32 whatever the matmul
settings are, and histogrammed by ``torch.bucketize`` against the float32
bin edges followed by one integer ``torch.bincount`` of the pairs inside the
range: bin b holds the pairs with edge_{b−1} ≤ r < edge_b, exactly the JAX
package's cumulative edge-comparison count differenced.  Counts are int64
and exact at any trajectory size.  Nothing is padded: the last tile of a
sweep is a ragged slice, and the B side of a tile may be wider than its A
side.

The linked-cell path cuts the pair count to the 27 wrapped neighbour cells
of each cell; its bucketing (an O(N) sort per frame) stays on the host in
NumPy, carried over unchanged.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ['rdf_block', 'rdf_sweep', 'rdf_cells_sweep', 'bucketize_frames',
           'neighbor_table', 'cell_counts', 'PAIR_BYTES']

#: Device bytes per pair of a tile at the peak of :func:`_pair_hist`: the
#: three separation planes and the three fractional planes (24) and the
#: rounding's temporary (4), later the distance beside its bin index and the
#: in-range mask; rounded up for the allocator.  Frame chunks are sized by it.
PAIR_BYTES = 32


def _edges(r_max: float, n_bins: int, device) -> torch.Tensor:
    """Upper bin edges in float32, formed as the JAX package forms them (a
    float32 width times 1 … n_bins), so a pair on an edge falls alike."""
    width = np.float32(r_max) / np.float32(n_bins)
    return torch.arange(1, n_bins + 1, dtype=torch.float32, device=device) * float(width)


def _combine(planes, coeffs, out=None) -> torch.Tensor:
    """Σ_j coeffs[j] · planes[j] in float32, terms with a zero coefficient
    left out (an orthorhombic cell needs one multiply per component); into
    ``out`` when given (which must be none of the planes still to be read)."""
    terms = [(p, float(c)) for p, c in zip(planes, coeffs) if c != 0.0]
    if not terms:
        return torch.zeros_like(planes[0]) if out is None else out.zero_()
    acc = torch.mul(terms[0][0], terms[0][1], out=out)
    for plane, c in terms[1:]:
        acc.add_(plane, alpha=c)
    return acc


def _pair_hist(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor,
               invalid: torch.Tensor, h, h_inv, edges: torch.Tensor) -> torch.Tensor:
    """(n_bins,) int64 histogram of the minimum-image lengths of the
    separations (dx, dy, dz), three float32 planes of one shape that are
    overwritten.  ``invalid`` (broadcastable to that shape) marks pairs that
    do not count; ``h``/``h_inv`` are host (3, 3) arrays (columns = cell
    vectors, Cartesian = H @ fractional)."""
    h = np.asarray(h, dtype=np.float32)
    h_inv = np.asarray(h_inv, dtype=np.float32)
    n_bins = edges.shape[0]
    frac = []
    for i in range(3):
        f = _combine((dx, dy, dz), h_inv[i])
        f.sub_(torch.round(f))                  # half to even, like jnp.round
        frac.append(f)
    for i, d in enumerate((dx, dy, dz)):        # the planes' storage is free now
        _combine(frac, h[i], out=d)
    r = frac[0]
    del frac
    torch.mul(dx, dx, out=r)
    r.addcmul_(dy, dy).addcmul_(dz, dz).sqrt_()
    r.masked_fill_(invalid, float('inf'))       # beyond every edge
    idx = torch.bucketize(r, edges, right=True, out_int32=True)
    # Only the pairs inside the range are counted: most pairs of a large cell
    # lie beyond r_max, and one bin taking them all serializes the histogram.
    return torch.bincount(idx[idx < n_bins], minlength=n_bins)


def _tile_hist(pos_a, pos_b, h, h_inv, edges, a_ids, b_ids) -> torch.Tensor:
    dx, dy, dz = (pos_a[:, :, None, c] - pos_b[:, None, :, c] for c in range(3))
    invalid = (a_ids[:, None] == b_ids[None, :])[None]
    return _pair_hist(dx, dy, dz, invalid, h, h_inv, edges)


def rdf_block(pos_a: torch.Tensor, pos_b: torch.Tensor, h, h_inv, r_max: float,
              n_bins: int, a_ids: torch.Tensor, b_ids: torch.Tensor) -> torch.Tensor:
    """Pair-distance histogram of one (frames × A-block × B-block) tile.

    Args:
        pos_a: (t, A, 3) float32; pos_b: (t, B, 3) float32, the same frames.
        h: (3, 3) cell matrix on the host (columns = cell vectors);
            h_inv: its inverse.  The minimum image rounds the fractional
            separation: exact for orthorhombic cells and for tilts within
            the LAMMPS bounds (|tilt| ≤ L/2).
        r_max: histogram range [0, r_max), bin width r_max / n_bins.
        n_bins: bin count.
        a_ids, b_ids: (A,) / (B,) integer global atom ids.  Pairs of equal
            id are dropped: the i == j self pairs go by identity, not by
            r ≈ 0, so coincident distinct atoms still count, and cross
            groups with overlapping membership work.

    Returns:
        (n_bins,) int64 pair counts, summed over the tile's frames; both
        (i, j) and (j, i) count when the caller tiles the full A×B square.
    """
    edges = _edges(r_max, n_bins, pos_a.device)
    return _tile_hist(pos_a.float(), pos_b.float(), h, h_inv, edges, a_ids, b_ids)


def rdf_sweep(pos_a: torch.Tensor, a_ids: torch.Tensor, pos_b: torch.Tensor,
              b_ids: torch.Tensor, h, h_inv, r_max: float, n_bins: int, block: int,
              b_block: Optional[int] = None) -> torch.Tensor:
    """Full A×B pair histogram of one frame chunk: (n_bins,) int64.

    A Python loop over A rows of ``block`` atoms and B tiles of ``b_block``
    atoms (default ``block``), one (t, block, b_block) tile resident per
    step; the last tile of each side is ragged.

    Args:
        pos_a: (t, N_a, 3) float32 with its ids ``a_ids`` (N_a,); the same
            for the B side (pass the A tensors again for a same-group g(r)).
        h, h_inv, r_max, n_bins: as in :func:`rdf_block`.
    """
    b_block = b_block or block
    edges = _edges(r_max, n_bins, pos_a.device)
    pos_a, pos_b = pos_a.float(), pos_b.float()
    counts = torch.zeros(n_bins, dtype=torch.int64, device=pos_a.device)
    for a0 in range(0, pos_a.shape[1], block):
        pa, ida = pos_a[:, a0:a0 + block], a_ids[a0:a0 + block]
        for b0 in range(0, pos_b.shape[1], b_block):
            counts += _tile_hist(pa, pos_b[:, b0:b0 + b_block], h, h_inv, edges,
                                 ida, b_ids[b0:b0 + b_block])
    return counts


# ----------------------------------------------------------------------
# Cell-list (linked-cell) pair sweep: O(N · density · r_max³) instead of
# O(N²).  For large systems with a short histogram range (the usual liquid
# g(r): r_max ≪ L) the MD cell decomposition cuts the pair count by about
# n_cells/27.  Buckets have a fixed capacity (padded with −1), so a cell
# block's pairs are one dense (t, cells, C_a, 27·C_b) tile; the minimum
# image and the binning are the brute sweep's.  Bucketing stays on the
# host: it is data-dependent bookkeeping.
# ----------------------------------------------------------------------

def cell_counts(frac: np.ndarray, n_cells_xyz) -> np.ndarray:
    """Linear cell id per atom from wrapped fractional coordinates.

    Args:
        frac: (..., 3) float in [0, 1) (values at exactly 1.0 from float64
            roundoff are clipped into the last cell).
        n_cells_xyz: (nx, ny, nz) ints.

    Returns:
        (...,) int64 linear cell ids, x-major (matches neighbor_table).
    """
    n = np.asarray(n_cells_xyz, dtype=np.int64)
    ci = np.minimum((frac * n).astype(np.int64), n - 1)
    ci = np.maximum(ci, 0)
    return (ci[..., 0] * n[1] + ci[..., 1]) * n[2] + ci[..., 2]


def bucketize_frames(lin: np.ndarray, n_atoms: int, n_cells: int,
                     nc_pad: int, capacity: int) -> np.ndarray:
    """Fixed-capacity cell buckets for a chunk of frames (host side).

    Args:
        lin: (t, N) int linear cell ids (from :func:`cell_counts`).
        n_atoms: N (bucket entries index the compact group, 0..N-1).
        n_cells: real cell count; nc_pad ≥ n_cells + 1: the cells beyond
            stay empty (the +1 guarantees an all-empty sentinel cell for
            the neighbour table's dedup to point at).
        capacity: max atoms per cell over the chunk (caller-measured).

    Returns:
        (t, nc_pad, capacity) int32 atom indices, -1 where empty.
    """
    t = lin.shape[0]
    idx = np.full((t, nc_pad, capacity), -1, dtype=np.int32)
    for f in range(t):
        order = np.argsort(lin[f], kind='stable')
        cells = lin[f][order]
        # rank within cell = position in the sorted run
        first = np.searchsorted(cells, cells, side='left')
        ranks = np.arange(n_atoms) - first
        idx[f, cells, ranks] = order.astype(np.int32)
    return idx


def neighbor_table(n_cells_xyz, nc_pad: int) -> np.ndarray:
    """(27, nc_pad) int32 neighbour cell ids with periodic wrap.

    Duplicate stencil entries (dims with fewer than 3 cells wrap onto the
    same cell) and all entries of the cells beyond the grid point at the
    empty sentinel cell ``nc_pad - 1``, so each real (cell, neighbour) pair
    is visited exactly once: the sweep stays correct down to a single cell
    per dim.
    """
    nx, ny, nz = (int(v) for v in n_cells_xyz)
    nc = nx * ny * nz
    if nc_pad < nc + 1:
        raise ValueError("nc_pad must leave at least one empty sentinel cell")
    empty = nc_pad - 1
    cx, cy, cz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing='ij')
    cx, cy, cz = cx.ravel(), cy.ravel(), cz.ravel()
    arr = np.empty((27, nc), dtype=np.int32)
    o = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                arr[o] = (((cx + dx) % nx) * ny + (cy + dy) % ny) * nz \
                    + (cz + dz) % nz
                o += 1
    arr = np.sort(arr, axis=0)          # order within the stencil is free
    dup = np.zeros_like(arr, dtype=bool)
    dup[1:] = arr[1:] == arr[:-1]
    arr[dup] = empty
    out = np.full((27, nc_pad), empty, dtype=np.int32)
    out[:, :nc] = arr
    return out


def _bucket_gather(pos: torch.Tensor, gid: torch.Tensor, idx: torch.Tensor):
    """(t, N, 3) positions and (N,) ids × (t, ..., C) int64 bucket indices →
    ((t, ..., C, 3) positions, (t, ..., C) ids, (t, ..., C) empty mask).
    Empty slots (−1) gather row 0 and are masked."""
    empty = idx < 0
    safe = idx.clamp(min=0)
    frame = torch.arange(pos.shape[0], device=pos.device).reshape((-1,) + (1,) * (idx.dim() - 1))
    return pos[frame, safe], gid[safe], empty


def rdf_cells_sweep(pos_a: torch.Tensor, idx_a: torch.Tensor, gid_a: torch.Tensor,
                    pos_b: torch.Tensor, idx_b: torch.Tensor, gid_b: torch.Tensor,
                    neigh: torch.Tensor, h, h_inv, r_max: float, n_bins: int,
                    cell_block: int) -> torch.Tensor:
    """Cell-list pair histogram of one frame chunk: (n_bins,) int64.

    For every A cell, distances go only to the 27 wrapped neighbour cells
    on the B side: exact for any cell grid built with cell width ≥ r_max
    per dim (and below that too: the wrap dedup of :func:`neighbor_table`
    collapses the stencil onto the whole box).  Positions must be wrapped
    into the cell (the bucket assignment assumes it); distances are still
    minimum-imaged through the full cell matrix, so boundary pairs are
    exact.  A Python loop over blocks of ``cell_block`` cells (the last one
    ragged); a block's 27 neighbour buckets are gathered side by side, so
    one (t, cells, C_a, 27·C_b) tile is resident per step.

    Args:
        pos_a: (t, N_a, 3) float32 wrapped Cartesian positions (compact group).
        idx_a: (t, nc_pad, C_a) integer buckets from :func:`bucketize_frames`.
        gid_a: (N_a,) integer global atom ids (self and overlap pairs drop
            by id equality, as in :func:`rdf_block`).
        pos_b/idx_b/gid_b: the same for the B side (pass A's for same-group).
        neigh: (27, nc_pad) integer table from :func:`neighbor_table`.
        h, h_inv, r_max, n_bins: as in :func:`rdf_block`.
    """
    edges = _edges(r_max, n_bins, pos_a.device)
    pos_a, pos_b = pos_a.float(), pos_b.float()
    idx_a, idx_b, neigh = idx_a.long(), idx_b.long(), neigh.long()   # once per chunk
    n_t, nc_pad = idx_a.shape[0], idx_a.shape[1]
    counts = torch.zeros(n_bins, dtype=torch.int64, device=pos_a.device)
    for c0 in range(0, nc_pad, cell_block):
        pa, ga, ea = _bucket_gather(pos_a, gid_a, idx_a[:, c0:c0 + cell_block])   # (t, cb, Ca[, 3])
        n_cb = pa.shape[1]
        nb = neigh[:, c0:c0 + cell_block].T                                        # (cb, 27)
        pb, gb, eb = _bucket_gather(pos_b, gid_b, idx_b[:, nb].reshape(n_t, n_cb, -1))
        dx, dy, dz = (pa[:, :, :, None, c] - pb[:, :, None, :, c] for c in range(3))
        invalid = (ea[:, :, :, None] | eb[:, :, None, :]
                   | (ga[:, :, :, None] == gb[:, :, None, :]))
        counts += _pair_hist(dx, dy, dz, invalid, h, h_inv, edges)
    return counts
