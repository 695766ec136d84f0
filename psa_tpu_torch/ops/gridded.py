"""Gridded (NUFFT-accelerated) k-grid projection on PyTorch (counterpart of
:mod:`psa_tpu.ops.gridded`), one device.

The direct projection costs O(n_t·N·Gx·Gy) for a Gx×Gy k-grid.  On a
uniform grid the x-axis factor exp(i·kx_i·x_a) is a type-1 non-uniform FFT,
so the engine is a hybrid:

* y axis (and the fixed k component): exact.  The per-atom phases
  exp(i·ky_j·y_a) are formed on the device in float64, folded by 2π, and
  cast to float32 before cos and sin;
* x axis: gridded.  Each atom spreads onto a σ = 2 oversampled fine x-line
  with a width-w Kaiser-Bessel window; an FFT along x recovers the modes,
  deconvolved by the window's analytic Fourier transform.

The products drop from 4·3·n_t·N·Gx·Gy to about 12·w·n_t·N·Gy flop, w = 8.

The scatter of a classical NUFFT is made of dense operations:

1. atoms are sorted by fine-x cell (host, once) and packed into balanced
   (n_rows, P) rows, one cell per row, crowded cells split over several
   consecutive rows (:func:`plan_kgrid`);
2. a batched IEEE float32 ``torch.bmm`` contracts the slots of each cell
   (all of its rows at once, so a cell's rows are summed inside the
   product) against the complex weight tensor (base phase × window × exact
   y phase); the three polarizations ride in its M axis;
3. the w window offsets fold into a local window by in-place adds on
   slices, or by ``index_add_`` on distinct rows (so the sum does not depend
   on the run), and the window lands on the cell axis cyclically, by
   slices.

The only approximation is the x window (w = 8, β = π·w·(1 − 1/2σ)): about
1e-6 relative.  The large-angle base phases (kx0·x_a, k_f·z_a) are made on
the host in float64.  The products are IEEE float32 at every precision tier
of the calculator, like the instantaneous-phase family's.

Signals are complex64 on the device.  Not carried over from the JAX module,
which needs them only on a TPU: the one-dispatch ``lax.scan`` form of the
time-chunk loop, the (re, im) float32 pair convention, buffer donation, the
padding of every row chunk to one compiled shape, and the host-allocator
arena of ``psa_tpu/utils/host_alloc.py`` (pinned staging buffers are
allocated once per sweep here).

:func:`gridded_kgrid_sharded` splits the ky axis into stripes over a list of
devices (a mesh's positions): every device holds the trajectory, or streams
it, and computes its own stripe; no collective.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..parallel.sharded import ArrayBlockSource  # noqa: F401 — the streamed sweep's source
from ..utils.transfer import DeviceToHost, HostToDevice, copy_rows, gather_atoms
from . import spectral

logger = logging.getLogger(__name__)

DEFAULT_W = 8          # spreading window width (cells)
DEFAULT_SIGMA = 2      # fine-grid oversampling factor


def _kb_window(x: np.ndarray, w: int, beta: float) -> np.ndarray:
    """Kaiser-Bessel ψ(x) on cell units, support |x| ≤ w/2 (float64)."""
    t = 1.0 - (2.0 * x / w) ** 2
    out = np.zeros_like(x)
    ok = t > 0
    out[ok] = np.i0(beta * np.sqrt(t[ok])) / np.i0(beta)
    return out


def _kb_fourier(xi: np.ndarray, w: int, beta: float) -> np.ndarray:
    """Continuous FT ψ̂(ξ) = ∫ψ(x)e^{-iξx}dx (float64; sinh branch)."""
    arg = beta ** 2 - (w * xi / 2.0) ** 2
    out = np.empty_like(xi)
    pos = arg > 0
    s = np.sqrt(arg[pos])
    out[pos] = (w / np.i0(beta)) * np.sinh(s) / s
    neg = ~pos
    s2 = np.sqrt(-arg[neg])
    with np.errstate(invalid='ignore', divide='ignore'):
        out[neg] = (w / np.i0(beta)) * np.where(s2 > 0, np.sin(s2) / s2, 1.0)
    return out


def is_uniform(vals: np.ndarray) -> bool:
    """True if ``vals`` is uniformly spaced to within float32 quantization.

    Grids from ``get_k_grid`` are float32 linspaces whose per-step jitter is
    about eps·|k|: fit the affine grid and bound the deviation by a few
    float32 ulps.  :func:`plan_kgrid` enforces it.
    """
    n = len(vals)
    if n <= 1:
        return True
    d = (float(vals[-1]) - float(vals[0])) / (n - 1)
    fit = float(vals[0]) + d * np.arange(n)
    tol = 32 * np.finfo(np.float32).eps * max(
        abs(float(vals[0])), abs(float(vals[-1])), abs(d))
    return float(np.max(np.abs(np.asarray(vals, dtype=np.float64) - fit))) <= tol


@dataclass
class GridPlan:
    """Host-precomputed spreading plan for one (mean positions, k-grid) pair.

    Atoms are packed into balanced rows of width P: each row holds slots of
    one fine cell, and cells with more than P atoms get several consecutive
    rows (``slot_cell`` maps row → cell, ascending).  A max-count-per-cell
    bucket layout pads crystals 2–5× (lattice sites alias onto few fine
    cells); balanced rows keep padding at the last-partial-row level.
    """
    order: np.ndarray          # (N,) atom permutation (sorted by fine-x cell)
    n_cells: int               # Fx = sigma * Gx
    bucket_size: int           # P, slots per row
    slot_cell: np.ndarray      # (n_rows,) i32 row -> fine cell (ascending)
    pad_mask: np.ndarray       # (n_rows, P) f32 1/0 valid-slot mask
    atom_of_slot: np.ndarray   # (n_rows, P) i32 atom feeding each slot (0 if pad)
    y_hi: np.ndarray           # (n_rows, P) f32 hi word of packed y coords
    y_lo: np.ndarray           # (n_rows, P) f32 lo word (hi + lo = the float64 y)
    ky_vals: np.ndarray        # (Gy,) f64 fast-axis grid values
    wx: np.ndarray             # (n_rows, P, w) f32 window weights (0 at pad slots)
    base_re: np.ndarray        # (n_rows, P) f32 Re exp(i(kx0·x + kf·z)), 0 at pad slots
    base_im: np.ndarray        # (n_rows, P) f32
    deconv_re: np.ndarray      # (Gx,) f32 1/ψ̂ per mode
    deconv_im: np.ndarray      # (Gx,) f32 (zero)
    gx: int
    gy: int
    w: int
    offsets: np.ndarray        # (w,) int window cell offsets

    @property
    def n_rows(self) -> int:
        return self.base_re.shape[0]


def plan_kgrid(mean_pos64: np.ndarray, kx_vals: np.ndarray, ky_vals: np.ndarray,
               k_fixed: float = 0.0, axes: Tuple[int, int, int] = (0, 1, 2),
               w: int = DEFAULT_W, sigma: int = DEFAULT_SIGMA) -> GridPlan:
    """Build the spreading plan.

    Args:
        mean_pos64: (N, 3) float64 mean positions.
        kx_vals / ky_vals: uniformly spaced grid values along the two plane
            axes (kx varies slowest in the output, matching ``get_k_grid``).
        k_fixed: the out-of-plane k component.
        axes: (x-axis, y-axis, fixed-axis) position-column indices for the
            plane (e.g. (0, 1, 2) for 'xy', (1, 2, 0) for 'yz').
    """
    n_atoms = mean_pos64.shape[0]
    gx, gy = len(kx_vals), len(ky_vals)
    if gx > 1:
        if not is_uniform(kx_vals):
            raise ValueError("kx_vals must be uniformly spaced for the gridded path")
        dkx = (float(kx_vals[-1]) - float(kx_vals[0])) / (gx - 1)
    else:
        dkx = 1.0
    kx0 = float(kx_vals[0])
    beta = np.pi * w * (1.0 - 1.0 / (2.0 * sigma))

    x = mean_pos64[:, axes[0]]
    y = mean_pos64[:, axes[1]]
    z = mean_pos64[:, axes[2]]

    n_cells = sigma * gx
    # fine-x coordinate: ux = (dkx·x mod 2π)·Fx/2π ∈ [0, Fx)
    phi = np.mod(dkx * x, 2.0 * np.pi)
    ux = phi * n_cells / (2.0 * np.pi)
    cell = np.floor(ux).astype(np.int64) % n_cells

    order = np.argsort(cell, kind='stable')
    cell_sorted = cell[order]
    counts = np.bincount(cell_sorted, minlength=n_cells)

    # Balanced rows: pick the row width P so that the padded slots
    # Σ_c ceil(count_c / P)·P stay near minimal.  Among near-minimal widths
    # take the largest P: it is the batched product's contraction length.
    def total_slots(p):
        return int(np.sum(-(-counts // p)) * p)
    # include the first width above max-count too: a cell of 12 atoms fits
    # one row of 16 (longer contraction) as cheaply as two of 8
    candidates = [p for p in (8, 16, 32, 64, 128, 256, 512, 1024)
                  if p // 2 < max(8, int(counts.max() or 1))]
    best = min(total_slots(p) for p in candidates)
    bucket_size = max(p for p in candidates
                      if total_slots(p) <= 1.25 * best)

    rows_per_cell = -(-counts // bucket_size)              # ceil
    row_start = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(rows_per_cell, out=row_start[1:])
    n_rows = int(row_start[-1])
    slot_cell = np.repeat(np.arange(n_cells, dtype=np.int32),
                          rows_per_cell)                   # (n_rows,)

    start = np.zeros(n_cells + 1, dtype=np.int64)
    np.cumsum(counts, out=start[1:])
    pos_in_cell = np.arange(n_atoms) - start[cell_sorted]
    row_of = row_start[cell_sorted] + pos_in_cell // bucket_size
    slot_of = pos_in_cell % bucket_size

    def packed(values, extra_shape=()):
        out = np.zeros((n_rows, bucket_size) + extra_shape, dtype=np.float64)
        out[row_of, slot_of] = values
        return out

    pad_mask = packed(np.ones(n_atoms))
    atom_of_slot = np.zeros((n_rows, bucket_size), dtype=np.int32)
    atom_of_slot[row_of, slot_of] = order
    y_packed64 = packed(y[order])
    y_hi = y_packed64.astype(np.float32)
    y_lo = (y_packed64 - y_hi.astype(np.float64)).astype(np.float32)

    offsets = np.arange(-(w // 2 - 1), w // 2 + 1)        # e.g. -3..4
    # window weights per atom/offset: ψ(cell + off − ux)
    dist = (cell[order][:, None] + offsets[None, :]) - ux[order][:, None]
    wx_vals = _kb_window(dist.astype(np.float64), w, beta)  # (N, w)
    wx = np.zeros((n_rows, bucket_size, w), dtype=np.float64)
    wx[row_of, slot_of] = wx_vals

    # Fold a half-band shift into the base weight so the recovered modes are
    # symmetric around zero (m' = m − Gx/2 ∈ [−Gx/2, Gx/2)): one-sided modes
    # would reach the fine-grid Nyquist where the window aliases (~0.3 error).
    m0 = gx // 2
    base = np.exp(1j * (kx0 * x[order] + k_fixed * z[order] + m0 * phi[order]))
    base_re = packed(base.real)
    base_im = packed(base.imag)

    # deconvolution per shifted mode m' = m − m0: 1/ψ̂(2πm'/Fx); |m'| ≤ Fx/4
    modes = np.arange(gx) - m0
    xi = 2.0 * np.pi * modes / n_cells
    deconv = 1.0 / _kb_fourier(xi, w, beta)

    logger.info("gridded plan: %d atoms -> %d cells, %d rows x %d slots "
                "(pad %.1f%%), window w=%d beta=%.2f", n_atoms, n_cells,
                n_rows, bucket_size,
                100.0 * (n_rows * bucket_size / max(n_atoms, 1) - 1.0), w, beta)

    return GridPlan(order=order, n_cells=n_cells, bucket_size=bucket_size,
                    slot_cell=slot_cell, pad_mask=pad_mask.astype(np.float32),
                    atom_of_slot=atom_of_slot, y_hi=y_hi, y_lo=y_lo,
                    ky_vals=np.asarray(ky_vals, dtype=np.float64),
                    wx=wx.astype(np.float32),
                    base_re=base_re.astype(np.float32), base_im=base_im.astype(np.float32),
                    deconv_re=deconv.astype(np.float32),
                    deconv_im=np.zeros_like(deconv, dtype=np.float32),
                    gx=gx, gy=gy, w=w, offsets=offsets)


#: Default device budget of one row-chunk's weight tensor.
DEFAULT_WEIGHT_BYTES = 2 * 2 ** 30
#: Default budget of the three polarizations' full-time grid accumulators of
#: one ky block: a resident sweep's, and a streamed one's (every ky block
#: re-reads the whole source, so streamed blocks are cut coarser).
GRID_BUDGET_RESIDENT, GRID_BUDGET_STREAMED = 1 << 30, 6 << 30
#: Default budget of one time chunk's transients (the packed data and the
#: spread products).
TRANSIENT_BYTES = 1 << 30


def cells_per_chunk(plan: GridPlan, weight_bytes: int = DEFAULT_WEIGHT_BYTES) -> int:
    """Largest row chunk whose weights (re and im, all of the plan's ky)
    fit ``weight_bytes``."""
    per_row = 2 * 4 * plan.bucket_size * plan.w * plan.gy
    return max(1, min(plan.n_rows, weight_bytes // max(per_row, 1)))


def _chunk_slot_ranges(plan: GridPlan, row_starts, row_chunk: int):
    """Per row-chunk [s0, s1) ranges into the sorted atom order.

    Atoms fill the balanced rows one after the other in sorted-by-cell
    order, so the atoms touched by rows [r0, r1) are ``plan.order[s0:s1]``
    with s0/s1 the cumulative real-slot counts: the streamed path uploads
    just that gather.
    """
    real_per_row = plan.pad_mask.sum(axis=1).astype(np.int64)
    cum = np.zeros(len(real_per_row) + 1, dtype=np.int64)
    np.cumsum(real_per_row, out=cum[1:])
    n_rows = plan.n_rows
    return {r0: (int(cum[r0]), int(cum[min(r0 + row_chunk, n_rows)]))
            for r0 in row_starts}


def _chunk_packed_tables(plan: GridPlan, row_starts, row_chunk: int, device,
                         local_slots: bool = False) -> Dict[int, dict]:
    """Upload each row-chunk's packed tables: N-sized data that crosses to
    the device once for the whole sweep.

    The rows of one fine cell are consecutive.  A chunk's rows are
    regrouped by how many rows their cell has in the chunk: the cells with r
    rows form one group, whose (cells, r·P) slot table lets one batched
    product contract all r rows of each cell at once, so a cell's rows are
    summed inside the product and nothing is summed over rows afterwards.
    Per chunk: ``groups`` (for each r: the cell count, the flat atom index of
    every slot, and for each window offset the window row of each cell, as
    device indices, or None where the cells are a contiguous run from 0), the
    complex base phase times the window ``bwx`` (R, P, w) and the packed
    float64 ``y``, both in group order, ``c_lo`` (the first cell the chunk
    touches) and ``n_seg`` (the cells it spans).

    ``local_slots`` maps each chunk's slots into the chunk's own compact
    atom slab (the position within ``plan.order[s0:s1]``, see
    :func:`_chunk_slot_ranges`): the streamed path packs from a per-chunk
    upload instead of a resident trajectory.
    """
    n_rows, p, w = plan.n_rows, plan.bucket_size, plan.w
    if local_slots:
        ranges = _chunk_slot_ranges(plan, row_starts, row_chunk)
        rank_of_atom = np.empty(plan.order.shape[0], dtype=np.int64)
        rank_of_atom[plan.order] = np.arange(plan.order.shape[0])

    def dev(x, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(device)

    tabs = {}
    for r0 in row_starts:
        r1 = min(r0 + row_chunk, n_rows)
        cells = plan.slot_cell[r0:r1].astype(np.int64)
        c_lo = int(cells[0])
        seg, first, counts = np.unique(cells - c_lo, return_index=True, return_counts=True)
        n_seg = int(seg[-1]) + 1
        if local_slots:
            # pad slots carry atom 0, whose place in the slab is arbitrary
            loc = rank_of_atom[plan.atom_of_slot[r0:r1]] - ranges[r0][0]
            slots = np.where(plan.pad_mask[r0:r1] > 0, loc, 0)
        else:
            slots = plan.atom_of_slot[r0:r1].astype(np.int64)
        groups, perm = [], []
        for r in np.unique(counts):
            sel = counts == r
            rows = (first[sel][:, None] + np.arange(r)[None, :]).reshape(-1)   # chunk-local
            perm.append(rows)
            run = bool(sel.all()) and n_seg == len(seg)     # every cell of 0..n_seg-1, in order
            groups.append({'r': int(r), 'cells': int(sel.sum()),
                           'slots': dev(slots[rows].reshape(-1), np.int64),
                           'win_rows': None if run else [dev(seg[sel] + di, np.int64)
                                                         for di in range(w)]})
        perm = np.concatenate(perm) + r0
        base = plan.base_re[perm].astype(np.complex64)
        base.imag = plan.base_im[perm]
        tabs[r0] = {'groups': groups, 'bwx': dev(base[:, :, None] * plan.wx[perm]),
                    'y': dev(plan.y_hi[perm].astype(np.float64) + plan.y_lo[perm]),
                    'c_lo': c_lo, 'n_seg': n_seg}
    return tabs


def _device_weights(tabs: dict, ky: torch.Tensor) -> torch.Tensor:
    """One row-chunk's spreading weights, built on the device:
    W[r, p, dx, g] = (base·ψx_dx)[r, p] · exp(i·ky_g·y[r, p]) as a float32
    (R, P, w·gy·2) tensor, re and im interleaved last, rows in the tables'
    group order.

    The angle ky·y is formed and folded by 2π in float64 from the packed
    float64 y and the float32 ``ky`` (the grid's values), then cast to
    float32 before cos and sin.  Only the N-sized tables cross to the
    device; the weights (16·w·N·Gy bytes for all rows) never exist whole.
    """
    r, p, w = tabs['bwx'].shape
    ang = tabs['y'].reshape(-1, 1) * ky.double()[None, :]
    turns = (ang / (2.0 * torch.pi)).round_()
    ang = ang.sub_(turns, alpha=2.0 * torch.pi).float()
    del turns
    wy = torch.complex(torch.cos(ang), torch.sin(ang)).view(r, p, 1, -1)
    del ang
    weights = tabs['bwx'][:, :, :, None] * wy                       # (R, P, w, gy) complex64
    return torch.view_as_real(weights).reshape(r, p, -1)


def _spread_cells(frames: torch.Tensor, weights: torch.Tensor, tabs: dict, p: int, w: int
                  ) -> torch.Tensor:
    """Spread one row-chunk over the (tc, atoms, 3) ``frames``: per group of
    cells one gather into the packed layout, one batched product, and the
    fold of the w window offsets.

    A group's cells have r rows each: their atoms are gathered on the device
    into (cells, 3·tc, r·P) (the polarizations times the frames in the
    product's M axis) and contracted against the group's (cells, r·P,
    w·gy·2) weights by one IEEE float32 ``torch.bmm``, which sums each
    cell's rows in its own fixed order.  The contribution of cell c at
    offset dx then lands on window row c + dx: an in-place add on a slice,
    or an ``index_add_`` whose target rows are distinct (no two additions
    race, so the sum is the same in every run).  Returns the (n_seg + w,
    3·tc, gy) complex64 window; the caller adds it into the cell axis
    cyclically.
    """
    tc = frames.shape[0]
    n_seg = tabs['n_seg']
    gy = weights.shape[2] // (2 * w)
    win = torch.zeros((n_seg + w, 3 * tc, gy), dtype=torch.complex64, device=frames.device)
    win_ri = torch.view_as_real(win)
    row = 0
    for group in tabs['groups']:
        r, n_c = group['r'], group['cells']
        packed = frames.index_select(1, group['slots'])               # (tc, cells·r·P, 3)
        packed = packed.view(tc, n_c, r * p, 3).permute(1, 3, 0, 2).reshape(n_c, 3 * tc, r * p)
        y = torch.bmm(packed, weights[row:row + n_c * r].view(n_c, r * p, -1))
        del packed
        y = y.view(n_c, 3 * tc, w, gy, 2)
        row += n_c * r
        for di in range(w):
            if group['win_rows'] is None:
                win_ri[di:di + n_c] += y[:, :, di]
            else:
                win_ri.index_add_(0, group['win_rows'][di], y[:, :, di])
    return win


def _add_cyclic(grid: torch.Tensor, win: torch.Tensor, start: int, t0: int, t1: int) -> None:
    """grid[:, (start + i) mod C, t0:t1] += win[i] for every window row i;
    ``grid`` is (3, C, n_t, gy) and ``win`` (rows, 3·(t1 − t0), gy)."""
    n_cells, rows = grid.shape[1], win.shape[0]
    win = win.view(rows, 3, t1 - t0, -1).transpose(0, 1)              # (3, rows, tc, gy)
    pos = 0
    while pos < rows:
        c0 = (start + pos) % n_cells
        n = min(rows - pos, n_cells - c0)
        grid[:, c0:c0 + n, t0:t1] += win[:, pos:pos + n]
        pos += n


def _spread_chunk(grid: torch.Tensor, data: torch.Tensor, tabs: dict, weights: torch.Tensor,
                  plan: GridPlan, t_chunk: int, grid_t0: int = 0) -> None:
    """Add one row-chunk's spread of ``data`` (n_frames, atoms, 3) into the
    (3, C, n_t, gy) grid, frames landing from row ``grid_t0`` on, in time
    chunks of ``t_chunk``."""
    win_start = (tabs['c_lo'] - (plan.w // 2 - 1)) % plan.n_cells
    for t0 in range(0, data.shape[0], t_chunk):
        t1 = min(t0 + t_chunk, data.shape[0])
        win = _spread_cells(data[t0:t1], weights, tabs, plan.bucket_size, plan.w)
        _add_cyclic(grid, win, win_start, grid_t0 + t0, grid_t0 + t1)


def _spread_gy_block(data: torch.Tensor, plan: GridPlan, packed_tabs, row_starts,
                     ky: torch.Tensor, n_t: int, t_chunk: int) -> torch.Tensor:
    """The full-time (3, C, n_t, gyc) complex64 grid of one ky block from a
    device-resident trajectory.  Rows outer, time chunks inner: each
    row-chunk's weights are built once and serve every time chunk."""
    grid = torch.zeros((3, plan.n_cells, n_t, len(ky)), dtype=torch.complex64,
                       device=data.device)
    for r0 in row_starts:
        weights = _device_weights(packed_tabs[r0], ky)
        _spread_chunk(grid, data, packed_tabs[r0], weights, plan, t_chunk)
        del weights
    return grid


def _spread_gy_blocks_streamed(src, plan: GridPlan, targets, row_starts, chunk_cols,
                               n_t: int, t_superchunk: int, t_chunk: int,
                               weight_cache_bytes: int) -> Tuple[list, int]:
    """Streamed form of :func:`_spread_gy_block` for a group too large for
    the device, feeding several ky blocks from one pass: ``targets`` is a
    list of (ky, tabs) pairs, each ky block on its own device (``ky``'s)
    with that device's packed tables.  The source is read once, in
    superchunks of ``t_superchunk`` frames; of each, every row-chunk's
    compact atom slab is gathered on the host once and crosses through
    pinned staging on a side stream to each device that takes it
    (:class:`~psa_tpu_torch.utils.transfer.HostToDevice`: the host gathers
    slab i+1 while the device spreads slab i).  A device holds two slabs and
    its grids, never the trajectory.  A target's row-chunk weights are kept
    across superchunks when they all fit ``weight_cache_bytes`` (they do not
    depend on time), else rebuilt.  Returns (grids, bytes moved to the
    devices)."""
    grids = [torch.zeros((3, plan.n_cells, n_t, len(ky)), dtype=torch.complex64,
                         device=ky.device) for ky, _ in targets]
    keep = [plan.n_rows * plan.bucket_size * plan.w * len(ky) * 8 <= weight_cache_bytes
            for ky, _ in targets]
    caches: List[Dict[int, torch.Tensor]] = [{} for _ in targets]
    a_max = max(max((c.size for c in chunk_cols.values()), default=1), 1)
    stagers: Dict[torch.device, HostToDevice] = {}
    for ky, _ in targets:
        if ky.device not in stagers:
            stagers[ky.device] = HostToDevice(ky.device, min(t_superchunk, n_t) * a_max * 3)
    for ts0 in range(0, n_t, t_superchunk):
        ts1 = min(ts0 + t_superchunk, n_t)
        slab = src.read_block(ts0, ts1, 0, src.n_atoms)                # (ts, N, 3) host
        for r0 in row_starts:
            cols, shape = chunk_cols[r0], (ts1 - ts0, chunk_cols[r0].size, 3)
            gathered, data = [], {}
            for dev, stager in stagers.items():
                def fill(dst):
                    if gathered:                    # gathered once, copied to the others
                        copy_rows(dst, gathered[0])
                    else:
                        gather_atoms(dst, slab, cols)
                        gathered.append(dst)
                data[dev] = stager.put(fill, shape)
            for j, (ky, tabs) in enumerate(targets):
                weights = caches[j].get(r0)
                if weights is None:
                    weights = _device_weights(tabs[r0], ky)
                    if keep[j]:
                        caches[j][r0] = weights
                _spread_chunk(grids[j], data[ky.device], tabs[r0], weights, plan, t_chunk,
                              grid_t0=ts0)
                del weights
    return grids, sum(st.bytes_moved for st in stagers.values())


def _streamed_budgets(plan: GridPlan, src, t_superchunk, data_budget_bytes, cell_chunk):
    """Validate a streamed source against the plan and derive the
    superchunk length and the row-chunk cap from the data budgets."""
    if src.n_atoms != plan.order.shape[0]:
        raise ValueError(f"streamed source has {src.n_atoms} atoms but "
                         f"the plan packs {plan.order.shape[0]}")
    n_t = src.n_frames
    if t_superchunk is None:
        # one host slab ~4 GB: sequential reads, bounded RAM
        t_superchunk = max(256, (4 << 30) // max(1, src.n_atoms * 12))
    t_superchunk = min(t_superchunk, n_t)
    # uploaded per (superchunk, row-chunk): (t_superchunk, atoms, 3) float32
    a_budget = max(plan.bucket_size,
                   data_budget_bytes // max(1, t_superchunk * 12))
    rows_budget = max(1, a_budget // plan.bucket_size)
    cell_chunk = min(cell_chunk or cells_per_chunk(plan), rows_budget)
    return n_t, t_superchunk, cell_chunk


def _streamed_tables(plan: GridPlan, src, row_starts, cell_chunk, n_t: int, t_superchunk: int):
    """Per row-chunk, the compact atom columns of a streamed sweep."""
    ranges = _chunk_slot_ranges(plan, row_starts, cell_chunk)
    chunk_cols = {r0: plan.order[s0:s1] for r0, (s0, s1) in ranges.items()}
    logger.info("gridded streamed sweep: %d frames x %d atoms via %d-frame superchunks, "
                "%d row-chunks (largest %d atoms)", n_t, src.n_atoms, t_superchunk,
                len(row_starts), max((c.size for c in chunk_cols.values()), default=0))
    return chunk_cols


def _finish_grid(grid: torch.Tensor, deconv: torch.Tensor, gx: int) -> torch.Tensor:
    """x-axis modes over the cell axis of one polarization's (C, n_t, gy)
    grid: S_m' = ifft·Fx at m' = m − Gx/2, deconvolved; (n_t, gx, gy)
    complex64."""
    spec = torch.fft.ifft(grid, dim=0) * grid.shape[0]
    spec = torch.roll(spec, gx // 2, dims=0)[:gx] * deconv[:, None, None]
    return spec.transpose(0, 1)


def _fft_take(sig: torch.Tensor, freq_idx: torch.Tensor) -> torch.Tensor:
    """FFT over time divided by n_t, at the kept rows."""
    return (torch.fft.fft(sig, dim=0) / sig.shape[0]).index_select(0, freq_idx)


class _Sweep:
    """What the browse, peaks and spectrum sweeps share: the chunk sizes,
    the packed tables on the device, and the grid of each ky block."""

    def __init__(self, data, plan: GridPlan, device, t_chunk, cell_chunk, gy_chunk,
                 t_superchunk=None, data_budget_bytes: int = 2 << 30,
                 grid_budget_bytes: Optional[int] = None,
                 weight_cache_bytes: int = 4 << 30):
        self.plan = plan
        self.streamed = hasattr(data, 'read_block')
        self.weight_cache_bytes = weight_cache_bytes
        self.bytes_streamed = 0
        if self.streamed:
            self.src = data
            self.device = torch.device(device)
            self.n_t, self.t_superchunk, cell_chunk = _streamed_budgets(
                plan, data, t_superchunk, data_budget_bytes, cell_chunk)
        else:
            if not isinstance(data, torch.Tensor):
                data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(device)
            self.data, self.device, self.n_t = data, data.device, data.shape[0]
        n_rows, p = plan.base_re.shape
        self.empty = n_rows == 0
        if self.empty:
            return
        if cell_chunk is None:
            cell_chunk = cells_per_chunk(plan)
        cell_chunk = min(cell_chunk, n_rows)                    # rows per chunk
        self.row_starts = list(range(0, n_rows, cell_chunk))
        if gy_chunk is None:
            # bound the three polarizations' full-time grids, the largest residents
            per_col = 6 * self.n_t * plan.n_cells * 4
            budget = grid_budget_bytes if grid_budget_bytes is not None else (
                GRID_BUDGET_STREAMED if self.streamed else GRID_BUDGET_RESIDENT)
            gy_chunk = max(1, min(plan.gy, budget // max(per_col, 1)))
        self.gy_chunk = gy_chunk
        gyc_max = min(gy_chunk, plan.gy)
        if t_chunk is None:
            # bound a time chunk's transients: the packed data (R, tc, P) and
            # the spread products (R, tc, w·gyc) re and im, per polarization
            per_frame = cell_chunk * p * 4 + cell_chunk * plan.w * gyc_max * 4 * 2
            t_chunk = max(64, min(self.n_t, TRANSIENT_BYTES // max(per_frame, 1)))
        self.t_chunk = min(t_chunk, self.t_superchunk) if self.streamed else t_chunk
        if len(self.row_starts) > 1:
            logger.info("gridded: %d rows in %d chunks of %d", n_rows, len(self.row_starts),
                        cell_chunk)
        self.tabs = _chunk_packed_tables(plan, self.row_starts, cell_chunk, self.device,
                                         local_slots=self.streamed)
        if self.streamed:
            self.chunk_cols = _streamed_tables(plan, data, self.row_starts, cell_chunk,
                                               self.n_t, self.t_superchunk)
        self.deconv = torch.from_numpy(plan.deconv_re).to(self.device)

    def block_bounds(self, g_lo: int = 0, g_hi: Optional[int] = None):
        """(g0, g1) of the ky blocks of columns [g_lo, g_hi)."""
        g_hi = self.plan.gy if g_hi is None else g_hi
        return [(g0, min(g0 + self.gy_chunk, g_hi)) for g0 in range(g_lo, g_hi, self.gy_chunk)]

    def ky(self, g0: int, g1: int) -> torch.Tensor:
        return torch.from_numpy(self.plan.ky_vals[g0:g1].astype(np.float32)).to(self.device)

    def blocks(self, g_lo: int = 0, g_hi: Optional[int] = None):
        """Yield (g0, g1, grid): the (3, C, n_t, g1 − g0) complex64 grid of
        each ky block of columns [g_lo, g_hi)."""
        for g0, g1 in self.block_bounds(g_lo, g_hi):
            ky = self.ky(g0, g1)
            if self.streamed:
                (grid,), moved = _spread_gy_blocks_streamed(
                    self.src, self.plan, [(ky, self.tabs)], self.row_starts, self.chunk_cols,
                    self.n_t, self.t_superchunk, self.t_chunk, self.weight_cache_bytes)
                self.bytes_streamed += moved
            else:
                grid = _spread_gy_block(self.data, self.plan, self.tabs, self.row_starts, ky,
                                        self.n_t, self.t_chunk)
            yield g0, g1, grid

    def reduce(self, grid: torch.Tensor, freq_dev: torch.Tensor, comp_pair,
               angle_range_opt: str, n_peaks: Optional[int], fkept_dev, exclusion_bins: int,
               width_method: str) -> torch.Tensor:
        """One ky block's grid → (n_out, lead, gx·gyc) float32 on the device:
        the intensity (and chiral phase) at the kept rows, or its peaks."""
        gx, n_t = self.plan.gx, self.n_t
        inten, kept = None, {}
        for pol in range(3):
            spec = _fft_take(_finish_grid(grid[pol], self.deconv, gx).reshape(n_t, -1),
                             freq_dev)                                  # (n_f, gx·gyc)
            part = spec.real ** 2 + spec.imag ** 2
            inten = part if inten is None else inten + part
            if comp_pair is not None and pol in comp_pair:
                kept[pol] = spec
        if n_peaks is not None:
            return torch.stack(spectral.peak_reduce(
                inten, fkept_dev, n_peaks=n_peaks, exclusion_bins=exclusion_bins,
                width_method=width_method))
        if comp_pair is not None:
            return torch.stack([inten, spectral.chiral_phase(
                kept[comp_pair[0]], kept[comp_pair[1]], angle_range_opt=angle_range_opt)])
        return inten[None]


def gridded_kgrid_browse(data, plan: GridPlan, freq_idx: np.ndarray,
                         comp_pair: Optional[Tuple[int, int]] = None,
                         angle_range_opt: str = 'C',
                         t_chunk: Optional[int] = None,
                         cell_chunk: Optional[int] = None,
                         gy_chunk: Optional[int] = None,
                         precision: str = 'parity',
                         n_peaks: Optional[int] = None,
                         exclusion_bins: int = 4,
                         freqs_kept: Optional[np.ndarray] = None,
                         width_method: str = 'rms',
                         t_superchunk: Optional[int] = None,
                         data_budget_bytes: int = 2 << 30,
                         grid_budget_bytes: Optional[int] = None,
                         weight_cache_bytes: int = 4 << 30,
                         device: Union[str, torch.device] = 'cuda',
                         stats: Optional[dict] = None):
    """NUFFT k-grid sweep fused with the time FFT and the browse reduction.

    The projected signal stays on the device in ky-column blocks: assembled
    across time chunks, FFT'd, filtered to ``freq_idx`` rows and reduced to
    intensity (and the chiral phase for ``comp_pair``), so only the filtered
    float32 planes cross to the host, block by block through a one-deep
    pinned readback.

    Args:
        data: (n_t, N, 3) float32, a tensor on its device or a host array
            (sent to ``device``); or, for a group too large for the device,
            a source with ``n_frames``/``n_atoms``/``read_block(t0, t1, a0,
            a1)`` over the plan's N atoms (:class:`ArrayBlockSource`): the
            sweep then streams time superchunks from it to ``device`` and
            holds two compact atom slabs and the grid there, never the
            trajectory.  The atom axis must match the plan's.
        plan: from :func:`plan_kgrid`.
        freq_idx: (n_keep,) kept frequency rows.
        comp_pair: polarization pair for the chiral phase, or None.
        cell_chunk: packing rows per weight-tensor chunk (None: a 2 GB
            weight budget; the streamed path also caps it by
            ``data_budget_bytes``).
        gy_chunk: ky columns per device-resident block (None: the three
            polarizations' full-time grids within ``grid_budget_bytes``,
            1 GB resident and 6 GB streamed by default; every ky block of a
            streamed sweep re-reads the whole source).
        t_chunk: frames per spread (None: about 1 GB of transients).
        precision: accepted for the calculator's tiers; the products are
            IEEE float32 at each.
        t_superchunk: streamed only, frames per host read (None: a 4 GB
            slab).
        data_budget_bytes: streamed only, cap on one uploaded slab.
        weight_cache_bytes: streamed only, keep the row-chunks' weights
            across superchunks when they fit this.
        stats: an optional dict that receives ``bytes_streamed``.

    With ``n_peaks`` (needs ``freqs_kept``, the THz values of the kept rows;
    exclusive with ``comp_pair``) each block's intensity reduces further to
    its top peaks on the device, and only the (3, n_peaks, Gx·Gy) triplets
    cross.

    Returns:
        (intensity (n_keep, Gx·Gy) float32, phase or None), or with
        ``n_peaks``: (peak_freq, peak_height, peak_width), each
        (n_peaks, Gx·Gy) float32.
    """
    spectral.check_precision(precision)
    if n_peaks is not None:
        if comp_pair is not None:
            raise ValueError("peaks mode is exclusive with comp_pair")
        if freqs_kept is None:
            raise ValueError("peaks mode needs freqs_kept")
    sweep = _Sweep(data, plan, device, t_chunk, cell_chunk, gy_chunk, t_superchunk,
                   data_budget_bytes, grid_budget_bytes, weight_cache_bytes)
    gx, gy, n_t = plan.gx, plan.gy, sweep.n_t
    n_f = int(len(freq_idx))
    lead = n_peaks if n_peaks is not None else n_f
    n_out = 3 if n_peaks is not None else (2 if comp_pair is not None else 1)
    full = np.zeros((n_out, lead, gx, gy), dtype=np.float32)
    if not sweep.empty:                       # an empty atom set gives zero spectra
        dev = sweep.device
        freq_dev = torch.from_numpy(np.asarray(freq_idx, dtype=np.int64)).to(dev)
        fkept_dev = (torch.from_numpy(np.asarray(freqs_kept, np.float32)).to(dev)
                     if n_peaks is not None else None)
        readback = DeviceToHost(dev)
        for g0, g1, grid in sweep.blocks():
            out = sweep.reduce(grid, freq_dev, comp_pair, angle_range_opt, n_peaks, fkept_dev,
                               exclusion_bins, width_method)
            del grid

            def sink(arrays, g0=g0, g1=g1):
                full[:, :, :, g0:g1] = arrays[0].reshape(n_out, lead, gx, g1 - g0)
            readback.push([out], sink)
        readback.finish()
    if stats is not None:
        stats['bytes_streamed'] = sweep.bytes_streamed
    full = full.reshape(n_out, lead, gx * gy)
    if n_peaks is not None:
        return tuple(full)
    return full[0], (full[1] if comp_pair is not None else None)


def gridded_kgrid_spectrum(data, plan: GridPlan,
                           t_chunk: Optional[int] = None,
                           cell_chunk: Optional[int] = None,
                           gy_chunk: Optional[int] = None,
                           precision: str = 'parity',
                           time_fft: bool = False,
                           grid_budget_bytes: Optional[int] = None,
                           device: Union[str, torch.device] = 'cuda') -> np.ndarray:
    """SED projection S[t, i·Gy + j, pol] over the planned k-grid, a host
    complex64 array (n_t, Gx·Gy, 3): the projected signal before the time
    FFT, or with ``time_fft`` its spectrum FFT_t[S]/n_t (each ky block is
    transformed on the device before it crosses, through a one-deep pinned
    readback).

    Shares the browse path's loops (ky blocks → row chunks → time chunks);
    ``data``, ``t_chunk``, ``cell_chunk``, ``gy_chunk``, ``precision`` and
    ``device`` as in :func:`gridded_kgrid_browse` (resident data only).
    """
    spectral.check_precision(precision)
    sweep = _Sweep(data, plan, device, t_chunk, cell_chunk, gy_chunk,
                   grid_budget_bytes=grid_budget_bytes)
    gx, gy, n_t = plan.gx, plan.gy, sweep.n_t
    out = np.zeros((n_t, gx, gy, 3), dtype=np.complex64)
    if sweep.empty:                           # an empty atom set gives a zero signal
        return out.reshape(n_t, gx * gy, 3)
    readback = DeviceToHost(sweep.device)
    for g0, g1, grid in sweep.blocks():
        for pol in range(3):
            sig = _finish_grid(grid[pol], sweep.deconv, gx)                # (n_t, gx, gyc)
            if time_fft:
                sig = torch.fft.fft(sig, dim=0) / n_t

            def sink(arrays, g0=g0, g1=g1, pol=pol):
                out[:, :, g0:g1, pol] = arrays[0]
            readback.push([sig.contiguous()], sink)
        del grid
    readback.finish()
    return out.reshape(n_t, gx * gy, 3)


def _replicate_per_device(data, plan: GridPlan, devs, *sweep_args) -> Dict[torch.device, _Sweep]:
    """One :class:`_Sweep` per distinct device of ``devs``: a resident
    ``data`` and the packed tables are sent to each device once, however many
    stripes it runs (a streamed source stays on the host)."""
    if not hasattr(data, 'read_block') and not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32))
    sweeps: Dict[torch.device, _Sweep] = {}
    for d in devs:
        if d not in sweeps:
            sweeps[d] = _Sweep(data if hasattr(data, 'read_block') else data.to(d), plan, d,
                               *sweep_args)
    return sweeps


def gridded_kgrid_sharded(data, plan: GridPlan, freq_idx: np.ndarray, devices,
                          freqs_kept: Optional[np.ndarray] = None,
                          n_peaks: Optional[int] = None,
                          exclusion_bins: int = 4,
                          width_method: str = 'rms',
                          comp_pair: Optional[Tuple[int, int]] = None,
                          angle_range_opt: str = 'C',
                          precision: str = 'parity',
                          t_chunk: Optional[int] = None,
                          cell_chunk: Optional[int] = None,
                          gy_chunk: Optional[int] = None,
                          t_superchunk: Optional[int] = None,
                          data_budget_bytes: int = 2 << 30,
                          grid_budget_bytes: Optional[int] = None,
                          weight_cache_bytes: int = 4 << 30,
                          stats: Optional[dict] = None):
    """Multi-device NUFFT k-grid sweep: ky stripes over ``devices``.

    The plan is separable along the fast (ky) axis, so the devices split
    the ky columns into ``min(len(devices), Gy)`` contiguous stripes and
    each runs the whole spread → x-FFT → time FFT → reduction of
    :func:`gridded_kgrid_browse` on its own; no collective, only the reduced
    outputs come back, once every stripe's work is enqueued.  Devices may
    repeat (a virtual mesh on one card); the data and the packed tables are
    sent once to each distinct device.

    ``data`` is a tensor or host array (every device holds it whole), or a
    source with ``read_block`` for a group too large for a device (streamed
    mode: in rounds of one ky block per device, one pass over the source
    feeds every device's block, each row-chunk's slab gathered on the host
    once).  The other arguments as in :func:`gridded_kgrid_browse`.

    Returns:
        (intensity (n_keep, Gx·Gy) float32, phase or None), or with
        ``n_peaks`` (peak_freq, peak_height, peak_width), each
        (n_peaks, Gx·Gy) float32.
    """
    spectral.check_precision(precision)
    if n_peaks is not None:
        if comp_pair is not None:
            raise ValueError("peaks mode is exclusive with comp_pair")
        if freqs_kept is None:
            raise ValueError("peaks mode needs freqs_kept")
    gx, gy = plan.gx, plan.gy
    devs = [torch.device(d) for d in devices][:max(1, min(len(devices), gy))]
    streamed = hasattr(data, 'read_block')
    sweeps = _replicate_per_device(data, plan, devs, t_chunk, cell_chunk, gy_chunk, t_superchunk,
                                   data_budget_bytes, grid_budget_bytes, weight_cache_bytes)
    n_f = int(len(freq_idx))
    lead = n_peaks if n_peaks is not None else n_f
    n_out = 3 if n_peaks is not None else (2 if comp_pair is not None else 1)
    full = np.zeros((n_out, lead, gx, gy), dtype=np.float32)
    first = sweeps[devs[0]]
    if not first.empty:
        stripes = [round(i * gy / len(devs)) for i in range(len(devs) + 1)]
        per_dev = [sweeps[d].block_bounds(stripes[i], stripes[i + 1])
                   for i, d in enumerate(devs)]
        consts = {d: (torch.from_numpy(np.asarray(freq_idx, dtype=np.int64)).to(d),
                      None if n_peaks is None else
                      torch.from_numpy(np.asarray(freqs_kept, np.float32)).to(d))
                  for d in sweeps}
        parts = []

        def finish(d, g0, g1, grid):
            parts.append((g0, g1, sweeps[d].reduce(
                grid, consts[d][0], comp_pair, angle_range_opt, n_peaks, consts[d][1],
                exclusion_bins, width_method)))

        for rnd in range(max(len(b) for b in per_dev)):
            todo = [(d, *blocks[rnd]) for d, blocks in zip(devs, per_dev) if rnd < len(blocks)]
            if streamed:
                targets = [(sweeps[d].ky(g0, g1), sweeps[d].tabs) for d, g0, g1 in todo]
                grids, moved = _spread_gy_blocks_streamed(
                    first.src, plan, targets, first.row_starts, first.chunk_cols, first.n_t,
                    first.t_superchunk, first.t_chunk, weight_cache_bytes)
                first.bytes_streamed += moved
                for (d, g0, g1), grid in zip(todo, grids):
                    finish(d, g0, g1, grid)
                del grids
            else:
                for d, g0, g1 in todo:
                    sw = sweeps[d]
                    finish(d, g0, g1, _spread_gy_block(sw.data, plan, sw.tabs, sw.row_starts,
                                                       sw.ky(g0, g1), sw.n_t, sw.t_chunk))
        for g0, g1, out in parts:                    # read back once all is enqueued
            full[:, :, :, g0:g1] = out.cpu().numpy().reshape(n_out, lead, gx, g1 - g0)
    if stats is not None:
        stats['bytes_streamed'] = first.bytes_streamed
    full = full.reshape(n_out, lead, gx * gy)
    if n_peaks is not None:
        return tuple(full)
    return full[0], (full[1] if comp_pair is not None else None)


def gridded_kgrid_peaks_sharded(data, plan: GridPlan, freq_idx: np.ndarray,
                                freqs_kept: np.ndarray, devices,
                                n_peaks: int = 1, exclusion_bins: int = 4,
                                width_method: str = 'rms', **kwargs):
    """Peaks mode of :func:`gridded_kgrid_sharded`."""
    return gridded_kgrid_sharded(data, plan, freq_idx, devices, freqs_kept=freqs_kept,
                                 n_peaks=n_peaks, exclusion_bins=exclusion_bins,
                                 width_method=width_method, **kwargs)
