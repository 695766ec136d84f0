"""The SED projection: phase angles, [cos|sin] and the atom contraction.

Counterpart of :mod:`psa_tpu.ops.pallas_sed`.  Computes

    out_re[t, c, k] = Σ_a data[t, a, c] · cos A[a, k]
    out_im[t, c, k] = Σ_a data[t, a, c] · sin A[a, k]
    A[a, k]         = (mp_hi + mp_lo)_a · k_k, folded into [−π, π]

:func:`sed_projection` is the kernels' wrapper: a CPU tensor goes to the
plain PyTorch version :func:`sed_projection_plain`; a CUDA tensor launches
the hand-written kernels or raises.  Both take ``out=(re, im)`` to write
into given (n_t, 3, K) float32 tensors (a row slice of a longer signal,
when the time axis streams in blocks), and ``accumulate=True`` to add to
them (an atom axis streamed in blocks).

The angle is formed and folded in float64, then cast to float32 before
sin/cos.  The double-single arithmetic of the JAX package exists only
because its TPU has no float64.

``precision`` picks the tier (the JAX package's ``--precision``):

- 'parity' (3xTF32 products, IEEE float32 sums; 1e-6 of max against the
  float64 oracle) runs the fused kernel of ``csrc/sed_projection.cu``,
  which makes the angles beside its products and never stores them;
- 'balanced' (3xBF16, hi = rn_bf16(x), lo = rn_bf16(x − hi); ~1e-5) and
  'fast' (one TF32 product; ~1e-3) run the two kernels of
  ``csrc/sed_projection_tiers.cu``: :func:`tier_table` makes the tier's
  split [cos | sin] table once per call into a scratch (the product's
  tile layout, :func:`tile_table`), then :func:`tier_product` multiplies.
  Past :data:`TABLE_CAP_BYTES` of table the atom axis goes in blocks
  (:func:`atom_blocks`), the later ones added through ``accumulate``.

Each tier's plain version rounds the operands exactly as the kernels do
and multiplies in float32, where a TF32 or bf16 product is exact, so the
two differ only in the order of the sum.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from .. import _build
from ..utils import debug
from ..utils.profiling import count, counters, span

#: Tier name -> the kernels' ``tier`` argument.
TIERS = {'parity': 0, 'balanced': 1, 'fast': 2}
#: Data elements per atom block of the tiers' plain versions (bounds their copies).
PLAIN_BLOCK_ELEMS = 1 << 28
#: Bytes of table one call of 'balanced' or 'fast' may hold; past it the atom
#: axis goes in blocks (:func:`atom_blocks`).
TABLE_CAP_BYTES = 1 << 30
#: The table's tiles (``sed_projection_tiers.cu``: BA, BK, STAGE_BYTES): atoms
#: per stage, k-points per tile, bytes of one tile (either tier).
TABLE_ATOMS, TABLE_K, TABLE_TILE_BYTES = 32, 64, 16384
#: The fused 'parity' kernel's tiles (``sed_projection.cu``: BT, BK, CL): time
#: steps and k-points per block, blocks per cluster (time tiles that share
#: one angle tile).
PARITY_T, PARITY_K, PARITY_CLUSTER = 64, 32, 2


def accurate_angles(mp_hi: torch.Tensor, mp_lo: torch.Tensor,
                    k_vectors: torch.Tensor) -> torch.Tensor:
    """(A, K) float32 angles (mp_hi+mp_lo)·k folded by 2π in float64."""
    pos = mp_hi.double() + mp_lo.double()
    ang = pos @ k_vectors.double().T
    ang = ang - (2.0 * torch.pi) * torch.round(ang / (2.0 * torch.pi))
    return ang.float()


def phase_table(mp_hi: torch.Tensor, mp_lo: torch.Tensor,
                k_vectors: torch.Tensor) -> torch.Tensor:
    """[cos | sin] of the folded angles, (A, 2K) float32."""
    ang = accurate_angles(mp_hi, mp_lo, k_vectors)
    return torch.cat([torch.cos(ang), torch.sin(ang)], dim=1)


def kernel_launches() -> int:
    """Launches of every kernel of this module in this process: the counters
    ``launch.parity`` (the fused kernel, ``csrc/sed_projection.cu``),
    ``launch.table`` and ``launch.product`` (``csrc/sed_projection_tiers.cu``)
    of :data:`psa_tpu_torch.utils.profiling.counters`.  The plain versions
    count nothing."""
    return counters['launch.parity'] + counters['launch.table'] + counters['launch.product']


def tier_split(cs: torch.Tensor, precision: str) -> Tuple[torch.Tensor, ...]:
    """The parts of a float32 table as the tier's kernels multiply them:
    'fast' (tf32(x),), 'balanced' (hi, lo) with hi = rn_bf16(x) and
    lo = rn_bf16(x − hi)."""
    _check_table_tier(precision)
    if precision == 'fast':
        return (round_tf32(cs),)
    hi = round_bf16(cs)
    return hi, round_bf16(cs - hi)


def tier_table_plain(mp_hi: torch.Tensor, mp_lo: torch.Tensor, k_vectors: torch.Tensor,
                     precision: str) -> Tuple[torch.Tensor, ...]:
    """Plain version of the table kernel: :func:`phase_table` split by the
    tier (:func:`tier_split`), each part (A, 2K) float32 in logical layout."""
    return tier_split(phase_table(mp_hi, mp_lo, k_vectors), precision)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: add 0x1000 to
    the bits, clear the low 13 (finite x)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16, to nearest with ties to even, as float32."""
    return x.to(torch.bfloat16).float()


def _tier_product(d: torch.Tensor, parts: Tuple[torch.Tensor, ...], precision: str
                  ) -> torch.Tensor:
    """d @ c with d split and rounded as the tier's kernel splits it and c
    given as the tier's parts (:func:`tier_split`), each product exact in
    float32 and summed in float32: the small terms first, then big·big."""
    if precision == 'fast':
        return round_tf32(d) @ parts[0]
    c_hi, c_lo = parts
    d_hi = round_bf16(d)
    out = round_bf16(d - d_hi) @ c_hi
    out += d_hi @ c_lo
    return out.add_(d_hi @ c_hi)


def table_bytes(n_atoms: int, n_k: int) -> int:
    """Bytes of the tiled table of ``n_atoms`` atoms and ``n_k`` k-points."""
    return -(-n_k // TABLE_K) * -(-n_atoms // TABLE_ATOMS) * TABLE_TILE_BYTES


def parity_tiles(n_t: int, n_k: int) -> Tuple[int, int]:
    """(time tiles, angle tiles) of one 'parity' launch on ``n_t`` time steps
    and ``n_k`` k-points: the output tiles whose products run,
    ⌈n_t / PARITY_T⌉·⌈n_k / PARITY_K⌉, and the angle tiles made, one per
    cluster, ⌈⌈n_t / PARITY_T⌉ / PARITY_CLUSTER⌉·⌈n_k / PARITY_K⌉."""
    grid_t, grid_k = -(-n_t // PARITY_T), -(-n_k // PARITY_K)
    return grid_t * grid_k, -(-grid_t // PARITY_CLUSTER) * grid_k


def atom_blocks(n_atoms: int, n_k: int, cap_bytes: Optional[int] = None
                ) -> List[Tuple[int, int]]:
    """The atom ranges [a0, a1) whose tables the product takes one at a
    time: whole stages of :data:`TABLE_ATOMS` atoms, as many as
    ``cap_bytes`` (default :data:`TABLE_CAP_BYTES`) of table hold at
    ``n_k`` k-points, the last block ragged."""
    cap = TABLE_CAP_BYTES if cap_bytes is None else cap_bytes
    stage_bytes = table_bytes(TABLE_ATOMS, n_k)
    if cap < stage_bytes:
        raise ValueError(f"a table cap of {cap} bytes holds no stage of {TABLE_ATOMS} atoms at "
                         f"{n_k} k-points ({stage_bytes} bytes)")
    block = cap // stage_bytes * TABLE_ATOMS
    return [(a0, min(a0 + block, n_atoms)) for a0 in range(0, n_atoms, block)]


def _tile_shape(n_atoms: int, n_k: int, precision: str):
    """(tile-order shape, element type) of the tier's table: dims (k-tile,
    stage, k-step, part, atom group, 8-column group, column, atom), as
    ``csrc/sed_projection_tiers.cu::b_byte`` lays the bytes of each tile."""
    _check_table_tier(precision)
    parts, core, dtype = (2, 8, torch.bfloat16) if precision == 'balanced' else (1, 4, torch.float32)
    shape = (-(-n_k // TABLE_K), -(-n_atoms // TABLE_ATOMS), TABLE_ATOMS // (2 * core), parts, 2,
             2 * TABLE_K // 8, 8, core)
    return shape, dtype


def tile_table(parts: Tuple[torch.Tensor, ...], n_k: int, precision: str) -> torch.Tensor:
    """The (A, 2K) parts of a table in the product kernel's tile layout: a
    flat uint8 tensor of :func:`table_bytes` bytes, zero past the last atom
    and k-point."""
    n_atoms = parts[0].shape[0]
    shape, dtype = _tile_shape(n_atoms, n_k, precision)
    gk, ns = shape[0], shape[1]
    x = torch.zeros((len(parts), ns * TABLE_ATOMS, 2, gk * TABLE_K), dtype=torch.float32,
                    device=parts[0].device)
    for p, part in enumerate(parts):
        x[p, :n_atoms, :, :n_k] = part.reshape(n_atoms, 2, n_k)
    # atoms as (stage, k-step, group, atom); the tile's columns [cos | sin] as 8-column groups
    x = x.reshape(len(parts), ns, shape[2], 2, shape[7], 2, gk, TABLE_K).transpose(5, 6)
    x = x.reshape(len(parts), ns, shape[2], 2, shape[7], gk, shape[5], 8)
    return x.permute(5, 1, 2, 0, 3, 6, 7, 4).contiguous().to(dtype).view(torch.uint8).reshape(-1)


def untile_table(table: torch.Tensor, n_atoms: int, n_k: int, precision: str
                 ) -> Tuple[torch.Tensor, ...]:
    """The parts of a tiled table (:func:`tile_table`) as (A, 2K) float32."""
    shape, dtype = _tile_shape(n_atoms, n_k, precision)
    gk, ns = shape[0], shape[1]
    x = table[:table_bytes(n_atoms, n_k)].view(dtype).float().reshape(shape)
    x = x.permute(3, 1, 2, 4, 7, 0, 5, 6).reshape(shape[3], ns * TABLE_ATOMS, gk, 2, TABLE_K)
    x = x[:, :n_atoms].transpose(2, 3).reshape(shape[3], n_atoms, 2, gk * TABLE_K)[..., :n_k]
    return tuple(x.reshape(shape[3], n_atoms, 2 * n_k))


def _tier_sum(data: torch.Tensor, parts: Tuple[torch.Tensor, ...], precision: str
              ) -> torch.Tensor:
    """(n_t, 3, 2K) Σ_a data[t, a, c] c[a, :] at the tier, c given as its
    (A, 2K) parts, summed over atom blocks of :data:`PLAIN_BLOCK_ELEMS`
    data elements (the blocks' copies of the data stay small)."""
    n_t, n_atoms, _ = data.shape
    block = max(1, PLAIN_BLOCK_ELEMS // (3 * n_t))
    proj = None
    for a0 in range(0, n_atoms, block):
        d = data[:, a0:a0 + block].transpose(1, 2).reshape(n_t * 3, -1)
        part = _tier_product(d, tuple(c[a0:a0 + block] for c in parts), precision)
        proj = part if proj is None else proj.add_(part)
    return proj.reshape(n_t, 3, -1)


def tier_product_plain(data: torch.Tensor, table: torch.Tensor, n_k: int, precision: str,
                       atoms: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the product kernel: atoms [a0, a1) of ``data``
    (default all) times their tiled ``table``, (re, im) each (n_t, 3, K)."""
    a0, a1 = atoms or (0, data.shape[1])
    proj = _tier_sum(data[:, a0:a1], untile_table(table, a1 - a0, n_k, precision), precision)
    return proj[..., :n_k].contiguous(), proj[..., n_k:].contiguous()


def sed_projection_plain(data: torch.Tensor, mp_hi: torch.Tensor,
                         mp_lo: torch.Tensor, k_vectors: torch.Tensor,
                         out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         accumulate: bool = False, precision: str = 'parity'
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: materialized (A, 2K) table and float32 matmuls.

    'parity' is one IEEE float32 matmul; 'balanced' and 'fast' round the
    operands as their kernels do (:func:`_tier_product`) and sum blocks of
    atoms, so their copies of the data stay small.  Returns (re, im), each
    (n_t, 3, K) float32: new tensors, or ``out`` written
    (``accumulate=False``) or added to (``accumulate=True``).  Needs
    ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's default) to
    stay IEEE float32 on a GPU.
    """
    _check_precision(precision)
    n_t, n_atoms, _ = data.shape
    n_k = k_vectors.shape[0]
    cs = phase_table(mp_hi, mp_lo, k_vectors)
    if precision == 'parity':
        proj = (data.transpose(1, 2).reshape(n_t * 3, n_atoms) @ cs).reshape(n_t, 3, 2 * n_k)
    else:
        proj = _tier_sum(data, tier_split(cs, precision), precision)
    return _deliver((proj[..., :n_k], proj[..., n_k:]), out, accumulate)


def _deliver(pair, out, accumulate):
    """``pair`` as new contiguous tensors, or written into (added to) ``out``."""
    if out is None:
        return tuple(x.contiguous() for x in pair)
    for dst, src in zip(out, pair):
        if accumulate:
            dst.add_(src)
        else:
            dst.copy_(src)
    return out


def _check_precision(precision: str) -> None:
    if precision not in TIERS:
        raise ValueError(f"precision must be one of {sorted(TIERS)}, got {precision!r}")


def _check_table_tier(precision: str) -> None:
    if precision not in ('balanced', 'fast'):
        raise ValueError(f"the table and product kernels run 'balanced' or 'fast', got {precision!r}")


def _check_out(out, shape, device) -> None:
    if len(out) != 2:
        raise ValueError("out must be a (re, im) pair")
    for t in out:
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != device:
            raise ValueError(f"out tensors must be float32 {shape} on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError("out tensors must be contiguous")


def _check(data, mp_hi, mp_lo, k_vectors) -> None:
    if data.dim() != 3 or data.shape[2] != 3:
        raise ValueError(f"data must be (n_t, n_atoms, 3), got {tuple(data.shape)}")
    n_t, n_atoms, _ = data.shape
    for name, t in (('mp_hi', mp_hi), ('mp_lo', mp_lo)):
        if tuple(t.shape) != (n_atoms, 3):
            raise ValueError(f"{name} must be ({n_atoms}, 3), got {tuple(t.shape)}")
    if k_vectors.dim() != 2 or k_vectors.shape[1] != 3:
        raise ValueError(f"k_vectors must be (n_k, 3), got {tuple(k_vectors.shape)}")
    if n_t == 0 or n_atoms == 0 or k_vectors.shape[0] == 0:
        raise ValueError(f"empty projection: n_t={n_t}, n_atoms={n_atoms}, "
                         f"n_k={k_vectors.shape[0]}")
    tensors = (data, mp_hi, mp_lo, k_vectors)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("sed_projection takes float32 tensors, got "
                        f"{[str(t.dtype) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("sed_projection tensors lie on different devices: "
                         f"{[str(t.device) for t in tensors]}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def tier_table(mp_hi: torch.Tensor, mp_lo: torch.Tensor, k_vectors: torch.Tensor,
               precision: str, atoms: Optional[Tuple[int, int]] = None,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The tier's table of atoms [a0, a1) (default all) in the product
    kernel's tile layout (:func:`tile_table`): a flat uint8 tensor of
    :func:`table_bytes` bytes, new or ``out`` (at least that long).

    A CPU tensor gets the plain version; a CUDA tensor launches the table
    kernel (``csrc/sed_projection_tiers.cu``) or raises.
    """
    _check_table_tier(precision)
    a0, a1 = atoms or (0, mp_hi.shape[0])
    n_k = k_vectors.shape[0]
    nbytes = table_bytes(a1 - a0, n_k)
    device = mp_hi.device
    if out is not None and (out.dtype != torch.uint8 or out.device != device
                            or not out.is_contiguous() or out.numel() < nbytes):
        raise ValueError(f"out must be a contiguous uint8 tensor of >= {nbytes} bytes on {device}")
    if device.type == 'cpu':
        table = tile_table(tier_table_plain(mp_hi[a0:a1], mp_lo[a0:a1], k_vectors, precision),
                           n_k, precision)
        if out is None:
            return table
        out[:nbytes].copy_(table)
        return out
    if out is None:
        out = torch.empty(nbytes, dtype=torch.uint8, device=device)
    with torch.cuda.device(device):
        err = _build.load().psa_sed_tier_table(
            mp_hi.data_ptr(), mp_lo.data_ptr(), k_vectors.data_ptr(), out.data_ptr(), out.numel(),
            a0, a1 - a0, n_k, TIERS[precision], _stream(device))
    _raise_on(err, "sed_projection table")
    count('launch.table')
    return out


def tier_product(data: torch.Tensor, table: torch.Tensor, n_k: int, precision: str,
                 out: Tuple[torch.Tensor, torch.Tensor], accumulate: bool = False,
                 atoms: Optional[Tuple[int, int]] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Atoms [a0, a1) (default all) of ``data`` times their tiled ``table``
    (:func:`tier_table`) at 'balanced' or 'fast', written into (added to,
    with ``accumulate``) ``out``.

    A CPU tensor gets the plain version :func:`tier_product_plain`; a CUDA
    tensor launches the product kernel (``csrc/sed_projection_tiers.cu``) or
    raises.  On CUDA ``data`` must be contiguous and start on a 16-byte
    boundary.
    """
    _check_table_tier(precision)
    n_t, n_atoms, _ = data.shape
    a0, a1 = atoms or (0, n_atoms)
    device = data.device
    if device.type == 'cpu':
        return _deliver(tier_product_plain(data, table, n_k, precision, (a0, a1)), out,
                        accumulate)
    if not data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError("the product kernel takes contiguous data on a 16-byte boundary")
    with torch.cuda.device(device):
        err = _build.load().psa_sed_tier_product(
            data.data_ptr(), table.data_ptr(), table.numel(), out[0].data_ptr(),
            out[1].data_ptr(), n_t, n_atoms, a0, a1 - a0, n_k, int(accumulate), TIERS[precision],
            _stream(device))
    _raise_on(err, "sed_projection product")
    count('launch.product')
    return out


def sed_projection(data: torch.Tensor, mp_hi: torch.Tensor, mp_lo: torch.Tensor,
                   k_vectors: torch.Tensor,
                   out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   accumulate: bool = False, precision: str = 'parity'
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) projections, each (n_t, 3, K) float32.

    Args:
        data: (n_t, n_atoms, 3) float32 velocities or displacements.
        mp_hi, mp_lo: (n_atoms, 3) float32 split of the float64 mean positions.
        k_vectors: (n_k, 3) float32.
        out: optional (re, im) pair of contiguous (n_t, 3, n_k) float32
            tensors on ``data``'s device to write the result into.
        accumulate: add the result to ``out`` instead of overwriting it.
        precision: the tier, 'parity', 'balanced' or 'fast'.  On CUDA
            'parity' launches the fused kernel; the others launch, per atom
            block of :func:`atom_blocks`, the table kernel into one scratch
            of at most :data:`TABLE_CAP_BYTES`, then the product kernel.

    Any n_t, n_atoms and n_k ≥ 1 are accepted; the kernels mask the edges.
    On CUDA the inputs must be contiguous; a ``data`` view that does not
    start on a 16-byte boundary is copied first (the kernels copy 16-byte
    blocks).
    """
    with span('psa.project'):
        _check(data, mp_hi, mp_lo, k_vectors)
        _check_precision(precision)
        device = data.device
        if out is not None:
            _check_out(out, (data.shape[0], 3, k_vectors.shape[0]), device)
        elif accumulate:
            raise ValueError("accumulate=True needs out=")
        if device.type == 'cpu':
            out = sed_projection_plain(data, mp_hi, mp_lo, k_vectors, out=out,
                                       accumulate=accumulate, precision=precision)
            if debug.active:
                debug.check_tensors('sed_projection', out)
            return out
        if device.type != 'cuda':
            raise ValueError(f"sed_projection runs on cpu or cuda, got {device}")
        tensors = (data, mp_hi, mp_lo, k_vectors)
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("sed_projection's CUDA kernels take contiguous tensors")
        if data.data_ptr() % 16:
            data = data.clone()
        n_t, n_atoms, _ = data.shape
        n_k = k_vectors.shape[0]
        if out is None:
            out = tuple(torch.empty((n_t, 3, n_k), dtype=torch.float32, device=device)
                        for _ in range(2))
        if precision == 'parity':
            with torch.cuda.device(device):
                err = _build.load().psa_sed_projection(
                    data.data_ptr(), mp_hi.data_ptr(), mp_lo.data_ptr(), k_vectors.data_ptr(),
                    out[0].data_ptr(), out[1].data_ptr(), n_t, n_atoms, n_k, int(accumulate),
                    _stream(device))
            _raise_on(err, "sed_projection")
            count('launch.parity')
            time_tiles, angle_tiles = parity_tiles(n_t, n_k)
            count('parity.time_tiles', time_tiles)
            count('parity.angle_tiles', angle_tiles)
        else:
            blocks = atom_blocks(n_atoms, n_k)
            scratch = torch.empty(table_bytes(blocks[0][1] - blocks[0][0], n_k), dtype=torch.uint8,
                                  device=device)
            for i, block in enumerate(blocks):
                tier_table(mp_hi, mp_lo, k_vectors, precision, atoms=block, out=scratch)
                tier_product(data, scratch, n_k, precision, out, accumulate=accumulate or i > 0,
                             atoms=block)
        if debug.active:
            debug.check_tensors('sed_projection', out)
        return out
