"""The SED projection: phase angles, [cos|sin] and the atom contraction.

Counterpart of :mod:`psa_tpu.ops.pallas_sed`.  Computes

    out_re[t, c, k] = Σ_a data[t, a, c] · cos A[a, k]
    out_im[t, c, k] = Σ_a data[t, a, c] · sin A[a, k]
    A[a, k]         = (mp_hi + mp_lo)_a · k_k, folded into [−π, π]

:func:`sed_projection` is the kernel's wrapper: a CPU tensor goes to the
plain PyTorch version :func:`sed_projection_plain`; a CUDA tensor launches
the hand-written kernel in ``csrc/sed_projection.cu`` or raises.  Both take
``out=(re, im)`` to write into given (n_t, 3, K) float32 tensors (a row
slice of a longer signal, when the time axis streams in blocks), and
``accumulate=True`` to add to them (an atom axis streamed in blocks).

The angle is formed and folded in float64, then cast to float32 before
sin/cos.  The double-single arithmetic of the JAX package exists only
because its TPU has no float64.

``precision`` picks the kernel's tier (the JAX package's ``--precision``):
'parity' (3xTF32 products, IEEE float32 sums; 1e-6 of max against the
float64 oracle), 'balanced' (3xBF16, hi = rn_bf16(x), lo = rn_bf16(x − hi);
~1e-5) and 'fast' (one TF32 product; ~1e-3).  Each tier's plain version
rounds the operands exactly as the kernel does and multiplies in float32,
where a TF32 or bf16 product is exact, so the two differ only in the order
of the sum.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build
from ..utils import debug

#: Launches of the CUDA kernel in this process, every tier (the plain version counts nothing).
launches = 0
#: Tier name -> the kernel entry point's ``tier`` argument.
TIERS = {'parity': 0, 'balanced': 1, 'fast': 2}
#: Data elements per atom block of the tiers' plain versions (bounds their copies).
PLAIN_BLOCK_ELEMS = 1 << 28


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


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds: add 0x1000 to
    the bits, clear the low 13 (finite x)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to bfloat16, to nearest with ties to even, as float32."""
    return x.to(torch.bfloat16).float()


def _tier_product(d: torch.Tensor, c: torch.Tensor, precision: str) -> torch.Tensor:
    """d @ c with both operands split and rounded as the tier's kernel
    splits them, each product exact in float32 and summed in float32: the
    small terms first, then big·big."""
    if precision == 'fast':
        return round_tf32(d) @ round_tf32(c)
    d_hi, c_hi = round_bf16(d), round_bf16(c)
    out = round_bf16(d - d_hi) @ c_hi
    out += d_hi @ round_bf16(c - c_hi)
    return out.add_(d_hi @ c_hi)


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
        proj = data.transpose(1, 2).reshape(n_t * 3, n_atoms) @ cs
    else:
        block = max(1, PLAIN_BLOCK_ELEMS // (3 * n_t))
        proj = None
        for a0 in range(0, n_atoms, block):
            d = data[:, a0:a0 + block].transpose(1, 2).reshape(n_t * 3, -1)
            part = _tier_product(d, cs[a0:a0 + block], precision)
            proj = part if proj is None else proj.add_(part)
    proj = proj.reshape(n_t, 3, 2 * n_k)
    re, im = proj[..., :n_k], proj[..., n_k:]
    if out is None:
        return re.contiguous(), im.contiguous()
    for dst, src in zip(out, (re, im)):
        if accumulate:
            dst.add_(src)
        else:
            dst.copy_(src)
    return out


def _check_precision(precision: str) -> None:
    if precision not in TIERS:
        raise ValueError(f"precision must be one of {sorted(TIERS)}, got {precision!r}")


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
        precision: the tier, 'parity', 'balanced' or 'fast'; on CUDA each
            launches its own variant of the kernel.

    Any n_t, n_atoms and n_k ≥ 1 are accepted; the kernel masks the edges.
    On CUDA the inputs must be contiguous; a ``data`` view that does not
    start on a 16-byte boundary is copied first (the kernel copies 16-byte
    blocks).
    """
    global launches
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
        raise ValueError("sed_projection's CUDA kernel takes contiguous tensors")
    if data.data_ptr() % 16:
        data = data.clone()
    lib = _build.load()
    n_t, n_atoms, _ = data.shape
    n_k = k_vectors.shape[0]
    if out is None:
        out = tuple(torch.empty((n_t, 3, n_k), dtype=torch.float32, device=device)
                    for _ in range(2))
    out_re, out_im = out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.psa_sed_projection(
            data.data_ptr(), mp_hi.data_ptr(), mp_lo.data_ptr(),
            k_vectors.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
            n_t, n_atoms, n_k, int(accumulate), TIERS[precision], stream)
    if err != 0:
        raise RuntimeError(f"sed_projection kernel launch failed: CUDA error {err}")
    launches += 1
    if debug.active:
        debug.check_tensors('sed_projection', (out_re, out_im))
    return out_re, out_im
