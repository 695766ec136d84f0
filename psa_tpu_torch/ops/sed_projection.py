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
sin/cos; the contraction is IEEE float32.  The double-single arithmetic of
the JAX package exists only because its TPU has no float64.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .. import _build

#: Launches of the CUDA kernel in this process (the plain version counts nothing).
launches = 0


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


def sed_projection_plain(data: torch.Tensor, mp_hi: torch.Tensor,
                         mp_lo: torch.Tensor, k_vectors: torch.Tensor,
                         out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                         accumulate: bool = False
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version: materialized (A, 2K) table and one float32 matmul.

    Returns (re, im), each (n_t, 3, K) float32: new tensors, or ``out``
    written (``accumulate=False``) or added to (``accumulate=True``).
    Needs ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's
    default) to stay IEEE float32 on a GPU.
    """
    n_t, n_atoms, _ = data.shape
    n_k = k_vectors.shape[0]
    cs = phase_table(mp_hi, mp_lo, k_vectors)
    data2d = data.transpose(1, 2).reshape(n_t * 3, n_atoms)
    proj = (data2d @ cs).reshape(n_t, 3, 2 * n_k)
    re, im = proj[..., :n_k], proj[..., n_k:]
    if out is None:
        return re.contiguous(), im.contiguous()
    for dst, src in zip(out, (re, im)):
        if accumulate:
            dst.add_(src)
        else:
            dst.copy_(src)
    return out


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
                   accumulate: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(re, im) projections, each (n_t, 3, K) float32.

    Args:
        data: (n_t, n_atoms, 3) float32 velocities or displacements.
        mp_hi, mp_lo: (n_atoms, 3) float32 split of the float64 mean positions.
        k_vectors: (n_k, 3) float32.
        out: optional (re, im) pair of contiguous (n_t, 3, n_k) float32
            tensors on ``data``'s device to write the result into.
        accumulate: add the result to ``out`` instead of overwriting it.

    Any n_t, n_atoms and n_k ≥ 1 are accepted; the kernel masks the edges.
    On CUDA the inputs must be contiguous; a ``data`` view that does not
    start on a 16-byte boundary is copied first (the kernel copies 16-byte
    blocks).
    """
    global launches
    _check(data, mp_hi, mp_lo, k_vectors)
    device = data.device
    if out is not None:
        _check_out(out, (data.shape[0], 3, k_vectors.shape[0]), device)
    elif accumulate:
        raise ValueError("accumulate=True needs out=")
    if device.type == 'cpu':
        return sed_projection_plain(data, mp_hi, mp_lo, k_vectors, out=out,
                                    accumulate=accumulate)
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
            n_t, n_atoms, n_k, int(accumulate), stream)
    if err != 0:
        raise RuntimeError(f"sed_projection kernel launch failed: CUDA error {err}")
    launches += 1
    return out_re, out_im
