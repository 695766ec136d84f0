"""Peaks of the chip and the work of the projection stage, from the calls' shapes.

Peaks: NVIDIA's data sheet for one H100 SXM, dense rates.  The projection
Σ_a data[t, a, c]·(cos | sin)(k·r̄_a) multiplies a (3·n_t, A) matrix by an
(A, 2K) one: 2·(3·n_t)·(2K)·A = 12·n_t·A·K operations, counted at the TF32
rate.  Each input byte is counted once, read, and each output byte once,
written: the data (12·n_t·A), the split mean positions (24·A), the k-vectors
(12·K) and what the call returns.
"""
from __future__ import annotations

#: Dense TF32 tensor-core rate of one H100 SXM, operations per second.
TF32_FLOPS = 495e12
#: HBM3 bandwidth of one H100 SXM, bytes per second.
HBM_BYTES_PER_S = 3.35e12


def projection_flops(n_t: int, n_atoms: int, n_k: int) -> float:
    return 12.0 * n_t * n_atoms * n_k


def projection_bytes(n_t: int, n_atoms: int, n_k: int, out_bytes: int) -> float:
    return 12.0 * n_t * n_atoms + 24.0 * n_atoms + 12.0 * n_k + float(out_bytes)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / TF32_FLOPS, nbytes / HBM_BYTES_PER_S)
