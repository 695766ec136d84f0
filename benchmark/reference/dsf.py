"""Plain reference of the dynamic structure factor and the current spectra.

    ρ(t, k)   = Σ_a exp(i k·r_a(t))
    j_c(t, k) = Σ_a v_a,c(t) · exp(i k·r_a(t))
    S(k, ω)   = |ρ̂|² / N,   C_L = |k̂·ĵ|² / N,   C_T = (Σ_c |ĵ_c|² − |k̂·ĵ|²) / N

with x̂ the FFT over time divided by n_t, on the rows ω ≥ 0.
"""
from __future__ import annotations

import numpy as np
import torch

from .sed import ieee_matmul, kept_rows, on, round_tf32, where


def modes(positions, velocities, k_vectors: np.ndarray, tf32: bool = False,
          block_elems: int = 1 << 27, device=None):
    """(re, im), each (n_t, 4, K): the channels [ρ, j_x, j_y, j_z].

    ``positions`` and ``velocities`` are the (n_t, N, 3) float32 arrays the
    harness made, where the program holds them: host NumPy arrays, CPU
    tensors or tensors on a card.  The sums run on ``device`` (by default
    where ``positions`` lie), each block of frames moved there in turn.  The
    angle is formed in float64 from them; float64 phasors and sums, or with
    ``tf32`` phasors and velocities rounded to TF32 and summed in float32.
    """
    dev = where(positions, device)
    n_t, n_atoms, _ = positions.shape
    kv = torch.as_tensor(np.asarray(k_vectors, np.float32), device=dev).double()
    n_k = kv.shape[0]
    dtype = torch.float32 if tf32 else torch.float64
    re = torch.zeros((n_t, 4, n_k), dtype=dtype, device=dev)
    im = torch.zeros_like(re)
    tb = max(1, block_elems // max(1, n_atoms * n_k))
    rnd = round_tf32 if tf32 else (lambda x: x)
    with ieee_matmul():
        for t0 in range(0, n_t, tb):
            t1 = min(t0 + tb, n_t)
            ang = on(dev, positions[t0:t1]).double() @ kv.T            # (tb, N, K)
            w = torch.ones((t1 - t0, 4, n_atoms), dtype=dtype, device=dev)
            w[:, 1:] = on(dev, velocities[t0:t1]).transpose(1, 2).to(dtype)
            w = rnd(w)
            re[t0:t1] = torch.bmm(w, rnd(torch.cos(ang).to(dtype)))
            im[t0:t1] = torch.bmm(w, rnd(torch.sin(ang).to(dtype)))
            del ang
    return re, im


def planes(positions, velocities, k_vectors: np.ndarray, tf32: bool = False, device=None):
    """(S, C_L, C_T), each (n_keep, K) float64 on the host, computed on
    ``device`` (:func:`modes`)."""
    re, im = modes(positions, velocities, k_vectors, tf32, device=device)
    n_t, n_atoms = positions.shape[0], positions.shape[1]
    rows = torch.as_tensor(kept_rows(n_t), device=re.device)
    spec = (torch.fft.fft(torch.complex(re, im), dim=0) / n_t).index_select(0, rows)
    spec = spec.to(torch.complex128)
    kv = np.asarray(k_vectors, np.float64)
    norms = np.linalg.norm(kv, axis=1, keepdims=True)
    unit = torch.as_tensor(np.where(norms > 0, kv / np.where(norms > 0, norms, 1.0), 0.0),
                           device=re.device)
    rho, j = spec[:, 0], spec[:, 1:]                                   # (F, K), (F, 3, K)
    s = rho.real ** 2 + rho.imag ** 2
    jl = (j * unit.T[None]).sum(dim=1)
    c_l = jl.real ** 2 + jl.imag ** 2
    total = (j.real ** 2 + j.imag ** 2).sum(dim=1)
    return tuple((x / n_atoms).cpu().numpy() for x in (s, c_l, total - c_l))
