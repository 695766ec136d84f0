"""Plain reference of the spectral energy density and of its peaks.

    Φ_c(ω, k) = FFT_t[ Σ_a data[t, a, c] · exp(i k·r̄_a) ](ω) / n_t
    I(ω, k)   = Σ_c |Φ_c(ω, k)|²  on the rows ω ≥ 0

and the top peaks of each k-column of I: the greedy argmax with an
exclusion window and the intensity-weighted RMS width inside it.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def ieee_matmul():
    """Float32 matrix products in IEEE float32 (TF32 off), restored after."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32's 10-bit mantissa (nearest, ties away from
    zero, as the tensor cores' conversion does).  A product of two such
    values is exact in float32, so an IEEE float32 product of rounded
    operands is the TF32 product on every device."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def on(device, x) -> torch.Tensor:
    """``x``, a host NumPy array, a CPU tensor or a tensor on a card, as a
    tensor on ``device`` (itself, where it is there already)."""
    return torch.as_tensor(x).to(device)


def where(data, device) -> torch.device:
    """The device to compute on: ``device``, or by default the one ``data`` lies on."""
    if device is not None:
        return torch.device(device)
    return data.device if torch.is_tensor(data) else torch.device('cpu')


def kept_rows(n_t: int) -> np.ndarray:
    """Indices of the ω ≥ 0 rows of an n_t-point FFT (numpy's fftfreq order)."""
    return np.flatnonzero(np.fft.fftfreq(n_t) >= 0)


def projection(data, sites64: np.ndarray, k_vectors: np.ndarray, tf32: bool = False,
               block_atoms: int = 4096, device=None):
    """(re, im), each (n_t, 3, K): Σ_a data[t, a, c]·cos/sin(k·r̄_a).

    ``data`` is the (n_t, A, 3) float32 array the program was given, where
    the program holds it: a host NumPy array, a CPU tensor or a tensor on a
    card.  The sums run on ``device`` (by default where ``data`` lies), each
    atom block of ``data`` moved there in turn.  Float64 throughout, or with
    ``tf32`` the angle's cosine and sine and the data rounded to TF32 and
    summed in float32 (:func:`round_tf32`).
    """
    dev = where(data, device)
    n_t, n_atoms, _ = data.shape
    pos = torch.as_tensor(np.asarray(sites64, np.float64), device=dev)
    kv = torch.as_tensor(np.asarray(k_vectors, np.float32), device=dev).double()
    dtype = torch.float32 if tf32 else torch.float64
    re = torch.zeros((n_t * 3, kv.shape[0]), dtype=dtype, device=dev)
    im = torch.zeros_like(re)
    with ieee_matmul():
        for a0 in range(0, n_atoms, block_atoms):
            a1 = min(a0 + block_atoms, n_atoms)
            ang = pos[a0:a1] @ kv.T                                    # (B, K) float64
            cos, sin = torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)
            blk = on(dev, data[:, a0:a1, :]).to(dtype).permute(0, 2, 1).reshape(n_t * 3, a1 - a0)
            if tf32:
                cos, sin, blk = round_tf32(cos), round_tf32(sin), round_tf32(blk)
            re.addmm_(blk, cos)
            im.addmm_(blk, sin)
    return re.view(n_t, 3, -1), im.view(n_t, 3, -1)


def spectrum(re: torch.Tensor, im: torch.Tensor) -> torch.Tensor:
    """Φ (n_t, K, 3), complex: the FFT over time of re + i·im, divided by n_t."""
    return (torch.fft.fft(torch.complex(re, im), dim=0) / re.shape[0]).transpose(1, 2)


def intensity(spec: torch.Tensor) -> torch.Tensor:
    """(n_keep, K) Σ_c |Φ_c|² on the ω ≥ 0 rows, in float64."""
    rows = torch.as_tensor(kept_rows(spec.shape[0]), device=spec.device)
    kept = spec.index_select(0, rows)
    return (kept.real.double() ** 2 + kept.imag.double() ** 2).sum(dim=-1)


def peaks(inten: torch.Tensor, freqs: np.ndarray, n_peaks: int, exclusion_bins: int):
    """(freq, height, width), each (n_peaks, K) float64, of each column of ``inten``.

    Greedy: take the row of the column's largest value (the first of equal
    ones), record its frequency and value, and the RMS frequency spread of
    the intensity within ±``exclusion_bins`` rows of it; zero that window;
    repeat.
    """
    cur = inten.double().clone()
    fk = torch.as_tensor(np.asarray(freqs, np.float64), device=cur.device)[:, None]
    row = torch.arange(cur.shape[0], device=cur.device)[:, None]
    out = []
    for _ in range(n_peaks):
        idx = torch.argmax(cur, dim=0)
        height = cur.gather(0, idx[None])[0]
        win = (row - idx[None]).abs() <= exclusion_bins
        w = torch.where(win, cur, torch.zeros_like(cur))
        wsum = torch.clamp(w.sum(dim=0), min=1e-300)
        mu = (w * fk).sum(dim=0) / wsum
        var = (w * (fk - mu[None]) ** 2).sum(dim=0) / wsum
        out.append((fk[:, 0][idx], height, torch.sqrt(torch.clamp(var, min=0.0))))
        cur = torch.where(win, torch.zeros_like(cur), cur)
    return tuple(torch.stack(col) for col in zip(*out))


def kgrid_peaks(data, sites64: np.ndarray, k_vectors: np.ndarray, dt_ps: float,
                n_peaks: int, exclusion_bins: int, tf32: bool = False, block_k: int = 1024,
                device=None):
    """Peaks of the coherent SED of every k in ``k_vectors``, computed on
    ``device`` (:func:`projection`): host float64 arrays (freq, height,
    width), each (n_peaks, K)."""
    n_t = data.shape[0]
    freqs = np.fft.fftfreq(n_t, d=dt_ps)[kept_rows(n_t)]
    cols = []
    for s in range(0, len(k_vectors), block_k):
        inten = intensity(spectrum(*projection(data, sites64, k_vectors[s:s + block_k], tf32,
                                               device=device)))
        cols.append([x.cpu().numpy() for x in peaks(inten, freqs, n_peaks, exclusion_bins)])
        del inten
    return tuple(np.concatenate(parts, axis=1) for parts in zip(*cols))


def phi(data, sites64: np.ndarray, k_vectors: np.ndarray, tf32: bool = False, device=None):
    """The full coherent Φ (n_t, K, 3) of ``k_vectors``, computed on
    ``device`` (:func:`projection`), complex on the host."""
    return spectrum(*projection(data, sites64, k_vectors, tf32, device=device)).cpu().numpy()
