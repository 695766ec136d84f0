"""Plain reference of the SED of data held in atom shards on several devices.

The same sums as :mod:`benchmark.reference.sed`, for data that no one
device holds whole: each shard's float64 projection
(:func:`benchmark.reference.sed.projection`) runs on the device that holds
the shard, every shard's launched before any is moved; the partials are
then summed on ``home`` in ascending shard order, and the spectrum, the
intensity and the peaks follow there.  Imports nothing of the program.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from benchmark.reference import sed

#: One shard: (a0, a1, data), ``data`` the (n_t, a1 − a0, 3) float32 values
#: of atoms [a0, a1) over every frame, on the device that holds them.
Shard = Tuple[int, int, torch.Tensor]


def projection(shards: Sequence[Shard], sites64: np.ndarray, k_vectors: np.ndarray,
               tf32: bool = False, home=None):
    """(re, im), each (n_t, 3, K) on ``home`` (default the first shard's
    device): Σ over the shards of their :func:`sed.projection`."""
    home = torch.device(home) if home is not None else shards[0][2].device
    parts = [sed.projection(data, sites64[a0:a1], k_vectors, tf32, device=data.device)
             for a0, a1, data in shards]
    re, im = (x.to(home) for x in parts[0])
    for p_re, p_im in parts[1:]:
        re += p_re.to(home)
        im += p_im.to(home)
    return re, im


def kgrid_peaks(shards: Sequence[Shard], sites64: np.ndarray, k_vectors: np.ndarray,
                dt_ps: float, n_peaks: int, exclusion_bins: int, tf32: bool = False,
                block_k: int = 1024, home=None):
    """Peaks of the coherent SED of every k in ``k_vectors``: host float64
    arrays (freq, height, width), each (n_peaks, K), as :func:`sed.kgrid_peaks`."""
    n_t = shards[0][2].shape[0]
    freqs = np.fft.fftfreq(n_t, d=dt_ps)[sed.kept_rows(n_t)]
    cols = []
    for s in range(0, len(k_vectors), block_k):
        inten = sed.intensity(sed.spectrum(*projection(shards, sites64, k_vectors[s:s + block_k],
                                                       tf32, home)))
        cols.append([x.cpu().numpy() for x in sed.peaks(inten, freqs, n_peaks, exclusion_bins)])
        del inten
    return tuple(np.concatenate(parts, axis=1) for parts in zip(*cols))


def phi(shards: Sequence[Shard], sites64: np.ndarray, k_vectors: np.ndarray,
        tf32: bool = False, home=None) -> np.ndarray:
    """The full coherent Φ (n_t, K, 3) of ``k_vectors``, complex on the host."""
    return sed.spectrum(*projection(shards, sites64, k_vectors, tf32, home)).cpu().numpy()
