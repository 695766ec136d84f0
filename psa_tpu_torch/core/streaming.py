"""Out-of-core SED: stream a LAMMPS dump through the device in O(chunk) memory.

Port of :mod:`psa_tpu.core.streaming`.  The projection
``S[t,k] = Σ_a data[t,a]·e^{ik·r̄_a}`` is elementwise in t, so frames stream
through in time blocks: each block is parsed on the host, crosses to the
device through pinned staging (the next block's parse and copy overlap this
block's kernel), and the projection kernel writes its rows into one
(n_t, 3, K) device signal (``out=`` row slices).  The kernel makes the phase
angles itself, so no (N, 2K) phase table is built.  One FFT ends it.

Two passes over the file:
  pass 1 — count frames and accumulate the float64 mean positions
           (skipped when ``mean_pos64`` is given);
  pass 2 — project time blocks.

Memory: O(frame_chunk · N) host and device, plus the projected signal.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..io import lammps as lammps_io
from ..ops import spectral
from ..ops.sed_projection import sed_projection
from ..utils.transfer import HostToDevice
from .calculator import resolve_device
from .sed import SED

logger = logging.getLogger(__name__)


def _open_mmap_source(dump_path: Path):
    """Native chunked random-access source, or None (fall back to the
    line iterator)."""
    try:
        return lammps_io.MmapDumpFrames(dump_path)
    except (ValueError, OSError) as e:
        logger.info("Native mmap dump source unavailable for %s (%s); "
                    "using the line iterator.", Path(dump_path).name, e)
        return None


def _mean_positions_pass(dump_path: Path, source=None,
                         frame_chunk: int = 128
                         ) -> Tuple[np.ndarray, int, np.ndarray]:
    """One streaming pass: (mean_pos64, n_frames, types)."""
    if source is not None:
        acc = np.zeros((source.n_atoms, 3), dtype=np.float64)
        for i in range(0, source.n_frames, frame_chunk):
            j = min(i + frame_chunk, source.n_frames)
            pos, _ = source.frames(i, j)
            acc += pos.astype(np.float64).sum(axis=0)
        return acc / source.n_frames, source.n_frames, source.types
    acc = None
    count = 0
    types = None
    for frame in lammps_io.iter_lammps_frames(dump_path):
        pos = frame.positions.astype(np.float64)
        acc = pos if acc is None else acc + pos
        if types is None:
            types = frame.types
        count += 1
    if count == 0:
        raise ValueError(f"No frames found in {dump_path}")
    return acc / count, count, types


def _frame_blocks(dump_path: Path, source, n_t: int, frame_chunk: int,
                  use_displacements: bool, mean_pos64: np.ndarray):
    """Yield (i, j, fill) for frame windows [i, j): ``fill(dst)`` writes the
    window's data (velocities, or float64-subtracted displacements) into a
    (j - i, N, 3) float32 host array."""
    def data_of(pos, vel):
        if use_displacements:
            return (pos.astype(np.float64) - mean_pos64[None]).astype(np.float32)
        return vel

    if source is not None:
        if not use_displacements and not source.has_velocities:
            raise ValueError(f"{dump_path.name} has no velocity columns; "
                             "use use_displacements=True")
        for i in range(0, n_t, frame_chunk):
            j = min(i + frame_chunk, n_t)
            yield i, j, lambda dst, i=i, j=j: np.copyto(dst, data_of(*source.frames(i, j)))
        return
    frames = lammps_io.iter_lammps_frames(dump_path)

    def fill(dst):
        for row in range(dst.shape[0]):
            frame = next(frames)
            if not use_displacements and frame.velocities is None:
                raise ValueError(f"{dump_path.name} has no velocity columns; "
                                 "use use_displacements=True")
            dst[row] = data_of(frame.positions[None], None if frame.velocities is None
                               else frame.velocities[None])[0]

    for i in range(0, n_t, frame_chunk):
        yield i, min(i + frame_chunk, n_t), fill


def sed_from_dump_streaming(dump_path, dt_ps: float, k_vectors: np.ndarray,
                            frame_chunk: int = 128,
                            use_displacements: bool = False,
                            k_points_mags: Optional[np.ndarray] = None,
                            k_grid_shape: Optional[Tuple[int, int]] = None,
                            mean_pos64: Optional[np.ndarray] = None,
                            device: Union[str, torch.device] = 'cuda') -> SED:
    """Coherent SED of all atoms, streamed from a LAMMPS text dump.

    Args:
        dump_path: path to the dump (must contain velocities unless
            ``use_displacements``).
        dt_ps: frame spacing (ps).
        k_vectors: (K, 3) float32.
        frame_chunk: frames per streamed block (host and device memory knob).
        use_displacements: project r(t) − r̄ instead of velocities.
        mean_pos64: pre-computed float64 mean positions (skips pass 1).
        device: 'cuda' (default; raises when CUDA is absent) or 'cpu'.

    Returns:
        SED with complex64 amplitudes (n_freq, K, 3).
    """
    dev = resolve_device(device)
    dump_path = Path(dump_path)
    k_vectors = np.ascontiguousarray(k_vectors, dtype=np.float32)
    n_k = k_vectors.shape[0]

    source = _open_mmap_source(dump_path)
    try:
        if mean_pos64 is None:
            logger.info("Streaming pass 1/2: mean positions over %s", dump_path.name)
            mean_pos64, n_t, _ = _mean_positions_pass(dump_path, source=source,
                                                      frame_chunk=frame_chunk)
        elif source is not None:
            n_t = source.n_frames
        else:
            n_t = sum(1 for _ in lammps_io.iter_lammps_frames(dump_path))
        n_atoms = mean_pos64.shape[0]
        # the kernel takes C-contiguous tensors; np.mean of a column-major
        # trajectory gives a column-major mean
        hi, lo = (torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                  for x in spectral.split_f64(mean_pos64))
        k_dev = torch.from_numpy(k_vectors).to(dev)
        re, im = (torch.empty((n_t, 3, n_k), dtype=torch.float32, device=dev) for _ in range(2))
        logger.info("Streaming pass 2/2: projecting %d frames in blocks of %d "
                    "(projected signal: %.2f GB)", n_t, frame_chunk, 2 * re.numel() * 4 / 1e9)
        stager = HostToDevice(dev, min(frame_chunk, n_t) * n_atoms * 3)
        for i, j, fill in _frame_blocks(dump_path, source, n_t, frame_chunk,
                                        use_displacements, mean_pos64):
            block = stager.put(fill, (j - i, n_atoms, 3))
            sed_projection(block, hi, lo, k_dev, out=(re[i:j], im[i:j]))
    finally:
        if source is not None:
            source.close()

    sed_c = spectral.finalize_spectrum(re, im).contiguous().cpu().numpy()
    freqs = spectral.fftfreq_thz(n_t, dt_ps)
    return SED(sed_c, freqs,
               k_points_mags if k_points_mags is not None else np.array([], np.float32),
               k_vectors, k_grid_shape=k_grid_shape, is_complex=True, dt_ps=dt_ps)
