"""Two-process check of the mesh sweeps over a real process group.

:func:`launch` starts ``world`` fresh interpreters that join one process
group (``tcp://localhost``, a free port) and run :func:`worker`: each builds
the same (t, a, k) mesh of ``positions`` positions per rank, reads the
trajectory through counting sources over ``.npy`` memmaps, runs the SED
peaks and the instantaneous-phase family and the time correlations over
the mesh, and saves what it gathered, how many trajectory elements it read
and how many times it launched the projection kernel.  The ports of ``scripts/multihost_smoke.py`` and
``scripts/multihost_smoke_dsf.py``: their callers check that every rank
holds the same results, that these equal a one-process run, and that each
rank read at most its share of the trajectory.

    python -m psa_tpu_torch.parallel.smoke --rank R --world W --port P \\
        --workdir DIR [--device cpu] [--backend gloo]

``DIR`` holds ``inputs.npz`` (k-sets, kept rows, peaks, lags, the mesh's
shape, the time superchunk and the atom chunk of the per-atom sweeps),
``positions.npy`` and ``velocities.npy``; rank R writes ``rank{R}.npz``.  NCCL takes one rank per card, so two ranks on one card
take gloo.
"""
from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np

#: The arrays a rank saves besides its read counts.
RESULTS = ('peak_freqs', 'peak_heights', 'peak_widths', 's', 'c_long', 'c_trans', 'sk',
           'isf', 'dsf_self', 'msd', 'vacf')


def write_inputs(workdir: Path, positions: np.ndarray, velocities: np.ndarray, **inputs) -> None:
    """The files :func:`worker` reads: the two (n_t, N, 3) float32 arrays as
    ``.npy`` and the other inputs in ``inputs.npz``."""
    workdir.mkdir(parents=True, exist_ok=True)
    np.save(workdir / 'positions.npy', np.asarray(positions, dtype=np.float32))
    np.save(workdir / 'velocities.npy', np.asarray(velocities, dtype=np.float32))
    np.savez(workdir / 'inputs.npz', **inputs)


def run_sweeps(mesh, pos_src, vel_src, inp: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The mesh sweeps of the check on one mesh (one process or several)."""
    from .sharded import (sharded_dsf, sharded_dsf_self, sharded_isf, sharded_sed_spectrum,
                          sharded_sk, sharded_timecorr)
    sc = int(inp['t_superchunk'])
    mean64 = np.asarray(inp['mean64'], dtype=np.float64)
    pf, ph, pw = sharded_sed_spectrum(
        mesh, vel_src, mean64, inp['k_sed'], t_superchunk=sc, freq_indices=inp['freq_idx'],
        n_peaks=int(inp['n_peaks']), peak_freqs_thz=inp['freqs_kept'])
    s, c_l, c_t = sharded_dsf(mesh, pos_src, vel_src, inp['k_dsf'], inp['freq_idx'],
                              t_superchunk=sc)
    n_lags, chunk = int(inp['n_lags']), int(inp['atom_chunk'])
    return dict(peak_freqs=pf, peak_heights=ph, peak_widths=pw, s=s, c_long=c_l, c_trans=c_t,
                sk=sharded_sk(mesh, pos_src, inp['k_dsf'], t_superchunk=sc),
                isf=sharded_isf(mesh, pos_src, inp['k_dsf'], n_lags, t_superchunk=sc),
                dsf_self=sharded_dsf_self(mesh, pos_src, inp['k_dsf'], inp['freq_idx'],
                                          atom_chunk=chunk),
                msd=sharded_timecorr(mesh, pos_src, 'msd', n_lags, atom_chunk=chunk),
                vacf=sharded_timecorr(mesh, vel_src, 'vacf', n_lags, atom_chunk=chunk))


class CountingSource:
    """A memmap source that counts the trajectory elements it reads."""

    def __init__(self, data):
        from .sharded import ArrayBlockSource
        self._src = ArrayBlockSource(data)
        self.n_frames, self.n_atoms = self._src.n_frames, self._src.n_atoms
        self.elements = 0

    def read_block(self, t0, t1, a0, a1):
        self.elements += (t1 - t0) * (a1 - a0)
        return self._src.read_block(t0, t1, a0, a1)


def worker(rank: int, world: int, port: int, workdir: Path, device: str = 'cuda',
           backend: str = 'gloo', positions: int = 4) -> None:
    import torch.distributed as dist
    from ..ops import sed_projection
    from .distributed import initialize_cluster
    from .sharded import make_mesh
    group = initialize_cluster(f'localhost:{port}', world, rank, backend=backend, device=device)
    try:
        inp = dict(np.load(workdir / 'inputs.npz'))
        pos_src = CountingSource(np.load(workdir / 'positions.npy', mmap_mode='r'))
        vel_src = CountingSource(np.load(workdir / 'velocities.npy', mmap_mode='r'))
        dev = 'cpu' if device == 'cpu' else 'cuda:0'
        mesh = make_mesh(shape=tuple(int(x) for x in inp['mesh_shape']),
                         devices=[dev] * (positions * world), group=group)
        out = run_sweeps(mesh, pos_src, vel_src, inp)
        np.savez(workdir / f'rank{rank}.npz', pos_elements=pos_src.elements,
                 vel_elements=vel_src.elements, launches=sed_projection.kernel_launches(), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def launch(workdir: Path, world: int = 2, device: str = 'cuda', backend: str = 'gloo',
           positions: int = 4, timeout: float = 120.0) -> List[Dict[str, np.ndarray]]:
    """Run :func:`worker` in ``world`` fresh interpreters; returns each
    rank's saved arrays.  A rank that fails or outlives ``timeout`` stops
    every rank and raises with their output."""
    port = free_port()
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [p for p in os.environ.get('PYTHONPATH', '').split(os.pathsep) if p]))
    procs = [subprocess.Popen(
        [sys.executable, '-m', 'psa_tpu_torch.parallel.smoke', '--rank', str(r),
         '--world', str(world), '--port', str(port), '--workdir', str(workdir),
         '--device', device, '--backend', backend, '--positions', str(positions)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=root)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    except subprocess.TimeoutExpired:
        raise RuntimeError(f"the {world}-process check ran past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    if any(p.returncode for p in procs):
        raise RuntimeError("a rank failed:\n" + "\n".join(
            f"--- rank {r} (exit {p.returncode}) ---\n{log}"
            for r, (p, log) in enumerate(zip(procs, logs))))
    return [dict(np.load(Path(workdir) / f'rank{r}.npz')) for r in range(world)]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument('--rank', type=int, required=True)
    p.add_argument('--world', type=int, required=True)
    p.add_argument('--port', type=int, required=True)
    p.add_argument('--workdir', type=Path, required=True)
    p.add_argument('--device', choices=['cpu', 'cuda'], default='cuda')
    p.add_argument('--backend', choices=['gloo', 'nccl'], default='gloo')
    p.add_argument('--positions', type=int, default=4, help='mesh positions per rank')
    a = p.parse_args(argv)
    worker(a.rank, a.world, a.port, a.workdir, a.device, a.backend, a.positions)


if __name__ == '__main__':
    main()
