"""A crystal whose velocities are a few vibrating modes plus thermal noise.

    v[t, a, c] = Σ_m cos(2π (b_m + δ) t / n_t + φ_m) · A_m X_m[a, c] + σ ξ[t, a, c]

with X and ξ standard normal: every k sees each mode as one peak of its
own frequency, well above the noise, instead of near-ties in white noise.
Made on the device from the seed in three calls (a normal draw, a scale, a
rank-M product), in float32, the type the calculator serves.  The atoms sit
on the configuration's lattice (positions constant, their mean the sites).

The data reach the calculator through ``preload_device_group_data``, with
the float64 mean positions the calculator caches after its first call: the
state of a session after that call.  :func:`halve_atoms` breaks that data
path for the tests.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness.ksets import seed_words
from benchmark.reference import lattice


def make(config: dict, seed: int, device: torch.device) -> SimpleNamespace:
    from psa_tpu_torch import Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays

    n_t, n_atoms, a0 = config['n_frames'], config['n_atoms'], config['lattice_constant_A']
    waves = config['waves']
    sites32 = lattice.diamond_sites(n_atoms, a0).astype(np.float32)
    sites64 = sites32.astype(np.float64)

    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed))
    bins = torch.tensor(waves['bins'], dtype=torch.float64, device=device) + waves['detune_bins']
    amps = torch.tensor(waves['amplitude_A_per_ps'], dtype=torch.float32, device=device)
    phase0 = torch.rand(len(waves['bins']), generator=gen, dtype=torch.float64,
                        device=device) * (2 * math.pi)
    t = torch.arange(n_t, dtype=torch.float64, device=device)
    time_f = torch.cos(2 * math.pi * t[:, None] * bins[None] / n_t + phase0[None]).float()
    atom_f = torch.randn((len(waves['bins']), n_atoms * 3), generator=gen, device=device)
    atom_f *= amps[:, None]
    data = torch.randn((n_t, n_atoms * 3), generator=gen, device=device)
    data.mul_(waves['noise_A_per_ps']).addmm_(time_f, atom_f)
    data = data.view(n_t, n_atoms, 3)

    side = float(np.max(sites32)) + a0
    box = np.diag([side] * 3).astype(np.float32)
    traj = Trajectory(np.broadcast_to(sites32[None], (n_t, n_atoms, 3)),
                      np.broadcast_to(np.zeros(3, np.float32), (n_t, n_atoms, 3)),
                      np.ones(n_atoms, dtype=np.int32),
                      np.arange(n_t, dtype=np.float32) * np.float32(config['dt_ps']),
                      box, *make_box_arrays(box), dt_ps=config['dt_ps'])

    def calculator(precision: str):
        from psa_tpu_torch import SEDCalculator
        calc = SEDCalculator(traj, nx=1, ny=1, nz=1, precision=precision,
                             max_device_bytes=config['max_device_bytes'], device=device)
        calc._mean_pos64 = sites64
        hi = torch.from_numpy(sites32).to(device)
        lo = torch.from_numpy((sites64 - sites32.astype(np.float64)).astype(np.float32)).to(device)
        calc.preload_device_group_data(data, hi, lo)
        return calc

    return SimpleNamespace(n_t=n_t, n_atoms=n_atoms, dt_ps=config['dt_ps'], sites64=sites64,
                           box_lengths=np.diag(box).astype(np.float64), data=data,
                           calculator=calculator, device=device)


def halve_atoms(monkeypatch) -> None:
    """A fault for the tests: half of the atoms left out of every sum, the
    rest counted double, where this system's data reach the projection
    (``SEDCalculator._group_device_arrays``, the resident group's arrays)."""
    from psa_tpu_torch import SEDCalculator
    orig = SEDCalculator._group_device_arrays

    def arrays(self, group_idx):
        data, hi, lo = orig(self, group_idx)
        keep = torch.zeros(data.shape[1], dtype=data.dtype, device=data.device)
        keep[::2] = 2.0
        return data * keep[None, :, None], hi, lo
    monkeypatch.setattr(SEDCalculator, '_group_device_arrays', arrays)
