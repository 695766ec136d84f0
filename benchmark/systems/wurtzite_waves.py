"""A wurtzite crystal whose velocities are one vibrating mode per branch plus
thermal noise, every basis site a group of its own.

    v[t, a, c] = Σ_m cos(2π (b_m + δ) t / n_t + φ_m) · A_m X_m[a, c] + σ ξ[t, a, c]

with X and ξ standard normal, as in :mod:`benchmark.systems.crystal_waves`:
made on the device from the seed in three calls (a normal draw, a scale, a
rank-M product), float32.  The atoms sit on the configuration's wurtzite
sites (:mod:`benchmark.reference.wurtzite`, positions constant, their mean
the sites), listed cell-major, so each site's atoms are every fourth one;
types 1-4 name the four sites, and each atom carries its species' mass.
The trajectory the calculator sees holds zero velocities: what reads them
reads nothing of the data.

The velocities reach the calculator through ``preload_device_group_data``
as the whole trajectory, with the float64 mean positions; the calculator
makes each basis group from them on the device and weights it by √m.
:func:`halve_atoms` breaks the groups where they reach the projections,
:func:`leave_out_group` and :func:`drop_mass_weights` where the calculator
resolves and weights them.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness.ksets import seed_words
from benchmark.reference import wurtzite


def make(config: dict, seed: int, device: torch.device) -> SimpleNamespace:
    from psa_tpu_torch import Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    from psa_tpu_torch.ops.spectral import split_f64

    n_t, cells = config['n_frames'], config['cells']
    a0, c0, u = config['a_A'], config['c_A'], config['u']
    sites, site = wurtzite.sites(cells, a0, c0, u)
    if len(sites) != config['n_atoms']:
        raise ValueError(f"{cells} cells hold {len(sites)} atoms, not {config['n_atoms']}")
    n_atoms = len(sites)
    sites32 = sites.astype(np.float32)
    sites64 = sites32.astype(np.float64)
    types = (site + 1).astype(np.int32)
    masses = np.asarray(config['site_masses_u'], np.float64)[site]

    waves = config['waves']
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

    box = np.diag(wurtzite.box_lengths(cells, a0, c0)).astype(np.float32)
    traj = Trajectory(np.broadcast_to(sites32[None], (n_t, n_atoms, 3)),
                      np.broadcast_to(np.zeros(3, np.float32), (n_t, n_atoms, 3)),
                      types, np.arange(n_t, dtype=np.float32) * np.float32(config['dt_ps']),
                      box, *make_box_arrays(box), dt_ps=config['dt_ps'], masses=masses)

    def calculator(precision: str):
        from psa_tpu_torch import SEDCalculator
        calc = SEDCalculator(traj, nx=1, ny=1, nz=1, precision=precision,
                             max_device_bytes=config['max_device_bytes'],
                             mass_weighted=config['mass_weighted'], device=device)
        hi, lo = (torch.from_numpy(x).to(device) for x in split_f64(sites64))
        calc.preload_device_group_data(data, hi, lo, mean_positions64=sites64)
        return calc

    return SimpleNamespace(n_t=n_t, n_atoms=n_atoms, dt_ps=config['dt_ps'], sites64=sites64,
                           types=types, masses=masses,
                           box_lengths=np.diag(box).astype(np.float64), data=data,
                           calculator=calculator, device=device)


def halve_atoms(monkeypatch) -> None:
    """A fault for the tests: half of the atoms left out of every sum, the
    rest counted double, where the groups reach the projections
    (``SEDCalculator._group_device_arrays``, each group's device arrays)."""
    from psa_tpu_torch import SEDCalculator
    orig = SEDCalculator._group_device_arrays

    def arrays(self, group_idx):
        data, hi, lo = orig(self, group_idx)
        keep = torch.zeros(data.shape[1], dtype=data.dtype, device=data.device)
        keep[::2] = 2.0
        return data * keep[None, :, None], hi, lo
    monkeypatch.setattr(SEDCalculator, '_group_device_arrays', arrays)


def leave_out_group(monkeypatch) -> None:
    """A fault for the tests: the last basis group left out of the sum
    (``SEDCalculator._resolve_atom_groups``)."""
    from psa_tpu_torch import SEDCalculator
    orig = SEDCalculator._resolve_atom_groups

    def resolve(self, *args, **kwargs):
        groups = orig(self, *args, **kwargs)
        return groups[:-1] if len(groups) > 1 else groups
    monkeypatch.setattr(SEDCalculator, '_resolve_atom_groups', resolve)


def drop_mass_weights(monkeypatch) -> None:
    """A fault for the tests: the √m weights left out
    (``SEDCalculator._mass_weights``)."""
    from psa_tpu_torch import SEDCalculator
    monkeypatch.setattr(SEDCalculator, '_mass_weights', lambda self, group_idx: None)
