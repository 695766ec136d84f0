"""A Lennard-Jones liquid: atoms that start on fcc sites and wander by a seeded walk.

Positions are the sites plus the running sum of normal steps of
``walk_step_A`` per axis and frame; velocities are Maxwell's at T*, in Å/ps
for the configuration's argon units.  Both are made on the device from the
seed, then copied to host arrays: the port has no public way to install raw
positions and velocities on the device, so the calculator's first call
uploads them (a warm-up call of set-up) and keeps them in its device cache.
:func:`halve_atoms` breaks that data path for the tests.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness.ksets import seed_words
from benchmark.reference import lattice

BOLTZMANN = 1.380649e-23          # J/K
AMU = 1.66053906660e-27           # kg


def units(config: dict):
    """(τ in ps, the Maxwell speed per axis in Å/ps, the frame spacing in ps)."""
    sigma_m = config['sigma_A'] * 1e-10
    tau_ps = sigma_m * math.sqrt(config['mass_amu'] * AMU / (config['epsilon_K'] * BOLTZMANN)) * 1e12
    v_axis = math.sqrt(config['T_reduced']) * config['sigma_A'] / tau_ps
    return tau_ps, v_axis, config['dump_every'] * config['dt_tau'] * tau_ps


def make(config: dict, seed: int, device: torch.device) -> SimpleNamespace:
    from psa_tpu_torch import Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays

    _, v_axis, dt_ps = units(config)
    cells, n_t = config['cells'], config['n_frames']
    a0 = (4.0 / config['density_reduced']) ** (1 / 3) * config['sigma_A']
    sites32 = lattice.fcc_sites(cells, a0).astype(np.float32)
    n_atoms = sites32.shape[0]

    gen = torch.Generator(device=device)
    gen.manual_seed(seed_words(seed))
    pos = torch.randn((n_t, n_atoms, 3), generator=gen, device=device)
    pos.mul_(config['walk_step_A']).cumsum_(0).add_(torch.from_numpy(sites32).to(device))
    host_pos = pos.cpu().numpy()
    del pos
    vel = torch.randn((n_t, n_atoms, 3), generator=gen, device=device)
    host_vel = vel.mul_(v_axis).cpu().numpy()
    del vel

    side = cells * a0
    box = np.diag([side] * 3).astype(np.float32)
    traj = Trajectory(host_pos, host_vel, np.ones(n_atoms, dtype=np.int32),
                      np.arange(n_t, dtype=np.float32) * np.float32(dt_ps),
                      box, *make_box_arrays(box), dt_ps=dt_ps)

    def calculator(precision: str):
        from psa_tpu_torch import SEDCalculator
        return SEDCalculator(traj, nx=cells, ny=cells, nz=cells, precision=precision,
                             max_device_bytes=config['max_device_bytes'], device=device)

    return SimpleNamespace(n_t=n_t, n_atoms=n_atoms, dt_ps=dt_ps, positions=host_pos,
                           velocities=host_vel, box_lengths=np.diag(box).astype(np.float64),
                           calculator=calculator, device=device)


def halve_atoms(monkeypatch) -> None:
    """A fault for the tests: half of the atoms left out of every sum, the
    rest counted double, where this system's data reach the DSF's sums
    (``ops/instantaneous.accumulate_modes``, each block's mode accumulation)."""
    from psa_tpu_torch.ops import instantaneous
    orig = instantaneous.accumulate_modes

    def accumulate(acc_re, acc_im, pos, vel, *args, **kwargs):
        w = torch.full((pos[:, ::2].shape[1],), 2.0, dtype=torch.float32, device=pos.device)
        orig(acc_re, acc_im, pos[:, ::2], None if vel is None else vel[:, ::2], *args,
             **dict(kwargs, weights=w))
    monkeypatch.setattr(instantaneous, 'accumulate_modes', accumulate)
