"""The crystal of :mod:`benchmark.systems.crystal_waves` at a size no one
card holds: its velocities made on the cards in atom shards, one shard a
mesh position, and kept there, resident on the port's (t, a, k) mesh.

    v[t, a, c] = Σ_m cos(2π (b_m + δ) t / n_t + φ_m) · A_m X_m[a, c] + σ ξ[t, a, c]

The time factors (one seeded phase per mode) are shared by every shard;
each shard's atom patterns X and noise ξ are drawn on its own card from
(seed, shard index): a normal draw and a rank-M product, in slabs of
frames, never on the host.  The mesh is the configuration's
``mesh_shape`` (atoms sharded only): cards 0 … n − 1 on CUDA, n positions
of the CPU there.  The trajectory the calculator sees holds zero-stride
arrays (positions constant on the sites): nothing reads it frame by frame.

The shards reach the calculator through ``preload_mesh_group_data``, with
the float64 mean positions cached as in :mod:`crystal_waves`.
:func:`halve_atoms` breaks the resident windows' hand-over to the
projections, where this system's data reach them.
"""
from __future__ import annotations

import math
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness.ksets import seed_words
from benchmark.reference import lattice

#: Elements of one slab of a shard made at once (cuBLAS and the normal
#: draw take 32-bit sizes; a shard is 1.5e10 elements at the cell's size).
SLAB_ELEMS = 1 << 30


def mesh_devices(device: torch.device, n: int) -> list:
    """Cards 0 … n − 1 for a CUDA ``device``, else ``n`` positions of it."""
    if device.type == 'cuda':
        return [torch.device('cuda', i) for i in range(n)]
    return [device] * n


def atom_shards(n_atoms: int, parts: int) -> list:
    """[a0, a1) of ``parts`` consecutive shards, ⌈n_atoms/parts⌉ atoms each."""
    size = -(-n_atoms // parts)
    return [(min(i * size, n_atoms), min((i + 1) * size, n_atoms)) for i in range(parts)]


def shard_seed(seed: int, index: int) -> int:
    return int(np.random.SeedSequence([seed_words(seed), index]).generate_state(
        1, np.uint64)[0]) % (1 << 63)


def make_shard(n_t: int, n_atoms: int, time_f: torch.Tensor, waves: dict, seed: int,
               device: torch.device) -> torch.Tensor:
    """(n_t, n_atoms, 3) float32 velocities of one shard, made on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    amps = torch.tensor(waves['amplitude_A_per_ps'], dtype=torch.float32, device=device)
    atom_f = torch.randn((len(amps), n_atoms * 3), generator=gen, device=device)
    atom_f *= amps[:, None]
    data = torch.empty((n_t, n_atoms * 3), dtype=torch.float32, device=device)
    slab = max(1, SLAB_ELEMS // (n_atoms * 3))
    for r0 in range(0, n_t, slab):
        rows = data[r0:r0 + slab]
        rows.normal_(generator=gen)
        rows.mul_(waves['noise_A_per_ps']).addmm_(time_f[r0:r0 + slab], atom_f)
    return data.view(n_t, n_atoms, 3)


def make(config: dict, seed: int, device: torch.device) -> SimpleNamespace:
    from psa_tpu_torch import Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    from psa_tpu_torch.parallel import make_mesh

    n_t, n_atoms, a0 = config['n_frames'], config['n_atoms'], config['lattice_constant_A']
    shape = tuple(config['mesh_shape'])
    if shape[0] != 1 or shape[2] != 1:
        raise ValueError(f"this system shards the atoms only: mesh_shape (1, n, 1), got {shape}")
    waves = config['waves']
    sites32 = lattice.diamond_sites(n_atoms, a0).astype(np.float32)
    sites64 = sites32.astype(np.float64)
    lo32 = (sites64 - sites32.astype(np.float64)).astype(np.float32)

    rng = np.random.default_rng([seed_words(seed), 0])
    bins = np.asarray(waves['bins'], np.float64) + waves['detune_bins']
    phase0 = rng.random(len(bins)) * (2 * math.pi)
    t = np.arange(n_t, dtype=np.float64)
    time_host = np.cos(2 * math.pi * t[:, None] * bins[None] / n_t + phase0[None])
    time_host = time_host.astype(np.float32)

    devices = mesh_devices(device, shape[1])
    mesh = make_mesh(shape=shape, devices=devices)
    bounds = atom_shards(n_atoms, shape[1])
    # every host copy first, then the shards: a copy from pageable memory
    # waits for its card, so the cards make their shards side by side
    held = {(0, a, 0): (s0, s1, dev) for a, ((s0, s1), dev) in enumerate(zip(bounds, devices))
            if s1 > s0}
    time_fs, his, los = {}, {}, {}
    for pos, (s0, s1, dev) in held.items():
        time_fs[pos] = torch.from_numpy(time_host).to(dev)
        his[pos] = torch.from_numpy(sites32[s0:s1]).to(dev)
        los[pos] = torch.from_numpy(lo32[s0:s1]).to(dev)
    shards = {pos: make_shard(n_t, s1 - s0, time_fs[pos], waves, shard_seed(seed, pos[1]), dev)
              for pos, (s0, s1, dev) in held.items()}

    side = float(np.max(sites32)) + a0
    box = np.diag([side] * 3).astype(np.float32)
    traj = Trajectory(np.broadcast_to(sites32[None], (n_t, n_atoms, 3)),
                      np.broadcast_to(np.zeros(3, np.float32), (n_t, n_atoms, 3)),
                      np.ones(n_atoms, dtype=np.int32),
                      np.arange(n_t, dtype=np.float32) * np.float32(config['dt_ps']),
                      box, *make_box_arrays(box), dt_ps=config['dt_ps'])

    def calculator(precision: str):
        from psa_tpu_torch import SEDCalculator
        calc = SEDCalculator(traj, nx=1, ny=1, nz=1, precision=precision, device=devices[0])
        calc._mean_pos64 = sites64
        calc.preload_mesh_group_data(mesh, shards, his, los)
        return calc

    return SimpleNamespace(
        n_t=n_t, n_atoms=n_atoms, dt_ps=config['dt_ps'], sites64=sites64,
        box_lengths=np.diag(box).astype(np.float64), mesh=mesh,
        shards=[(bounds[a][0], bounds[a][1], shards[(0, a, 0)]) for a in range(shape[1])
                if (0, a, 0) in shards],
        calculator=calculator, device=devices[0])


def halve_atoms(monkeypatch) -> None:
    """A fault for the tests: half of the atoms left out of every sum, the
    rest counted double, where this system's data reach the projections
    (``ResidentShards.device_windows``, the resident windows' hand-over)."""
    from psa_tpu_torch.parallel import ResidentShards
    orig = ResidentShards.device_windows

    def device_windows(self, *window, **kw):
        out = {}
        for dev, data in orig(self, *window, **kw).items():
            keep = torch.zeros(data.shape[1], dtype=data.dtype, device=data.device)
            keep[::2] = 2.0
            out[dev] = data * keep[None, :, None]
        return out
    monkeypatch.setattr(ResidentShards, 'device_windows', device_windows)
