"""Incoherent, mass-weighted sweeps over the basis sites of a crystal.

A small seeded wurtzite crystal (four basis sites, types 1-4, each site every
fourth atom) through the port against the benchmark's float64 reference of
the published SED (``benchmark/reference/sed_basis.py``), with the data on
the host or installed on the device.  A resident install of the whole
trajectory serves every group a call resolves and reads nothing of the host
trajectory; host groups stay on the device when they fit there together and
stream once per pass of k-chunks when they do not; the counters
``groups.requested_bytes`` and ``groups.resident_bytes`` say which.
"""
import math

import numpy as np
import pytest
import torch

from benchmark.reference import sed_basis, wurtzite
from psa_tpu_torch import SEDCalculator, Trajectory
from psa_tpu_torch.core.trajectory import make_box_arrays
from psa_tpu_torch.ops.spectral import split_f64
from psa_tpu_torch.utils.profiling import counted_since, snapshot

torch.set_num_threads(1)

A, C, U = 3.189, 5.185, 0.377
MASSES = np.array([69.723, 69.723, 14.007, 14.007])
DT = 0.02
TYPES = [1, 2, 3, 4]
RTOL = 1e-6


def crystal(cells=(2, 2, 2), n_t=64, seed=3, bins=(5, 12, 21)):
    """(trajectory, velocities, mean positions): a few modes plus noise on
    the wurtzite sites, positions walking a little around them."""
    rng = np.random.default_rng(seed)
    sites, site = wurtzite.sites(cells, A, C, U)
    n = len(sites)
    t = np.arange(n_t)[:, None]
    vel = rng.normal(size=(n_t, n, 3))
    for m, b in enumerate(bins):
        vel += np.cos(2 * math.pi * (b + 0.25) * t / n_t + m)[:, :, None] \
            * (3.0 - m * 0.5) * rng.normal(size=(n, 3))[None]
    vel = vel.astype(np.float32)
    pos = (sites[None] + rng.normal(0, 0.02, size=(n_t, n, 3))).astype(np.float32)
    box = np.diag(wurtzite.box_lengths(cells, A, C)).astype(np.float32)
    traj = Trajectory(pos, vel, (site + 1).astype(np.int32),
                      np.arange(n_t, dtype=np.float32) * DT, box, *make_box_arrays(box),
                      dt_ps=DT, masses=MASSES[site])
    return traj, vel, np.mean(pos, axis=0, dtype=np.float64)


def blank(traj):
    """The trajectory with zero positions and velocities: what reads them
    reads nothing of the data."""
    zeros = np.broadcast_to(np.zeros(3, np.float32), traj.positions.shape)
    return Trajectory(zeros, zeros, traj.types, traj.timesteps, traj.box_matrix,
                      traj.box_lengths, traj.box_tilts, dt_ps=traj.dt_ps, masses=traj.masses)


def host_calc(traj, **kw):
    return SEDCalculator(traj, 1, 1, 1, mass_weighted=True, device='cpu', **kw)


def resident_calc(traj, vel, means, **kw):
    """A calculator over ``blank(traj)`` whose data are installed on the device."""
    calc = host_calc(blank(traj), **kw)
    hi, lo = (torch.from_numpy(x) for x in split_f64(means))
    calc.preload_device_group_data(torch.from_numpy(vel), hi, lo, mean_positions64=means)
    calc._host_group_data = calc._stream_group = None        # any host read raises
    return calc


def groups_of(traj):
    return [np.flatnonzero(traj.types == t) for t in TYPES]


def kgrid(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.3, 1.3, size=(n * n, 3)).astype(np.float32) * [1, 1, 0.3]


@pytest.mark.parametrize('where', ['host', 'resident'])
@pytest.mark.parametrize('surface', ['kgrid_peaks', 'calculate'])
def test_the_port_holds_the_basis_reference(surface, where):
    traj, vel, means = crystal()
    calc = host_calc(traj) if where == 'host' else resident_calc(traj, vel, means)
    k = kgrid()
    args = (vel, means, traj.masses, groups_of(traj), k)
    if surface == 'calculate':
        got = calc.calculate(np.zeros(len(k)), k, basis_atom_types=TYPES,
                             summation_mode='incoherent', k_chunk_size=7).sed
        want = sed_basis.power(*args).numpy()
        assert np.max(np.abs(got - want)) / np.max(want) < RTOL
        return
    got = calc.calculate_kgrid_peaks(k, basis_atom_types=TYPES, summation_mode='incoherent',
                                     n_peaks=3, width_method='lorentzian', k_chunk_size=7)
    want = sed_basis.kgrid_peaks(*args, DT, 3, 4)
    df = 1.0 / (traj.n_frames * DT)
    np.testing.assert_array_equal(np.rint(got[0] / df), np.rint(want[0] / df))
    assert np.max(np.abs(got[1] - want[1])) / np.max(want[1]) < RTOL
    assert np.max(np.abs(got[2] - want[2])) / df < 1e-4        # bins
    assert np.all(got[2] > 0)


@pytest.mark.parametrize('spec', [
    dict(basis_atom_types=TYPES, summation_mode='incoherent'),
    dict(basis_atom_types=[[1, 3], [2, 4]], summation_mode='incoherent'),
    dict(basis_atom_indices=[[0, 5, 9, 17], [1, 2, 30], [63]], summation_mode='incoherent'),
    dict(basis_atom_types=[1, 3], summation_mode='coherent'),
    dict(summation_mode='coherent')])
def test_a_resident_install_serves_every_group_and_reads_nothing_of_the_host(spec):
    traj, vel, means = crystal()
    k = kgrid(3)
    want = host_calc(traj).calculate(np.zeros(len(k)), k, k_chunk_size=4, **spec).sed
    calc = resident_calc(traj, vel, means)
    before = snapshot()
    got = calc.calculate(np.zeros(len(k)), k, k_chunk_size=4, **spec).sed
    counted = counted_since(before)
    np.testing.assert_array_equal(got, want)
    assert counted['groups.resident_bytes'] == counted['groups.requested_bytes'] > 0
    np.testing.assert_array_equal(calc.mean_positions64, means)


def test_the_install_is_the_all_atoms_group_and_nothing_is_gathered_for_it():
    traj, vel, means = crystal()
    calc = resident_calc(traj, vel, means)
    calc.mass_weighted = False
    k = kgrid(3)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        calc.calculate_kgrid_peaks(k, n_peaks=2, k_chunk_size=4)
    assert not [e for e in prof.events() if e.name == 'psa.groups.gather']
    assert len(calc._device_cache) == 1 and sum(calc._device_cache_bytes.values()) == 0
    (entry,) = calc._device_cache.values()
    assert entry[0].data_ptr() == calc._resident[0].data_ptr()
    calc.mass_weighted = True
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        calc.calculate_kgrid_peaks(k, basis_atom_types=TYPES, summation_mode='incoherent',
                                   k_chunk_size=4)
    assert len([e for e in prof.events() if e.name == 'psa.groups.gather']) == 4


@pytest.mark.parametrize('room', ['all', 'two'])
def test_host_groups_cross_once(room):
    """Room for the four groups: they stay, and the second call moves no
    group byte.  Room for two: the sweep streams each group once per pass of
    k-chunks (two passes of two chunks here), never once per chunk."""
    traj, _, _ = crystal(cells=(4, 4, 5), n_t=16)
    groups = groups_of(traj)
    group_bytes = [12 * traj.n_frames * len(g) for g in groups]
    calc = host_calc(traj)
    if room == 'two':
        calc.max_device_bytes = calc._entry_bytes(groups[0])
    k = kgrid(4)[:20]
    kw = dict(basis_atom_types=TYPES, summation_mode='incoherent', n_peaks=2, k_chunk_size=5)
    counts = []
    for _ in range(2):
        before = snapshot()
        out = calc.calculate_kgrid_peaks(k, **kw)
        counts.append(counted_since(before))
    asked = 4 * sum(group_bytes)                     # four chunks
    assert [c['groups.requested_bytes'] for c in counts] == [asked, asked]
    if room == 'all':
        assert calc.streamed_bytes == 0 and len(calc._device_cache) == 4
        assert [c.get('groups.resident_bytes', 0) for c in counts] == [3 * sum(group_bytes), asked]
        return
    assert calc._streamed_groups(groups) == [True] * 4 and not calc._device_cache
    assert calc.streamed_bytes == 2 * 2 * sum(group_bytes)       # two calls of two passes
    assert all('groups.resident_bytes' not in c for c in counts)
    ref = host_calc(traj).calculate_kgrid_peaks(k, **kw)
    np.testing.assert_array_equal(out[0], ref[0])
    assert np.max(np.abs(out[1] - ref[1])) / np.max(ref[1]) < RTOL


def test_install_arguments_are_checked():
    traj, vel, means = crystal()
    calc = host_calc(blank(traj))
    hi, lo = (torch.from_numpy(x) for x in split_f64(means))
    with pytest.raises(ValueError, match="mean_positions64"):
        calc.preload_device_group_data(torch.from_numpy(vel), hi, lo,
                                       mean_positions64=means[:-1])
    calc.preload_device_group_data(torch.from_numpy(vel), hi, lo)
    assert calc._install_serves()
    calc.clear_device_cache()
    assert not calc._install_serves() and calc._resident is None
