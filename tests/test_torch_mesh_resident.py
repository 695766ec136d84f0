"""Resident shards on a mesh (``parallel.ResidentShards``,
``SEDCalculator.preload_mesh_group_data``) on four CPU positions, mesh
shapes (1, 4, 1) and (2, 2, 1).

* resident windows give the host source's answers bit for bit: the same
  sums in the same order;
* the spectrum holds 1e-6 of max|Φ| against the float64 oracle
  (``tests/conftest.py``) and against the benchmark's sharded reference
  (``benchmark/reference/sed_shards.py``);
* the peaks match the one-device ``calculate_kgrid_peaks`` within
  ``test_torch_parallel.py``'s peak tolerances;
* a call reads nothing from the host: a recording source sees no read, and
  ``mesh.ingest_bytes`` counts the k-vectors alone;
* ``mesh.exchange_bytes`` counts the partials moved between devices: on a
  mesh whose atom shards but the first lie on other devices ('cpu:a', which
  torch places on the one CPU) every partial but the first of its (t, k)
  cell, (A − 1) × 2 × n_t × 3 × K × 4 bytes, with the one-device sums bit
  for bit; on one device none;
* a window missing, of the wrong shape or type, or on another device
  raises, and so does a call on another mesh than the resident one.
"""
import numpy as np
import pytest
import torch

from psa_tpu_torch import SEDCalculator
from psa_tpu_torch import parallel as tpar
from psa_tpu_torch.models import make_random_crystal_trajectory
from psa_tpu_torch.ops.spectral import split_f64
from psa_tpu_torch.parallel import sharded as tsh
from psa_tpu_torch.utils import profiling

from benchmark.reference import sed_shards
from conftest import reference_sed_oracle

torch.set_num_threads(1)

SHAPES = [(1, 4, 1), (2, 2, 1)]
K6 = np.outer(np.linspace(0, 1.0, 6), [1, 0.5, 0]).astype(np.float32)
N_PEAKS = 2


@pytest.fixture(scope='module')
def traj():
    return make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2, n_frames=16,
                                          dt_ps=0.02, seed=9)


@pytest.fixture(scope='module')
def mean64(traj):
    return traj.positions.astype(np.float64).mean(axis=0)


def mesh_of(shape):
    return tpar.make_mesh(shape=shape, devices=['cpu'] * 4)


def resident_parts(mesh, data, mean64):
    """({position: window}, {position: hi}, {position: lo}) of ``data`` on ``mesh``."""
    t_sh, a_sh, _ = mesh.devices.shape
    rows = data.shape[0] // t_sh
    hi, lo = split_f64(mean64)
    parts = ({}, {}, {})
    for t, a, k, dev in mesh.local_positions():
        a0, a1 = tsh._shards(data.shape[1], a_sh)[a]
        for store, x in zip(parts, (data[t * rows:(t + 1) * rows, a0:a1], hi[a0:a1], lo[a0:a1])):
            store[(t, a, k)] = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)
    return parts


def resident_calc(traj, mesh, mean64):
    calc = SEDCalculator(traj, nx=3, ny=2, nz=2, device='cpu')
    calc.preload_mesh_group_data(mesh, *resident_parts(mesh, traj.velocities, mean64))
    return calc


def peak_args(traj):
    freqs = np.fft.fftfreq(traj.n_frames, traj.dt_ps)
    keep = freqs >= 0
    return dict(freq_indices=np.flatnonzero(keep), n_peaks=N_PEAKS,
                peak_freqs_thz=freqs[keep].astype(np.float32))


def of_max(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize('shape', SHAPES)
def test_resident_equals_the_host_source_bit_for_bit(traj, mean64, shape):
    mesh = mesh_of(shape)
    calc = resident_calc(traj, mesh, mean64)
    resident = calc._resident_shards
    for a, b in zip(tsh.sharded_sed_spectrum(mesh, resident, None, K6),
                    tsh.sharded_sed_spectrum(mesh, traj.velocities, mean64, K6)):
        assert np.array_equal(a, b)
    for a, b in zip(tsh.sharded_sed_spectrum(mesh, resident, None, K6, **peak_args(traj)),
                    tsh.sharded_sed_spectrum(mesh, tpar.ArrayBlockSource(traj.velocities),
                                             mean64, K6, **peak_args(traj))):
        assert np.array_equal(a, b)
    host = tpar.ArrayBlockSource(traj.velocities)
    for a, b in zip(calc.calculate_kgrid_peaks_sharded(mesh, K6, n_peaks=N_PEAKS),
                    calc.calculate_kgrid_peaks_sharded(mesh, K6, n_peaks=N_PEAKS, data=host)):
        assert np.array_equal(a, b)
    got, want = (calc.calculate_kgrid_browse_sharded(mesh, K6, **kw)
                 for kw in ({}, {'data': host}))
    assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


@pytest.mark.parametrize('shape', SHAPES)
def test_resident_spectrum_holds_the_oracle_and_the_sharded_reference(traj, mean64, shape):
    mesh = mesh_of(shape)
    resident = resident_calc(traj, mesh, mean64)._resident_shards
    re, im = tsh.sharded_sed_spectrum(mesh, resident, None, K6)
    got = re + 1j * im
    assert of_max(got, reference_sed_oracle(traj, K6)) <= 1e-6
    shards = [(a0, a1, torch.from_numpy(np.ascontiguousarray(traj.velocities[:, a0:a1])))
              for a0, a1 in tsh._shards(traj.n_atoms, 4)]
    assert of_max(got, sed_shards.phi(shards, mean64, K6)) <= 1e-6


@pytest.mark.parametrize('shape', SHAPES)
def test_resident_peaks_match_one_device(traj, mean64, shape):
    mesh = mesh_of(shape)
    calc = resident_calc(traj, mesh, mean64)
    got = calc.calculate_kgrid_peaks_sharded(mesh, K6, n_peaks=N_PEAKS)
    want = calc.calculate_kgrid_peaks(K6, n_peaks=N_PEAKS)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize('shape', SHAPES)
def test_a_resident_call_reads_nothing_from_the_host(traj, mean64, shape, monkeypatch):
    mesh = mesh_of(shape)
    calc = resident_calc(traj, mesh, mean64)
    reads = []
    orig = tpar.ArrayBlockSource.read_block

    def recording(self, *window):
        reads.append(window)
        return orig(self, *window)
    monkeypatch.setattr(tpar.ArrayBlockSource, 'read_block', recording)
    before = profiling.snapshot()
    calc.calculate_kgrid_peaks_sharded(mesh, K6, n_peaks=N_PEAKS)
    counted = profiling.counted_since(before)
    assert reads == []
    assert counted['mesh.ingest_bytes'] == K6.nbytes            # one device: one copy of k
    calc.calculate_kgrid_peaks_sharded(mesh, K6, n_peaks=N_PEAKS,
                                       data=tpar.ArrayBlockSource(traj.velocities))
    assert len(reads) == np.prod(shape[:2])                     # the host source is read


@pytest.mark.parametrize('shape', SHAPES)
def test_exchange_bytes_count_every_partial_but_the_first(traj, mean64, shape):
    t_sh, a_sh, _ = shape
    apart = tpar.make_mesh(shape=shape, devices=['cpu' if a == 0 else f'cpu:{a}'
                                                 for t in range(t_sh) for a in range(a_sh)])
    before = profiling.snapshot()
    moved = tsh.sharded_sed_spectrum(apart, traj.velocities, mean64, K6)
    counted = profiling.counted_since(before)
    assert counted['mesh.exchange_bytes'] == (a_sh - 1) * 2 * traj.n_frames * 3 * len(K6) * 4
    for a, b in zip(moved, tsh.sharded_sed_spectrum(mesh_of(shape), traj.velocities, mean64, K6)):
        assert np.array_equal(a, b)
    mesh = mesh_of(shape)
    calc = resident_calc(traj, mesh, mean64)
    before = profiling.snapshot()
    calc.calculate_kgrid_peaks_sharded(mesh, K6, n_peaks=N_PEAKS)
    assert profiling.counted_since(before).get('mesh.exchange_bytes', 0) == 0   # one device


@pytest.mark.parametrize('shape', SHAPES)
def test_a_call_on_another_mesh_than_the_resident_one_raises(traj, mean64, shape):
    calc = resident_calc(traj, mesh_of(shape), mean64)
    other = mesh_of(shape)
    with pytest.raises(ValueError, match="resident on another mesh"):
        calc.calculate_kgrid_peaks_sharded(other, K6, n_peaks=N_PEAKS)
    host = tpar.ArrayBlockSource(traj.velocities)
    for a, b in zip(calc.calculate_kgrid_peaks_sharded(other, K6, n_peaks=N_PEAKS, data=host),
                    calc.calculate_kgrid_peaks_sharded(calc.resident_mesh, K6,
                                                       n_peaks=N_PEAKS)):
        assert np.array_equal(a, b)


def test_a_misplaced_shard_raises(traj, mean64):
    mesh = mesh_of((1, 4, 1))
    calc = SEDCalculator(traj, nx=3, ny=2, nz=2, device='cpu')
    windows, hi, lo = resident_parts(mesh, traj.velocities, mean64)
    cases = {
        'another device': ({**windows, (0, 1, 0): windows[(0, 1, 0)].to('meta')}, hi, lo),
        'a wrong shape': ({**windows, (0, 2, 0): windows[(0, 2, 0)][:, 1:]}, hi, lo),
        'float64': (windows, {**hi, (0, 3, 0): hi[(0, 3, 0)].double()}, lo),
        'a mean on another device': (windows, hi, {**lo, (0, 0, 0): lo[(0, 0, 0)].to('meta')}),
        'a position missing': ({p: w for p, w in windows.items() if p != (0, 3, 0)}, hi, lo),
    }
    for what, parts in cases.items():
        with pytest.raises(ValueError):
            calc.preload_mesh_group_data(mesh, *parts)
        assert calc.resident_mesh is None, what
    calc.preload_mesh_group_data(mesh, windows, hi, lo)
    assert calc.resident_mesh is mesh
    with pytest.raises(ValueError, match="one time superchunk"):
        calc.calculate_kgrid_peaks_sharded(mesh, K6, n_peaks=N_PEAKS, t_superchunk=8)
    calc.clear_device_cache()
    assert calc.resident_mesh is None
