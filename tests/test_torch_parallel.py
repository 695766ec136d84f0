"""psa_tpu_torch.parallel against the JAX package and the float64 oracle on
eight-position meshes: the JAX side on its eight virtual CPU devices
(``tests/conftest.py``), the port on ``['cpu'] * 8``, the same seeded
inputs, the mesh shapes of ``tests/test_parallel.py``.

Tolerances (the JAX tests' own):

* spectra against the float64 oracle: 1e-6 of max, each package; the port
  against JAX and against its own one-device path: 1e-6 of max;
* browse/L-T planes against the one-device path: rtol 1e-5, atol 1e-8;
* peaks: frequencies within 1e-6 THz, heights rtol 1e-4, widths rtol 1e-3
  and atol 1e-5; chiral phases within 1e-4 rad;
* a rerun of the same mesh, and a tiled source against its materialized
  tiling: bit for bit.

On the CPU every shard's projection goes through the kernel's wrapper,
which runs its plain version there; the wrapper is counted to show it.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu import parallel as jpar
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu_torch import parallel as tpar
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.parallel import sharded as tsh

from conftest import reference_sed_oracle

torch.set_num_threads(1)

SHAPES = [(1, 1, 8), (1, 2, 4), (2, 2, 2), (1, 8, 1), (2, 1, 4)]
K9 = np.outer(np.linspace(0, 1.1, 9), [1, 0, 0]).astype(np.float32)
K5 = np.outer(np.linspace(0, 1.0, 5), [1, 0, 0]).astype(np.float32)
KG = np.outer(np.linspace(0, 1.0, 6), [1, 0.5, 0]).astype(np.float32)


def tmesh(shape, **kw):
    return tpar.make_mesh(shape=shape, devices=['cpu'] * 8, **kw)


def of_max(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


class RecordingSource(tpar.ArrayBlockSource):
    """ArrayBlockSource that records every block read."""

    def __init__(self, data):
        super().__init__(data)
        self.reads = []

    def read_block(self, t0, t1, a0, a1):
        self.reads.append((t0, t1, a0, a1))
        return super().read_block(t0, t1, a0, a1)


class FailingSource(RecordingSource):
    def __init__(self, data, fail_from_t):
        super().__init__(data)
        self.fail_from_t = fail_from_t

    def read_block(self, t0, t1, a0, a1):
        if t0 >= self.fail_from_t:
            raise OSError(f"injected read failure at t0={t0}")
        return super().read_block(t0, t1, a0, a1)


@pytest.fixture(scope='module')
def traj():
    return make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2, n_frames=16,
                                          dt_ps=0.02, seed=9)


@pytest.fixture(scope='module')
def mean64(traj):
    return traj.positions.astype(np.float64).mean(axis=0)


@pytest.fixture(scope='module')
def calcs(traj):
    ref = JaxCalculator(traj, nx=3, ny=2, nz=2)
    return ref, from_reference_calculator(ref, device='cpu')


@pytest.fixture
def counted(monkeypatch):
    """Calls of the projection wrapper made by the mesh sweeps."""
    calls = []
    inner = tsh.sed_projection

    def wrapper(data, *args, **kw):
        calls.append(tuple(data.shape))
        return inner(data, *args, **kw)
    monkeypatch.setattr(tsh, 'sed_projection', wrapper)
    return calls


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,expected_prod", [(1, 1), (2, 2), (4, 4), (8, 8), (6, 6)])
def test_mesh_shape_factorization_matches_jax(n, expected_prod):
    shape = tpar.mesh_shape_for(n)
    assert shape == jpar.mesh_shape_for(n) and np.prod(shape) == expected_prod


@pytest.mark.parametrize("kw", [
    dict(n_devices=8, n_t=10),
    dict(n_devices=8, n_t=16, n_atoms=100, hbm_bytes=8 * 2 ** 30),
    dict(n_devices=256, n_t=100_000, n_atoms=1_000_000, hbm_bytes=16 * 2 ** 30),
    dict(n_devices=64, n_t=12_800, n_atoms=500_000, hbm_bytes=16 * 2 ** 30),
    dict(n_devices=8, n_t=100_000, n_atoms=1_000_000, hbm_bytes=4 * 2 ** 30),
], ids=['time-divides', 'small', 'pod', 'partial', 'infeasible'])
def test_mesh_shape_budget_matches_jax(kw):
    assert tpar.mesh_shape_for(**kw) == jpar.mesh_shape_for(**kw)


def test_mesh_shape_auto_reads_the_card(monkeypatch):
    """'auto' is half the card's own memory, never the JAX package's 16 GiB
    TPU figure; on the CPU it raises."""
    with pytest.raises(ValueError, match="budget in bytes"):
        tpar.mesh_shape_for(8, n_t=16, n_atoms=100, hbm_bytes='auto', device='cpu')

    class Props:
        total_memory = 80 * 10 ** 9
    monkeypatch.setattr(torch.cuda, 'get_device_properties', lambda dev: Props)
    shape = tpar.mesh_shape_for(8, n_t=10_000, n_atoms=2_000_000, hbm_bytes='auto')
    assert shape == jpar.mesh_shape_for(8, n_t=10_000, n_atoms=2_000_000,
                                        hbm_bytes=40 * 10 ** 9)


def test_k_outer_places_k_stripes_like_jax():
    devs = [f'cpu:{i}' for i in range(8)]
    mesh = tpar.make_mesh(shape=(2, 2, 2), devices=devs, k_outer=True)
    jmesh = jpar.make_mesh(shape=(2, 2, 2), k_outer=True)
    jids = np.vectorize(lambda d: d.id)(jmesh.devices)
    tids = np.vectorize(lambda d: d.index)(mesh.devices)
    np.testing.assert_array_equal(tids, jids)
    np.testing.assert_array_equal(np.vectorize(lambda d: d.index)(
        tpar.make_mesh(shape=(2, 2, 2), devices=devs).devices),
        np.vectorize(lambda d: d.id)(jpar.make_mesh(shape=(2, 2, 2)).devices))
    assert mesh.shape == {'t': 2, 'a': 2, 'k': 2} and mesh.world == 1


def test_make_mesh_validation():
    with pytest.raises(ValueError, match="does not cover"):
        tpar.make_mesh(shape=(2, 2, 1), devices=['cpu'] * 8)
    with pytest.raises(ValueError, match="cuda"):
        tpar.make_mesh(devices=['mps'])
    assert tpar.make_mesh(n_devices=4, devices=['cpu'] * 8).size == 4


# ---------------------------------------------------------------------------
# the SED over the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES)
def test_sharded_matches_oracle_jax_and_one_device(traj, mean64, calcs, shape, counted):
    _, port = calcs
    re, im = tpar.sharded_sed_spectrum(tmesh(shape), traj.velocities, mean64, K9)
    jre, jim = jpar.sharded_sed_spectrum(jpar.make_mesh(shape=shape), traj.velocities,
                                         mean64, K9)
    oracle = reference_sed_oracle(traj, K9)
    got = re + 1j * im
    assert of_max(got, oracle) < 1e-6
    assert of_max(jre + 1j * jim, oracle) < 1e-6
    assert of_max(got, jre + 1j * jim) < 1e-6
    assert of_max(got, port.calculate(np.zeros(9), K9).sed) < 1e-6
    t, a, k = shape
    # one projection per position whose atom shard and k stripe are not empty
    assert len(counted) == t * a * len([s for s in tsh._shards(9, k) if s[1] > s[0]])


def test_rerun_is_bitwise(traj, mean64):
    mesh = tmesh((2, 2, 2))
    first = tpar.sharded_sed_spectrum(mesh, traj.velocities, mean64, K9, t_superchunk=4)
    again = tpar.sharded_sed_spectrum(mesh, traj.velocities, mean64, K9, t_superchunk=4)
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def test_sharded_intensity(traj, mean64):
    kv = np.outer(np.linspace(0, 1.1, 5), [0, 1, 0]).astype(np.float32)
    inten = tpar.sharded_sed_spectrum(tmesh((2, 2, 2)), traj.velocities, mean64, kv,
                                      want_intensity=True)
    expected = np.sum(np.abs(reference_sed_oracle(traj, kv)) ** 2, axis=-1)
    assert of_max(inten, expected) < 1e-6


def test_time_axis_must_divide(traj, mean64):
    re, im = tpar.sharded_sed_spectrum(tmesh((8, 1, 1)), traj.velocities, mean64, K5)
    assert of_max(re + 1j * im, reference_sed_oracle(traj, K5)) < 1e-6
    bad = make_random_crystal_trajectory(n_cells_xyz=(2, 2, 1), n_frames=15, seed=1)
    with pytest.raises(ValueError, match="time axis"):
        tpar.sharded_sed_spectrum(tmesh((2, 2, 2)), bad.velocities,
                                  bad.positions.astype(np.float64).mean(0), K5)


@pytest.mark.parametrize("shape,t_superchunk,prefetch", [
    ((1, 2, 4), 4, True), ((2, 2, 2), 4, True), ((2, 2, 2), 6, False),
    ((4, 1, 2), 8, True), ((1, 8, 1), 3, True)])
def test_streamed_superchunks_match_oracle_and_jax(traj, mean64, shape, t_superchunk,
                                                   prefetch):
    re, im = tpar.sharded_sed_spectrum(tmesh(shape), traj.velocities, mean64, K9,
                                       t_superchunk=t_superchunk, prefetch=prefetch)
    jre, jim = jpar.sharded_sed_spectrum(jpar.make_mesh(shape=shape), traj.velocities,
                                         mean64, K9, t_superchunk=t_superchunk,
                                         prefetch=prefetch)
    assert of_max(re + 1j * im, reference_sed_oracle(traj, K9)) < 1e-6
    assert of_max(re + 1j * im, jre + 1j * jim) < 1e-6


def test_prefetch_error_propagates(traj, mean64):
    src = FailingSource(traj.velocities, fail_from_t=8)
    with pytest.raises(RuntimeError, match="prefetch of superchunk") as ei:
        tpar.sharded_sed_spectrum(tmesh((2, 2, 2)), src, mean64, K5, t_superchunk=4,
                                  prefetch=True)
    assert isinstance(ei.value.__cause__, OSError)


def test_reads_are_per_window_once_per_process(traj, mean64):
    """Each (t, a) window is read once per superchunk, whatever the k
    extent, and no read exceeds one window."""
    src = RecordingSource(traj.velocities)
    re, im = tpar.sharded_sed_spectrum(tmesh((2, 2, 2)), src, mean64, K5, t_superchunk=4)
    assert of_max(re + 1j * im, reference_sed_oracle(traj, K5)) < 1e-6
    budget = 4 * 3 * 4 * traj.n_atoms // 2
    assert max(4 * 3 * (t1 - t0) * (a1 - a0) for t0, t1, a0, a1 in src.reads) <= budget
    assert len(src.reads) == (traj.n_frames // 4) * 2 * 2
    assert len(set(src.reads)) == len(src.reads)


def test_memmap_source(traj, mean64, tmp_path):
    path = tmp_path / "vel.npy"
    np.save(path, traj.velocities)
    kv = np.outer(np.linspace(0, 1.0, 5), [1, 1, 0]).astype(np.float32)
    re, im = tpar.sharded_sed_spectrum(tmesh((1, 2, 4)), np.load(path, mmap_mode='r'),
                                       mean64, kv, t_superchunk=4)
    assert of_max(re + 1j * im, reference_sed_oracle(traj, kv)) < 1e-6


def test_freq_indices_filter_matches_full(traj, mean64):
    mesh = tmesh((2, 2, 2))
    full_re, full_im = tpar.sharded_sed_spectrum(mesh, traj.velocities, mean64, K5)
    idx = np.array([0, 2, 5, 7], dtype=np.int32)
    re, im = tpar.sharded_sed_spectrum(mesh, traj.velocities, mean64, K5, freq_indices=idx)
    np.testing.assert_array_equal(re, full_re[idx])
    np.testing.assert_array_equal(im, full_im[idx])
    inten = tpar.sharded_sed_spectrum(mesh, traj.velocities, mean64, K5,
                                      want_intensity=True, freq_indices=idx)
    np.testing.assert_allclose(inten, np.sum(full_re[idx] ** 2 + full_im[idx] ** 2, -1),
                               rtol=1e-6)


def test_peaks_match_jax_and_one_device(traj, mean64, calcs):
    _, port = calcs
    freqs = np.fft.fftfreq(traj.n_frames, traj.dt_ps)
    mask = freqs >= 0
    kw = dict(t_superchunk=8, freq_indices=np.flatnonzero(mask).astype(np.int32), n_peaks=2,
              peak_freqs_thz=freqs[mask].astype(np.float32))
    kv = np.outer(np.linspace(0, 1.0, 6), [1, 0, 0]).astype(np.float32)
    got = tpar.sharded_sed_spectrum(tmesh((2, 2, 2)), traj.velocities, mean64, kv, **kw)
    jax_got = jpar.sharded_sed_spectrum(jpar.make_mesh(shape=(2, 2, 2)), traj.velocities,
                                        mean64, kv, **kw)
    for want in (jax_got, port.calculate_kgrid_peaks(kv, n_peaks=2)):
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-3, atol=1e-5)
    with pytest.raises(ValueError, match="n_peaks requires"):
        tpar.sharded_sed_spectrum(tmesh((1, 1, 8)), traj.velocities, mean64,
                                  np.zeros((4, 3), np.float32), n_peaks=1)


# ---------------------------------------------------------------------------
# group semantics through the calculator (tests/test_parallel.py's cases)
# ---------------------------------------------------------------------------

GROUP_CASES = {
    'coherent-subset': ('browse', (2, 2, 2), dict(basis_atom_types=[1], t_superchunk=8)),
    'incoherent': ('browse', (2, 2, 2), dict(basis_atom_types=[1, 2],
                                             summation_mode='incoherent', t_superchunk=4)),
    'chiral-browse': ('browse', (1, 2, 4), dict(chiral=True, chiral_axis='z')),
    'chiral-peaks': ('peaks', (2, 2, 2), dict(n_peaks=2, chiral=True, t_superchunk=8)),
    'incoherent-peaks': ('peaks', (2, 2, 2), dict(basis_atom_types=[1, 2],
                                                  summation_mode='incoherent', n_peaks=2)),
    'lt': ('lt', (2, 2, 2), dict(t_superchunk=8)),
    'lt-incoherent': ('lt', (2, 2, 2), dict(basis_atom_types=[1, 2],
                                            summation_mode='incoherent', t_superchunk=4)),
    'welch-browse': ('browse', (2, 2, 2), dict(welch_segments=2, t_superchunk=8)),
    'welch-chiral-peaks': ('peaks', (1, 2, 4), dict(n_peaks=2, chiral=True,
                                                    welch_segments=2)),
}


def _one_device(calc, kind, kw):
    kw = {k: v for k, v in kw.items() if k != 't_superchunk'}
    return {'browse': calc.calculate_kgrid_browse, 'peaks': calc.calculate_kgrid_peaks,
            'lt': calc.calculate_lt}[kind](KG, **kw)


def _sharded(calc, kind, mesh, kw):
    return {'browse': calc.calculate_kgrid_browse_sharded,
            'peaks': calc.calculate_kgrid_peaks_sharded,
            'lt': calc.calculate_lt_sharded}[kind](mesh, KG, **kw)


def _assert_surface(kind, got, want):
    if kind == 'peaks':
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-3, atol=1e-5)
        if len(want) == 4:
            np.testing.assert_allclose(got[3], want[3], atol=1e-4)
        return
    np.testing.assert_allclose(got[0], want[0], atol=0)                # frequencies
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-8)
    if kind == 'lt':
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-8)
    elif want[2] is not None:
        np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    else:
        assert got[2] is None


@pytest.mark.parametrize("case", list(GROUP_CASES))
def test_group_semantics_match_one_device_and_jax(calcs, case):
    ref, port = calcs
    kind, shape, kw = GROUP_CASES[case]
    got = _sharded(port, kind, tmesh(shape), kw)
    _assert_surface(kind, got, _one_device(port, kind, kw))
    _assert_surface(kind, got, _sharded(ref, kind, jpar.make_mesh(shape=shape), kw))


@pytest.mark.parametrize("mode", ['displacement', 'mass'])
def test_displacement_and_mass_weighted(traj, mode):
    if mode == 'mass':
        traj = dataclasses.replace(traj, masses=np.where(traj.types == 1, 1.0, 3.5)
                                   .astype(np.float32))
        kw, shape = dict(mass_weighted=True), (1, 4, 2)
    else:
        kw, shape = dict(use_displacements=True), (2, 2, 2)
    ref = JaxCalculator(traj, nx=3, ny=2, nz=2, **kw)
    port = from_reference_calculator(ref, device='cpu')
    got = port.calculate_kgrid_browse_sharded(tmesh(shape), KG, t_superchunk=8)
    _assert_surface('browse', got, port.calculate_kgrid_browse(KG))
    _assert_surface('browse', got, ref.calculate_kgrid_browse_sharded(
        jpar.make_mesh(shape=shape), KG, t_superchunk=8))


def test_multi_group_streams_data_once(traj, calcs):
    _, port = calcs
    src = RecordingSource(traj.velocities)
    port.calculate_kgrid_browse_sharded(tmesh((2, 2, 2)), KG, basis_atom_types=[1, 2],
                                        summation_mode='incoherent', t_superchunk=4, data=src)
    assert len(src.reads) == (traj.n_frames // 4) * 2 * 2


@pytest.mark.parametrize("kwargs,match", [
    (dict(lt=True), "lt=True requires"),
    (dict(lt=True, freq_indices=np.arange(4), comp_pair=(0, 1)), "exclusive"),
    (dict(atom_weights=[np.ones(24), np.ones(24)]), "incoherent"),
    (dict(want_intensity=True, atom_weights=[np.ones(3, np.float32)] * 2),
     "atom_weights entries"),
    (dict(comp_pair=(0, 1)), "comp_pair requires"),
    (dict(lt=True, freq_indices=np.arange(4), welch_segments=2), "does not support"),
], ids=['lt-needs-freq', 'lt-exclusive', 'incoherent-needs-intensity', 'weight-shape',
        'chiral-needs-planes', 'welch-lt'])
def test_validation(traj, mean64, kwargs, match):
    with pytest.raises(ValueError, match=match):
        tpar.sharded_sed_spectrum(tmesh((1, 1, 8)), traj.velocities, mean64, KG, **kwargs)


REFUSED = {
    'chiral-incoherent': dict(chiral=True, basis_atom_types=[1, 2],
                              summation_mode='incoherent'),
    'welch-gridded': dict(welch_segments=2, engine='gridded', k_grid_shape=(2, 3)),
    'no-peaks': dict(n_peaks=0),
    'no-kept-row': dict(max_freq=-1.0),
    'summation-mode': dict(summation_mode='bogus'),
}


@pytest.mark.parametrize("kind,case", [
    ('browse', 'chiral-incoherent'), ('peaks', 'chiral-incoherent'),
    ('browse', 'welch-gridded'), ('peaks', 'welch-gridded'),
    ('peaks', 'no-peaks'), ('peaks', 'no-kept-row'),
    ('browse', 'summation-mode'), ('peaks', 'summation-mode'), ('lt', 'summation-mode'),
])
def test_mesh_surfaces_refuse_as_their_one_device_twins(calcs, kind, case):
    """Each mesh surface refuses what its one-device twin refuses, with the
    same message."""
    _, port = calcs
    with pytest.raises(ValueError) as one:
        _one_device(port, kind, REFUSED[case])
    with pytest.raises(ValueError) as mesh:
        _sharded(port, kind, tmesh((1, 1, 8)), REFUSED[case])
    assert str(mesh.value) == str(one.value)


# ---------------------------------------------------------------------------
# block sources
# ---------------------------------------------------------------------------

def _write_dump(traj, path):
    with open(path, "w") as f:
        for t in range(traj.n_frames):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{traj.n_atoms}\n")
            f.write("ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                f.write(f"0.0 {traj.box_matrix[d, d]:.6f}\n")
            f.write("ITEM: ATOMS id type x y z vx vy vz\n")
            for a in range(traj.n_atoms):
                p, v = traj.positions[t, a], traj.velocities[t, a]
                f.write(f"{a + 1} {traj.types[a]} {p[0]:.8f} {p[1]:.8f} {p[2]:.8f} "
                        f"{v[0]:.8f} {v[1]:.8f} {v[2]:.8f}\n")
    return path


def test_dump_feeds_mesh_and_siblings_share_a_parse(traj, tmp_path):
    from psa_tpu_torch.io import native
    if not native.bulk_dump_available():
        pytest.skip("native parallel parser unavailable")
    src = tpar.DumpBlockSource(_write_dump(traj, tmp_path / "mesh.dump"))
    assert (src.n_frames, src.n_atoms) == (traj.n_frames, traj.n_atoms)
    re, im = tpar.sharded_sed_spectrum(tmesh((2, 2, 2)), src, src.mean_positions64(), K5,
                                       t_superchunk=4)
    assert of_max(re + 1j * im, reference_sed_oracle(traj, K5)) < 1e-5   # 8-decimal text
    pos_src = src.sibling('positions')
    parses = []
    inner = src._src.frames
    src._src.frames = lambda i, j: (parses.append((i, j)), inner(i, j))[1]
    for t0, t1 in [(0, 4), (4, 8)]:
        np.testing.assert_allclose(pos_src.read_block(t0, t1, 0, traj.n_atoms),
                                   traj.positions[t0:t1], atol=1e-6)
        np.testing.assert_allclose(src.read_block(t0, t1, 0, traj.n_atoms),
                                   traj.velocities[t0:t1], atol=1e-6)
    assert parses == [(0, 4), (4, 8)]
    src.close()


def test_tiled_source_blocks_and_views():
    pool = np.random.default_rng(4).normal(size=(3, 7, 3)).astype(np.float32)
    src, jsrc = tpar.TiledBlockSource(pool, n_frames=11), jpar.TiledBlockSource(pool, 11)
    for w in [(0, 3, 0, 7), (3, 6, 2, 5), (2, 7, 0, 7), (9, 11, 1, 4), (0, 11, 0, 7)]:
        np.testing.assert_array_equal(src.read_block(*w), jsrc.read_block(*w))
    zero = np.zeros((4, 5, 3), np.float32)
    tiled = tpar.TiledBlockSource(zero, n_frames=20)
    assert np.shares_memory(tiled.read_block(8, 12, 1, 4), zero)
    assert not np.shares_memory(tiled.read_block(3, 6, 0, 5), zero)
    with pytest.raises(ValueError, match="pool"):
        tpar.TiledBlockSource(np.zeros((4, 5), np.float32), n_frames=8)
    with pytest.raises(ValueError, match="n_frames"):
        tpar.TiledBlockSource(zero, n_frames=0)
    with pytest.raises(ValueError, match="time window"):
        tpar.TiledBlockSource(zero, n_frames=8).read_block(6, 9, 0, 5)


def test_tiled_source_mesh_parity(traj, mean64):
    pool = traj.velocities[:4]
    tiled = pool[np.arange(traj.n_frames) % 4]
    mesh = tmesh((2, 2, 2))
    got = tpar.sharded_sed_spectrum(mesh, tpar.TiledBlockSource(pool, traj.n_frames), mean64,
                                    K5, t_superchunk=4)
    want = tpar.sharded_sed_spectrum(mesh, tiled, mean64, K5, t_superchunk=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_mesh_info_without_a_group():
    info = tpar.global_mesh_info()
    assert info['process_index'] == 0 and info['process_count'] == 1
    assert set(info) == {'process_index', 'process_count', 'local_devices',
                         'global_devices', 'platform'}
    assert jax.device_count() == 8                    # the JAX side's virtual devices
