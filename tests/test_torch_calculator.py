"""psa_tpu_torch's SEDCalculator against the JAX package's and the f64 oracle.

Each port calculator is built from a JAX-package calculator with
``from_reference_calculator`` on the CPU, so both compute from identical
host state.
"""
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.models import make_chain_trajectory
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.core import calculator as tcalc
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.models import make_chain_trajectory as torch_chain
from psa_tpu_torch.ops import sed_projection as tproj

from conftest import reference_sed_oracle

torch.set_num_threads(1)

RTOL = 1e-6  # relative to max |oracle|


def rel_err(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def pair(traj, **kw):
    ref = JaxCalculator(traj, nx=2, ny=2, nz=2, **kw)
    return ref, from_reference_calculator(ref, device='cpu')


@pytest.fixture
def massive(small_trajectory):
    rng = np.random.default_rng(3)
    small_trajectory.masses = rng.uniform(1.0, 30.0, small_trajectory.n_atoms)
    return small_trajectory


def test_convert_carries_state(small_trajectory):
    ref, port = pair(small_trajectory, use_displacements=True)
    for name in ('a1', 'a2', 'a3', 'b1', 'b2', 'b3', 'recip_vecs_prim', 'mean_positions64'):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    assert (port.use_displacements, port.mass_weighted, port.precision, port.dt_ps,
            port.max_device_bytes) == (True, False, 'parity', ref.dt_ps, ref.max_device_bytes)
    assert port.device == torch.device('cpu')
    np.testing.assert_array_equal(port.traj.velocities, small_trajectory.velocities)


def test_constructor_matches_reference_lattice(small_trajectory):
    ref = JaxCalculator(small_trajectory, nx=3, ny=2, nz=4)
    port = SEDCalculator(small_trajectory, nx=3, ny=2, nz=4, device='cpu')
    for name in ('a1', 'a2', 'a3', 'b1', 'b2', 'b3', 'recip_vecs_prim'):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))


@pytest.mark.parametrize('direction,cov,n_k,lat', [
    ('x', 1.0, 13, None), ([1, 1, 0], 2.0, 7, None), ('111', 0.5, 1, 5.43),
    (45.0, 1.5, 9, None), ({'h': 1, 'k': 0, 'l': 1}, 1.0, 4, 2.0)])
def test_k_path_identical(small_trajectory, direction, cov, n_k, lat):
    ref, port = pair(small_trajectory)
    for a, b in zip(port.get_k_path(direction, cov, n_k, lat_param=lat),
                    ref.get_k_path(direction, cov, n_k, lat_param=lat)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize('plane', ['xy', 'yz', 'zx'])
def test_k_grid_identical(small_trajectory, plane):
    ref, port = pair(small_trajectory)
    a = port.get_k_grid(plane, (-1, 1), (-2, 2), 3, 5, k_fixed_val=0.5)
    b = ref.get_k_grid(plane, (-1, 1), (-2, 2), 3, 5, k_fixed_val=0.5)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


@pytest.mark.parametrize('case', ['coherent', 'types_union', 'index_groups_coherent',
                                  'displacements', 'mass_weighted'])
def test_coherent_matches_jax_and_oracle(small_trajectory, massive, case):
    """Coherent spectra across k-chunk boundaries (11 k-points, chunks of 4)."""
    kw, calc_kw, idx = {}, {}, None
    traj = small_trajectory
    if case == 'types_union':
        kw = dict(basis_atom_types=[1, 2])
    elif case == 'index_groups_coherent':
        kw = dict(basis_atom_indices=[[0, 1, 2], [2, 3, 4, 9]])
        idx = np.array([0, 1, 2, 3, 4, 9])
    elif case == 'displacements':
        calc_kw = dict(use_displacements=True)
    elif case == 'mass_weighted':
        traj = massive
        calc_kw = dict(mass_weighted=True)
    ref, port = pair(traj, **calc_kw)
    k_mags, k_vecs = ref.get_k_path([1, 1, 0], bz_coverage=2.0, n_k=11)
    got = port.calculate(k_mags, k_vecs, k_chunk_size=4, **kw)
    want = ref.calculate(k_mags, k_vecs, k_chunk_size=4, **kw)
    assert got.is_complex and got.sed.dtype == np.complex64
    assert got.sed.shape == (traj.n_frames, 11, 3)
    np.testing.assert_array_equal(got.freqs, want.freqs)
    orc = reference_sed_oracle(traj, k_vecs, group_idx=idx,
                               use_displacements=case == 'displacements')
    if case == 'mass_weighted':
        group = np.arange(traj.n_atoms) if idx is None else idx
        w = np.sqrt(traj.masses[group])
        mean = traj.positions.astype(np.float64).mean(axis=0)[group]
        data = traj.velocities[:, group, :].astype(np.float64) * w[None, :, None]
        orc = np.fft.fft(np.einsum('tac,ka->tkc', data,
                                   np.exp(1j * (k_vecs.astype(np.float64) @ mean.T))),
                         axis=0) / traj.n_frames
    assert rel_err(got.sed, orc) < RTOL
    assert np.max(np.abs(got.sed - want.sed)) / np.max(np.abs(orc)) < RTOL


@pytest.mark.parametrize('kw', [dict(basis_atom_types=[1, 2]),
                                dict(basis_atom_indices=[[0, 1, 2, 3], [4, 5, 6, 7, 8]])])
def test_incoherent_matches_jax_and_oracle(small_trajectory, kw):
    ref, port = pair(small_trajectory)
    k_mags, k_vecs = ref.get_k_path('x', bz_coverage=1.0, n_k=9)
    got = port.calculate(k_mags, k_vecs, summation_mode='incoherent', k_chunk_size=4, **kw)
    want = ref.calculate(k_mags, k_vecs, summation_mode='incoherent', k_chunk_size=4, **kw)
    groups = ([np.where(small_trajectory.types == t)[0] for t in (1, 2)]
              if 'basis_atom_types' in kw else [np.array(g) for g in kw['basis_atom_indices']])
    expected = sum(np.sum(np.abs(reference_sed_oracle(small_trajectory, k_vecs, group_idx=g)) ** 2,
                          axis=-1) for g in groups)
    assert not got.is_complex and got.sed.dtype == np.float32
    assert rel_err(got.sed, expected) < RTOL
    assert np.max(np.abs(got.sed - want.sed)) / np.max(expected) < 2 * RTOL


def test_grid_k_chunks_ragged(small_trajectory):
    """A k-grid in ragged chunks equals one chunk and the JAX result."""
    ref, port = pair(small_trajectory)
    _, k_vecs, shape = ref.get_k_grid('xy', (-2, 2), (-2, 2), 5, 3)
    a = port.calculate(np.array([]), k_vecs, k_grid_shape=shape, k_chunk_size=4)
    b = port.calculate(np.array([]), k_vecs, k_grid_shape=shape, k_chunk_size=1000)
    c = ref.calculate(np.array([]), k_vecs, k_grid_shape=shape, k_chunk_size=4)
    assert a.k_grid_shape == (5, 3)
    np.testing.assert_allclose(a.sed, b.sed, atol=1e-7)
    assert rel_err(a.sed, c.sed) < RTOL


def test_empty_k_and_bad_mode(small_trajectory):
    _, port = pair(small_trajectory)
    sed = port.calculate(np.array([]), np.zeros((0, 3), dtype=np.float32))
    assert sed.sed.shape == (small_trajectory.n_frames, 0, 3)
    with pytest.raises(ValueError, match="summation_mode"):
        port.calculate(np.zeros(1), np.zeros((1, 3), np.float32), summation_mode='bogus')


@pytest.mark.parametrize('opt', ['A', 'B', 'C'])
def test_chiral_phase_matches_jax(small_trajectory, opt):
    ref, port = pair(small_trajectory)
    rng = np.random.default_rng(11)
    z1 = (rng.normal(size=(6, 5)) + 1j * rng.normal(size=(6, 5))).astype(np.complex64)
    z2 = (rng.normal(size=(6, 5)) + 1j * rng.normal(size=(6, 5))).astype(np.complex64)
    got = port.calculate_chiral_phase(z1, z2, angle_range_opt=opt)
    want = ref.calculate_chiral_phase(z1, z2, angle_range_opt=opt)
    fold = {'A': np.cos, 'B': np.sin, 'C': lambda x: x}[opt]
    np.testing.assert_allclose(fold(got), fold(want), atol=2e-6)
    assert port.calculate_chiral_phase(z1[:0], z2[:0]).shape == (0, 5)
    with pytest.raises(ValueError, match="shapes must match"):
        port.calculate_chiral_phase(z1, z2[:2])


def test_chain_dispersion_physics():
    a, nu_max, n_cells = 2.5, 10.0, 32
    traj = torch_chain(n_cells=n_cells, n_frames=256, dt_ps=0.02, a=a,
                       omega_max_thz=nu_max, seed=0)
    calc = SEDCalculator(traj, nx=n_cells, ny=1, nz=1, device='cpu')
    k_mags, k_vecs = calc.get_k_path('x', bz_coverage=0.5, n_k=n_cells // 2 + 1)
    sed = calc.calculate(k_mags, k_vecs)
    pos = sed.freqs >= 0
    peaks = sed.freqs[pos][np.argmax(sed.intensity[pos], axis=0)]
    analytic = nu_max * np.abs(np.sin(k_mags * a / 2))
    df = 1.0 / (traj.n_frames * traj.dt_ps)
    assert np.all(np.abs(peaks[1:] - analytic[1:]) <= df + 1e-6)


def _read_dump(path):
    frames = []
    lines = path.read_text().splitlines()
    i = 0
    while i < len(lines):
        if lines[i] == 'ITEM: NUMBER OF ATOMS':
            n = int(lines[i + 1])
        if lines[i].startswith('ITEM: ATOMS'):
            frames.append(np.array([[float(x) for x in ln.split()] for ln in lines[i + 1:i + 1 + n]]))
            i += n
        i += 1
    header = [ln for ln in lines if not ln[:1].isdigit() or ln.count(' ') < 4]
    return np.stack(frames), header


@pytest.mark.parametrize('kw', [
    dict(k_dir_spec='x', k_target=0.6, w_target=5.0, char_len_k_path=2.5,
         nk_on_path=20, rescale_factor='auto', n_recon_frames=10),
    dict(k_dir_spec=[1, 0, 0], k_target=0.5, w_target=5.0, char_len_k_path=2.5,
         nk_on_path=12, basis_atom_idx_ised=[[0, 2, 4], [1, 3]],
         rescale_factor=2.0, n_recon_frames=4)])
def test_ised_dump_matches_jax(tmp_path, kw):
    traj = make_chain_trajectory(n_cells=16, n_frames=64, dt_ps=0.05)
    ref = JaxCalculator(traj, nx=16, ny=1, nz=1)
    port = from_reference_calculator(ref, device='cpu')
    ref.ised(dump_filepath=str(tmp_path / 'jax.dump'), **kw)
    port.ised(dump_filepath=str(tmp_path / 'torch.dump'), **kw)
    got, got_head = _read_dump(tmp_path / 'torch.dump')
    want, want_head = _read_dump(tmp_path / 'jax.dump')
    assert got.shape == (kw['n_recon_frames'], 16, 5)
    assert got_head == want_head
    np.testing.assert_array_equal(got[..., :2], want[..., :2])
    np.testing.assert_allclose(got[..., 2:], want[..., 2:], atol=2e-6)


@pytest.mark.parametrize('call', ['cache_dir', 'streamed', 'npt', 'plot'])
def test_unported_paths_raise(tmp_path, small_trajectory, call):
    """Nothing of these still raises: the shard cache, groups over
    max_device_bytes, NPT iSED and the iSED figure are ported, so each case
    holds the port to the JAX package on the same call instead (NPT iSED on
    a trajectory without per-frame cells raises the same ValueError in
    both; ``plot_dir_ised`` writes the same figure file in both)."""
    ref, port = pair(small_trajectory)
    k_mags, k_vecs = port.get_k_path('x', 1.0, 3)
    if call in ('cache_dir', 'streamed'):
        kw = dict(cache_dir=tmp_path) if call == 'cache_dir' else {}
        if call == 'streamed':
            ref.max_device_bytes = port.max_device_bytes = 1000
        got, want = port.calculate(k_mags, k_vecs, **kw), ref.calculate(k_mags, k_vecs, **kw)
        assert rel_err(got.sed, want.sed) < RTOL
        assert rel_err(got.sed, reference_sed_oracle(small_trajectory, k_vecs)) < RTOL
        assert (call == 'streamed') == (port.streamed_bytes > 0)
        return
    if call == 'npt':
        for calc in (port, ref):
            with pytest.raises(ValueError, match="box_matrices"):
                calc.ised('x', 0.5, 5.0, 2.5, nk_on_path=4, n_recon_frames=2,
                          dump_filepath=str(tmp_path / 'x.dump'), npt=True)
        return
    import matplotlib
    matplotlib.use('Agg')
    for calc, name in ((port, 'port'), (ref, 'ref')):
        (tmp_path / name).mkdir()
        calc.ised('x', 0.5, 5.0, 2.5, nk_on_path=4, n_recon_frames=2,
                  dump_filepath=str(tmp_path / name / 'x.dump'), plot_dir_ised=tmp_path / name)
    figures = [sorted(p.name for p in (tmp_path / name).glob('*.png')) for name in ('port', 'ref')]
    assert figures[0] == figures[1] == ['iSED_x_0p50_5p00.png']
    assert (tmp_path / 'port' / figures[0][0]).stat().st_size > 5000


@pytest.mark.parametrize('precision,exc', [('fast', None), ('balanced', None),
                                           ('bogus', ValueError)])
def test_precision_validation(small_trajectory, precision, exc):
    """The tiers are ported (tests/test_torch_precision.py holds their
    numbers); an unknown name raises."""
    if exc is None:
        calc = SEDCalculator(small_trajectory, 1, 1, 1, precision=precision, device='cpu')
        assert calc.precision == precision
        return
    with pytest.raises(exc):
        SEDCalculator(small_trajectory, 1, 1, 1, precision=precision, device='cpu')


def test_cuda_device_without_cuda_raises(small_trajectory, monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SEDCalculator(small_trajectory, 2, 2, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcalc.resolve_device('cuda')


def test_preload_and_lru(small_trajectory):
    ref, port = pair(small_trajectory)
    k_mags, k_vecs = ref.get_k_path('y', 1.0, 5)
    data, hi, lo = port._host_group_data(np.arange(small_trajectory.n_atoms))
    # preloaded data is what the calculator uses: zeroing it zeroes the SED
    port.preload_device_group_data(torch.zeros(data.shape), torch.from_numpy(hi),
                                   torch.from_numpy(lo))
    assert np.all(port.calculate(k_mags, k_vecs).sed == 0)
    port.clear_device_cache()
    assert rel_err(port.calculate(k_mags, k_vecs).sed,
                   reference_sed_oracle(small_trajectory, k_vecs)) < RTOL
    for g in ([0, 1], [2, 3], [4, 5]):
        port.calculate(k_mags, k_vecs, basis_atom_indices=g)
    assert len(port._device_cache) == len(port._device_cache_order) == 2
    with pytest.raises(ValueError, match="shape"):
        port.preload_device_group_data(torch.zeros(2, 2, 3), torch.from_numpy(hi),
                                       torch.from_numpy(lo))
    with pytest.raises(ValueError, match="float32"):
        port.preload_device_group_data(torch.zeros(data.shape, dtype=torch.float64),
                                       torch.from_numpy(hi), torch.from_numpy(lo))


def test_cpu_calculate_counts_no_launch(small_trajectory):
    _, port = pair(small_trajectory)
    before = tproj.kernel_launches()
    port.calculate(*port.get_k_path('x', 1.0, 4))
    assert tproj.kernel_launches() == before == 0


@pytest.mark.parametrize('cached', [False, True], ids=['no_cache', 'cache_dir'])
@pytest.mark.parametrize('mode', ['coherent', 'incoherent'])
def test_ragged_chunks_equal_one_chunk_bit_for_bit(small_trajectory, tmp_path, mode, cached):
    """11 k in chunks of 4, each read back into its slice of Φ (stored to and
    resumed from the shard cache under ``cache_dir``), equal one chunk of 11
    bit for bit."""
    _, port = pair(small_trajectory)
    k_mags, k_vecs = port.get_k_path('x', bz_coverage=1.0, n_k=11)
    kw = dict(summation_mode=mode,
              basis_atom_types=[1, 2] if mode == 'incoherent' else None)
    one = port.calculate(k_mags, k_vecs, k_chunk_size=1000, **kw)
    cache_dir = tmp_path / 'shards' if cached else None
    runs = [port.calculate(k_mags, k_vecs, k_chunk_size=4, cache_dir=cache_dir, **kw)
            for _ in range(2 if cached else 1)]           # the second resumes every chunk
    assert one.sed.dtype == (np.complex64 if mode == 'coherent' else np.float32)
    for got in runs:
        assert got.sed.dtype == one.sed.dtype and np.array_equal(got.sed, one.sed)


def test_each_call_returns_an_array_of_its_own(small_trajectory):
    """Two calls in a row share no memory: writing into one leaves the other."""
    _, port = pair(small_trajectory)
    k_mags, k_vecs = port.get_k_path('x', bz_coverage=1.0, n_k=5)
    first = port.calculate(k_mags, k_vecs).sed
    second = port.calculate(k_mags, k_vecs).sed
    assert not np.shares_memory(first, second)
    kept = second.copy()
    first[...] = 0
    assert np.array_equal(second, kept) and np.any(second != 0)
