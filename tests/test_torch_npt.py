"""psa_tpu_torch's NPT family (a time-dependent cell, phases anchored in
fractional space) against the JAX package and the float64 NPT oracle.

The port's calculators come from JAX ones through
``from_reference_calculator``; both run the same seeded breathing-chain
trajectories of ``tests/test_npt.py`` on the CPU.  Every surface is held to
the JAX result at 1e-6 of max and to the oracle exp(2πi m·s̄),
s = h(t)⁻¹ r, at 1e-6 of max; the fractional mean s̄, summed on the
calculator's device in float64, to the JAX host sum at 1e-12 relative.
"""
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.io.loader import TrajectoryLoader

from test_npt import TestLoaderPlumbing, _npt_oracle, _npt_traj

torch.set_num_threads(1)

TOL = 1e-6          # of max, against the JAX package and the oracle


def of_max(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def pair(traj, nx=16, **kw):
    ref = JaxCalculator(traj, nx=nx, ny=1, nz=1, **kw)
    return ref, from_reference_calculator(ref, device='cpu')


def miller(n, step=1.0):
    m = np.zeros((n, 3))
    m[:, 0] = np.arange(1, n + 1) * step
    return m


@pytest.fixture(scope='module')
def breathing():
    """±4% breathing over 1.5 periods, noisy velocities: the oracle case."""
    lam = 1.0 + 0.04 * np.sin(np.linspace(0, 3 * np.pi, 96))
    return _npt_traj(lam, n_frames=96, vel_noise=0.3)


@pytest.fixture(scope='module')
def drift():
    lam = 1.0 + 0.01 * np.sin(np.linspace(0, 2 * np.pi, 128))
    traj = _npt_traj(lam)
    ref, port = pair(traj)
    return traj, ref, port, np.stack([np.arange(1, 8) / 16.0, np.zeros(7), np.zeros(7)], axis=1)


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('call', ['calculate_npt', 'calculate_npt_browse',
                                  'calculate_npt_peaks'])
def test_requires_box_matrices(small_trajectory, call):
    _, port = pair(small_trajectory, nx=2)
    with pytest.raises(ValueError, match="box_matrices"):
        getattr(port, call)(np.ones((3, 3)))


def test_rejects_displacement_mode_and_bad_miller():
    _, port = pair(_npt_traj(np.ones(16), n_frames=16), use_displacements=True)
    with pytest.raises(ValueError, match="velocity"):
        port.calculate_npt(np.ones((3, 3)))
    _, port = pair(_npt_traj(np.ones(16), n_frames=16))
    with pytest.raises(ValueError, match="n_k, 3"):
        port.calculate_npt(np.ones((3, 2)))


@pytest.mark.parametrize('call,kw', [('calculate_npt_browse', dict(chiral=True)),
                                     ('calculate_npt_peaks', dict(n_peaks=2))],
                         ids=['browse', 'peaks'])
def test_mesh_matches_jax_mesh_and_one_device(breathing, call, kw):
    """``mesh=`` (the fractional anchor over a (2, 2, 2) mesh, superchunks
    of 24 frames) against the JAX package's mesh on its eight virtual
    devices and the port's one-device sweep: planes within 1e-6 of max,
    peak frequencies within 1e-6 THz, heights rtol 1e-4, phases 1e-4 rad."""
    from psa_tpu.parallel import make_mesh as jax_mesh
    from psa_tpu_torch.parallel import make_mesh
    ref, port = pair(breathing)
    m = miller(8)
    got = getattr(port, call)(m, mesh=make_mesh(shape=(2, 2, 2), devices=['cpu'] * 8),
                              t_superchunk=24, **kw)
    assert port._phase_anchor == 'cartesian'
    for want in (getattr(port, call)(m, **kw),
                 getattr(ref, call)(m, mesh=jax_mesh(shape=(2, 2, 2)), t_superchunk=24, **kw)):
        np.testing.assert_array_equal(got[-1], want[-1])                  # k_cart
        if call == 'calculate_npt_peaks':
            np.testing.assert_allclose(got[0], want[0], atol=1e-6)
            np.testing.assert_allclose(got[1], want[1], rtol=1e-4)
        else:
            np.testing.assert_allclose(got[0], want[0].astype(np.float32), atol=0)
            assert of_max(got[1], want[1]) < TOL
            bright = want[1] >= 1e-6 * want[1].max()
            assert np.abs(got[2] - want[2])[bright].max() < 1e-4


# ---------------------------------------------------------------------------
# the fractional mean and the oracle
# ---------------------------------------------------------------------------

def test_fractional_mean_matches_jax(breathing):
    ref, port = pair(breathing)
    want = ref._fractional_mean_positions64()
    port._frac_mean64 = None                      # summed anew by the port
    got = port._fractional_mean_positions64()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)


def test_fractional_mean_in_frame_chunks(breathing, monkeypatch):
    """Frame chunks (here 7 frames, the last ragged) sum to the same s̄."""
    from psa_tpu_torch.core import calculator as tcalc
    ref, port = pair(breathing)
    monkeypatch.setattr(tcalc, 'FRAC_MEAN_CHUNK_ELEMS', 7 * breathing.n_atoms * 3)
    port._frac_mean64 = None
    np.testing.assert_allclose(port._fractional_mean_positions64(),
                               ref._fractional_mean_positions64(), rtol=1e-12, atol=0)


def test_matches_f64_npt_oracle_and_jax(breathing):
    ref, port = pair(breathing)
    m = miller(8)
    got = port.calculate_npt(m)
    want = ref.calculate_npt(m)
    oracle = _npt_oracle(breathing, m)
    assert of_max(got.sed, oracle) < TOL
    assert of_max(got.sed, want.sed) < TOL
    np.testing.assert_array_equal(got.k_vectors, want.k_vectors)
    np.testing.assert_array_equal(got.k_points, want.k_points)
    np.testing.assert_array_equal(got.freqs, want.freqs)
    assert port._phase_anchor == 'cartesian'


@pytest.mark.parametrize('precision,bar', [('balanced', 5e-5), ('fast', 5e-3)])
def test_tiers_meet_their_bars(breathing, precision, bar):
    _, port = pair(breathing, precision=precision)
    m = miller(8)
    assert of_max(port.calculate_npt(m).sed, _npt_oracle(breathing, m)) < bar


def test_constant_cell_degenerates_to_calculate():
    traj = _npt_traj(np.ones(64), n_frames=64, vel_noise=0.2)
    ref, port = pair(traj)
    m = miller(6)
    sed_npt = port.calculate_npt(m)
    kv = (2 * np.pi / (16 * 2.5)) * m.astype(np.float32)
    sed_fix = port.calculate(np.linalg.norm(kv, axis=1), kv)
    np.testing.assert_allclose(sed_npt.intensity, sed_fix.intensity, rtol=2e-5, atol=1e-10)
    np.testing.assert_allclose(sed_npt.k_vectors, kv, rtol=1e-6)
    assert of_max(sed_npt.sed, ref.calculate_npt(m).sed) < TOL


def test_device_cache_keys_the_anchor():
    """A fixed-cell run and an NPT run over numerically identical k arrays,
    one after the other on one calculator: the NPT run must not reuse the
    cached Cartesian means (the 2-slot device LRU is keyed on the anchor)."""
    traj = _npt_traj(1.0 + 0.03 * np.linspace(0, 1, 48), n_frames=48, vel_noise=0.2)
    _, port = pair(traj)
    m = miller(4)
    k_eff = (2 * np.pi * m).astype(np.float32)
    fixed = port.calculate(np.linalg.norm(k_eff, axis=1), k_eff)
    npt = port.calculate_npt(m)
    assert not np.allclose(npt.intensity, fixed.intensity)
    # sanity only, as in test_npt.py: stale means would be off by O(1); the
    # 1e-6 bar lives in test_matches_f64_npt_oracle_and_jax
    assert of_max(npt.sed, _npt_oracle(traj, m)) < 5e-6
    again = port.calculate(np.linalg.norm(k_eff, axis=1), k_eff)
    np.testing.assert_array_equal(again.sed, fixed.sed)


def test_cache_dir_keys_anchor_separately(tmp_path):
    traj = _npt_traj(np.ones(32), n_frames=32, vel_noise=0.2)
    _, port = pair(traj)
    m = miller(4)
    k_eff = (2 * np.pi * m).astype(np.float32)
    sed_fix = port.calculate(np.linalg.norm(k_eff, axis=1), k_eff, cache_dir=tmp_path)
    sed_npt = port.calculate_npt(m, cache_dir=tmp_path)
    assert not np.allclose(sed_npt.intensity, sed_fix.intensity)
    assert of_max(sed_npt.sed, _npt_oracle(traj, m)) < 5e-6
    assert len({p.parent.name for p in tmp_path.glob('*/chunk_*.npy')}) == 2


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_npt_cache_resumes_across_packages(tmp_path, writer):
    """The shard-cache keys carry the fractional anchor in both packages, so
    an NPT sweep written by one resumes in the other, bit for bit."""
    traj = _npt_traj(1.0 + 0.02 * np.sin(np.linspace(0, 2 * np.pi, 32)), n_frames=32,
                     vel_noise=0.2)
    ref, port = pair(traj)
    first, second = (ref, port) if writer == 'jax' else (port, ref)
    want = first.calculate_npt(miller(6), k_chunk_size=3, cache_dir=tmp_path).sed
    second._group_device_arrays = None                 # any computation raises
    got = second.calculate_npt(miller(6), k_chunk_size=3, cache_dir=tmp_path).sed
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# physics
# ---------------------------------------------------------------------------

def test_drifting_cell_keeps_phonon_clean():
    """Linear 10% drift: the fractional anchor puts the ridden phonon on its
    frequency and keeps the neighbours empty, where the frame-0 Cartesian
    mapping loses its peak."""
    n_frames, nu, mode_m = 128, 4.0, 7
    traj = _npt_traj(1.0 + 0.10 * np.linspace(0.0, 1.0, n_frames), n_frames=n_frames,
                     nu_thz=nu, mode_m=mode_m)
    ref, port = pair(traj)
    m = miller(8)
    sed = port.calculate_npt(m)
    assert of_max(sed.sed, ref.calculate_npt(m).sed) < TOL
    pos = sed.freqs >= 0
    inten = sed.intensity[pos]
    col = mode_m - 1
    df = sed.freqs[1] - sed.freqs[0]
    assert abs(sed.freqs[pos][np.argmax(inten[:, col])] - nu) <= df + 1e-9
    kv = (2 * np.pi / (16 * 2.5)) * m.astype(np.float32)
    fixed = port.calculate(np.linalg.norm(kv, axis=1), kv).intensity[pos]
    assert inten[:, col].max() > 1.2 * fixed[:, col].max()
    assert max(inten[:, col - 1].max(), inten[:, col + 1].max()) < 0.05 * inten[:, col].max()


# ---------------------------------------------------------------------------
# loader plumbing (the port's readers)
# ---------------------------------------------------------------------------

def test_lammps_npt_dump_fills_box_matrices(tmp_path):
    dump = tmp_path / "npt.dump"
    TestLoaderPlumbing()._write_npt_dump(dump)
    traj = TrajectoryLoader(str(dump), dt=0.01).load()
    assert traj.box_matrices is not None and traj.box_matrices.shape == (4, 3, 3)
    assert traj.box_matrices[3, 0, 0] == pytest.approx(10.0 * 1.06)
    np.testing.assert_allclose(traj.box_matrix, traj.box_matrices[0])
    again = TrajectoryLoader(str(dump), dt=0.01).load()       # from the .npy sidecars
    np.testing.assert_allclose(again.box_matrices, traj.box_matrices)
    from psa_tpu_torch import SEDCalculator
    calc = SEDCalculator(traj, nx=1, ny=1, nz=1, device='cpu')
    sed = calc.calculate_npt(miller(2))
    assert sed.sed.shape == (4, 2, 3) and np.isfinite(sed.sed).all()


# ---------------------------------------------------------------------------
# browse and peaks sweeps
# ---------------------------------------------------------------------------

def test_browse_equals_full_reduction_and_jax(drift):
    traj, ref, port, m = drift
    sed = port.calculate_npt(m)
    freqs, inten, phase, k_cart = port.calculate_npt_browse(m)
    assert phase is None
    mask = sed.freqs >= 0
    np.testing.assert_allclose(inten, sed.intensity[mask], rtol=1e-5, atol=1e-8)
    np.testing.assert_array_equal(freqs, sed.freqs[mask])
    np.testing.assert_allclose(k_cart, sed.k_vectors, atol=0)
    j_freqs, j_inten, _, j_k = ref.calculate_npt_browse(m)
    np.testing.assert_array_equal(freqs, j_freqs)
    np.testing.assert_array_equal(k_cart, j_k)
    assert of_max(inten, j_inten) < TOL


def test_browse_matches_oracle_peak(drift):
    traj, _, port, m = drift
    freqs, inten, _, _ = port.calculate_npt_browse(m, k_chunk_size=3)
    want = (np.abs(_npt_oracle(traj, m)) ** 2).sum(axis=-1)[
        np.fft.fftfreq(traj.n_frames, d=traj.dt_ps) >= 0]
    assert of_max(inten, want) < TOL
    assert abs(freqs[np.argmax(inten[:, 4])] - 4.0) < 0.5     # mode m=5 rides at 4 THz


def test_peaks_form_and_jax(drift):
    _, ref, port, m = drift
    pf, ph, pw, k_cart = port.calculate_npt_peaks(m, n_peaks=2)
    assert pf.shape == (2, len(m)) and k_cart.shape == (len(m), 3)
    freqs, inten, _, _ = port.calculate_npt_browse(m)
    np.testing.assert_allclose(pf[0], freqs[np.argmax(inten, axis=0)], atol=1e-6)
    jf, jh, jw, jk = ref.calculate_npt_peaks(m, n_peaks=2)
    np.testing.assert_array_equal(pf, jf)
    assert of_max(ph, jh) < TOL
    np.testing.assert_allclose(pw, jw, rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(k_cart, jk)


def test_anchor_restored_on_error(drift):
    _, _, port, m = drift
    with pytest.raises(ValueError):
        port.calculate_npt_browse(m, engine='bogus')
    assert port._phase_anchor == 'cartesian'
    with pytest.raises(ValueError):
        port.calculate_npt_peaks(m, width_method='bogus')
    assert port._phase_anchor == 'cartesian'


# ---------------------------------------------------------------------------
# NPT iSED
# ---------------------------------------------------------------------------

def _read_dump(path):
    from psa_tpu_torch.io.lammps import read_lammps_dump
    return read_lammps_dump(path, unwrap=False)[0]


def _ised(calc, path, lam, n_cells=16, n_frames=32, **kw):
    calc.ised(k_dir_spec=[1, 0, 0], k_target=2 * np.pi * 5 / (lam.mean() * n_cells * 2.5),
              w_target=4.0, char_len_k_path=2.5, nk_on_path=8, bz_cov_ised=8.0,
              rescale_factor='auto', n_recon_frames=n_frames, dump_filepath=str(path),
              npt=True, **kw)


def test_npt_ised_reconstructs_commensurate_mode(tmp_path):
    lam = 1.0 + 0.03 * np.sin(np.linspace(0, 2 * np.pi, 96))
    traj = _npt_traj(lam, n_frames=96, vel_noise=0.05)
    ref, port = pair(traj)
    _ised(port, tmp_path / 'port.dump', lam)
    _ised(ref, tmp_path / 'jax.dump', lam)
    assert port._phase_anchor == 'cartesian'
    pos = _read_dump(tmp_path / 'port.dump')
    assert pos.shape == (32, 16, 3)
    np.testing.assert_allclose(pos, _read_dump(tmp_path / 'jax.dump'), atol=2e-6)
    disp = pos[:, :, 0] - pos[:, :, 0].mean(axis=0, keepdims=True)
    assert np.argmax(np.abs(np.fft.fft(disp[0]))[1:8]) + 1 == 5        # the m=5 wave
    assert np.argmax(np.abs(np.fft.fft(disp[:, 3]))[1:16]) + 1 == 1    # one period


def test_npt_ised_requires_box_matrices(small_trajectory, tmp_path):
    _, port = pair(small_trajectory, nx=2)
    with pytest.raises(ValueError, match="box_matrices"):
        port.ised(k_dir_spec='x', k_target=0.5, w_target=1.0, char_len_k_path=2.5,
                  nk_on_path=4, bz_cov_ised=2.0, dump_filepath=str(tmp_path / "x.dump"),
                  npt=True)


def test_auto_rescale_ignores_cell_drift(tmp_path):
    """±3% breathing on a long box: the Cartesian drift is ~100x the mode;
    'auto' must scale to the vibration (as the JAX package does)."""
    lam = 1.0 + 0.03 * np.sin(np.linspace(0, 2 * np.pi, 96))
    traj = _npt_traj(lam, n_cells=32, n_frames=96, vel_noise=0.0)
    ref, port = pair(traj, nx=32)
    h = traj.box_matrices.astype(np.float64)
    s = np.einsum('tij,taj->tai', np.linalg.inv(h), traj.positions.astype(np.float64))
    vib_std = np.std((s - s.mean(axis=0)) @ h.mean(axis=0).T)
    _ised(port, tmp_path / 'port.dump', lam, n_cells=32, n_frames=16)
    _ised(ref, tmp_path / 'jax.dump', lam, n_cells=32, n_frames=16)
    pos = _read_dump(tmp_path / 'port.dump')
    assert np.abs(pos - pos.mean(axis=0, keepdims=True)).max() < 10 * vib_std
    np.testing.assert_allclose(pos, _read_dump(tmp_path / 'jax.dump'), atol=2e-6)
