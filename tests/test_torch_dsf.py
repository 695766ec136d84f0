"""psa_tpu_torch's instantaneous-phase family (DSF and current spectra,
S(k), the ISF, the self parts) against the JAX package and the float64
oracles of ``tests/test_dsf.py``.

The port's calculators come from JAX ones (``phase_mode='exact'`` unless a
test says otherwise) through ``from_reference_calculator``; both run the
same seeded inputs on the CPU.  The JAX side runs one k-chunk (one compiled
shape); the port runs ragged chunks where a test gives it several k.

Tolerances: every plane is held to the JAX result and to its float64
oracle at 1e-6 of the plane's max (or of 1 where the oracle test of
``test_dsf.py`` scales so); the Parseval sums and physics at the bars of
``test_dsf.py``.
"""
import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.core.trajectory import Trajectory
from psa_tpu.models import make_chain_trajectory
from psa_tpu.ops import instantaneous as jinst
from psa_tpu.ops import spectral as jspec
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch import Trajectory as TorchTrajectory
from psa_tpu_torch.core.trajectory import make_box_arrays
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.ops import instantaneous as tinst

from test_dsf import _traj, dsf_oracle

torch.set_num_threads(1)

TOL = 1e-6


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def assert_close(got, want, tol=TOL, floor=0.0):
    """max|got − want| ≤ tol · max(max|want|, floor)."""
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), floor)


def assert_dsf_close(got, want):
    """(S, C_L, C_T) planes: S and C_L, and C_T through C_L + C_T (where
    the motion is along k, C_T is rounding noise in both packages)."""
    (s, c_l, c_t), (j_s, j_cl, j_ct) = got, want
    assert_close(s, j_s)
    assert_close(c_l, j_cl)
    assert_close(c_l + c_t, j_cl + j_ct)


def pair(traj, nx=1, phase_mode='exact', **kw):
    ref = JaxCalculator(traj, nx=nx, ny=1, nz=1, phase_mode=phase_mode, **kw)
    return ref, from_reference_calculator(ref, device='cpu')


def positive(traj):
    return jspec.fftfreq_thz(traj.n_frames, traj.dt_ps) >= 0


def chain_case(n_cells=12, n_frames=64, seed=4):
    traj = make_chain_trajectory(n_cells=n_cells, n_frames=n_frames, dt_ps=0.02, a=2.5,
                                 omega_max_thz=7.0, seed=seed)
    kv = np.zeros((6, 3), dtype=np.float32)
    kv[:, 0] = 2 * np.pi * np.arange(1, 7) / (n_cells * 2.5)
    return traj, jinst.nearest_commensurate(kv, traj.box_lengths)


# ---------------------------------------------------------------------------
# float64 oracles, with the JAX package beside them
# ---------------------------------------------------------------------------

def test_f64_parity_with_large_offsets():
    """S/C_L/C_T on coordinates offset to thousands of Å (folding stress),
    in ragged k-chunks of 2."""
    rng = np.random.default_rng(7)
    n_t, n_a = 32, 9
    pos = (rng.uniform(0, 12, (n_t, n_a, 3)) + 4000.0).astype(np.float32)
    vel = rng.standard_normal((n_t, n_a, 3)).astype(np.float32)
    traj = _traj(pos, vel, box_edge=12.0)
    ref, port = pair(traj)
    kv = np.array([[0.7, 0, 0], [0, 1.3, 0], [0.4, 0.4, 0.2],
                   [0, 0, 0], [2.1, -0.9, 0.5]], dtype=np.float32)
    freqs, *planes = port.calculate_dsf(kv, k_chunk_size=2)
    j_freqs, *j_planes = ref.calculate_dsf(kv)
    np.testing.assert_array_equal(freqs, j_freqs)
    mask = positive(traj)
    for got, want, jax_plane in zip(planes, dsf_oracle(pos, vel, kv), j_planes):
        assert_close(got, want[mask], floor=1.0)
        assert_close(got, jax_plane, floor=1.0)


def test_self_part_f64_parity():
    rng = np.random.default_rng(3)
    n_t, n_a = 16, 5
    pos = (rng.uniform(0, 8, (n_t, n_a, 3)) + 1500.0).astype(np.float32)
    traj = _traj(pos, np.zeros_like(pos), box_edge=8.0)
    ref, port = pair(traj)
    kv = np.array([[0.9, 0.2, 0], [0, 0, 1.4]], dtype=np.float32)
    freqs, s_s = port.calculate_dsf_self(kv, k_chunk_size=1)
    ang = np.einsum('tac,kc->tak', pos.astype(np.float64), kv.astype(np.float64))
    want = (np.abs(np.fft.fft(np.exp(1j * ang), axis=0) / n_t) ** 2).sum(axis=1) / n_a
    assert np.abs(s_s - want[positive(traj)]).max() <= TOL
    j_freqs, j_s = ref.calculate_dsf_self(kv)
    np.testing.assert_array_equal(freqs, j_freqs)
    assert_close(s_s, j_s)


def test_basis_selects_atoms():
    rng = np.random.default_rng(11)
    n_t, n_a = 8, 6
    pos = rng.uniform(0, 5, (n_t, n_a, 3)).astype(np.float32)
    vel = rng.standard_normal((n_t, n_a, 3)).astype(np.float32)
    ref, port = pair(_traj(pos, vel, box_edge=5.0))
    kv = np.array([[1.1, 0, 0]], dtype=np.float32)
    idx = [0, 2, 5]
    _, s, c_l, _ = port.calculate_dsf(kv, basis_atom_indices=idx)
    so, clo, _ = dsf_oracle(pos[:, idx], vel[:, idx], kv)
    mask = jspec.fftfreq_thz(n_t, 0.02) >= 0
    assert_close(s, so[mask], floor=1.0)
    assert_close(c_l, clo[mask], floor=1.0)
    _, j_s, j_cl, _ = ref.calculate_dsf(kv, basis_atom_indices=idx)
    assert_close(s, j_s)
    assert_close(c_l, j_cl)


def test_ops_match_jax_ops():
    """The mode stack in ragged time tiles and the reductions equal the JAX
    ops on one atom block at 1e-6 of max."""
    rng = np.random.default_rng(12)
    n_t, n_a, n_k = 24, 7, 5
    pos = rng.uniform(0, 9, (n_t, n_a, 3)).astype(np.float32) + 300.0
    vel = rng.standard_normal((n_t, n_a, 3)).astype(np.float32)
    kv = rng.uniform(-2, 2, (n_k, 3)).astype(np.float32)
    re, im = tinst.instant_modes(t(pos), t(vel), t(kv), t_chunk=5)
    j_re, j_im = jinst.instant_modes_scan(jnp.asarray(pos), jnp.asarray(vel),
                                          jnp.ones(n_a, jnp.float32), jnp.asarray(kv), t_chunk=8)
    assert_close(re.numpy(), np.asarray(j_re))
    assert_close(im.numpy(), np.asarray(j_im))
    d_re, d_im = tinst.density_modes(t(pos), t(kv), t_chunk=7)
    assert d_re.shape == (n_t, n_k, 1)
    assert_close(d_re.numpy()[..., 0], re.numpy()[..., 0])
    assert_close(d_im.numpy()[..., 0], im.numpy()[..., 0])
    ku = jspec.unit_k_vectors(kv)
    idx = np.arange(n_t // 2, dtype=np.int32)
    for segments, window in ((1, 'rect'), (3, 'hann')):
        seg_idx = idx[:n_t // segments // 2]
        got = tinst.dsf_reduce(re, im, t(ku), t(seg_idx.astype(np.int64)), segments, window)
        want = jinst.dsf_reduce(j_re, j_im, jnp.asarray(ku), jnp.asarray(seg_idx), n_t,
                                segments=segments, window=window)
        for g, w in zip(got, want):
            assert_close(g.numpy(), np.asarray(w))
    assert_close(tinst.sk_reduce(re, im).numpy(), np.asarray(jinst.sk_reduce(j_re, j_im, n_t)))
    assert_close(tinst.isf_reduce(re, im, 9).numpy(),
                 np.asarray(jinst.isf_reduce(j_re, j_im, n_t, 9)))
    assert tinst._autocorr_fft_len(n_t) == jinst._autocorr_fft_len(n_t) == 64
    assert tinst._autocorr_fft_len(10_000) == 32_768


# ---------------------------------------------------------------------------
# Parseval conventions (ops level, all rows kept)
# ---------------------------------------------------------------------------

def test_sum_over_all_omega_is_static_structure_factor():
    rng = np.random.default_rng(1)
    n_t, n_a, n_k = 16, 7, 3
    pos = rng.uniform(0, 9, (n_t, n_a, 3)).astype(np.float32)
    kv = rng.uniform(-2, 2, (n_k, 3)).astype(np.float32)
    re, im = tinst.instant_modes(t(pos), torch.zeros(n_t, n_a, 3), t(kv), t_chunk=6)
    s, _, _ = tinst.dsf_reduce(re, im, t(jspec.unit_k_vectors(kv)), torch.arange(n_t))
    ang = np.einsum('tac,kc->tak', pos.astype(np.float64), kv.astype(np.float64))
    s_k = (np.abs(np.exp(1j * ang).sum(axis=1)) ** 2).mean(axis=0) / n_a
    np.testing.assert_allclose(s.numpy().sum(axis=0) / n_a, s_k, rtol=1e-5)


def test_self_part_sums_to_one():
    rng = np.random.default_rng(2)
    n_t, n_a = 12, 4
    pos = rng.uniform(0, 6, (n_t, n_a, 3)).astype(np.float32)
    kv = np.array([[0.8, -0.3, 1.1]], dtype=np.float32)
    s_s = tinst.dsf_self_block(t(pos), t(kv), torch.arange(n_t)).numpy() / n_a
    np.testing.assert_allclose(s_s.sum(axis=0), 1.0, rtol=1e-6)


# ---------------------------------------------------------------------------
# physics
# ---------------------------------------------------------------------------

def _static_chain(n_t, a0=2.0, n_cells=8):
    pos0 = np.zeros((n_cells, 3))
    pos0[:, 0] = np.arange(n_cells) * a0
    pos = np.broadcast_to(pos0, (n_t, n_cells, 3)).copy()
    return _traj(pos, np.zeros_like(pos), box_edge=n_cells * a0)


def test_bragg_peak_on_static_lattice():
    """k = G: all the weight is S(G, ω=0) = N; the commensurate m=3 of 8
    sums to zero."""
    traj = _static_chain(16)
    _, port = pair(traj, nx=8)
    kv = np.array([[np.pi, 0, 0], [2 * np.pi * 3 / 16.0, 0, 0]], dtype=np.float32)
    _, s, _, _ = port.calculate_dsf(kv)
    assert abs(s[0, 0] - 8) <= 1e-4 * 8
    assert s[1:, 0].max() <= 1e-6 * 8
    assert s[:, 1].max() <= 1e-4


def test_current_spectrum_peaks_on_chain_dispersion():
    """C_L peaks at ν = ν_max|sin(ka/2)|; the transverse plane is empty."""
    traj = make_chain_trajectory(n_cells=16, n_frames=128, dt_ps=0.02, a=2.5,
                                 omega_max_thz=8.0, seed=5)
    ref, port = pair(traj, nx=16)
    kv = np.zeros((3, 3), dtype=np.float32)
    kv[:, 0] = 2 * np.pi * np.array([2, 5, 8]) / (16 * 2.5)
    kv = tinst.nearest_commensurate(kv, traj.box_lengths)
    freqs, s, c_l, c_t = port.calculate_dsf(kv, k_chunk_size=2)
    nu_pred = 8.0 * np.abs(np.sin(kv[:, 0] * 2.5 / 2))
    for col in range(3):
        assert abs(freqs[np.argmax(c_l[:, col])] - nu_pred[col]) <= 0.5
    assert c_t.max() <= 1e-8 * c_l.max()
    _, j_s, j_cl, _ = ref.calculate_dsf(kv)
    assert_close(s, j_s)
    assert_close(c_l, j_cl)


def test_harmonic_limit_matches_sed_intensity():
    """Displacements → 0 at fixed velocities: N·(C_L + C_T) is the SED
    intensity of the port's own ``calculate``."""
    base = make_chain_trajectory(n_cells=10, n_frames=64, dt_ps=0.02, a=2.5,
                                 omega_max_thz=6.0, seed=9)
    mean = base.positions.mean(axis=0, dtype=np.float64)
    pos = (mean[None] + 1e-6 * (base.positions.astype(np.float64) - mean[None])).astype(np.float32)
    traj = Trajectory(positions=pos, velocities=base.velocities, types=base.types,
                      timesteps=base.timesteps, box_matrix=base.box_matrix,
                      box_lengths=base.box_lengths, box_tilts=base.box_tilts, dt_ps=base.dt_ps)
    _, port = pair(traj, nx=10)
    km, kv = port.get_k_path('x', bz_coverage=0.5, n_k=6)
    _, _, c_l, c_t = port.calculate_dsf(kv.astype(np.float32))
    sed = port.calculate(km, kv)
    inten = sed.intensity[sed.freqs >= 0]
    assert np.abs(traj.n_atoms * (c_l + c_t) - inten).max() <= 2e-3 * inten.max()


# ---------------------------------------------------------------------------
# S(k)
# ---------------------------------------------------------------------------

def test_sk_matches_f64_oracle_jax_and_parseval():
    rng = np.random.default_rng(9)
    n_t, n_a = 24, 11
    pos = rng.uniform(0, 9, (n_t, n_a, 3)).astype(np.float32)
    traj = _traj(pos, rng.normal(size=(n_t, n_a, 3)).astype(np.float32), box_edge=9.0)
    ref, port = pair(traj)
    kv = tinst.nearest_commensurate(rng.uniform(-2, 2, (5, 3)).astype(np.float32),
                                    traj.box_lengths)
    sk = port.calculate_sk(kv, k_chunk_size=2)
    ang = np.einsum('tac,kc->tak', pos.astype(np.float64), kv.astype(np.float64))
    oracle = (np.abs(np.exp(1j * ang).sum(axis=1)) ** 2).mean(axis=0) / n_a
    np.testing.assert_allclose(sk, oracle, rtol=1e-5)
    assert_close(sk, ref.calculate_sk(kv))
    freqs_all = jspec.fftfreq_thz(n_t, traj.dt_ps)
    _, s_plane, _, _ = port.calculate_dsf(kv)
    neg = dsf_oracle(pos, np.zeros_like(pos), kv)[0][freqs_all < 0]
    np.testing.assert_allclose(sk, s_plane.sum(axis=0) + neg.sum(axis=0), rtol=1e-4)


def test_sk_bragg_and_ideal_gas_limits():
    traj = _static_chain(8)
    _, port = pair(traj, nx=8)
    kv = np.array([[np.pi, 0, 0], [2 * np.pi * 3 / 16.0, 0, 0]], dtype=np.float32)
    sk = port.calculate_sk(kv)
    assert abs(sk[0] - 8) <= 1e-4 * 8
    assert sk[1] <= 1e-6 * 8
    rng = np.random.default_rng(3)
    posg = rng.uniform(0, 20.0, (512, 400, 3)).astype(np.float32)
    trajg = _traj(posg, np.zeros_like(posg), box_edge=20.0)
    calcg = SEDCalculator(trajg, nx=1, ny=1, nz=1, device='cpu')
    kvg = tinst.nearest_commensurate(np.array([[1.0, 0.6, 0], [2.0, 0, 1.2]], np.float32),
                                     trajg.box_lengths)
    np.testing.assert_allclose(calcg.calculate_sk(kvg), 1.0, atol=0.2)


def test_sk_group_selection():
    rng = np.random.default_rng(5)
    n_t, n_a = 12, 10
    pos = rng.uniform(0, 8, (n_t, n_a, 3)).astype(np.float32)
    ref, port = pair(_traj(pos, np.zeros_like(pos), box_edge=8.0))
    kv = np.array([[0.9, 0.2, -0.5]], np.float32)
    idx = [1, 4, 8]
    sk = port.calculate_sk(kv, basis_atom_indices=idx)
    ang = np.einsum('tac,kc->tak', pos[:, idx].astype(np.float64), kv.astype(np.float64))
    oracle = (np.abs(np.exp(1j * ang).sum(axis=1)) ** 2).mean(axis=0) / len(idx)
    np.testing.assert_allclose(sk, oracle, rtol=1e-5)
    assert_close(sk, ref.calculate_sk(kv, basis_atom_indices=idx))


# ---------------------------------------------------------------------------
# the ISF and the self parts
# ---------------------------------------------------------------------------

def test_isf_matches_f64_oracle_jax_and_sk_at_zero_lag():
    rng = np.random.default_rng(21)
    n_t, n_a = 32, 9
    pos = rng.uniform(0, 7, (n_t, n_a, 3)).astype(np.float32)
    traj = _traj(pos, np.zeros_like(pos), box_edge=7.0)
    ref, port = pair(traj)
    kv = tinst.nearest_commensurate(rng.uniform(-2, 2, (4, 3)).astype(np.float32),
                                    traj.box_lengths)
    lags, f = port.calculate_isf(kv, n_lags=16, k_chunk_size=3)
    np.testing.assert_allclose(lags, np.arange(16) * traj.dt_ps, rtol=1e-6)
    ang = np.einsum('tac,kc->tak', pos.astype(np.float64), kv.astype(np.float64))
    rho = np.exp(1j * ang).sum(axis=1)
    want = np.stack([(np.conj(rho[:n_t - tau]) * rho[tau:]).real.mean(axis=0) / n_a
                     for tau in range(16)])
    np.testing.assert_allclose(f, want, rtol=2e-4, atol=1e-5)
    np.testing.assert_allclose(f[0], port.calculate_sk(kv), rtol=1e-5)
    j_lags, j_f = ref.calculate_isf(kv, n_lags=16)
    np.testing.assert_array_equal(lags, j_lags)
    assert_close(f, j_f)
    assert port.calculate_isf(kv)[1].shape == (n_t // 2, len(kv))


def test_isf_static_crystal_is_constant_at_bragg():
    traj = _static_chain(16)
    _, port = pair(traj, nx=8)
    _, f = port.calculate_isf(np.array([[np.pi, 0, 0]], np.float32), n_lags=12)
    np.testing.assert_allclose(f[:, 0], 8, rtol=1e-4)


def test_self_parts_match_jax_and_oracle_on_the_chain():
    traj, kv = chain_case()
    ref, port = pair(traj, nx=12)
    lags, fs = port.calculate_isf_self(kv, n_lags=24, k_chunk_size=4)
    j_lags, j_fs = ref.calculate_isf_self(kv, n_lags=24)
    np.testing.assert_array_equal(lags, j_lags)
    assert_close(fs, j_fs)
    np.testing.assert_allclose(fs[0], 1.0, rtol=1e-6)
    ph = np.exp(1j * np.einsum('tac,kc->tak', traj.positions.astype(np.float64),
                               kv.astype(np.float64)))
    n_t = traj.n_frames
    want = np.stack([(np.conj(ph[:n_t - tau]) * ph[tau:]).real.mean(axis=0).mean(axis=0)
                     for tau in range(24)])
    assert_close(fs, want)
    freqs, ss = port.calculate_dsf_self(kv, max_freq=10.0, k_chunk_size=4,
                                        basis_atom_indices=[0, 3, 7, 9])
    j_freqs, j_ss = ref.calculate_dsf_self(kv, max_freq=10.0, basis_atom_indices=[0, 3, 7, 9])
    np.testing.assert_array_equal(freqs, j_freqs)
    assert_close(ss, j_ss)


def test_self_brownian_decay_recovers_diffusion():
    """F_s(k,τ) = exp(−k² D τ) for Brownian walkers."""
    rng = np.random.default_rng(13)
    n_t, n_a, d_true, dt_ps = 1024, 256, 0.4, 0.1
    sigma = np.sqrt(2 * d_true * dt_ps)
    pos = (rng.uniform(0, 40.0, (1, n_a, 3))
           + np.cumsum(rng.normal(0, sigma, (n_t, n_a, 3)), axis=0)).astype(np.float32)
    traj = _traj(pos, np.zeros_like(pos), box_edge=40.0, dt_ps=dt_ps)
    calc = SEDCalculator(traj, nx=1, ny=1, nz=1, device='cpu')
    kv = tinst.nearest_commensurate(np.array([[0.6, 0, 0], [0.9, 0, 0]], np.float32),
                                    traj.box_lengths)
    lags, f_s = calc.calculate_isf_self(kv, n_lags=40)
    np.testing.assert_allclose(f_s[0], 1.0, rtol=1e-5)
    tau = lags[1:25].astype(np.float64)
    for j in range(len(kv)):
        y = np.log(np.maximum(f_s[1:25, j].astype(np.float64), 1e-6))
        d_est = -np.polyfit(tau, y, 1)[0] / float(kv[j, 0]) ** 2
        np.testing.assert_allclose(d_est, d_true, rtol=0.12)


def test_quasielastic_width_recovers_diffusion_constant():
    """n_t·S_s(k, 0) = (1 + e^{−λ}) / (1 − e^{−λ}) with λ = k² D dt."""
    rng = np.random.default_rng(11)
    n_t, n_a, d_true, dt_ps = 2048, 256, 0.5, 0.1
    pos = np.cumsum(rng.normal(0, np.sqrt(2 * d_true * dt_ps), (n_t, n_a, 3)),
                    axis=0).astype(np.float32)
    traj = _traj(pos, np.zeros_like(pos), box_edge=50.0, dt_ps=dt_ps)
    calc = SEDCalculator(traj, nx=1, ny=1, nz=1, device='cpu')
    kv = tinst.nearest_commensurate(np.array([[0.5, 0, 0], [0.75, 0, 0], [1.0, 0, 0]],
                                             np.float32), traj.box_lengths)
    freqs, s_s = calc.calculate_dsf_self(kv)
    assert freqs[0] == 0.0
    s0n = n_t * s_s[0].astype(np.float64)
    d_est = -np.log((s0n - 1.0) / (s0n + 1.0)) / (kv[:, 0].astype(np.float64) ** 2 * dt_ps)
    np.testing.assert_allclose(d_est, d_true, rtol=0.15)
    assert abs(d_est.mean() - d_true) < 0.08 * d_true


# ---------------------------------------------------------------------------
# the commensurate helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('box', [np.array([10.0, 20.0, 0.0]), np.array([10.0, 14.0, 9.0]),
                                 np.diag([10.0, 14.0, 9.0]),
                                 np.array([[12.0, 0, 0], [4.0, 10.0, 0], [0, 2.0, 9.0]])])
def test_commensurate_helpers_match_jax(box):
    kv = np.random.default_rng(3).uniform(-2, 2, (17, 3))
    np.testing.assert_array_equal(tinst.nearest_commensurate(kv, box),
                                  jinst.nearest_commensurate(kv, box))
    assert tinst.commensurate_deviation(kv, box) == jinst.commensurate_deviation(kv, box)
    path = np.outer(np.linspace(0, 2, 40), [1.0, 0.5, 0.0])
    np.testing.assert_array_equal(tinst.commensurate_kpath(path, box),
                                  jinst.commensurate_kpath(path, box))


def test_snaps_to_box_lattice_keeping_degenerate_axes():
    out = tinst.nearest_commensurate(np.array([[0.70, 0.30, 0.5]]), np.array([10.0, 20.0, 0.0]))
    for c, edge in ((0, 10.0), (1, 20.0)):
        m = out[0, c] / (2 * np.pi / edge)
        assert abs(m - round(m)) < 1e-6
    assert out[0, 2] == np.float32(0.5)
    assert tinst.nearest_commensurate(np.zeros((0, 3), np.float32), np.full(3, 8.0)).shape == (0, 3)
    assert tinst.k_count(np.zeros((7, 3))) == 7


def test_triclinic_snap_is_wrap_invariant():
    H = np.array([[12.0, 0.0, 0.0], [4.0, 10.0, 0.0], [0.0, 2.0, 9.0]])
    rng = np.random.default_rng(5)
    out = tinst.nearest_commensurate(rng.uniform(-1.5, 1.5, (23, 3)), H).astype(np.float64)
    m = out @ H.T / (2 * np.pi)
    np.testing.assert_allclose(m, np.round(m), atol=1e-5)
    assert tinst.commensurate_deviation(out, H) < 1e-5
    r = rng.uniform(0, 10, (6, 3))
    for row in H:
        d = (out @ (r + row).T - out @ r.T) / (2 * np.pi)
        np.testing.assert_allclose(d, np.round(d), atol=1e-5)


def test_deviation_detects_off_lattice_k_and_singular_box_raises():
    box = np.array([10.0, 10.0, 10.0])
    on = tinst.nearest_commensurate(np.array([[0.7, 0.3, 0.0]]), box)
    assert tinst.commensurate_deviation(on, box) < 1e-5
    assert tinst.commensurate_deviation(on + np.float32(0.25 * 2 * np.pi / 10.0), box) > 0.2
    assert tinst.commensurate_deviation(np.zeros((0, 3), np.float32), box) == 0.0
    with pytest.raises(ValueError, match="singular"):
        tinst.nearest_commensurate(np.ones((2, 3)), np.array([[10.0, 0, 0], [10.0, 0, 0],
                                                               [1.0, 2.0, 3.0]]))
    with pytest.raises(ValueError, match="fewer than 2"):
        tinst.commensurate_kpath(np.zeros((3, 3)), box)


def test_off_lattice_k_warns(caplog):
    traj, kv = chain_case()
    _, port = pair(traj, nx=12)
    with caplog.at_level(logging.WARNING, logger='psa_tpu_torch.core.calculator'):
        port.calculate_sk(kv + np.float32(0.05))
    assert "off the box reciprocal lattice" in caplog.text


# ---------------------------------------------------------------------------
# edge cases
# ---------------------------------------------------------------------------

def test_duplicate_basis_indices_collapse():
    traj = make_chain_trajectory(n_cells=8, n_frames=16, seed=2)
    _, port = pair(traj, nx=8)
    kv = tinst.nearest_commensurate(np.array([[0.5, 0, 0], [1.0, 0, 0]], np.float32),
                                    traj.box_lengths)
    for a, b in zip(port.calculate_dsf(kv, basis_atom_indices=[0, 0, 2, 5]),
                    port.calculate_dsf(kv, basis_atom_indices=[0, 2, 5])):
        np.testing.assert_array_equal(a, b)


def test_empty_k():
    _, port = pair(make_chain_trajectory(n_cells=4, n_frames=8), nx=4)
    empty = np.zeros((0, 3), np.float32)
    freqs, s, c_l, c_t = port.calculate_dsf(empty)
    assert s.shape == c_l.shape == c_t.shape == (len(freqs), 0)
    freqs, s_s = port.calculate_dsf_self(empty)
    assert s_s.shape == (len(freqs), 0)
    assert port.calculate_sk(empty).shape == (0,)
    assert port.calculate_isf(empty)[1].shape == (4, 0)
    assert port.calculate_isf_self(empty)[1].shape == (4, 0)


def test_gamma_point_conventions():
    """ρ_0(t) = N: S(0, ω=0) = N; C_L(Γ) = 0 by the unit-k convention."""
    rng = np.random.default_rng(4)
    pos = rng.uniform(0, 5, (8, 6, 3)).astype(np.float32)
    vel = rng.standard_normal((8, 6, 3)).astype(np.float32)
    ref, port = pair(_traj(pos, vel, box_edge=5.0))
    _, s, c_l, c_t = port.calculate_dsf(np.zeros((1, 3), dtype=np.float32))
    assert abs(s[0, 0] - 6.0) <= 1e-5
    assert c_l.max() == 0.0 and c_t.max() > 0.0
    assert_close(c_t, ref.calculate_dsf(np.zeros((1, 3), dtype=np.float32))[3])


# ---------------------------------------------------------------------------
# phase_mode, the JAX 'auto' engines, Welch, caches, streaming
# ---------------------------------------------------------------------------

def test_phase_mode_validation():
    traj = make_chain_trajectory(n_cells=4, n_frames=8)
    for mode in ('incremental', 'factored', 'exact'):
        assert SEDCalculator(traj, nx=4, ny=1, nz=1, phase_mode=mode,
                             device='cpu').phase_mode == mode
    with pytest.raises(ValueError, match="phase_mode"):
        SEDCalculator(traj, nx=4, ny=1, nz=1, phase_mode='bogus', device='cpu')
    assert SEDCalculator(traj, nx=4, ny=1, nz=1, device='cpu').phase_mode == 'auto'


# ---------------------------------------------------------------------------
# the 'incremental' engine: one exact phasor per 32 frames, small float32
# phases between; held to JAX 'incremental' and to the float64 oracles at
# 1e-6 of each plane's max, on unwrapped and on wrapped coordinates
# ---------------------------------------------------------------------------

def incremental_case(wrapped, n_frames=80):
    """The chain (atom 0 oscillates about x = 0) with its k path; ``wrapped``
    folds the coordinates into the box, so that atom jumps by a box length
    between frames.  80 frames: two whole anchor windows and a ragged one."""
    traj, kv = chain_case(n_frames=n_frames)
    if wrapped:
        pos = np.mod(traj.positions.astype(np.float64), traj.box_lengths).astype(np.float32)
        assert np.ptp(pos[:, 0, 0]) > 0.9 * traj.box_lengths[0]
        traj = dataclasses.replace(traj, positions=pos)
    return traj, kv


@pytest.fixture(scope='module', params=['unwrapped', 'wrapped'])
def incremental(request):
    traj, kv = incremental_case(request.param == 'wrapped')
    ref, port = pair(traj, nx=12, phase_mode='incremental')
    assert port._phase_cfg(kv)[1] == 'incremental'
    return traj, kv, ref, port


def test_incremental_dsf_matches_jax_and_oracle(incremental):
    traj, kv, ref, port = incremental
    freqs, *planes = port.calculate_dsf(kv, k_chunk_size=4)
    j_freqs, *j_planes = ref.calculate_dsf(kv)
    np.testing.assert_array_equal(freqs, j_freqs)
    assert_dsf_close(planes, j_planes)
    want = [p[positive(traj)] for p in dsf_oracle(traj.positions, traj.velocities, kv)]
    assert_dsf_close(planes, want)


def test_incremental_density_paths_match_jax_and_oracle(incremental):
    traj, kv, ref, port = incremental
    n_a, n_t = traj.n_atoms, traj.n_frames
    ang = np.einsum('tac,kc->tak', traj.positions.astype(np.float64), kv.astype(np.float64))
    rho = np.exp(1j * ang).sum(axis=1)
    sk = port.calculate_sk(kv, k_chunk_size=4)
    assert_close(sk, ref.calculate_sk(kv))
    assert_close(sk, (np.abs(rho) ** 2).mean(axis=0) / n_a)
    _, f = port.calculate_isf(kv, n_lags=20)
    assert_close(f, ref.calculate_isf(kv, n_lags=20)[1])
    assert_close(f, np.stack([(np.conj(rho[:n_t - tau]) * rho[tau:]).real.mean(axis=0) / n_a
                              for tau in range(20)]))


def test_incremental_self_parts_match_jax_and_oracle(incremental):
    traj, kv, ref, port = incremental
    n_t = traj.n_frames
    ph = np.exp(1j * np.einsum('tac,kc->tak', traj.positions.astype(np.float64),
                               kv.astype(np.float64)))
    _, ss = port.calculate_dsf_self(kv, k_chunk_size=4)
    assert_close(ss, ref.calculate_dsf_self(kv)[1])
    want = (np.abs(np.fft.fft(ph, axis=0) / n_t) ** 2).mean(axis=1)
    assert_close(ss, want[positive(traj)])
    _, fs = port.calculate_isf_self(kv, n_lags=20)
    assert_close(fs, ref.calculate_isf_self(kv, n_lags=20)[1])
    assert_close(fs, np.stack([(np.conj(ph[:n_t - tau]) * ph[tau:]).real.mean(axis=(0, 1))
                               for tau in range(20)]))
    np.testing.assert_allclose(fs[0], 1.0, rtol=1e-6)


def test_incremental_welch_matches_jax(incremental):
    traj, kv, ref, port = incremental
    got = port.calculate_dsf(kv, welch_segments=2)[1:]
    assert_dsf_close(got, ref.calculate_dsf(kv, welch_segments=2)[1:])


@pytest.mark.parametrize('wrapped', [False, True])
def test_incremental_time_tiles_equal_untiled(wrapped, monkeypatch):
    """Tiles are cut on anchor-window boundaries (a 40-frame request becomes
    32), so a tiled run meets the anchors of an untiled one: the stacks are
    the same bit for bit, at the ops and through the calculator."""
    traj, kv = incremental_case(wrapped)
    box = t(np.asarray(traj.box_matrix, np.float32))
    assert tinst.time_tile(40, 'incremental') == 32 and tinst.time_tile(7, 'incremental') == 32
    assert tinst.time_tile(40, 'exact') == tinst.time_tile(40, 'factored') == 40
    args = (t(traj.positions), t(traj.velocities), t(kv))
    whole = tinst.instant_modes(*args, 10_000, box, 'incremental')
    tiled = tinst.instant_modes(*args, 40, box, 'incremental')
    for a, b in zip(whole, tiled):
        assert torch.equal(a, b)
    d_whole = tinst.density_modes(args[0], args[2], 10_000, box, 'incremental')
    d_tiled = tinst.density_modes(args[0], args[2], 33, box, 'incremental')
    for a, b in zip(d_whole, d_tiled):
        assert torch.equal(a, b)
    _, port = pair(traj, nx=12, phase_mode='incremental')
    want = port.calculate_dsf(kv)
    monkeypatch.setattr(port, '_dsf_plan', lambda *a: (5, 40))
    for g, w in zip(port.calculate_dsf(kv), want):
        assert_close(g, w, floor=1e-30)


def test_incremental_phasors_match_jax_ops_and_window():
    """The phasors against the JAX op on wrapped coordinates, with the box
    (minimum image and the removed images' residual phases) and without
    (unwrapped), at 2e-6 absolute: both sides carry about |δ|·2⁻²⁴ of their
    own rounding."""
    assert tinst._ANCHOR_WINDOW == jinst._ANCHOR_WINDOW == 32
    for wrapped in (False, True):
        traj, kv = incremental_case(wrapped, n_frames=70)
        box = np.asarray(traj.box_matrix, np.float32) if wrapped else None
        cs = tinst.instant_phasors(t(traj.positions), t(kv), None if box is None else t(box),
                                   'incremental').numpy()
        j_c, j_s = jinst._instant_phasors(jnp.asarray(traj.positions), jnp.asarray(kv),
                                          None if box is None else jnp.asarray(box),
                                          'incremental')
        assert cs.shape == (70, traj.n_atoms, 2 * len(kv))
        c, s = (part for part in tinst.phasor_parts(torch.from_numpy(cs), 'incremental'))
        assert np.abs(c.numpy() - np.asarray(j_c)).max() <= 2e-6
        assert np.abs(s.numpy() - np.asarray(j_s)).max() <= 2e-6
        ang = np.einsum('tac,kc->tak', traj.positions.astype(np.float64), kv.astype(np.float64))
        assert np.abs(c.numpy() - np.cos(ang)).max() <= 2e-6


@pytest.mark.parametrize('mode', ['incremental', 'factored'])
def test_fast_engines_fall_back_to_exact_bit_for_bit(mode):
    """Off-lattice k runs 'exact' under either engine, and a singular box
    turns 'incremental' into 'exact': the outputs are the exact engine's."""
    traj, kv = chain_case()
    _, exact = pair(traj, nx=12)
    _, port = pair(traj, nx=12, phase_mode=mode)
    off = (kv * 1.013).astype(np.float32)
    assert port._phase_cfg(off) == (None, 'exact')
    for a, b in zip(port.calculate_dsf(off), exact.calculate_dsf(off)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port.calculate_isf_self(off, n_lags=8)[1],
                                  exact.calculate_isf_self(off, n_lags=8)[1])
    # a degenerate axis: no calculator is built on such a box, so it is set after
    port.traj.box_matrix = np.diag([30.0, 10.0, 0.0]).astype(np.float32)
    assert port._dsf_box() is None
    assert port._phase_cfg(kv) == (None, 'exact' if mode == 'incremental' else 'factored')
    np.testing.assert_array_equal(port.calculate_sk(kv), exact.calculate_sk(kv))


def test_phasor_bytes_size_the_tiles_per_engine():
    """Each engine's own byte count sizes its tiles (the exact engine's plan
    is pinned below, at the working size)."""
    traj, kv = chain_case()
    _, port = pair(traj, nx=12, max_device_bytes=int(8e9))
    group = np.arange(traj.n_atoms)
    assert set(tinst.PHASOR_BYTES) == {'exact', 'factored', 'incremental'}
    n_t, n_a = 10_000, 100_000
    zeros = np.broadcast_to(np.zeros(3, np.float32), (n_t, n_a, 3))
    box = np.diag([130.0] * 3).astype(np.float32)
    big = TorchTrajectory(zeros, zeros, np.ones(n_a, np.int32), np.arange(n_t, dtype=np.float32),
                          box, *make_box_arrays(box), dt_ps=0.01)
    calc = SEDCalculator(big, nx=24, ny=24, nz=24, max_device_bytes=int(30e9), device='cpu')
    group = np.arange(n_a)
    for mode, per in tinst.PHASOR_BYTES.items():
        atoms, frames = calc._dsf_plan(128, group, True, mode)
        assert atoms == n_a and frames == int(30e9) // (4 * per) // (n_a * 128)


def test_auto_matches_jax_auto():
    """JAX 'auto' runs its incremental engine on the density and self
    families; the port's exact engine agrees with it at 1e-6 of max."""
    traj, kv = chain_case()
    ref, port = pair(traj, nx=12, phase_mode='auto')
    assert port.phase_mode == 'auto'
    assert_close(port.calculate_sk(kv), ref.calculate_sk(kv))
    assert_close(port.calculate_isf(kv, n_lags=20)[1], ref.calculate_isf(kv, n_lags=20)[1])
    assert_close(port.calculate_dsf_self(kv)[1], ref.calculate_dsf_self(kv)[1])
    assert_close(port.calculate_isf_self(kv, n_lags=20)[1],
                 ref.calculate_isf_self(kv, n_lags=20)[1])
    assert_dsf_close(port.calculate_dsf(kv)[1:], ref.calculate_dsf(kv)[1:])


def test_welch_segments_match_jax():
    traj, kv = chain_case(n_frames=96)
    ref, port = pair(traj, nx=12)
    freqs, *planes = port.calculate_dsf(kv, welch_segments=3, k_chunk_size=4)
    j_freqs, *j_planes = ref.calculate_dsf(kv, welch_segments=3)
    np.testing.assert_array_equal(freqs, j_freqs)
    assert planes[0].shape == (16, len(kv))
    assert_dsf_close(planes, j_planes)
    with pytest.raises(ValueError, match="welch_segments"):
        port.calculate_dsf(kv, welch_segments=0)


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_dsf_cache_resumes_across_packages(tmp_path, writer):
    """The 'dsf' shard cache carries the JAX workload keys (phase_mode
    'auto' on both sides), so a sweep written by one package resumes in the
    other without computing, bit for bit."""
    traj, kv = chain_case()
    ref, port = pair(traj, nx=12, phase_mode='auto')
    first, second = (ref, port) if writer == 'jax' else (port, ref)
    want = first.calculate_dsf(kv, k_chunk_size=4, cache_dir=tmp_path)
    # any computation raises on the second side
    second._dsf_blocks = second._dsf_device_blocks = None
    got = second.calculate_dsf(kv, k_chunk_size=4, cache_dir=tmp_path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_resume_computes_only_missing_chunks(tmp_path, monkeypatch):
    traj, kv = chain_case()
    _, port = pair(traj, nx=12)
    whole = port.calculate_sk(kv, k_chunk_size=2, cache_dir=tmp_path)
    _, f = port.calculate_isf(kv, k_chunk_size=2, cache_dir=tmp_path, n_lags=8)
    next(tmp_path.glob('*/chunk_00001.npy')).unlink()
    calls = []
    real = tinst.accumulate_modes
    monkeypatch.setattr(tinst, 'accumulate_modes', lambda *a: calls.append(1) or real(*a))
    np.testing.assert_array_equal(port.calculate_sk(kv, k_chunk_size=2, cache_dir=tmp_path),
                                  whole)
    np.testing.assert_array_equal(
        port.calculate_isf(kv, k_chunk_size=2, cache_dir=tmp_path, n_lags=8)[1], f)
    assert len(calls) == 1


def test_streamed_group_matches_resident_and_jax():
    """max_device_bytes below the group: positions (and velocities) stream
    from the host in atom blocks; the planes agree with the resident ones
    and with JAX at 1e-6 of max."""
    traj, kv = chain_case()
    ref, port = pair(traj, nx=12)
    _, sport = pair(traj, nx=12, max_device_bytes=2 * 12 * traj.n_frames * 5)
    assert sport.stream_block_atoms(traj.n_atoms) < traj.n_atoms
    assert_dsf_close(sport.calculate_dsf(kv, k_chunk_size=4)[1:],
                     port.calculate_dsf(kv, k_chunk_size=4)[1:])
    assert sport.streamed_bytes > 0
    assert_close(sport.calculate_sk(kv), ref.calculate_sk(kv))
    assert_close(sport.calculate_dsf_self(kv)[1], ref.calculate_dsf_self(kv)[1])
    assert_close(sport.calculate_isf_self(kv, n_lags=10)[1],
                 ref.calculate_isf_self(kv, n_lags=10)[1])
    assert not sport._device_cache


class _NoVelocities:
    """A trajectory whose velocities must not be read."""

    def __init__(self, traj):
        self._traj = traj

    def __getattr__(self, name):
        if name == 'velocities':
            raise AssertionError("the density-only path read velocities")
        return getattr(self._traj, name)


@pytest.mark.parametrize('budget', [None, 600])
def test_density_paths_read_no_velocities(budget):
    traj, kv = chain_case()
    ref, port = pair(traj, nx=12, **({} if budget is None else {'max_device_bytes': budget}))
    want = (ref.calculate_sk(kv), ref.calculate_isf(kv, n_lags=8)[1],
            ref.calculate_dsf_self(kv)[1], ref.calculate_isf_self(kv, n_lags=8)[1])
    port.traj = _NoVelocities(traj)
    got = (port.calculate_sk(kv), port.calculate_isf(kv, n_lags=8)[1],
           port.calculate_dsf_self(kv)[1], port.calculate_isf_self(kv, n_lags=8)[1])
    for g, w in zip(got, want):
        assert_close(g, w)


def test_resident_arrays_are_cached_across_calls():
    """Warm calls reuse the device copies: the DSF's positions-and-
    velocities entry also serves S(k); nothing is uploaded again."""
    traj, kv = chain_case()
    _, port = pair(traj, nx=12)
    port.calculate_dsf(kv)
    group = np.arange(traj.n_atoms)
    pos, vel = port._raw_device_arrays(group, 'PV')
    port.calculate_sk(kv)
    port.calculate_dsf_self(kv)
    assert len(port._device_cache) == 1
    again, none = port._raw_device_arrays(group, 'P')
    assert again is pos and none is None and vel is not None


@pytest.mark.parametrize('budget,want', [(int(30e9), (100_000, 24)), (int(8e9), (2236, 291))])
def test_tile_plan_at_the_working_size(budget, want):
    """The working size (10⁵ atoms × 10⁴ frames, 128 k), as broadcast views:
    resident, the tiles span every atom; streamed, the atom chunk is the
    staged block and the time tiles fill the budget for it."""
    n_t, n_a = 10_000, 100_000
    zeros = np.broadcast_to(np.zeros(3, np.float32), (n_t, n_a, 3))
    box = np.diag([130.0] * 3).astype(np.float32)
    traj = TorchTrajectory(zeros, zeros, np.ones(n_a, np.int32), np.arange(n_t, dtype=np.float32),
                           box, *make_box_arrays(box), dt_ps=0.01)
    calc = SEDCalculator(traj, nx=24, ny=24, nz=24, max_device_bytes=budget, device='cpu')
    group = np.arange(n_a)
    assert calc._dsf_plan(128, group, True) == want
    assert calc._instant_streams(group, True) == (budget < 24e9)
    assert not calc._instant_streams(group, False) or budget < 12e9
