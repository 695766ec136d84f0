"""psa_tpu_torch's dispersion and transport layer against the JAX package.

``ops/dispersion.py`` and ``ops/transport.py`` are NumPy code carried over
from the JAX package: on the same inputs they give its outputs bit for bit.
The calculator methods built on the device peaks
(``calculate_group_velocity_path``/``_surface``,
``calculate_thermal_conductivity``) are held to the analytic oracles with the
tolerances of tests/test_dispersion.py and tests/test_transport.py, and to
the JAX calculator on the same trajectories.
"""
import dataclasses

import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.models import (make_chain_trajectory, make_square_lattice_trajectory,
                            square_lattice_dispersion)
from psa_tpu.ops import dispersion as jdisp
from psa_tpu.ops import transport as jtrans
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.ops import dispersion as tdisp
from psa_tpu_torch.ops import transport as ttrans

torch.set_num_threads(1)

TWO_PI = 2.0 * np.pi


def pair(traj, n_xy):
    ref = JaxCalculator(traj, nx=n_xy[0], ny=n_xy[1], nz=1)
    return ref, from_reference_calculator(ref, device='cpu')


def crossing_bands(rng, n_bands=3, n_k=31):
    """Height-ordered peaks of crossing branches, plus a companion array."""
    k = np.linspace(0, 1, n_k)
    bands = np.stack([np.sin(np.pi * k) * (b + 1) + 0.3 * b for b in range(n_bands)])
    heights = rng.uniform(0.1, 1.0, size=bands.shape)
    order = np.argsort(-heights, axis=0)
    return (np.take_along_axis(bands, order, 0).astype(np.float32),
            np.take_along_axis(heights, order, 0).astype(np.float32), k)


def test_dispersion_carried_bit_for_bit():
    rng = np.random.default_rng(0)
    freqs, heights, k = crossing_bands(rng)
    for a, b in zip(tdisp.sort_bands_path(freqs, heights), jdisp.sort_bands_path(freqs, heights)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tdisp.group_velocity_path(freqs, k),
                                  jdisp.group_velocity_path(freqs, k))
    k_uneven = np.sort(rng.uniform(0, 1, len(k)))
    np.testing.assert_array_equal(tdisp.group_velocity_path(freqs, k_uneven),
                                  jdisp.group_velocity_path(freqs, k_uneven))
    sheets = rng.uniform(0, 5, size=(2, 6, 5)).astype(np.float32)
    widths = rng.uniform(0, 1, size=sheets.shape).astype(np.float32)
    for a, b in zip(tdisp.sort_bands_grid(sheets, widths), jdisp.sort_bands_grid(sheets, widths)):
        np.testing.assert_array_equal(a, b)
    kx, ky = np.linspace(0, 1, 6), np.linspace(0, 2, 5)
    for a, b in zip(tdisp.group_velocity_grid(sheets, kx, ky),
                    jdisp.group_velocity_grid(sheets, kx, ky)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        tdisp.group_velocity_grid(np.zeros((1, 4, 5)), np.zeros(4), np.zeros(4))


def test_transport_carried_bit_for_bit():
    rng = np.random.default_rng(1)
    widths = rng.uniform(-0.1, 2.0, size=(2, 4, 3))
    widths[0, 0, 0] = 0.0
    for floor in (None, 0.3):
        np.testing.assert_array_equal(ttrans.phonon_lifetimes(widths, floor),
                                      jtrans.phonon_lifetimes(widths, floor))
    vx, vy = rng.normal(size=(2, 2, 4, 3))
    tau = ttrans.phonon_lifetimes(widths, 0.3)
    for weights in (None, rng.uniform(1, 2, size=vx.shape)):
        got = dataclasses.astuple(ttrans.kinetic_kappa(vx, vy, tau, 123.0, mode_weights=weights))
        want = dataclasses.astuple(jtrans.kinetic_kappa(vx, vy, tau, 123.0, mode_weights=weights))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="volume"):
        ttrans.kinetic_kappa(np.ones(2), np.ones(2), np.ones(2), 0.0)


def test_group_velocity_path_on_chain():
    """tests/test_dispersion.py's chain oracle through the port, and the JAX
    calculator on the same trajectory."""
    a, nu_max, n_cells, n_frames, dt = 2.5, 10.0, 64, 512, 0.05
    traj = make_chain_trajectory(n_cells=n_cells, n_frames=n_frames, dt_ps=dt, a=a,
                                 omega_max_thz=nu_max, seed=3)
    ref, port = pair(traj, (n_cells, 1))
    m = n_cells // 2
    k_mags = np.arange(m + 1) * (np.pi / a) / m
    k_vecs = np.stack([k_mags, np.zeros(m + 1), np.zeros(m + 1)], axis=1).astype(np.float32)
    freqs, v, heights = port.calculate_group_velocity_path(k_mags, k_vecs, n_bands=1,
                                                           k_chunk_size=10)
    want_v = np.pi * a * nu_max * np.cos(k_mags * a / 2.0)
    df = 1.0 / (n_frames * dt)
    tol = TWO_PI * df / (k_mags[1] - k_mags[0]) + 1e-3
    inner = slice(2, m)
    assert np.max(np.abs(v[0, inner] - want_v[inner])) <= tol
    assert np.max(np.abs(freqs[0, inner] - nu_max * np.abs(np.sin(k_mags[inner] * a / 2))))\
        <= df + 1e-6
    j_freqs, j_v, j_heights = ref.calculate_group_velocity_path(k_mags, k_vecs, n_bands=1)
    np.testing.assert_array_equal(freqs[:, 1:], j_freqs[:, 1:])     # Γ holds no mode
    np.testing.assert_array_equal(v[:, 2:], j_v[:, 2:])
    assert np.max(np.abs(heights - j_heights)) / np.max(j_heights) < 1e-6
    with pytest.raises(ValueError, match="chiral"):
        port.calculate_group_velocity_path(k_mags, k_vecs, chiral=True)


def test_group_velocity_surface_on_square_lattice():
    a, nu_max, n_cells, n_frames, dt = 2.5, 10.0, 12, 512, 0.01
    traj = make_square_lattice_trajectory(n_cells=n_cells, n_frames=n_frames, dt_ps=dt, a=a,
                                          nu_max_thz=nu_max, seed=5)
    ref, port = pair(traj, (n_cells, n_cells))
    n_half = n_cells // 2 + 1
    _, k_vecs, shape = port.get_k_grid('xy', (0.0, np.pi / a), (0.0, np.pi / a), n_half, n_half)
    freqs, vx, vy, heights = port.calculate_group_velocity_surface(k_vecs, shape, n_bands=1,
                                                                   k_chunk_size=20)
    assert freqs.shape == vx.shape == vy.shape == heights.shape == (1, n_half, n_half)
    kx = np.unique(k_vecs[:, 0].astype(np.float64))
    ky = np.unique(k_vecs[:, 1].astype(np.float64))
    KX, KY = np.meshgrid(kx, ky, indexing='ij')
    want_vx, want_vy = tdisp.group_velocity_grid(
        square_lattice_dispersion(KX, KY, a=a, nu_max_thz=nu_max)[None], kx, ky)
    tol = TWO_PI * (1.0 / (n_frames * dt)) / (kx[1] - kx[0]) + 1e-3
    assert np.max(np.abs(vx[0, 1:, 1:] - want_vx[0, 1:, 1:])) <= tol
    assert np.max(np.abs(vy[0, 1:, 1:] - want_vy[0, 1:, 1:])) <= tol
    j_freqs, j_vx, j_vy, _ = ref.calculate_group_velocity_surface(k_vecs, shape, n_bands=1)
    # the kx = 0 and ky = 0 lines are left out, as the analytic check above does
    np.testing.assert_array_equal(freqs[0, 1:, 1:], j_freqs[0, 1:, 1:])
    np.testing.assert_array_equal(vx[0, 2:, 1:], j_vx[0, 2:, 1:])
    np.testing.assert_array_equal(vy[0, 1:, 2:], j_vy[0, 1:, 2:])
    with pytest.raises(ValueError, match="chiral"):
        port.calculate_group_velocity_surface(k_vecs, shape, chiral=True)


def test_thermal_conductivity_on_damped_lattice():
    """tests/test_transport.py's damped-lattice oracle through the port, and
    κ against the JAX calculator to the rtol its mesh test uses (1e-3)."""
    a, nu_max, n_cells, n_frames, dt, gamma = 2.5, 10.0, 8, 2048, 0.01, 1.0
    traj = make_square_lattice_trajectory(n_cells=n_cells, n_frames=n_frames, dt_ps=dt, a=a,
                                          nu_max_thz=nu_max, seed=7, amp_decay_per_ps=gamma)
    ref, port = pair(traj, (n_cells, n_cells))
    dk = 2 * np.pi / (n_cells * a)
    m = n_cells // 2
    _, k_vecs, shape = port.get_k_grid('xy', (dk, m * dk), (dk, m * dk), m, m)
    res, bf, vx, vy = port.calculate_thermal_conductivity(k_vecs, shape, n_bands=1,
                                                          exclusion_bins=12, k_chunk_size=5)
    assert res.n_modes_used == res.n_modes_total == m * m
    np.testing.assert_allclose(res.lifetimes_ps, 1.0 / (2 * gamma), rtol=0.08)
    kx = np.unique(k_vecs[:, 0].astype(np.float64))
    ky = np.unique(k_vecs[:, 1].astype(np.float64))
    KX, KY = np.meshgrid(kx, ky, indexing='ij')
    want_vx, want_vy = tdisp.group_velocity_grid(
        square_lattice_dispersion(KX, KY, a=a, nu_max_thz=nu_max)[None], kx, ky)
    vol = float(np.abs(np.linalg.det(traj.box_matrix.astype(np.float64))))
    want = ttrans.kinetic_kappa(want_vx, want_vy, np.full_like(want_vx, 1.0 / (2 * gamma)), vol)
    np.testing.assert_allclose(res.kappa_xx, want.kappa_xx, rtol=0.2)
    np.testing.assert_allclose(res.kappa_yy, want.kappa_yy, rtol=0.2)
    j_res, j_bf, _, _ = ref.calculate_thermal_conductivity(k_vecs, shape, n_bands=1,
                                                           exclusion_bins=12)
    np.testing.assert_array_equal(bf, j_bf)
    assert res.n_modes_used == j_res.n_modes_used
    np.testing.assert_allclose(res.lifetimes_ps, j_res.lifetimes_ps, rtol=1e-3)
    for name in ('kappa_xx', 'kappa_yy'):
        np.testing.assert_allclose(getattr(res, name), getattr(j_res, name), rtol=1e-3)
    with pytest.raises(ValueError, match="lorentzian"):
        port.calculate_thermal_conductivity(k_vecs, shape, width_method='rms')
    with pytest.raises(ValueError, match="chiral"):
        port.calculate_thermal_conductivity(k_vecs, shape, chiral=True)
