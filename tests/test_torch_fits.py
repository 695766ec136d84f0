"""psa_tpu_torch's relaxation fits (NumPy, carried over): the cases of
``tests/test_fits.py`` and equality with :mod:`psa_tpu.utils.fits` to 1e-12
on the same curves."""
import numpy as np
import pytest
import torch

from psa_tpu.utils import fits as jfits
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.utils import fits as tfits
from psa_tpu_torch.utils import isf_relaxation_time, kww_fit

from test_timecorr import _traj

torch.set_num_threads(1)


def _kww(t, a, tau, beta):
    return a * np.exp(-(t / tau) ** beta)


PARAMS = [(1.0, 5.0, 1.0), (0.9, 2.0, 0.6), (0.7, 10.0, 1.8), (1.0, 0.5, 0.45)]


@pytest.mark.parametrize("a0,t0,b0", PARAMS)
def test_recovers_exact_parameters(a0, t0, b0):
    t = np.linspace(0.0, 40.0, 400)
    amp, tau, beta, rms = kww_fit(t, _kww(t, a0, t0, b0)[:, None], normalize=False)
    np.testing.assert_allclose(amp[0], a0, rtol=1e-3)
    np.testing.assert_allclose(tau[0], t0, rtol=1e-2)
    np.testing.assert_allclose(beta[0], b0, rtol=1e-2)
    assert rms[0] < 1e-5


def test_noisy_recovery():
    rng = np.random.default_rng(0)
    t = np.linspace(0.0, 30.0, 300)
    f = _kww(t, 1.0, 4.0, 0.8)[:, None] + rng.normal(0, 1e-3, (300, 1))
    _, tau, beta, rms = kww_fit(t, f, normalize=False)
    np.testing.assert_allclose(tau[0], 4.0, rtol=0.05)
    np.testing.assert_allclose(beta[0], 0.8, rtol=0.05)
    assert rms[0] < 5e-3


def test_normalize_and_window():
    t = np.linspace(0.0, 200.0, 2000)
    f = (0.4 * np.exp(-t / 0.3) + _kww(t, 0.6, 50.0, 0.7))[:, None] * 2.0
    amp, tau, beta, _ = kww_fit(t, f, fit_window=(3.0, 200.0))
    np.testing.assert_allclose(amp[0], 0.6, rtol=0.05)
    np.testing.assert_allclose(tau[0], 50.0, rtol=0.10)
    np.testing.assert_allclose(beta[0], 0.7, rtol=0.05)


def test_degenerate_inputs():
    amp, tau, _, _ = kww_fit(np.linspace(0.0, 1.0, 2), np.ones((2, 3)))
    assert np.isnan(amp).all() and np.isnan(tau).all()
    t = np.linspace(0.0, 10.0, 50)
    f = np.stack([_kww(t, 1.0, 2.0, 1.0), np.full(50, np.nan)], axis=1)
    _, tau, _, _ = kww_fit(t, f, normalize=False)
    np.testing.assert_allclose(tau[0], 2.0, rtol=1e-2)
    assert np.isnan(tau[1])


def test_exponential_crossing_is_tau():
    t = np.linspace(0.0, 20.0, 500)
    f = np.stack([np.exp(-t / 3.0), np.exp(-t / 7.0)], axis=1)
    np.testing.assert_allclose(isf_relaxation_time(t, f), [3.0, 7.0], rtol=1e-3)


def test_unnormalized_input_and_no_crossing():
    t = np.linspace(0.0, 5.0, 100)
    f = np.stack([4.0 * np.exp(-t / 1.5), np.exp(-t / 1e4)], axis=1)
    tau = isf_relaxation_time(t, f)
    np.testing.assert_allclose(tau[0], 1.5, rtol=1e-3)
    assert np.isnan(tau[1])


def curves(seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0.0, 30.0, 240)
    cols = [_kww(t, rng.uniform(0.5, 2.0), rng.uniform(1, 12), rng.uniform(0.5, 1.6))
            for _ in range(5)]
    return t, np.stack(cols, axis=1) + rng.normal(0, 1e-3, (240, 5))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kwargs", [{}, {'normalize': False}, {'fit_window': (1.0, 20.0)}],
                         ids=str)
def test_kww_fit_equals_the_reference(seed, kwargs):
    t, f = curves(seed)
    for got, want in zip(tfits.kww_fit(t, f, **kwargs), jfits.kww_fit(t, f, **kwargs)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12, equal_nan=True)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kwargs", [{}, {'threshold': 0.5}, {'normalize': False}], ids=str)
def test_relaxation_time_equals_the_reference(seed, kwargs):
    t, f = curves(seed)
    np.testing.assert_allclose(tfits.isf_relaxation_time(t, f, **kwargs),
                               jfits.isf_relaxation_time(t, f, **kwargs),
                               rtol=1e-12, atol=1e-12, equal_nan=True)


def test_isf_self_kww_gives_beta_one_and_d():
    """F_s(k,τ) = exp(−k²Dτ) for Brownian walkers through the port's
    ``calculate_isf_self``: the fit finds β ≈ 1 and D = 1/(τ_k·k²).  (A
    quarter of the reference test's walkers and frames, so wider bars.)"""
    rng = np.random.default_rng(3)
    n_t, n_a, d_true, dt_ps = 1024, 128, 0.25, 0.1
    pos = np.cumsum(rng.normal(0, np.sqrt(2 * d_true * dt_ps), (n_t, n_a, 3)), axis=0)
    port = SEDCalculator(_traj(pos, np.zeros_like(pos), box_edge=50.0, dt_ps=dt_ps), 1, 1, 1,
                         device='cpu')
    kv = np.array([[2 * np.pi / 50.0 * 8, 0, 0], [0, 2 * np.pi / 50.0 * 12, 0]], np.float32)
    lags, fs = port.calculate_isf_self(kv, n_lags=128)
    amp, tau, beta, _ = kww_fit(lags, fs)
    k2 = np.linalg.norm(kv, axis=1).astype(np.float64) ** 2
    np.testing.assert_allclose(beta, 1.0, atol=0.12)
    np.testing.assert_allclose(1.0 / (tau * k2), d_true, rtol=0.15)
    np.testing.assert_allclose(amp, 1.0, atol=0.08)
