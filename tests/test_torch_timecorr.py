"""psa_tpu_torch's MSD and VACF against the JAX package and the float64
oracles of ``tests/test_timecorr.py``.

The same seeded inputs go through both packages on the CPU.  Tolerances:
the block functions against the direct all-origins float64 sums at the
reference's own bar (rtol 5e-5, atol 1e-4); the port against JAX at rtol
1e-5, atol 1e-5 (two float32 FFTs); chunk-size and streamed-vs-resident
invariance at 1e-5; the physics at the bars of ``test_timecorr.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.ops import timecorr as jtc
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.ops import timecorr as ttc
from psa_tpu_torch.ops.instantaneous import _autocorr_fft_len

from test_timecorr import _traj, msd_oracle, vacf_oracle

torch.set_num_threads(1)

ORACLE = dict(rtol=5e-5, atol=1e-4)
JAX = dict(rtol=1e-5, atol=1e-5)
FUNCS = {'msd': (ttc.msd_block, jtc.msd_block, msd_oracle),
         'vacf': (ttc.vacf_block, jtc.vacf_block, vacf_oracle)}


def pair(traj, **kwargs):
    ref = JaxCalculator(traj, nx=1, ny=1, nz=1, **kwargs)
    return ref, from_reference_calculator(ref, device='cpu')


def random_case(seed, n_t=64, n_a=12, scale=1.0, types=None):
    rng = np.random.default_rng(seed)
    pos = rng.normal(0, scale, (n_t, n_a, 3)).astype(np.float32)
    vel = rng.normal(0, scale, (n_t, n_a, 3)).astype(np.float32)
    return _traj(pos, vel, types=types)


# ---------------------------------------------------------------------------
# The block functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ['msd', 'vacf'])
@pytest.mark.parametrize("n_t,n_a,n_lags", [(37, 5, 20), (64, 9, 64), (50, 1, 1), (16, 3, 8)])
def test_block_matches_f64_oracle_and_jax(kind, n_t, n_a, n_lags):
    """Odd n_t exercises the padding; n_lags = n_t the thinnest overlap."""
    port_fn, jax_fn, oracle = FUNCS[kind]
    x = np.random.default_rng(n_t + n_a).normal(0, 2.0, (n_t, n_a, 3)).astype(np.float32)
    got = port_fn(torch.from_numpy(x), n_lags).numpy()
    assert got.shape == (n_lags,) and got.dtype == np.float32
    np.testing.assert_allclose(got, oracle(x, n_lags).sum(axis=1), **ORACLE)
    ref = np.asarray(jax_fn(jnp.asarray(x), jnp.ones(n_a, jnp.float32), n_lags))
    np.testing.assert_allclose(got, ref, **ORACLE)


@pytest.mark.parametrize("offset", [0.0, 50.0, 1000.0])
def test_msd_invariant_to_large_coordinate_offset(offset):
    """The per-atom centring keeps the float32 S1 − 2·S2 usable far from
    the origin (without it a +1000 Å offset costs a factor at lag 1)."""
    rng = np.random.default_rng(1)
    pos = np.cumsum(rng.normal(0, 0.1, (128, 6, 3)), axis=0)
    want = msd_oracle(pos, 40).sum(axis=1)
    got = ttc.msd_block(torch.from_numpy((pos + offset).astype(np.float32)), 40).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("kind", ['msd', 'vacf'])
def test_blocks_add_up(kind):
    """Ragged atom blocks (no padding, no mask) sum to the whole."""
    port_fn = FUNCS[kind][0]
    x = torch.from_numpy(np.random.default_rng(2).normal(0, 1, (32, 7, 3)).astype(np.float32))
    whole = port_fn(x, 16).double()
    parts = ttc.timecorr_sum((x[:, a0:a0 + 3] for a0 in range(0, 7, 3)), 16, kind)
    assert parts.dtype == torch.float64
    np.testing.assert_allclose(parts.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)


def test_block_bytes_per_atom_counts_the_padded_transform():
    n_t = 10_000
    assert _autocorr_fft_len(n_t) == 32_768
    assert ttc.block_bytes_per_atom(n_t) == 60 * 32_768 + 24 * n_t


# ---------------------------------------------------------------------------
# The calculator surfaces against the JAX calculator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", ['calculate_msd', 'calculate_vacf'])
@pytest.mark.parametrize("kwargs", [
    {}, {'n_lags': 16}, {'n_lags': 1}, {'n_lags': 10_000},
    {'basis_atom_types': [1, 2]}, {'basis_atom_types': [[1, 2], [2]]},
    {'basis_atom_indices': [0, 3, 4, 9]}, {'basis_atom_indices': [[0, 1], [5, 6, 7]]},
    {'basis_atom_types': [3]},
], ids=str)
def test_surface_matches_jax(method, kwargs):
    types = np.array([1, 2] * 6, np.int32)
    ref, port = pair(random_case(3, types=types))
    want_lags, want = getattr(ref, method)(**kwargs)
    lags, got = getattr(port, method)(**kwargs)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(lags, want_lags)
    np.testing.assert_allclose(got, want, **JAX)


@pytest.mark.parametrize("method", ['calculate_msd', 'calculate_vacf'])
@pytest.mark.parametrize("chunk", [1, 3, 5, 12, 100])
def test_atom_chunk_invariance(method, chunk):
    _, port = pair(random_case(10, n_a=10))
    _, one = getattr(port, method)(n_lags=16)
    _, many = getattr(port, method)(n_lags=16, atom_chunk_size=chunk)
    np.testing.assert_allclose(many, one, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ['calculate_msd', 'calculate_vacf'])
@pytest.mark.parametrize("kwargs", [{}, {'atom_chunk_size': 5}, {'basis_atom_types': [1, 2]}],
                         ids=str)
def test_oversize_group_streams_and_matches_resident(method, kwargs):
    """``max_device_bytes`` small on both packages: every group streams
    through the staging; nothing raw stays in the device cache."""
    types = np.array([1] * 5 + [2] * 7, np.int32)
    traj = random_case(13, types=types)
    _, resident = pair(traj)
    ref, streamed = pair(traj, max_device_bytes=1000)
    _, want = getattr(resident, method)(n_lags=16, **kwargs)
    _, got = getattr(streamed, method)(n_lags=16, **kwargs)
    assert streamed.streamed_bytes > 0 and not streamed._device_cache
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, getattr(ref, method)(
        n_lags=16, **dict(kwargs, atom_chunk_size=kwargs.get('atom_chunk_size', 4)))[1], **JAX)


def test_default_chunk_follows_the_budget():
    """The atoms per FFT batch come from ``max_device_bytes`` and the
    chain's bytes per atom, not from a fixed constant."""
    seen = []
    traj = random_case(14, n_t=64, n_a=40)
    for budget in (4 * 3 * ttc.block_bytes_per_atom(64), int(8e9)):
        _, port = pair(traj, max_device_bytes=budget)
        real = port._raw_blocks
        port._raw_blocks = lambda g, chunk, need, streams, real=real: (
            seen.append(chunk) or real(g, chunk, need, streams))
        port.calculate_vacf(n_lags=8)
    assert seen == [3, 40]


def test_device_cache_reused_between_calls():
    """The raw arrays stay resident: a second call reuses the same tensor,
    and the DSF's positions-and-velocities entry serves MSD and VACF."""
    traj = random_case(11, n_a=10)
    _, port = pair(traj)
    _, m1 = port.calculate_msd(n_lags=16)
    keys = list(port._device_cache)
    assert len(keys) == 1 and keys[0].endswith(b'IP')
    before = port._device_cache[keys[0]][0]
    _, m2 = port.calculate_msd(n_lags=16)
    assert port._device_cache[keys[0]][0] is before
    np.testing.assert_array_equal(m1, m2)
    port.calculate_vacf(n_lags=16)
    assert any(k.endswith(b'IV') for k in port._device_cache)


def test_warm_after_dsf_uploads_nothing():
    traj = random_case(12, n_a=10)
    _, port = pair(traj)
    kv = np.array([[2 * np.pi / 20.0, 0, 0]], np.float32)
    port.calculate_dsf(kv)
    pos, vel = port._raw_device_arrays(np.arange(10), 'PV')
    port._to_device = None                      # any upload would raise
    port._host_blocks = None
    _, msd = port.calculate_msd(n_lags=8)
    _, vacf = port.calculate_vacf(n_lags=8)
    assert len(port._device_cache) == 1
    np.testing.assert_allclose(msd[0], ttc.msd_block(pos, 8).numpy() / 10, rtol=1e-6)
    np.testing.assert_allclose(vacf[0], ttc.vacf_block(vel, 8).numpy() / 10, rtol=1e-6)


# ---------------------------------------------------------------------------
# Physics (the fixtures of tests/test_timecorr.py)
# ---------------------------------------------------------------------------

def test_msd_einstein_recovers_diffusion():
    rng = np.random.default_rng(7)
    n_t, n_a, d_true, dt_ps = 2048, 128, 0.3, 0.1
    pos = np.cumsum(rng.normal(0, np.sqrt(2 * d_true * dt_ps), (n_t, n_a, 3)), axis=0)
    port = SEDCalculator(_traj(pos, np.zeros_like(pos), dt_ps=dt_ps), 1, 1, 1, device='cpu')
    lags, msd = port.calculate_msd(n_lags=100)
    assert msd.shape == (1, 100)
    assert abs(msd[0, 0]) < 1e-4 * msd[0, -1]
    slope = np.polyfit(lags[1:], msd[0, 1:].astype(np.float64), 1)[0]
    np.testing.assert_allclose(slope / 6.0, d_true, rtol=0.05)


def test_msd_per_type_groups():
    rng = np.random.default_rng(8)
    n_t, n_half, dt_ps, d1, d2 = 1024, 64, 0.1, 0.2, 0.8
    walks = [np.cumsum(rng.normal(0, np.sqrt(2 * d * dt_ps), (n_t, n_half, 3)), axis=0)
             for d in (d1, d2)]
    pos = np.concatenate(walks, axis=1)
    types = np.array([1] * n_half + [2] * n_half, np.int32)
    port = SEDCalculator(_traj(pos, np.zeros_like(pos), dt_ps=dt_ps, types=types), 1, 1, 1,
                         device='cpu')
    lags, msd = port.calculate_msd(basis_atom_types=[1, 2], n_lags=80)
    assert msd.shape == (2, 80)
    for row, d in zip(msd, (d1, d2)):
        slope = np.polyfit(lags[1:], row[1:].astype(np.float64), 1)[0]
        np.testing.assert_allclose(slope / 6.0, d, rtol=0.08)


def test_vacf_harmonic_oscillators():
    rng = np.random.default_rng(9)
    n_t, n_a, dt_ps, nu_thz, amp = 512, 200, 0.02, 4.0, 1.3
    t = np.arange(n_t) * dt_ps
    vel = amp * np.cos(2 * np.pi * nu_thz * t[:, None, None]
                       + rng.uniform(0, 2 * np.pi, (n_a, 3))[None])
    port = SEDCalculator(_traj(np.zeros_like(vel), vel, dt_ps=dt_ps), 1, 1, 1, device='cpu')
    lags, vacf = port.calculate_vacf(n_lags=64)
    v = vacf[0].astype(np.float64)
    np.testing.assert_allclose(v[0], 3 * amp ** 2 / 2, rtol=0.02)
    np.testing.assert_allclose(v, v[0] * np.cos(2 * np.pi * nu_thz * lags.astype(np.float64)),
                               atol=0.05 * v[0])


def test_defaults_to_the_card():
    """No device argument means CUDA: without a card the constructor raises
    and nothing runs on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SEDCalculator(random_case(0), 1, 1, 1)
