"""psa_tpu_torch's spectral ops against the JAX package and the float64 oracle.

The same seeded NumPy inputs go through both packages on the CPU.  On CPU
tensors the port's projection wrapper runs its plain PyTorch version; the
CUDA kernel itself is checked on the card by ``chip_smoke.py``.
"""
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psa_tpu.ops import spectral as jspec
from psa_tpu.ops.pallas_sed import sed_projection_pallas
from psa_tpu_torch import _build
from psa_tpu_torch.ops import sed_projection as tproj
from psa_tpu_torch.ops import spectral as tspec

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-6  # relative to max |oracle|, the parity bar


def make_problem(n_t, n_a, n_k, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_t, n_a, 3)).astype(np.float32)
    mean64 = rng.uniform(0, 50.0, size=(n_a, 3))
    hi, lo = jspec.split_f64(mean64)
    kv = rng.uniform(-3, 3, size=(n_k, 3)).astype(np.float32)
    return data, hi, lo, kv, mean64


def oracle(data, mean64, kv):
    phase = np.exp(1j * (kv.astype(np.float64) @ mean64.T))
    s = np.einsum('tac,ka->tkc', data.astype(np.float64), phase)
    return np.fft.fft(s, axis=0) / data.shape[0]


def rel_err(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def test_plain_projection_matches_pallas_interpret():
    """Plain projection vs the Pallas kernel in interpret mode, at the
    tests/test_pallas.py shapes and tolerances."""
    data, hi, lo, kv, _ = make_problem(8, 640, 64)
    n_t, n_a, _ = data.shape
    data2d = np.transpose(data, (0, 2, 1)).reshape(n_t * 3, n_a)
    want_re, want_im = sed_projection_pallas(
        jnp.asarray(data2d), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(kv),
        bm=8, bk=64, ba=128, interpret=True)
    re, im = tproj.sed_projection(t(data), t(hi), t(lo), t(kv))
    assert re.shape == (n_t, 3, 64) and im.shape == (n_t, 3, 64)
    np.testing.assert_allclose(re.reshape(n_t * 3, 64).numpy(), np.asarray(want_re),
                               rtol=2e-5, atol=2e-4)
    np.testing.assert_allclose(im.reshape(n_t * 3, 64).numpy(), np.asarray(want_im),
                               rtol=2e-5, atol=2e-4)


def test_angles_match_jax_double_single():
    """float64-folded angles agree with the JAX double-single angles mod 2π."""
    _, hi, lo, kv, mean64 = make_problem(2, 300, 50, seed=4)
    got = tproj.accurate_angles(t(hi), t(lo), t(kv)).numpy().astype(np.float64)
    want = np.asarray(jspec._accurate_angles(jnp.asarray(hi), jnp.asarray(lo),
                                             jnp.asarray(kv)), dtype=np.float64)
    exact = mean64 @ kv.astype(np.float64).T
    d_got = np.angle(np.exp(1j * (got - exact)))
    d_want = np.angle(np.exp(1j * (want - exact)))
    assert np.max(np.abs(d_got)) < 1e-6
    assert np.max(np.abs(d_want)) < 1e-6
    assert np.all(np.abs(got) <= np.pi + 1e-6)


@pytest.mark.parametrize('shape', [(8, 640, 64), (9, 1000, 77), (5, 37, 3),
                                   (16, 129, 65), (1, 1, 1)])
def test_sed_spectrum_matches_jax_and_oracle(shape):
    """Port vs JAX sed_spectrum vs the f64 oracle, tile-aligned and ragged."""
    data, hi, lo, kv, mean64 = make_problem(*shape, seed=sum(shape))
    got = tspec.sed_spectrum(t(data), t(hi), t(lo), t(kv))
    assert got.dtype == torch.complex64
    assert tuple(got.shape) == (shape[0], shape[2], 3)
    got = got.numpy()
    re, im = jspec.sed_spectrum(jnp.asarray(data), jnp.asarray(hi),
                                jnp.asarray(lo), jnp.asarray(kv))
    want_jax = np.asarray(re) + 1j * np.asarray(im)
    want = oracle(data, mean64, kv)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < RTOL
    assert np.max(np.abs(got - want_jax)) / scale < RTOL


def test_sed_intensity_matches_jax():
    data, hi, lo, kv, mean64 = make_problem(12, 200, 40, seed=2)
    got = tspec._power(tspec.sed_spectrum(t(data), t(hi), t(lo), t(kv))).numpy()
    want = np.asarray(jspec.sed_intensity(jnp.asarray(data), jnp.asarray(hi),
                                          jnp.asarray(lo), jnp.asarray(kv)))
    want64 = np.sum(np.abs(oracle(data, mean64, kv)) ** 2, axis=-1)
    assert got.shape == (12, 40) and got.dtype == np.float32
    assert rel_err(got, want64) < 2 * RTOL
    assert rel_err(got, want) < 2 * RTOL


def test_displacement_data_matches_jax():
    rng = np.random.default_rng(5)
    mean64 = rng.uniform(0, 80.0, size=(30, 3))
    pos = (mean64[None] + rng.normal(0, 0.05, size=(7, 30, 3))).astype(np.float32)
    hi, lo = tspec.split_f64(mean64)
    got = tspec.displacement_data(t(pos), t(hi), t(lo)).numpy()
    want = np.asarray(jspec.displacement_data(jnp.asarray(pos), jnp.asarray(hi),
                                              jnp.asarray(lo)))
    np.testing.assert_array_equal(got, want)
    exact = pos.astype(np.float64) - mean64[None]
    assert np.max(np.abs(got - exact)) < 1e-6


@pytest.mark.parametrize('opt', ['A', 'B', 'C'])
def test_chiral_phase_matches_jax(opt):
    rng = np.random.default_rng(7)
    z1 = (rng.normal(size=(12, 9)) + 1j * rng.normal(size=(12, 9))).astype(np.complex64)
    z2 = (rng.normal(size=(12, 9)) + 1j * rng.normal(size=(12, 9))).astype(np.complex64)
    z1[0, 0] = 0  # magnitude guard
    got = tspec.chiral_phase(t(z1), t(z2), angle_range_opt=opt).numpy()
    want = np.asarray(jspec.chiral_phase(
        jnp.asarray(z1.real), jnp.asarray(z1.imag), jnp.asarray(z2.real),
        jnp.asarray(z2.imag), angle_range_opt=opt))
    assert got.dtype == np.float32
    if opt == 'A':   # arccos is ill-conditioned near ±1: compare cosines
        np.testing.assert_allclose(np.cos(got), np.cos(want), atol=2e-6)
    elif opt == 'B':
        np.testing.assert_allclose(np.sin(got), np.sin(want), atol=2e-6)
    else:
        np.testing.assert_allclose(got, want, atol=2e-6)


def test_chiral_phase_bad_option():
    z = torch.ones(3, dtype=torch.complex64)
    with pytest.raises(ValueError, match="angle_range_opt"):
        tspec.chiral_phase(z, z, angle_range_opt='D')


def test_synthesize_mode_motion_matches_jax():
    rng = np.random.default_rng(9)
    amp = (rng.normal(size=3) + 1j * rng.normal(size=3)).astype(np.complex64)
    proj = rng.uniform(0, 30, size=25).astype(np.float32)
    frames = np.linspace(0, 2 * np.pi, 10, endpoint=False).astype(np.float32)
    got = tspec.synthesize_mode_motion(t(amp), t(proj), 0.7, t(frames)).numpy()
    want = np.asarray(jspec.synthesize_mode_motion(
        jnp.asarray(amp.real), jnp.asarray(amp.imag), jnp.asarray(proj),
        jnp.float32(0.7), jnp.asarray(frames)))
    assert got.shape == (10, 25, 3)
    np.testing.assert_allclose(got, want, atol=5e-6)


def test_host_helpers_identical():
    x = np.random.default_rng(1).uniform(-1e3, 1e3, size=(11, 3))
    for a, b in zip(tspec.split_f64(x), jspec.split_f64(x)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tspec.fftfreq_thz(17, 0.01), jspec.fftfreq_thz(17, 0.01))


@pytest.mark.parametrize('precision,exc', [('balanced', None), ('fast', None),
                                           ('bogus', ValueError)])
def test_precision_tiers(precision, exc):
    """'balanced' and 'fast' run their plain versions on the CPU within their
    bars of the float64 oracle (5e-5, 5e-3 of max); an unknown tier raises."""
    data, hi, lo, kv, mean64 = make_problem(2, 4, 3)
    if exc is None:
        got = tspec.sed_spectrum(t(data), t(hi), t(lo), t(kv), precision=precision).numpy()
        bar = {'balanced': 5e-5, 'fast': 5e-3}[precision]
        assert rel_err(got, oracle(data, mean64, kv)) < bar
        return
    with pytest.raises(exc):
        tspec.sed_spectrum(t(data), t(hi), t(lo), t(kv), precision=precision)


@pytest.mark.parametrize('case', ['dtype', 'data_shape', 'mp_shape', 'k_shape', 'empty'])
def test_wrapper_rejects_bad_inputs(case):
    data, hi, lo, kv, _ = make_problem(3, 5, 4)
    args = [t(data), t(hi), t(lo), t(kv)]
    exc = ValueError
    if case == 'dtype':
        args[0] = args[0].double()
        exc = TypeError
    elif case == 'data_shape':
        args[0] = args[0][..., :2]
    elif case == 'mp_shape':
        args[1] = args[1][:4]
    elif case == 'k_shape':
        args[3] = args[3][:, :2]
    else:
        args[3] = args[3][:0]
    with pytest.raises(exc):
        tproj.sed_projection(*args)


def test_cpu_path_never_counts_a_launch():
    data, hi, lo, kv, _ = make_problem(4, 20, 6)
    before = tproj.kernel_launches()
    tspec.sed_spectrum(t(data), t(hi), t(lo), t(kv))
    assert tproj.kernel_launches() == before == 0


def test_build_module_imports_without_nvcc():
    """The build module imports anywhere; it needs nvcc only to build."""
    assert [p.name for p in _build.sources()] == ['sed_projection.cu', 'sed_projection_tiers.cu']
    assert 'arch=compute_90a,code=sm_90a' in _build.NVCC_FLAGS
    assert '--use_fast_math' not in _build.NVCC_FLAGS


def test_import_leaves_jax_out():
    code = ("import sys, psa_tpu_torch, psa_tpu_torch.core.convert, psa_tpu_torch.models, "
            "psa_tpu_torch.ops.dispersion, psa_tpu_torch.ops.transport, "
            "psa_tpu_torch.ops.instantaneous, "
            "psa_tpu_torch.io.loader, psa_tpu_torch.io.lammps, psa_tpu_torch.io.h5md, "
            "psa_tpu_torch.io.shard_cache, psa_tpu_torch.io.native, psa_tpu_torch.io.writer, "
            "psa_tpu_torch.core.streaming, psa_tpu_torch.utils.transfer; "
            "bad = [m for m in ('jax', 'psa_tpu', 'matplotlib', 'yaml', 'h5py') if m in sys.modules]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, '-c', code], cwd=REPO, check=True, timeout=120)
