"""psa_tpu_torch's on-device grid reductions against the JAX package and the
float64 oracle: browse planes, Welch segments, the L/T split and peak
extraction, as ops and through the calculator's direct engine.

The same seeded inputs go through both packages on the CPU; the port's
calculators come from JAX ones through ``from_reference_calculator``.  The
JAX side runs one k-chunk (one compiled shape, k padded to 64) and the port
runs ragged chunks, so chunking is checked on the way.

Tolerances:

* planes (intensity, I_L, I_T, Welch): within 1e-6 of the plane's max
  against JAX and the float64 oracle;
* peaks: bins exact, heights within 1e-6 relative, widths within rtol 1e-4
  and atol 1e-5 (on identical planes);
* chiral phases: within 1e-5 rad where the intensity is ≥ 1e-6 of its max;
* float16 readback: the per-pixel bounds of tests/test_readback.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.core.calculator import peaks_np as jax_peaks_np
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu.ops import spectral as jspec
from psa_tpu_torch.core import calculator as tcalc
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.ops import spectral as tspec
from psa_tpu_torch.ops.sed_projection import sed_projection

from conftest import reference_sed_oracle

torch.set_num_threads(1)

PLANE_TOL = 1e-6           # of the plane's max
PHASE_TOL = 1e-5           # rad, where intensity >= PHASE_FLOOR * max
PHASE_FLOOR = 1e-6
REL_EPS, REL_FLOOR = 2.0 ** -9, 4e-9   # tests/test_readback.py
N_T, DT = 16, 0.02


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def of_max(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def fold_c(delta):
    """Option-'C' fold of a phase difference into [−π/2, π/2]."""
    delta = (delta + np.pi) % (2 * np.pi) - np.pi
    delta = np.where(delta > np.pi / 2, np.pi - delta, delta)
    return np.where(delta < -np.pi / 2, -np.pi - delta, delta)


def assert_phase(got, want, inten):
    bright = inten >= PHASE_FLOOR * inten.max()
    assert np.max(np.abs(got - want)[bright]) < PHASE_TOL


def assert_display_faithful(f16, exact):
    floor = REL_FLOOR * exact.max()
    bright = exact >= floor
    assert np.max(np.abs(f16[bright] - exact[bright]) / exact[bright]) <= REL_EPS
    if (~bright).any():
        assert np.abs(f16[~bright] - exact[~bright]).max() <= floor


@pytest.fixture(scope='module')
def crystal():
    return make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2, n_frames=N_T,
                                          dt_ps=DT, seed=11)


@pytest.fixture(scope='module')
def calcs(crystal):
    ref = JaxCalculator(crystal, nx=3, ny=2, nz=2)
    return ref, from_reference_calculator(ref, device='cpu')


@pytest.fixture(scope='module')
def kv(calcs):
    return calcs[0].get_k_grid('xy', (-1, 1), (-1, 1), 5, 4)[1]     # 20 k


@pytest.fixture(scope='module')
def oracle(crystal, kv):
    """(f64 spectrum over ω ≥ 0, its intensity)."""
    phi = reference_sed_oracle(crystal, kv)[np.fft.fftfreq(N_T, DT) >= 0]
    return phi, np.sum(np.abs(phi) ** 2, axis=-1)


def welch_oracle(traj, kv, segments, window, group_idx=None):
    """float64 segment spectra (S, seg, K, 3) of the reference formula."""
    group_idx = np.arange(traj.n_atoms) if group_idx is None else group_idx
    mean = traj.positions.astype(np.float64).mean(axis=0)[group_idx]
    s = np.einsum('tac,ka->tkc', traj.velocities[:, group_idx].astype(np.float64),
                  np.exp(1j * (kv.astype(np.float64) @ mean.T)))
    seg = traj.n_frames // segments
    s = s[:seg * segments].reshape(segments, seg, *s.shape[1:])
    if window == 'hann':
        s = s * (1.0 - np.cos(2 * np.pi * np.arange(seg) / seg))[None, :, None, None]
    return np.fft.fft(s, axis=1) / seg


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------

def make_problem(n_t=16, n_a=40, n_k=20, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_t, n_a, 3)).astype(np.float32)
    mean64 = rng.uniform(0, 30.0, size=(n_a, 3))
    hi, lo = jspec.split_f64(mean64)
    return data, hi, lo, rng.uniform(-2, 2, size=(n_k, 3)).astype(np.float32), mean64


def problem_oracle(data, mean64, kv):
    s = np.einsum('tac,ka->tkc', data.astype(np.float64),
                  np.exp(1j * (kv.astype(np.float64) @ mean64.T)))
    return np.fft.fft(s, axis=0) / data.shape[0]


@pytest.mark.parametrize('comp_pair,opt', [(None, 'C'), ((0, 1), 'C'), ((1, 2), 'A'),
                                           ((0, 2), 'B')])
def test_sed_grid_browse_matches_jax_and_oracle(comp_pair, opt):
    data, hi, lo, kv, mean64 = make_problem()
    keep = np.arange(0, 9)
    want_i, want_p = jspec.sed_grid_browse(jnp.asarray(data), jnp.asarray(hi), jnp.asarray(lo),
                                           jnp.asarray(kv), jnp.asarray(keep.astype(np.int32)),
                                           comp_pair=comp_pair, angle_range_opt=opt)
    got_i, got_p = tspec.browse_reduce(tspec.sed_spectrum(t(data), t(hi), t(lo), t(kv)),
                                       t(keep), comp_pair=comp_pair, angle_range_opt=opt)
    phi = problem_oracle(data, mean64, kv)[keep]
    inten = np.sum(np.abs(phi) ** 2, axis=-1)
    assert got_i.dtype == torch.float32 and tuple(got_i.shape) == (9, 20)
    assert of_max(got_i.numpy(), inten) < PLANE_TOL
    assert of_max(got_i.numpy(), np.asarray(want_i)) < PLANE_TOL
    if comp_pair is None:
        assert got_p is None and want_p is None
        return
    # A and B are compared through cos/sin: arccos/arcsin are ill-conditioned at ±1
    fold = {'A': np.cos, 'B': np.sin, 'C': lambda x: x}[opt]
    assert_phase(fold(got_p.numpy()), fold(np.asarray(want_p)), inten)
    if opt == 'C':
        c1, c2 = comp_pair
        assert_phase(got_p.numpy(), fold_c(np.angle(phi[..., c1]) - np.angle(phi[..., c2])),
                     inten)


def test_lt_reduce_matches_jax_and_oracle():
    data, hi, lo, kv, mean64 = make_problem(seed=1)
    kv[3] = 0.0                                                      # a Γ column
    ku = jspec.unit_k_vectors(kv)
    np.testing.assert_array_equal(tspec.unit_k_vectors(kv), ku)
    keep = np.arange(9)
    want_l, want_t = jspec.sed_lt(jnp.asarray(data), jnp.asarray(hi), jnp.asarray(lo),
                                  jnp.asarray(kv), jnp.asarray(ku),
                                  jnp.asarray(keep.astype(np.int32)))
    got_l, got_t = tspec.lt_reduce(tspec.sed_spectrum(t(data), t(hi), t(lo), t(kv)), t(ku),
                                   t(keep))
    phi = problem_oracle(data, mean64, kv)[keep]
    orc_l = np.abs(np.einsum('fkc,kc->fk', phi, ku.astype(np.float64))) ** 2
    orc_total = np.sum(np.abs(phi) ** 2, axis=-1)
    scale = orc_total.max()
    for got, want, orc in ((got_l, want_l, orc_l), (got_t, want_t, orc_total - orc_l)):
        assert np.max(np.abs(got.numpy() - orc)) / scale < PLANE_TOL
        assert np.max(np.abs(got.numpy() - np.asarray(want))) / scale < PLANE_TOL
    assert got_l[:, 3].max() == 0 and got_t[:, 3].max() > 0


@pytest.mark.parametrize('segments,window,comp_pair', [(1, 'rect', None), (3, 'hann', None),
                                                       (2, 'rect', (0, 1)), (3, 'hann', (1, 2))])
def test_welch_browse_matches_jax_and_oracle(segments, window, comp_pair):
    data, hi, lo, kv, mean64 = make_problem(n_t=17, seed=2)       # ragged: 17 % 3 dropped
    seg = 17 // segments
    keep = np.flatnonzero(np.fft.fftfreq(seg) >= 0)
    want_i, want_p = jspec.sed_grid_browse_welch(
        jnp.asarray(data), jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(kv),
        jnp.asarray(keep.astype(np.int32)), segments, window=window, comp_pair=comp_pair)
    re, im = sed_projection(t(data), t(hi), t(lo), t(kv))
    got_i, got_p = tspec.welch_browse_reduce(re, im, t(keep), segments, window,
                                             comp_pair=comp_pair)
    s = np.einsum('tac,ka->tkc', data[:seg * segments].astype(np.float64),
                  np.exp(1j * (kv.astype(np.float64) @ mean64.T)))
    s = s.reshape(segments, seg, 20, 3)
    if window == 'hann':
        s = s * (1.0 - np.cos(2 * np.pi * np.arange(seg) / seg))[None, :, None, None]
    spec = (np.fft.fft(s, axis=1) / seg)[:, keep]
    inten = np.mean(np.sum(np.abs(spec) ** 2, axis=-1), axis=0)
    assert of_max(got_i.numpy(), inten) < PLANE_TOL
    assert of_max(got_i.numpy(), np.asarray(want_i)) < PLANE_TOL
    if comp_pair is not None:
        c1, c2 = comp_pair
        cross = np.mean(spec[..., c1] * np.conj(spec[..., c2]), axis=0)
        assert_phase(got_p.numpy(), fold_c(np.angle(cross)), inten)
        assert_phase(got_p.numpy(), np.asarray(want_p), inten)
    full = tspec.welch_intensity_reduce(re, im, segments, window)
    assert tuple(full.shape) == (seg, 20)
    np.testing.assert_allclose(full.numpy()[keep], got_i.numpy(), rtol=1e-6)


def test_welch_window_matches_jax():
    """The port forms the taper in float64 (rounded once); JAX in float32."""
    got = tspec.welch_window(12, 'hann').numpy()
    np.testing.assert_allclose(got, 1.0 - np.cos(2 * np.pi * np.arange(12) / 12), atol=1.2e-7)
    np.testing.assert_allclose(got, np.asarray(jspec.welch_window(12, 'hann')), atol=1e-6)
    assert tspec.welch_window(12, 'rect') is None
    with pytest.raises(ValueError, match="window"):
        tspec.welch_window(12, 'hamming')


def test_compress_plane_matches_jax():
    rng = np.random.default_rng(5)
    plane = (rng.exponential(size=(30, 17)) * 1e10).astype(np.float32)
    plane[0, :3] = [0.0, 1e-3, 3e-9 * plane.max()]                  # dim pixels
    phase = rng.uniform(-np.pi / 2, np.pi / 2, size=(30, 17)).astype(np.float32)
    j16, jscale, jp16 = jspec.compress_browse(jnp.asarray(plane), jnp.asarray(phase),
                                              with_phase=True)
    p16, pscale, pp16 = tspec.compress_browse(t(plane), t(phase))
    np.testing.assert_array_equal(p16.numpy(), np.asarray(j16))
    np.testing.assert_array_equal(pp16.numpy(), np.asarray(jp16))
    assert float(pscale) == float(jscale)
    back = tspec.decompress_plane(p16.numpy(), pscale.numpy())
    np.testing.assert_array_equal(back, jspec.decompress_plane(j16, jscale))
    assert_display_faithful(back, plane)
    zero16, zscale = tspec.compress_plane(torch.zeros(3, 4))
    assert float(zscale) == 1.0 and not zero16.any()


@pytest.mark.parametrize('width_method,with_phase', [('rms', False), ('lorentzian', False),
                                                     ('rms', True), ('lorentzian', True)])
def test_peak_reduce_matches_jax_and_mirror(width_method, with_phase):
    """Identical planes into both peak_reduce's and the NumPy mirror: bins
    exact, heights 1e-6 relative, widths rtol 1e-4 / atol 1e-5.  The JAX
    side takes the chunks as one stack, the port one chunk at a time."""
    rng = np.random.default_rng(7)
    n_chunks, n_f, block = 3, 40, 24
    planes = rng.uniform(0, 1, size=(n_chunks, n_f, block)).astype(np.float32)
    planes[1] *= 1e10                                     # bright: must not overflow
    freqs = np.linspace(0, 20, n_f).astype(np.float32)
    phases = rng.uniform(-1.5, 1.5, size=planes.shape).astype(np.float32)
    kw = dict(n_peaks=3, exclusion_bins=4, width_method=width_method)
    want = [np.asarray(x) for x in jspec.peak_reduce(
        jnp.asarray(planes), jnp.asarray(freqs),
        phase_stack=jnp.asarray(phases) if with_phase else None, **kw)]
    assert len(want) == (4 if with_phase else 3)
    for c in range(n_chunks):
        got = [x.numpy() for x in tspec.peak_reduce(
            t(planes[c]), t(freqs), phase=t(phases[c]) if with_phase else None, **kw)]
        assert len(got) == len(want)
        pf_n, ph_n, pw_n = tcalc.peaks_np(planes[c], freqs, n_peaks=3, exclusion_bins=4,
                                          width_method=width_method)
        for mirror in ((pf_n, ph_n, pw_n), tuple(w[c] for w in want[:3])):
            np.testing.assert_array_equal(got[0], mirror[0])
            np.testing.assert_allclose(got[1], mirror[1], rtol=1e-6)
            np.testing.assert_allclose(got[2], mirror[2], rtol=1e-4, atol=1e-5)
        if with_phase:
            np.testing.assert_array_equal(got[3], want[3][c])
            rows = np.searchsorted(freqs, got[0])
            np.testing.assert_array_equal(got[3], phases[c][rows, np.arange(block)])


def test_peak_reduce_planted_ties_take_first_index():
    """Equal maxima: torch.argmax, jnp.argmax and np.argmax all take the
    first row, so peak bins stay exact across the three."""
    n_f, block = 30, 6
    planes = np.full((n_f, block), 0.25, dtype=np.float32)
    planes[[3, 17], 0] = 2.0                      # tie, far apart
    planes[[8, 9], 1] = 2.0                       # adjacent tie
    planes[[5, 25], 2] = 2.0
    planes[[12, 20], 2] = 1.5                     # tie among the second peaks
    planes[:, 3] = 1.0                            # flat column: every row ties
    planes[[0, n_f - 1], 4] = 3.0                 # tie at both edges
    planes[:, 5] = 0.0
    planes[[14, 15, 16], 5] = 1.0                 # all zero once the first peak is masked
    freqs = np.linspace(0.5, 15.0, n_f).astype(np.float32)
    got = tspec.peak_reduce(t(planes), t(freqs), n_peaks=3, exclusion_bins=2)
    want = jspec.peak_reduce(jnp.asarray(planes[None]), jnp.asarray(freqs), n_peaks=3,
                             exclusion_bins=2)
    mirror = tcalc.peaks_np(planes, freqs, n_peaks=3, exclusion_bins=2)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0])[0])
    np.testing.assert_array_equal(got[0].numpy(), mirror[0])
    rows = np.searchsorted(freqs, got[0].numpy())
    np.testing.assert_array_equal(rows[0], [3, 8, 5, 0, 0, 14])
    np.testing.assert_array_equal(rows[1], [17, 0, 25, 3, 29, 0])


def test_peaks_np_carried_unchanged():
    rng = np.random.default_rng(3)
    planes = rng.uniform(0, 1, size=(25, 9))
    freqs = np.linspace(0, 5, 25).astype(np.float32)
    for method in ('rms', 'lorentzian'):
        for a, b in zip(tcalc.peaks_np(planes, freqs, 2, 3, method),
                        jax_peaks_np(planes, freqs, 2, 3, method)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="width_method"):
        tspec.peak_reduce(t(planes), t(freqs), width_method='gauss')


# ---------------------------------------------------------------------------
# calculator, direct engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['coherent', 'max_freq', 'chiral_z', 'chiral_x_A',
                                  'incoherent', 'index_groups'])
def test_kgrid_browse_matches_jax_and_oracle(calcs, crystal, kv, oracle, case):
    ref, port = calcs
    kw = {'max_freq': dict(max_freq=10.0), 'chiral_z': dict(chiral=True),
          'chiral_x_A': dict(chiral=True, chiral_axis='x', angle_range_opt='A'),
          'incoherent': dict(basis_atom_types=[1, 2], summation_mode='incoherent'),
          'index_groups': dict(basis_atom_indices=[[0, 1, 2, 5], [5, 9, 11]],
                               summation_mode='incoherent')}.get(case, {})
    f_p, i_p, p_p = port.calculate_kgrid_browse(kv, k_chunk_size=8, **kw)   # chunks 8, 8, 4
    f_j, i_j, p_j = ref.calculate_kgrid_browse(kv, k_chunk_size=64, **kw)
    np.testing.assert_array_equal(f_p, f_j)
    assert i_p.dtype == np.float32 and i_p.shape == (len(f_j), len(kv))
    phi, inten = oracle
    if case in ('incoherent', 'index_groups'):
        groups = ([np.flatnonzero(crystal.types == typ) for typ in (1, 2)]
                  if case == 'incoherent' else [np.array(g) for g in kw['basis_atom_indices']])
        pos = np.fft.fftfreq(N_T, DT) >= 0
        inten = sum(np.sum(np.abs(reference_sed_oracle(crystal, kv, group_idx=g)[pos]) ** 2,
                           axis=-1) for g in groups)
    elif case == 'max_freq':
        phi, inten = phi[:len(f_p)], inten[:len(f_p)]
        assert f_p.max() <= 10.0 and len(f_p) < N_T // 2
    assert of_max(i_p, inten) < PLANE_TOL
    assert of_max(i_p, i_j) < PLANE_TOL
    if 'chiral' not in case:
        assert p_p is None and p_j is None
        return
    c1, c2 = tspec.CHIRAL_AXIS_COMPONENTS[kw.get('chiral_axis', 'z')]
    if case == 'chiral_z':
        assert_phase(p_p, fold_c(np.angle(phi[..., c1]) - np.angle(phi[..., c2])), inten)
        assert_phase(p_p, p_j, inten)
    else:
        assert_phase(np.cos(p_p), np.cos(p_j), inten)


@pytest.mark.parametrize('chiral', [False, True])
def test_kgrid_browse_welch_matches_jax_and_oracle(calcs, crystal, kv, chiral):
    ref, port = calcs
    f_p, i_p, p_p = port.calculate_kgrid_browse(kv, k_chunk_size=7, welch_segments=3,
                                                chiral=chiral)
    f_j, i_j, p_j = ref.calculate_kgrid_browse(kv, k_chunk_size=64, welch_segments=3,
                                               chiral=chiral)
    np.testing.assert_array_equal(f_p, f_j)
    spec = welch_oracle(crystal, kv, 3, 'hann')[:, np.fft.fftfreq(N_T // 3, DT) >= 0]
    inten = np.mean(np.sum(np.abs(spec) ** 2, axis=-1), axis=0)
    assert of_max(i_p, inten) < PLANE_TOL
    assert of_max(i_p, i_j) < PLANE_TOL
    if chiral:
        cross = np.mean(spec[..., 0] * np.conj(spec[..., 1]), axis=0)
        assert_phase(p_p, fold_c(np.angle(cross)), inten)
        assert_phase(p_p, p_j, inten)


@pytest.mark.parametrize('kw', [dict(), dict(chiral=True),
                                dict(basis_atom_types=[1, 2], summation_mode='incoherent'),
                                dict(welch_segments=2)])
def test_kgrid_browse_float16_readback(calcs, kv, kw):
    _, port = calcs
    _, exact, p32 = port.calculate_kgrid_browse(kv, k_chunk_size=6, **kw)
    _, f16, p16 = port.calculate_kgrid_browse(kv, k_chunk_size=6, readback_dtype='float16',
                                              **kw)
    assert f16.dtype == np.float32 and f16.shape == exact.shape
    if 'basis_atom_types' in kw:          # per-group planes rounded, then summed
        assert np.abs(f16 - exact).max() <= 2 * 2.0 ** -10 * exact.max()
    else:
        assert_display_faithful(f16, exact)
    if p32 is not None:
        assert p16.dtype == np.float32 and np.abs(p16 - p32).max() <= 2e-3


@pytest.mark.parametrize('kw', [dict(), dict(max_freq=12.0),
                                dict(basis_atom_types=[1, 2], summation_mode='incoherent')])
def test_lt_matches_jax_browse_and_oracle(calcs, crystal, kv, oracle, kw):
    ref, port = calcs
    kv = kv.copy()
    kv[7] = 0.0                                                    # Γ column
    f_p, l_p, t_p = port.calculate_lt(kv, k_chunk_size=6, **kw)
    f_j, l_j, t_j = ref.calculate_lt(kv, k_chunk_size=64, **kw)
    _, inten, _ = port.calculate_kgrid_browse(kv, k_chunk_size=9, **kw)
    np.testing.assert_array_equal(f_p, f_j)
    scale = inten.max()
    assert np.max(np.abs(l_p + t_p - inten)) / scale < PLANE_TOL
    assert np.max(np.abs(l_p - l_j)) / scale < PLANE_TOL
    assert np.max(np.abs(t_p - t_j)) / scale < PLANE_TOL
    assert l_p[:, 7].max() == 0.0 and t_p[:, 7].max() > 0.0
    if not kw:
        pos = np.fft.fftfreq(N_T, DT) >= 0
        phi = reference_sed_oracle(crystal, kv)[pos]
        orc_l = np.abs(np.einsum('fkc,kc->fk', phi,
                                 tspec.unit_k_vectors(kv).astype(np.float64))) ** 2
        assert np.max(np.abs(l_p - orc_l)) / scale < PLANE_TOL


@pytest.mark.parametrize('segments,window,kw', [(1, 'rect', {}), (2, 'hann', {}),
                                                (5, 'hann', {}),
                                                (2, 'hann', dict(basis_atom_types=[1, 2],
                                                                 summation_mode='incoherent'))])
def test_welch_matches_jax_and_oracle(calcs, crystal, kv, segments, window, kw):
    ref, port = calcs
    mags = np.linalg.norm(kv, axis=1)
    got = port.calculate_welch(mags, kv, segments, window=window, k_chunk_size=7, **kw)
    want = ref.calculate_welch(mags, kv, segments, window=window, k_chunk_size=64, **kw)
    groups = ([np.flatnonzero(crystal.types == typ) for typ in (1, 2)] if kw else [None])
    orc = sum(np.mean(np.sum(np.abs(welch_oracle(crystal, kv, segments, window, g)) ** 2,
                             axis=-1), axis=0) for g in groups)
    assert not got.is_complex and got.sed.shape == (N_T // segments, len(kv))
    np.testing.assert_array_equal(got.freqs, want.freqs)
    assert got.trajectory_metadata == {'welch_segments': segments, 'window': window}
    assert of_max(got.sed, orc) < PLANE_TOL
    assert of_max(got.sed, want.sed) < PLANE_TOL


@pytest.mark.parametrize('kw', [dict(), dict(width_method='lorentzian', exclusion_bins=2),
                                dict(chiral=True),
                                dict(basis_atom_types=[1, 2], summation_mode='incoherent'),
                                dict(welch_segments=2, chiral=True, max_freq=15.0)])
def test_kgrid_peaks_are_peaks_of_the_planes(calcs, kv, kw):
    """Peaks on the device equal the mirror's peaks of the port's own browse
    planes, made in the same k-chunks (bins exact); the planes match JAX and
    the oracle in the tests above."""
    _, port = calcs
    peak_kw = {k: kw[k] for k in ('width_method', 'exclusion_bins') if k in kw}
    browse_kw = {k: v for k, v in kw.items() if k not in peak_kw}
    got = port.calculate_kgrid_peaks(kv, n_peaks=3, k_chunk_size=8, **kw)
    freqs, inten, phase = port.calculate_kgrid_browse(kv, k_chunk_size=8, **browse_kw)
    want = tcalc.peaks_np(inten, freqs, n_peaks=3, **peak_kw)
    assert len(got) == (4 if kw.get('chiral') else 3)
    assert all(g.shape == (3, len(kv)) and g.dtype == np.float32 for g in got)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)
    if kw.get('chiral'):
        rows = np.searchsorted(freqs, got[0])
        np.testing.assert_array_equal(got[3], phase[rows, np.arange(len(kv))])


def test_kgrid_peaks_match_jax_on_a_lattice():
    """Peak bins exact against the JAX package where the peaks are physical
    (a square lattice on its allowed modes), with JAX's own tolerances."""
    from psa_tpu.models import make_square_lattice_trajectory, square_lattice_dispersion
    traj = make_square_lattice_trajectory(n_cells=8, n_frames=128, dt_ps=0.01, a=2.5,
                                          nu_max_thz=10.0, seed=4)
    ref = JaxCalculator(traj, nx=8, ny=8, nz=1)
    port = from_reference_calculator(ref, device='cpu')
    _, kv, _ = ref.get_k_grid('xy', (0.0, np.pi / 2.5), (0.0, np.pi / 2.5), 5, 5)
    analytic = square_lattice_dispersion(kv[:, 0], kv[:, 1], a=2.5, nu_max_thz=10.0)
    df = 1.0 / (traj.n_frames * traj.dt_ps)
    ok = analytic > df                  # Γ holds no mode: its peak is rounding noise
    for kw in (dict(), dict(width_method='lorentzian')):
        got = port.calculate_kgrid_peaks(kv, n_peaks=1, k_chunk_size=7, **kw)
        want = ref.calculate_kgrid_peaks(kv, n_peaks=1, k_chunk_size=64, **kw)
        np.testing.assert_array_equal(got[0][:, ok], want[0][:, ok])
        np.testing.assert_allclose(got[1][:, ok], want[1][:, ok], rtol=1e-6)
        np.testing.assert_allclose(got[2][:, ok], want[2][:, ok], rtol=1e-4, atol=1e-5)
    assert np.all(np.abs(got[0][0][ok] - analytic[ok]) <= df + 1e-6)


def test_kgrid_peaks_read_back_once(calcs, kv, monkeypatch):
    """The planes stay on the device: a sweep of four k-chunks copies one
    result to the host, at the end."""
    _, port = calcs
    copies = []
    real = tcalc._to_host
    monkeypatch.setattr(tcalc, '_to_host', lambda x: copies.append(x.shape) or real(x))
    out = port.calculate_kgrid_peaks(kv, n_peaks=2, k_chunk_size=6, chiral=True)
    assert copies == [(4, 2, len(kv))] and len(out) == 4


def test_engine_auto_is_direct(calcs, kv):
    _, port = calcs
    a = port.calculate_kgrid_peaks(kv, n_peaks=2, engine='auto', k_grid_shape=(5, 4))
    d = port.calculate_kgrid_peaks(kv, n_peaks=2, engine='direct')
    for x, y in zip(a, d):
        np.testing.assert_array_equal(x, y)
    with pytest.raises(ValueError, match="engine"):
        port.calculate_kgrid_peaks(kv, engine='nufft')
    with pytest.raises(ValueError, match="engine"):
        port.calculate_kgrid_browse(kv, engine='nufft')


def test_validation(calcs, kv):
    _, port = calcs
    with pytest.raises(ValueError, match="coherent"):
        port.calculate_kgrid_browse(kv, basis_atom_types=[1, 2], summation_mode='incoherent',
                                    chiral=True)
    with pytest.raises(ValueError, match="coherent"):
        port.calculate_kgrid_peaks(kv, basis_atom_types=[1, 2], summation_mode='incoherent',
                                   chiral=True)
    with pytest.raises(ValueError, match="readback_dtype"):
        port.calculate_kgrid_browse(kv, readback_dtype='bf16')
    with pytest.raises(ValueError, match="welch_segments"):
        port.calculate_kgrid_browse(kv, welch_segments=0)
    with pytest.raises(ValueError, match="at least 2"):
        port.calculate_kgrid_peaks(kv, welch_segments=N_T)
    with pytest.raises(ValueError, match="n_peaks"):
        port.calculate_kgrid_peaks(kv, n_peaks=0)
    with pytest.raises(ValueError, match="max_freq"):
        port.calculate_kgrid_peaks(kv, max_freq=-1.0)
    with pytest.raises(ValueError, match="summation_mode"):
        port.calculate_lt(kv, summation_mode='bogus')
    with pytest.raises(ValueError, match="window"):
        port.calculate_welch(np.zeros(len(kv)), kv, 2, window='hamming')
    empty = port.calculate_kgrid_peaks(np.zeros((0, 3), np.float32), n_peaks=2, chiral=True)
    assert len(empty) == 4 and all(e.shape == (2, 0) for e in empty)


@pytest.mark.parametrize('surface', ['browse', 'lt', 'peaks', 'welch'])
def test_zero_atom_trajectory_gives_zero_planes(surface):
    """A 0-atom trajectory resolves to no spectrum group: the sweeps return
    zero planes of the usual shapes (Welch: an empty SED) and launch nothing."""
    from psa_tpu_torch import SEDCalculator, Trajectory
    from psa_tpu_torch.core.trajectory import make_box_arrays
    box = np.diag([10.0, 10.0, 10.0]).astype(np.float32)
    none = np.zeros((N_T, 0, 3), np.float32)
    traj = Trajectory(none, none, np.zeros(0, np.int32), np.arange(N_T, dtype=np.float32),
                      box, *make_box_arrays(box), dt_ps=DT)
    calc = SEDCalculator(traj, nx=1, ny=1, nz=1, device='cpu')
    kv = np.random.default_rng(0).uniform(-1, 1, size=(5, 3)).astype(np.float32)
    n_keep = N_T // 2
    if surface == 'welch':
        assert calc.calculate_welch(np.zeros(5), kv, 2).sed.shape == (0, 5)
        return
    out = {'browse': lambda: calc.calculate_kgrid_browse(kv, chiral=True)[1:],
           'lt': lambda: calc.calculate_lt(kv)[1:],
           'peaks': lambda: calc.calculate_kgrid_peaks(kv, n_peaks=2)}[surface]()
    rows = 2 if surface == 'peaks' else n_keep
    assert all(o.shape == (rows, 5) and not o.any() for o in out)


@pytest.mark.parametrize('call', ['browse_gridded', 'peaks_gridded', 'browse_cache',
                                  'peaks_cache', 'browse_oversize', 'peaks_oversize',
                                  'lt_oversize', 'welch_oversize', 'kappa_mesh'])
def test_unported_surfaces_raise(calcs, kv, tmp_path, call):
    """The gridded engine and device meshes still raise.  The shard cache
    and groups over max_device_bytes are ported: those cases hold the port
    to the JAX package on the same call (planes within PLANE_TOL of max,
    peak bins exact) instead."""
    ref, port = calcs
    surface, what = call.split('_')
    kw = {'gridded': dict(engine='gridded', k_grid_shape=(5, 4)),
          'cache': dict(cache_dir=tmp_path), 'mesh': dict(mesh=object())}.get(what, {})
    if what == 'oversize':
        ref = JaxCalculator(ref.traj, nx=3, ny=2, nz=2, max_device_bytes=1000)
        port = from_reference_calculator(ref, device='cpu')
    run = {'browse': lambda c: c.calculate_kgrid_browse(kv, k_chunk_size=7, **kw)[1],
           'peaks': lambda c: c.calculate_kgrid_peaks(kv, n_peaks=2, k_chunk_size=7, **kw),
           'lt': lambda c: np.stack(c.calculate_lt(kv, k_chunk_size=7)[1:]),
           'welch': lambda c: c.calculate_welch(np.zeros(len(kv)), kv, 2).sed,
           'kappa': lambda c: c.calculate_thermal_conductivity(kv, (5, 4), **kw)}[surface]
    if what in ('cache', 'oversize'):
        got, want = run(port), run(ref)
        if surface == 'peaks':
            np.testing.assert_array_equal(got[0], want[0])
            assert of_max(got[1], want[1]) < PLANE_TOL
        else:
            assert of_max(got, want) < PLANE_TOL
        assert (what == 'oversize') == (port.streamed_bytes > 0)
        return
    row = {'gridded': 'ROADMAP A12', 'mesh': 'ROADMAP A13'}[what]
    with pytest.raises(NotImplementedError, match=row):
        run(port)
