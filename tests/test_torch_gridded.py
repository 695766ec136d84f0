"""psa_tpu_torch's gridded (NUFFT) k-grid engine against the JAX package's,
the port's direct engine and the float64 oracle: the cases of
``tests/test_gridded.py``'s single-device classes.

The same seeded inputs go through both packages on the CPU; the port's
calculators come from JAX ones through ``from_reference_calculator``.

Tolerances (``rel`` is max|got − want| / max|want|):

* ``plan_kgrid``: every field of the plan equals the JAX plan's bit for bit
  (both are the same NumPy on the host);
* ``gridded_kgrid_spectrum``: rel < 2e-6 against the float64 oracle (1e-5
  on the fine float32 grid, whose affine fit deviates by about 1e-6);
* ``calculate_gridded``: rel < 1e-5 against the port's direct ``calculate``
  and against JAX ``calculate_gridded``;
* chunked (``cell_chunk``, ``t_chunk``, ``gy_chunk``) against unchunked:
  rel < 1e-6;
* browse planes: rel < 1e-5 against the direct engine and JAX; chiral
  phases within 1e-3 rad where the intensity is above 1e-6 of its max;
* peaks: frequencies ``atol=1e-6``, heights ``rtol=2e-5`` (1e-4 streamed),
  widths ``rtol=1e-3, atol=1e-4``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu.ops import gridded as jgrid
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.ops import gridded as tgrid

torch.set_num_threads(1)


def rel(got, want):
    return np.max(np.abs(got - want)) / np.max(np.abs(want))


def pair(traj, **kw):
    ref = JaxCalculator(traj, nx=4, ny=3, nz=2, **kw)
    return ref, from_reference_calculator(ref, device='cpu')


@pytest.fixture(scope='module')
def traj():
    return make_random_crystal_trajectory(n_cells_xyz=(4, 3, 2), basis=2, n_frames=24,
                                          dt_ps=0.02, seed=8)


@pytest.fixture(scope='module')
def calcs(traj):
    return pair(traj)


def random_case(seed, n_t, n_atoms, extent):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n_t, n_atoms, 3)).astype(np.float32),
            rng.uniform(0, extent, size=(n_atoms, 3)))


def grid_oracle(data, mean64, kx, ky, k_fixed):
    kv = np.stack([np.repeat(kx, len(ky)), np.tile(ky, len(kx)),
                   np.full(len(kx) * len(ky), k_fixed)], 1).astype(np.float64)
    return np.einsum('tac,ka->tkc', data.astype(np.float64), np.exp(1j * (kv @ mean64.T)))


# ---------------------------------------------------------------------------
# the plan (host NumPy)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('case', ['random', 'crystal_yz', 'degenerate', 'crowded', 'empty'])
def test_plan_matches_jax_field_by_field(traj, case):
    if case == 'random':
        args = (random_case(0, 1, 500, 60.0)[1], np.linspace(-2, 2, 20), np.linspace(-1, 1, 16))
        kw = dict(k_fixed=0.4)
    elif case == 'crystal_yz':
        mean = traj.positions.astype(np.float64).mean(axis=0)
        args = (mean, np.linspace(-1.2, 1.2, 10), np.linspace(-0.8, 0.8, 8))
        kw = dict(k_fixed=0.3, axes=(1, 2, 0))
    elif case == 'degenerate':
        args = (random_case(1, 1, 60, 20.0)[1], np.array([0.7]), np.linspace(-1, 1, 5))
        kw = {}
    elif case == 'crowded':
        # 4 cells x 12 atoms mid-cell: one row of 16, not two of 8
        pos = np.zeros((48, 3))
        pos[:, 0] = np.repeat(np.arange(4) + 0.5, 12) * (2 * np.pi / 4)
        args, kw = (pos, np.linspace(0, 1.5, 2), np.linspace(0, 1, 3)), {}
    else:
        args, kw = (np.zeros((0, 3)), np.linspace(-1, 1, 4), np.linspace(-1, 1, 4)), {}
    got, want = tgrid.plan_kgrid(*args, **kw), jgrid.plan_kgrid(*args, **kw)
    for field in dataclasses.fields(want):
        a, b = getattr(got, field.name), getattr(want, field.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, field.name
            np.testing.assert_array_equal(a, b, err_msg=field.name)
        else:
            assert a == b, field.name
    assert got.n_rows == want.n_rows
    if case == 'crowded':
        assert got.bucket_size >= 16


def test_plan_helpers_match_jax(calcs):
    ref, _ = calcs
    plan = tgrid.plan_kgrid(ref.mean_positions64, np.linspace(-1, 1, 10), np.linspace(-1, 1, 8))
    per_row = 2 * 4 * plan.bucket_size * plan.w * plan.gy
    for budget, want in ((per_row * 3, 3), (1, 1), (1 << 40, plan.n_rows)):
        assert tgrid.cells_per_chunk(plan, weight_bytes=budget) == want
        assert jgrid.cells_per_chunk(plan, weight_bytes=budget) == want
    assert tgrid.DEFAULT_WEIGHT_BYTES == jgrid.DEFAULT_WEIGHT_BYTES
    for vals in (np.linspace(-2, 2, 50).astype(np.float32), np.array([0.0, 1.0, 3.0]),
                 np.array([1.5]), np.linspace(0, 1e-3, 7)):
        assert tgrid.is_uniform(vals) == jgrid.is_uniform(vals)
    with pytest.raises(ValueError, match="uniformly spaced"):
        tgrid.plan_kgrid(np.zeros((4, 3)), np.array([0.0, 1.0, 3.0]), np.linspace(0, 1, 4))
    rows = list(range(0, plan.n_rows, 3))
    assert tgrid._chunk_slot_ranges(plan, rows, 3) == jgrid._chunk_slot_ranges(plan, rows, 3)


# ---------------------------------------------------------------------------
# the projection (ops level)
# ---------------------------------------------------------------------------

def test_spectrum_matches_f64_oracle_and_jax():
    data, mean64 = random_case(0, 8, 500, 60.0)
    kx, ky = np.linspace(-2, 2, 20), np.linspace(-1, 1, 16)
    plan = tgrid.plan_kgrid(mean64, kx, ky, k_fixed=0.4)
    sig = tgrid.gridded_kgrid_spectrum(data, plan, device='cpu')
    assert sig.shape == (8, 320, 3) and sig.dtype == np.complex64
    assert rel(sig, grid_oracle(data, mean64, kx, ky, 0.4)) < 2e-6
    j_re, j_im = jgrid.gridded_kgrid_spectrum(data, plan)
    assert rel(sig, j_re + 1j * j_im) < 2e-6
    # the device FFT over time of each ky block is the host's FFT of the signal
    spec = tgrid.gridded_kgrid_spectrum(data, plan, device='cpu', time_fft=True, gy_chunk=5)
    assert rel(spec, np.fft.fft(sig.astype(np.complex128), axis=0) / 8) < 1e-6
    # a tensor on its device is read where it lies
    assert rel(tgrid.gridded_kgrid_spectrum(torch.from_numpy(data), plan), sig) == 0.0


def test_fine_f32_grid_accepted():
    """50-point float32 linspaces carry about eps·|k| of per-step jitter and
    must count as uniform."""
    data, mean64 = random_case(2, 4, 200, 50.0)
    kx = np.linspace(-2 * np.pi / 5.43, 2 * np.pi / 5.43, 50).astype(np.float32)
    plan = tgrid.plan_kgrid(mean64, kx, kx)
    sig = tgrid.gridded_kgrid_spectrum(data, plan, device='cpu')
    assert rel(sig, grid_oracle(data, mean64, kx, kx, 0.0)) < 1e-5


@pytest.mark.parametrize('kwargs', [{'t_chunk': 3}, {'cell_chunk': 3}, {'gy_chunk': 2},
                                    {'t_chunk': 5, 'cell_chunk': 4, 'gy_chunk': 3}],
                         ids=['t', 'cell', 'gy', 'all'])
def test_chunked_ops_match_unchunked(kwargs):
    data, mean64 = random_case(1, 10, 200, 30.0)
    plan = tgrid.plan_kgrid(mean64, np.linspace(0, 1, 8), np.linspace(0, 1, 6))
    assert rel(tgrid.gridded_kgrid_spectrum(data, plan, device='cpu', **kwargs),
               tgrid.gridded_kgrid_spectrum(data, plan, device='cpu')) < 1e-6
    freq_idx = np.arange(5)
    ref_i, ref_p = tgrid.gridded_kgrid_browse(data, plan, freq_idx, comp_pair=(0, 2),
                                              device='cpu')
    got_i, got_p = tgrid.gridded_kgrid_browse(data, plan, freq_idx, comp_pair=(0, 2),
                                              device='cpu', **kwargs)
    assert rel(got_i, ref_i) < 1e-6
    sig = ref_i > 1e-6 * ref_i.max()
    np.testing.assert_allclose(got_p[sig], ref_p[sig], rtol=0, atol=1e-3)


def test_rows_of_one_cell_are_summed_in_row_order():
    """Many atoms on few cells: a cell spans several rows, which one batched
    product contracts at once; the result holds the float64 oracle's bar."""
    data, mean64 = random_case(4, 3, 110, 30.0)
    kx, ky = np.linspace(0, 1.5, 2), np.linspace(0, 1, 3)
    # 100 atoms in fine cell 0 and 5 in each of cells 1 and 2 (of 4): rows of 16
    cells = np.repeat([0, 1, 2], [100, 5, 5])
    mean64[:, 0] = (cells + np.random.default_rng(5).uniform(0.1, 0.9, 110)) * (2 * np.pi / 4) / 1.5
    plan = tgrid.plan_kgrid(mean64, kx, ky)
    assert plan.n_rows == 9 and plan.bucket_size == 16 and len(np.unique(plan.slot_cell)) == 3
    sig = tgrid.gridded_kgrid_spectrum(data, plan, device='cpu')
    assert rel(sig, grid_oracle(data, mean64, kx, ky, 0.0)) < 2e-6
    assert rel(tgrid.gridded_kgrid_spectrum(data, plan, device='cpu', cell_chunk=2), sig) < 1e-6


def test_zero_atoms_yield_zero_spectra():
    plan = tgrid.plan_kgrid(np.zeros((0, 3)), np.linspace(-1, 1, 4), np.linspace(-1, 1, 4))
    data = np.zeros((8, 0, 3), dtype=np.float32)
    sig = tgrid.gridded_kgrid_spectrum(data, plan, device='cpu')
    assert sig.shape == (8, 16, 3) and not sig.any()
    inten, ph = tgrid.gridded_kgrid_browse(data, plan, np.arange(4), device='cpu')
    assert inten.shape == (4, 16) and not inten.any() and ph is None
    peaks = tgrid.gridded_kgrid_browse(data, plan, np.arange(4), device='cpu', n_peaks=2,
                                       freqs_kept=np.arange(4.0))
    assert all(p.shape == (2, 16) and not p.any() for p in peaks)


def test_ops_value_errors():
    data, mean64 = random_case(3, 6, 40, 20.0)
    plan = tgrid.plan_kgrid(mean64, np.linspace(-1, 1, 5), np.linspace(-1, 1, 4))
    with pytest.raises(ValueError, match="exclusive with comp_pair"):
        tgrid.gridded_kgrid_browse(data, plan, np.arange(3), device='cpu', n_peaks=1,
                                   comp_pair=(0, 1), freqs_kept=np.arange(3.0))
    with pytest.raises(ValueError, match="needs freqs_kept"):
        tgrid.gridded_kgrid_browse(data, plan, np.arange(3), device='cpu', n_peaks=1)
    with pytest.raises(ValueError, match="atoms"):
        tgrid.gridded_kgrid_browse(tgrid.ArrayBlockSource(data[:, :30]), plan, np.arange(3),
                                   device='cpu')
    with pytest.raises(ValueError, match="precision"):
        tgrid.gridded_kgrid_spectrum(data, plan, device='cpu', precision='exact')


# ---------------------------------------------------------------------------
# the streamed sweep (ops level)
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def streamed_case():
    data, mean64 = random_case(11, 24, 150, 40.0)
    plan = tgrid.plan_kgrid(mean64, np.linspace(-1, 1, 9), np.linspace(-1, 1, 7), k_fixed=0.2)
    return data, plan, np.arange(12)


def test_streamed_browse_matches_resident_and_jax(streamed_case):
    data, plan, freq_idx = streamed_case
    ref_i, _ = tgrid.gridded_kgrid_browse(data, plan, freq_idx, device='cpu')
    # 7-frame superchunks over 24 frames (a ragged last one), 3-frame spreads,
    # the weights rebuilt for every superchunk
    stats = {}
    got_i, _ = tgrid.gridded_kgrid_browse(
        tgrid.ArrayBlockSource(data), plan, freq_idx, t_superchunk=7, t_chunk=3, cell_chunk=3,
        weight_cache_bytes=0, device='cpu', stats=stats)
    assert rel(got_i, ref_i) < 1e-5
    assert stats['bytes_streamed'] == data.nbytes
    j_i, _ = jgrid.gridded_kgrid_browse(data, plan, freq_idx.astype(np.int32))
    assert rel(got_i, j_i) < 1e-5


def test_streamed_chiral_and_weight_cache(streamed_case):
    data, plan, freq_idx = streamed_case
    ref_i, ref_p = tgrid.gridded_kgrid_browse(data, plan, freq_idx, comp_pair=(0, 1),
                                              device='cpu')
    stats = {}
    got_i, got_p = tgrid.gridded_kgrid_browse(
        tgrid.ArrayBlockSource(data), plan, freq_idx, comp_pair=(0, 1), t_superchunk=10,
        gy_chunk=3, device='cpu', stats=stats)
    assert rel(got_i, ref_i) < 1e-5
    sig = ref_i > 1e-6 * ref_i.max()
    np.testing.assert_allclose(got_p[sig], ref_p[sig], atol=1e-3)
    assert stats['bytes_streamed'] == 3 * data.nbytes      # every ky block re-reads the source


def test_streamed_peaks_match_resident(streamed_case):
    data, plan, freq_idx = streamed_case
    freqs_kept = freq_idx.astype(np.float32) * 0.5
    ref = tgrid.gridded_kgrid_browse(data, plan, freq_idx, n_peaks=2, freqs_kept=freqs_kept,
                                     device='cpu')
    got = tgrid.gridded_kgrid_browse(tgrid.ArrayBlockSource(data), plan, freq_idx, n_peaks=2,
                                     freqs_kept=freqs_kept, t_superchunk=9, device='cpu')
    np.testing.assert_allclose(got[0], ref[0], atol=1e-6)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], rtol=1e-3, atol=1e-4)


# ---------------------------------------------------------------------------
# calculate_gridded
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("plane", ['xy', 'yz', 'zx'])
def test_calculate_gridded_matches_direct_and_jax(calcs, plane):
    ref, port = calcs
    _, k_vecs, shape = port.get_k_grid(plane, (-1.2, 1.2), (-0.8, 0.8), 10, 8, k_fixed_val=0.3)
    direct = port.calculate(np.array([]), k_vecs, k_grid_shape=shape)
    grid = port.calculate_gridded(k_vecs, shape)
    assert grid.sed.shape == direct.sed.shape and grid.sed.dtype == np.complex64
    assert grid.k_grid_shape == shape and grid.is_complex
    assert rel(grid.sed, direct.sed) < 1e-5
    np.testing.assert_allclose(grid.freqs, direct.freqs)
    assert rel(grid.sed, ref.calculate_gridded(k_vecs, shape).sed) < 1e-5


def test_calculate_gridded_displacement_mode(traj):
    ref, port = pair(traj, use_displacements=True)
    _, k_vecs, shape = port.get_k_grid('xy', (-1, 1), (-1, 1), 6, 6)
    grid = port.calculate_gridded(k_vecs, shape)
    assert rel(grid.sed, port.calculate(np.array([]), k_vecs, k_grid_shape=shape).sed) < 1e-5
    assert rel(grid.sed, ref.calculate_gridded(k_vecs, shape).sed) < 1e-5


def test_calculate_gridded_type_basis(calcs):
    ref, port = calcs
    _, k_vecs, shape = port.get_k_grid('xy', (-1, 1), (-1, 1), 6, 5)
    grid = port.calculate_gridded(k_vecs, shape, basis_atom_types=[1])
    direct = port.calculate(np.array([]), k_vecs, basis_atom_types=[1], k_grid_shape=shape)
    assert rel(grid.sed, direct.sed) < 1e-5
    assert rel(grid.sed, ref.calculate_gridded(k_vecs, shape, basis_atom_types=[1]).sed) < 1e-5


@pytest.mark.parametrize("nkx,nky", [(1, 8), (8, 1), (1, 1)])
def test_calculate_gridded_degenerate_grids(calcs, nkx, nky):
    ref, port = calcs
    _, k_vecs, shape = port.get_k_grid('xy', (-1.2, 1.2), (-0.8, 0.8), nkx, nky, k_fixed_val=0.3)
    assert port._detect_grid_axes(k_vecs, shape)[3] == ref._detect_grid_axes(k_vecs, shape)[3]
    grid = port.calculate_gridded(k_vecs, shape)
    direct = port.calculate(np.array([]), k_vecs, k_grid_shape=shape)
    assert grid.sed.shape == direct.sed.shape
    assert rel(grid.sed, direct.sed) < 1e-5


@pytest.mark.parametrize("kwargs", [{'cell_chunk': 1}, {'cell_chunk': 3}, {'cell_chunk': 5},
                                    {'cell_chunk': 7}, {'cell_chunk': 4, 't_chunk': 7},
                                    {'gy_chunk': 3}],
                         ids=['cell1', 'cell3', 'cell5', 'cell7', 'cell4-t7', 'gy3'])
def test_calculate_gridded_chunked_matches_unchunked(calcs, kwargs):
    _, port = calcs
    _, k_vecs, shape = port.get_k_grid('xy', (-1.2, 1.2), (-0.8, 0.8), 10, 8, k_fixed_val=0.3)
    full = port.calculate_gridded(k_vecs, shape)
    assert rel(port.calculate_gridded(k_vecs, shape, **kwargs).sed, full.sed) < 1e-6


@pytest.mark.parametrize("precision", ['balanced', 'fast'])
def test_calculate_gridded_tiers_run_ieee_float32(traj, calcs, precision):
    """The gridded products are IEEE float32 at every tier: the tier's
    result is 'parity''s (the JAX bar is < 1e-1 of it)."""
    _, port = calcs
    _, tier = pair(traj, precision=precision)
    _, k_vecs, shape = port.get_k_grid('xy', (-1, 1), (-1, 1), 6, 6)
    np.testing.assert_array_equal(tier.calculate_gridded(k_vecs, shape).sed,
                                  port.calculate_gridded(k_vecs, shape).sed)


def test_calculate_gridded_value_errors(calcs):
    _, port = calcs
    _, k_path = port.get_k_path('x', bz_coverage=1.0, n_k=8)
    with pytest.raises(ValueError, match="tensor-product"):
        port.calculate_gridded(k_path, (4, 2))
    with pytest.raises(ValueError, match="k_grid_shape does not match"):
        port.calculate_gridded(k_path, (3, 2))
    rng = np.random.default_rng(0)
    with pytest.raises(ValueError, match="tensor-product"):
        port.calculate_gridded(rng.uniform(-1, 1, (12, 3)).astype(np.float32), (4, 3))
    _, k_vecs, shape = port.get_k_grid('xy', (-1, 1), (-1, 1), 4, 3)
    k_vecs[::3, 0] *= 1.3                                   # the slow axis no longer uniform
    with pytest.raises(ValueError, match="uniformly spaced"):
        port.calculate_gridded(np.repeat(np.array([[0.0], [1.0], [3.0]], np.float32), 3, 0)
                               * [1, 0, 0] + np.tile(np.array([[0, 0.0, 0], [0, 0.5, 0],
                                                               [0, 1.0, 0]], np.float32), (3, 1)),
                               (3, 3))


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_calculate_gridded_cache_roundtrip(calcs, tmp_path, monkeypatch, writer):
    """The cache is all or nothing and carries the JAX workload key: a
    result stored by either package is returned by the port without
    computing."""
    ref, port = calcs
    _, k_vecs, shape = port.get_k_grid('xy', (-1, 1), (-1, 1), 6, 5)
    first = (port if writer == 'port' else ref).calculate_gridded(k_vecs, shape,
                                                                 cache_dir=tmp_path)
    monkeypatch.setattr(tgrid, 'gridded_kgrid_spectrum', None)     # any computation raises
    again = port.calculate_gridded(k_vecs, shape, cache_dir=tmp_path)
    np.testing.assert_array_equal(again.sed, first.sed)
    assert len(list(tmp_path.iterdir())) == 1
    with pytest.raises(TypeError):
        port.calculate_gridded(k_vecs, shape, basis_atom_types=[1], cache_dir=tmp_path)


# ---------------------------------------------------------------------------
# engine='gridded' of calculate_kgrid_browse and calculate_kgrid_peaks
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def browse_grid(calcs):
    return calcs[1].get_k_grid('xy', (-1.2, 1.2), (-0.8, 0.8), 10, 8, k_fixed_val=0.3)[1:]


def test_browse_matches_direct_and_jax(calcs, browse_grid):
    ref, port = calcs
    k_vecs, shape = browse_grid
    f_d, i_d, _ = port.calculate_kgrid_browse(k_vecs)
    f_g, i_g, p_g = port.calculate_kgrid_browse(k_vecs, engine='gridded', k_grid_shape=shape)
    np.testing.assert_array_equal(f_g, f_d)
    assert p_g is None and i_g.dtype == np.float32
    assert rel(i_g, i_d) < 1e-5
    j_f, j_i, _ = ref.calculate_kgrid_browse(k_vecs, engine='gridded', k_grid_shape=shape)
    np.testing.assert_allclose(f_g, j_f)
    assert rel(i_g, j_i) < 1e-5


def test_browse_chiral_and_max_freq(calcs, browse_grid):
    ref, port = calcs
    k_vecs, shape = browse_grid
    kw = dict(max_freq=10.0, chiral=True, chiral_axis='z')
    f_d, i_d, p_d = port.calculate_kgrid_browse(k_vecs, **kw)
    f_g, i_g, p_g = port.calculate_kgrid_browse(k_vecs, engine='gridded', k_grid_shape=shape,
                                                **kw)
    np.testing.assert_array_equal(f_g, f_d)
    assert rel(i_g, i_d) < 1e-5
    sig = i_d > 1e-6 * i_d.max()
    np.testing.assert_allclose(p_g[sig], p_d[sig], rtol=0, atol=1e-3)
    _, j_i, j_p = ref.calculate_kgrid_browse(k_vecs, engine='gridded', k_grid_shape=shape, **kw)
    assert rel(i_g, j_i) < 1e-5
    np.testing.assert_allclose(p_g[sig], j_p[sig], rtol=0, atol=1e-3)


def test_browse_displacement_mode_and_auto_is_direct(traj, monkeypatch):
    _, port = pair(traj, use_displacements=True)
    _, k_vecs, shape = port.get_k_grid('xy', (-1, 1), (-1, 1), 8, 6)
    _, i_d, _ = port.calculate_kgrid_browse(k_vecs)
    _, i_g, _ = port.calculate_kgrid_browse(k_vecs, engine='gridded', k_grid_shape=shape)
    assert rel(i_g, i_d) < 1e-5
    monkeypatch.setattr(tgrid, 'gridded_kgrid_browse', None)      # 'auto' must not reach it
    _, i_a, _ = port.calculate_kgrid_browse(k_vecs, engine='auto', k_grid_shape=shape)
    np.testing.assert_array_equal(i_a, i_d)


def test_peaks_match_direct_and_jax(calcs):
    ref, port = calcs
    _, k_vecs, shape = port.get_k_grid('xy', (-1.2, 1.2), (-1.2, 1.2), 10, 10)
    direct = port.calculate_kgrid_peaks(k_vecs, n_peaks=2)
    got = port.calculate_kgrid_peaks(k_vecs, n_peaks=2, engine='gridded', k_grid_shape=shape)
    want = ref.calculate_kgrid_peaks(k_vecs, n_peaks=2, engine='gridded', k_grid_shape=shape)
    for other in (direct, want):
        np.testing.assert_allclose(got[0], other[0], atol=1e-6)
        np.testing.assert_allclose(got[1], other[1], rtol=2e-5)
        np.testing.assert_allclose(got[2], other[2], rtol=1e-3, atol=1e-4)
    lor = port.calculate_kgrid_peaks(k_vecs, engine='gridded', k_grid_shape=shape,
                                     width_method='lorentzian', max_freq=12.0)
    lor_d = port.calculate_kgrid_peaks(k_vecs, width_method='lorentzian', max_freq=12.0)
    np.testing.assert_allclose(lor[0], lor_d[0], atol=1e-6)
    np.testing.assert_allclose(lor[2], lor_d[2], rtol=1e-3, atol=1e-4)


def test_plan_is_kept_for_the_next_sweep_of_the_grid(calcs, browse_grid, monkeypatch):
    """A browse and a peaks sweep of one grid plan once; the calculator keeps
    its last two plans."""
    _, port = calcs
    k_vecs, shape = browse_grid
    calls = []
    real = tgrid.plan_kgrid
    monkeypatch.setattr(tgrid, 'plan_kgrid', lambda *a, **k: calls.append(1) or real(*a, **k))
    port._grid_plans.clear()
    first = port.calculate_kgrid_browse(k_vecs, engine='gridded', k_grid_shape=shape)[1]
    port.calculate_kgrid_peaks(k_vecs, engine='gridded', k_grid_shape=shape)
    port.calculate_gridded(k_vecs, shape)
    assert len(calls) == 1
    port.calculate_kgrid_peaks(k_vecs, engine='gridded', k_grid_shape=shape, basis_atom_types=[1])
    _, other, other_shape = port.get_k_grid('yz', (-1, 1), (-1, 1), 4, 4)
    port.calculate_gridded(other, other_shape)
    assert len(calls) == 3 and len(port._grid_plans) == 2
    again = port.calculate_kgrid_browse(k_vecs, engine='gridded', k_grid_shape=shape)[1]
    assert len(calls) == 4                                  # evicted, planned anew
    np.testing.assert_array_equal(again, first)


def test_peaks_auto_stays_direct_at_any_size(calcs, monkeypatch):
    """The JAX package routes grids of 128² and more to its NUFFT engine;
    the port's 'auto' is 'direct' whatever the grid."""
    _, port = calcs
    monkeypatch.setattr(tgrid, 'gridded_kgrid_browse', None)
    _, k_big, sh_big = port.get_k_grid('xy', (-1, 1), (-1, 1), 128, 128)
    auto = port.calculate_kgrid_peaks(k_big[:256], engine='auto', k_grid_shape=(2, 128))
    np.testing.assert_array_equal(auto[0], port.calculate_kgrid_peaks(k_big[:256],
                                                                      engine='direct')[0])


@pytest.mark.parametrize('surface', ['peaks', 'browse'])
def test_oversize_group_streams_and_equals_resident(traj, surface):
    """max_device_bytes=1000 on both packages: the group streams through the
    NUFFT engine in time superchunks, with the resident path's transforms
    (mass weights, the displacement mean) applied per block on the host."""
    masses = np.where(traj.types == 1, 28.0, 12.0).astype(np.float64)
    traj_m = dataclasses.replace(traj, masses=masses)
    kw = dict(use_displacements=True, mass_weighted=True)
    _, resident = pair(traj_m, **kw)
    ref, port = pair(traj_m, max_device_bytes=1000, **kw)
    _, k_vecs, shape = port.get_k_grid('xy', (-1, 1), (-1, 1), 6, 5)
    if surface == 'peaks':
        run = lambda c: c.calculate_kgrid_peaks(k_vecs, n_peaks=2, engine='gridded',
                                                k_grid_shape=shape)
        got, want, jax_got = run(port), run(resident), run(ref)
        for other in (want, jax_got):
            np.testing.assert_allclose(got[0], other[0], atol=1e-6)
            np.testing.assert_allclose(got[1], other[1], rtol=1e-4)
            np.testing.assert_allclose(got[2], other[2], rtol=1e-3, atol=1e-4)
    else:
        run = lambda c: c.calculate_kgrid_browse(k_vecs, engine='gridded', k_grid_shape=shape)
        (f_s, i_s, _), (f_r, i_r, _), (_, i_j, _) = run(port), run(resident), run(ref)
        np.testing.assert_array_equal(f_s, f_r)
        assert rel(i_s, i_r) < 1e-5 and rel(i_s, i_j) < 1e-5
    assert port.streamed_bytes == 12 * traj.n_frames * traj.n_atoms
    assert resident.streamed_bytes == 0 and not port._device_cache


@pytest.mark.parametrize('case', ['browse_shape', 'browse_incoherent', 'browse_f16', 'browse_welch',
                                  'browse_cache', 'peaks_shape', 'peaks_incoherent',
                                  'peaks_chiral', 'peaks_welch', 'peaks_cache', 'bad_engine'])
def test_gridded_value_errors_match_jax(calcs, browse_grid, tmp_path, case):
    """Every refusal of the gridded surfaces, with the JAX package's text."""
    ref, port = calcs
    k_vecs, shape = browse_grid
    surface, what = case.split('_')
    kw, match = {
        'shape': ({}, "engine='gridded' needs k_grid_shape"),
        'incoherent': (dict(k_grid_shape=shape, basis_atom_types=[1, 2],
                            summation_mode='incoherent'), "coherent"),
        'f16': (dict(k_grid_shape=shape, readback_dtype='float16'), "runs on the direct"),
        'welch': (dict(k_grid_shape=shape, welch_segments=2), "welch_segments runs on the direct"),
        'cache': (dict(k_grid_shape=shape, cache_dir=tmp_path), "cache_dir checkpointing runs"),
        'chiral': (dict(k_grid_shape=shape, chiral=True), "chiral peaks run on the direct"),
        'engine': ({}, "engine must be"),
    }[what]
    for calc in (port, ref):
        run = (calc.calculate_kgrid_peaks if surface == 'peaks' else calc.calculate_kgrid_browse)
        engines = ('gridded',) if what != 'engine' else ('nufft',)
        for engine in engines:
            with pytest.raises(ValueError, match=match):
                run(k_vecs, engine=engine, **kw)
    if what == 'engine':
        with pytest.raises(ValueError, match=match):
            port.calculate_kgrid_peaks(k_vecs, engine='nufft')
