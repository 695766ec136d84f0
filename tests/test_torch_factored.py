"""psa_tpu_torch's 'factored' (anchor ⊕ delta) phase engine against the JAX
package's and the float64 oracle of ``tests/test_factored.py``.

The same seeded inputs go through both packages on the CPU; the port's
calculators come from JAX ones through ``from_reference_calculator``.

Tolerances:

* ``factor_k_chunk``: the same ``col_idx``; the port's float64 base rows
  equal the JAX package's hi + lo float32 pairs to 1e-12 (the pair holds the
  float64 value to about 2⁻⁴⁸ relative);
* phasors: within 1e-6 of the float64 phasors at the exact lattice k, and
  closer to them than the exact engine's (which evaluates the float32 k);
* S(k): rtol 1e-3, atol 1e-8; DSF planes, self parts, both ISFs and the
  Welch DSF: within 1e-5 of the plane's max, against the port's own 'exact'
  and against JAX ``phase_mode='factored'``;
* fallbacks (off-lattice k, a set too small to factor): bit identical to
  the port's 'exact'.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu.ops import instantaneous as jinst
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.ops import instantaneous as tinst

torch.set_num_threads(1)

L = np.array([17.3, 11.9, 23.4])
BOX = np.diag(L).astype(np.float32)
TRICLINIC = np.array([[17.3, 0, 0], [4.1, 11.9, 0], [-2.2, 3.3, 23.4]], dtype=np.float32)
PLANE_TOL = 1e-5


def recip(box):
    """B = 2π·H⁻ᵀ of the float32 box the engines read."""
    return 2 * np.pi * np.linalg.inv(box.astype(np.float64)).T


def case(name):
    """(float64 lattice k, box) of a detector case of test_factored.py."""
    line = (np.arange(1, 49)[:, None] * np.array([1, 2, 1])[None, :]).astype(np.float64)
    if name == 'exact_line':
        return line @ recip(BOX), BOX
    if name == 'gappy_unsorted_line':
        return (line @ recip(BOX))[np.random.default_rng(3).permutation(48)[:36]], BOX
    if name == 'grid_slice':
        m = np.array([[i, j, 2] for i in range(2, 9) for j in range(-3, 4)],
                     dtype=np.float64)[4:46]
        return m @ recip(BOX), BOX
    assert name == 'triclinic_line'
    return line @ recip(TRICLINIC), TRICLINIC


@pytest.fixture(scope='module')
def pos():
    return np.random.default_rng(0).uniform(-30, 60, (12, 40, 3)).astype(np.float32)


def oracle_phasors(pos, kv64):
    ang = np.einsum('tac,kc->tak', pos.astype(np.float64), kv64)
    return np.cos(ang), np.sin(ang)


def port_phasors(pos, k_arg, mode):
    cs = tinst.instant_phasors(torch.from_numpy(pos), k_arg, None, mode)
    z = tinst.complex_phasors(cs, mode).numpy()
    c, s = (part.numpy() for part in tinst.phasor_parts(cs, mode))
    assert np.array_equal(z.real, c) and np.array_equal(z.imag, s)
    return c, s


@pytest.mark.parametrize('name', ['exact_line', 'gappy_unsorted_line', 'grid_slice',
                                  'triclinic_line'])
def test_factor_k_chunk_matches_jax_and_oracle(pos, name):
    kv64, box = case(name)
    kv = kv64.astype(np.float32)
    (k_a, k_b), col_idx = tinst.factor_k_chunk(kv, box)
    (ja_hi, ja_lo, jb_hi, jb_lo), j_col = jinst.factor_k_chunk(kv, box)
    np.testing.assert_array_equal(col_idx, j_col)
    assert col_idx.dtype == np.int32 and k_a.dtype == k_b.dtype == torch.float64
    for got, hi, lo in ((k_a, ja_hi, ja_lo), (k_b, jb_hi, jb_lo)):
        want = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    assert tinst.k_count((k_a, k_b)) == k_a.shape[0] * k_b.shape[0]
    assert k_a.shape[0] + k_b.shape[0] < 20                 # ~2·√48 base columns
    # the product columns hold the requested k, in float64
    prod = (k_a[:, None, :] + k_b[None, :, :]).reshape(-1, 3).numpy()
    np.testing.assert_allclose(prod[col_idx], kv64, rtol=0, atol=1e-12)
    c, s = port_phasors(pos, (k_a, k_b), 'factored')
    c_o, s_o = oracle_phasors(pos, kv64)
    assert max(np.abs(c[:, :, col_idx] - c_o).max(), np.abs(s[:, :, col_idx] - s_o).max()) < 1e-6
    j_c, j_s = jinst._factored_phasors(jnp.asarray(pos), (ja_hi, ja_lo, jb_hi, jb_lo))
    assert np.abs(c - np.asarray(j_c)).max() < 1e-6
    assert np.abs(s - np.asarray(j_s)).max() < 1e-6


def test_rejects_what_jax_rejects():
    kv64, _ = case('exact_line')
    kv = kv64.astype(np.float32)
    rng = np.random.default_rng(1)
    soup = (rng.integers(-20, 20, (40, 3)).astype(np.float64) @ recip(BOX)).astype(np.float32)
    sparse = ((np.arange(16) ** 2 + 1)[:, None] * np.array([1.0, 0, 0])) @ recip(BOX)
    outlier = kv64.copy()
    outlier[5] = np.array([3.0, 1.0, 2.0]) @ recip(BOX)
    big = np.diag([97.3, 81.9, 123.4]).astype(np.float32)
    stair = tinst.nearest_commensurate(
        np.linspace(0.02, 1.9, 120)[:, None] * np.array([1.0, 0.53, 0.21])[None, :], big)
    _, first = np.unique(np.round(stair, 7), axis=0, return_index=True)
    degenerate = np.array([17.3, 11.9, 0.0])
    for k, box in ((kv * 1.01, BOX), (kv[:8], BOX), (soup, BOX), (sparse.astype(np.float32), BOX),
                   (outlier.astype(np.float32), BOX), (stair[np.sort(first)], big),
                   (kv, degenerate), (np.repeat(kv[:1], 20, axis=0), BOX)):
        assert tinst.factor_k_chunk(k, box) is None
        assert jinst.factor_k_chunk(k, box) is None


def test_more_accurate_than_exact_engine(pos):
    """The base angles come from the float64 lattice vectors m·B: the
    product phasor is the exact lattice phase to 1e-6, while the exact engine
    evaluates the float32-rounded k."""
    kv64, box = case('exact_line')
    fk, col_idx = tinst.factor_k_chunk(kv64.astype(np.float32), box)
    c_f, _ = port_phasors(pos, fk, 'factored')
    c_e, _ = port_phasors(pos, torch.from_numpy(kv64.astype(np.float32)), 'exact')
    c_o, _ = oracle_phasors(pos, kv64)
    err_f, err_e = np.abs(c_f[:, :, col_idx] - c_o).max(), np.abs(c_e - c_o).max()
    assert err_f < 1e-6 and err_f < err_e


def test_mode_stack_in_product_order_matches_exact(pos):
    """The factored mode stack's selected columns equal the exact engine's
    stack to 1e-5 of max (ragged time tiles on both)."""
    kv64, box = case('exact_line')
    kv = kv64.astype(np.float32)
    fk, col_idx = tinst.factor_k_chunk(kv, box)
    # inside the box, where the float32 k's distance from the lattice is small
    p = torch.from_numpy(np.random.default_rng(5).uniform(0, 10, (12, 40, 3)).astype(np.float32))
    vel = torch.from_numpy(np.random.default_rng(2).standard_normal(pos.shape).astype(np.float32))
    re_f, im_f = tinst.instant_modes(p, vel, fk, 5, None, 'factored')
    re_e, im_e = tinst.instant_modes(p, vel, torch.from_numpy(kv), 7)
    assert re_f.shape == (12, tinst.k_count(fk), 4)
    for got, want in ((re_f, re_e), (im_f, im_e)):
        got = got.numpy()[:, col_idx]
        assert np.abs(got - want.numpy()).max() <= PLANE_TOL * np.abs(want.numpy()).max()


# ---------------------------------------------------------------------------
# through the calculator
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def calcs():
    """(port exact, port factored, JAX factored, k): the 192-point lattice
    path of test_factored.py, which factors whole and in chunks of 64."""
    traj = make_random_crystal_trajectory(n_cells_xyz=(24, 6, 4), basis=2, n_frames=32,
                                          dt_ps=0.01, seed=1)
    jf = JaxCalculator(traj, nx=24, ny=6, nz=4, phase_mode='factored')
    pf = from_reference_calculator(jf, device='cpu')
    pe = from_reference_calculator(JaxCalculator(traj, nx=24, ny=6, nz=4, phase_mode='exact'),
                                   device='cpu')
    kv = np.outer(np.linspace(0.02, 2.0, 200), [1, 0, 0]).astype(np.float32)
    kv = tinst.commensurate_kpath(kv, traj.box_matrix)
    assert tinst.factor_k_chunk(kv, traj.box_matrix) is not None
    assert pf.phase_mode == 'factored' and pe.phase_mode == 'exact'
    return pe, pf, jf, kv


def of_max(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


def test_sk(calcs):
    pe, pf, jf, kv = calcs
    pf.factored_chunks.clear()
    got = pf.calculate_sk(kv)
    assert pf.factored_chunks and None not in pf.factored_chunks
    np.testing.assert_allclose(got, pe.calculate_sk(kv), rtol=1e-3, atol=1e-8)
    np.testing.assert_allclose(got, jf.calculate_sk(kv), rtol=1e-3, atol=1e-8)


def test_dsf_planes(calcs):
    pe, pf, jf, kv = calcs
    pf.factored_chunks.clear()
    freqs, *planes = pf.calculate_dsf(kv, k_chunk_size=64)
    assert len(pf.factored_chunks) == -(-len(kv) // 64) and None not in pf.factored_chunks
    e_freqs, *e_planes = pe.calculate_dsf(kv, k_chunk_size=64)
    j_freqs, *j_planes = jf.calculate_dsf(kv, k_chunk_size=64)
    np.testing.assert_array_equal(freqs, e_freqs)
    np.testing.assert_array_equal(freqs, j_freqs)
    for got, exact, jax_plane in zip(planes, e_planes, j_planes):
        assert of_max(got, exact) <= PLANE_TOL
        assert of_max(got, jax_plane) <= PLANE_TOL


def test_dsf_self(calcs):
    pe, pf, jf, kv = calcs
    _, got = pf.calculate_dsf_self(kv, k_chunk_size=64)
    assert of_max(got, pe.calculate_dsf_self(kv, k_chunk_size=64)[1]) <= PLANE_TOL
    assert of_max(got, jf.calculate_dsf_self(kv, k_chunk_size=64)[1]) <= PLANE_TOL


@pytest.mark.parametrize('which', ['isf', 'isf_self'])
def test_isf_both(calcs, which):
    pe, pf, jf, kv = calcs
    run = {'isf': lambda c: c.calculate_isf(kv, n_lags=8)[1],
           'isf_self': lambda c: c.calculate_isf_self(kv, n_lags=8)[1]}[which]
    got = run(pf)
    assert of_max(got, run(pe)) <= PLANE_TOL
    assert of_max(got, run(jf)) <= PLANE_TOL


def test_welch_dsf(calcs):
    pe, pf, jf, kv = calcs
    got = pf.calculate_dsf(kv, welch_segments=2)[1]
    assert of_max(got, pe.calculate_dsf(kv, welch_segments=2)[1]) <= PLANE_TOL
    assert of_max(got, jf.calculate_dsf(kv, welch_segments=2)[1]) <= PLANE_TOL


@pytest.mark.parametrize('fallback', ['off_lattice', 'small_set'])
def test_fallback_bit_identical_to_exact(calcs, fallback):
    pe, pf, _, kv = calcs
    k = kv * 1.013 if fallback == 'off_lattice' else kv[:5]
    pf.factored_chunks.clear()
    np.testing.assert_array_equal(pf.calculate_sk(k), pe.calculate_sk(k))
    # off-lattice k never reaches the factoring; a small set is tried and refused
    assert pf.factored_chunks == ([] if fallback == 'off_lattice' else [None])
    for a, b in zip(pf.calculate_dsf(k), pe.calculate_dsf(k)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(pf.calculate_dsf_self(k)[1], pe.calculate_dsf_self(k)[1])


def test_streamed_factored_matches_resident(calcs):
    """A group over max_device_bytes streams in atom blocks through the
    factored engine; the planes equal the resident ones to 1e-5 of max."""
    _, pf, jf, kv = calcs
    small = JaxCalculator(jf.traj, nx=24, ny=6, nz=4, phase_mode='factored',
                          max_device_bytes=2 * 12 * jf.traj.n_frames * 100)
    sport = from_reference_calculator(small, device='cpu')
    assert sport.stream_block_atoms(jf.traj.n_atoms) < jf.traj.n_atoms
    for got, want in zip(sport.calculate_dsf(kv, k_chunk_size=64)[1:3],
                         pf.calculate_dsf(kv, k_chunk_size=64)[1:3]):
        assert of_max(got, want) <= PLANE_TOL
    assert sport.streamed_bytes > 0


def test_resume_cache_roundtrip(calcs, tmp_path):
    """Stored planes are in the caller's k order, so a cache written by the
    factored engine replays bit for bit, in the port and from JAX's cache;
    another engine's cache is a miss (``phase_mode`` is in the key)."""
    pe, pf, jf, kv = calcs
    a = pf.calculate_dsf(kv, k_chunk_size=64, cache_dir=tmp_path / "c")[1]
    pf.factored_chunks.clear()
    b = pf.calculate_dsf(kv, k_chunk_size=64, cache_dir=tmp_path / "c")[1]
    np.testing.assert_array_equal(a, b)
    assert pf.factored_chunks == []                     # nothing was computed
    want = jf.calculate_dsf(kv, k_chunk_size=64, cache_dir=tmp_path / "j")[1]
    np.testing.assert_array_equal(
        pf.calculate_dsf(kv, k_chunk_size=64, cache_dir=tmp_path / "j")[1], want)
    assert pf.factored_chunks == []
    pe.calculate_dsf(kv, k_chunk_size=64, cache_dir=tmp_path / "c")
    assert len(list((tmp_path / "c").iterdir())) == 2


def test_invalid_mode_rejected(calcs):
    pe, _, _, _ = calcs
    with pytest.raises(ValueError, match="phase_mode"):
        SEDCalculator(pe.traj, nx=24, ny=6, nz=4, phase_mode='fast', device='cpu')
