"""The calculator's mesh surfaces in psa_tpu_torch against the JAX package:
the gridded engine's ky stripes, the instantaneous-phase family and the
time correlations over a mesh, and the gridded engine on data with one
strong mode.

The port runs on ``['cpu'] * 8`` meshes, the JAX package on its eight
virtual CPU devices, on the same seeded inputs.  Tolerances are the JAX
tests' own (``tests/test_gridded.py``, ``tests/test_dsf.py``,
``tests/test_timecorr.py``): stripes against
the one-device gridded engine with peak bins exact and heights rtol 1e-5;
DSF planes within 1e-5 of max; S(k) rtol 1e-5; the ISF rtol 1e-4 with atol
1e-5 of max; MSD/VACF rtol and atol 1e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu import parallel as jpar
from psa_tpu.models import make_chain_trajectory, make_random_crystal_trajectory
from psa_tpu.ops import instantaneous as jinst
from psa_tpu_torch import parallel as tpar
from psa_tpu_torch.core.convert import from_reference_calculator

torch.set_num_threads(1)


def tmesh(shape=(2, 2, 2), **kw):
    return tpar.make_mesh(shape=shape, devices=['cpu'] * 8, **kw)


def within(got, want, tol):
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


# ---------------------------------------------------------------------------
# the gridded engine's ky stripes
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def grid_calcs():
    traj = make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2, n_frames=16,
                                          dt_ps=0.02, seed=21)
    ref = JaxCalculator(traj, nx=3, ny=2, nz=2)
    return ref, from_reference_calculator(ref, device='cpu')


@pytest.mark.parametrize('grid,oversize', [((17, 23), False), ((12, 3), False),
                                           ((9, 11), True)],
                         ids=['stripes', 'gy-below-positions', 'streamed'])
def test_gridded_stripes_match_one_device_and_jax(grid_calcs, grid, oversize):
    """Peaks of the ky stripes over eight positions against the port's
    one-device gridded engine (bins exact) and the JAX stripes; streamed
    when the group is over max_device_bytes, one pass feeding every stripe."""
    ref, port = grid_calcs
    if oversize:
        ref = JaxCalculator(ref.traj, nx=3, ny=2, nz=2, max_device_bytes=1000)
        port = from_reference_calculator(ref, device='cpu')
    _, kv, shape = port.get_k_grid('xy', (-1.2, 1.2), (-0.9, 0.9), *grid)
    kw = dict(n_peaks=2, engine='gridded', k_grid_shape=shape)
    got = port.calculate_kgrid_peaks_sharded(tmesh((1, 1, 8)), kv, **kw)
    assert (port.streamed_bytes > 0) == oversize
    for want in (port.calculate_kgrid_peaks(kv, **kw),
                 ref.calculate_kgrid_peaks_sharded(jpar.make_mesh(shape=(1, 1, 8)), kv, **kw)):
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-4, atol=1e-5)


def test_gridded_stripes_browse_chiral(grid_calcs):
    ref, port = grid_calcs
    _, kv, shape = port.get_k_grid('xy', (-1.2, 1.2), (-0.9, 0.9), 7, 9)
    kw = dict(engine='gridded', k_grid_shape=shape, chiral=True)
    got = port.calculate_kgrid_browse_sharded(tmesh((2, 2, 2)), kv, **kw)
    want = port.calculate_kgrid_browse(kv, **kw)
    jax_got = ref.calculate_kgrid_browse_sharded(jpar.make_mesh(shape=(2, 2, 2)), kv, **kw)
    for w in (want, jax_got):
        within(got[1], w[1], 1e-5)
        bright = w[1] >= 1e-6 * w[1].max()
        assert np.abs(got[2] - w[2])[bright].max() < 1e-4


def test_gridded_stripes_validation(grid_calcs):
    _, port = grid_calcs
    _, kv, shape = port.get_k_grid('xy', (-1, 1), (-1, 1), 5, 5)
    mesh = tmesh((1, 1, 8))
    with pytest.raises(ValueError, match="k_grid_shape"):
        port.calculate_kgrid_peaks_sharded(mesh, kv, engine='gridded')
    with pytest.raises(ValueError, match="coherent"):
        port.calculate_kgrid_peaks_sharded(mesh, kv, engine='gridded', k_grid_shape=shape,
                                           basis_atom_types=[1, 2],
                                           summation_mode='incoherent')
    with pytest.raises(ValueError, match="direct engine"):
        port.calculate_kgrid_peaks_sharded(mesh, kv, engine='gridded', k_grid_shape=shape,
                                           chiral=True)


def test_gridded_one_strong_mode_matches_jax():
    """One strong phonon (12 THz, amplitude 20) over N(0, 1) velocity noise,
    the data on which the gridded engine's dim columns stray from the
    direct engine's.  The port's gridded planes equal the JAX package's
    within 1e-6 of max, and the port strays from its direct engine no more
    than the JAX engine strays from its own: the limit is the reference's
    (both come near 1e-5 of a dim column's own peak here; see ROADMAP §C)."""
    traj = make_random_crystal_trajectory(n_cells_xyz=(6, 6, 2), basis=2, n_frames=64,
                                          dt_ps=0.01, seed=5)
    vel = np.random.default_rng(0).normal(0, 1, traj.velocities.shape).astype(np.float32)
    mean = traj.positions.astype(np.float64).mean(0)
    k_mode = np.array([2 * np.pi * 2 / traj.box_matrix[0, 0], 0, 0])
    t = np.arange(traj.n_frames) * traj.dt_ps
    vel[:, :, 1] += (20.0 * np.cos((mean @ k_mode)[None] - 2 * np.pi * 12.0 * t[:, None])
                     ).astype(np.float32)
    ref = JaxCalculator(dataclasses.replace(traj, velocities=vel), nx=6, ny=6, nz=2)
    port = from_reference_calculator(ref, device='cpu')
    _, kv, shape = ref.get_k_grid('xy', (-2, 2), (-2, 2), 12, 10)
    kw = dict(engine='gridded', k_grid_shape=shape)
    pg, jg = (c.calculate_kgrid_browse(kv, **kw)[1] for c in (port, ref))
    pd, jd = (c.calculate_kgrid_browse(kv)[1] for c in (port, ref))
    assert np.abs(pg - jg).max() <= 1e-6 * jg.max()
    col = jd.max(axis=0)
    port_err = (np.abs(pg - pd).max(axis=0) / col).max()
    jax_err = (np.abs(jg - jd).max(axis=0) / col).max()
    assert port_err <= 2 * jax_err


# ---------------------------------------------------------------------------
# the instantaneous-phase family and the time correlations
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def chain():
    traj = make_chain_trajectory(n_cells=12, n_frames=64, dt_ps=0.02, a=2.5,
                                 omega_max_thz=7.0, seed=4)
    kv = np.zeros((6, 3), dtype=np.float32)
    kv[:, 0] = 2 * np.pi * np.arange(1, 7) / (12 * 2.5)
    kv = jinst.nearest_commensurate(kv, traj.box_lengths)
    ref = JaxCalculator(traj, nx=12, ny=1, nz=1, phase_mode='exact')
    return ref, from_reference_calculator(ref, device='cpu'), kv


DSF_CASES = {
    'dsf': ('dsf', dict(max_freq=10.0)),
    'dsf-streamed': ('dsf', dict(t_superchunk=16)),
    'dsf-basis': ('dsf', dict(basis_atom_indices=list(range(0, 12, 2)))),
    'dsf-welch': ('dsf', dict(welch_segments=2)),
    'sk': ('sk', dict()),
    'sk-streamed-basis': ('sk', dict(t_superchunk=16, basis_atom_indices=list(range(0, 12, 3)))),
    'isf': ('isf', dict(n_lags=24)),
    'isf-streamed': ('isf', dict(n_lags=24, t_superchunk=16)),
    'isf-self': ('isf_self', dict(n_lags=24, basis_atom_indices=list(range(0, 12, 2)))),
    'isf-self-chunks': ('isf_self', dict(n_lags=24, atom_chunk=4)),
    'dsf-self': ('dsf_self', dict(max_freq=10.0)),
    'dsf-self-chunks': ('dsf_self', dict(max_freq=10.0, atom_chunk=8,
                                         basis_atom_indices=[0, 3, 7, 9])),
}


def _planes(out):
    return [np.asarray(o) for o in (out if isinstance(out, tuple) else (out,))][-3:]


@pytest.mark.parametrize('case', list(DSF_CASES))
def test_instantaneous_family_matches_one_device_and_jax(chain, case):
    ref, port, kv = chain
    kind, kw = DSF_CASES[case]
    single_kw = {k: v for k, v in kw.items() if k not in ('t_superchunk', 'atom_chunk')}
    got = getattr(port, f'calculate_{kind}_sharded')(tmesh(), kv, **kw)
    one = getattr(port, f'calculate_{kind}')(kv, **single_kw)
    jax_got = getattr(ref, f'calculate_{kind}_sharded')(jpar.make_mesh(shape=(2, 2, 2)), kv,
                                                        **kw)
    if kind in ('dsf', 'dsf_self', 'isf', 'isf_self'):
        np.testing.assert_allclose(got[0], one[0], atol=0)         # frequencies or lags
    tol = 1e-4 if kind in ('isf', 'isf_self') else 1e-5
    for want in (one, jax_got):
        for g, w in zip(_planes(got), _planes(want)):
            within(g, w, tol)


def test_instantaneous_mesh_takes_factored_as_exact_and_incremental(chain):
    """A mesh runs 'factored' as 'exact' (the JAX rule); 'incremental' runs
    on the mesh against the one-device incremental engine."""
    ref, _, kv = chain
    for mode in ('factored', 'incremental'):
        port = from_reference_calculator(
            JaxCalculator(ref.traj, nx=12, ny=1, nz=1, phase_mode=mode), device='cpu')
        assert port._mesh_phase(kv)[1] == ('exact' if mode == 'factored' else 'incremental')
        got = port.calculate_dsf_sharded(tmesh(), kv, max_freq=10.0)
        want = port.calculate_dsf(kv, max_freq=10.0)
        for g, w in zip(got[1:], want[1:]):
            within(g, w, 1e-5)


@pytest.mark.parametrize('kind', ['msd', 'vacf'])
def test_timecorr_matches_one_device_and_jax(kind):
    from test_timecorr import _traj
    rng = np.random.default_rng(12)
    pos = rng.normal(0, 1, (64, 18, 3)).astype(np.float32)
    vel = rng.normal(0, 1, (64, 18, 3)).astype(np.float32)
    ref = JaxCalculator(_traj(pos, vel, types=np.array([1] * 10 + [2] * 8, np.int32)),
                        nx=1, ny=1, nz=1)
    port = from_reference_calculator(ref, device='cpu')
    kw = dict(basis_atom_types=[1, 2], n_lags=16)
    lags, one = getattr(port, f'calculate_{kind}')(**kw)
    _, jax_got = getattr(ref, f'calculate_{kind}_sharded')(jpar.make_mesh(shape=(2, 2, 2)),
                                                           **kw)
    for chunk in (None, 8):
        l2, got = getattr(port, f'calculate_{kind}_sharded')(tmesh(), atom_chunk=chunk, **kw)
        np.testing.assert_allclose(l2, lags, atol=0)
        for want in (one, jax_got):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
