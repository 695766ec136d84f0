"""Two processes over gloo (``psa_tpu_torch.parallel.smoke``): the mesh
sweeps across a real process boundary, the port of
``tests/test_multihost.py`` and ``scripts/multihost_smoke*.py``.

Two fresh interpreters join a process group on a free localhost port and
build one (2, 2, 2) mesh, four CPU positions each (rank 0 owns the first
time slice, rank 1 the second).  Each reads the trajectory through counting
sources over ``.npy`` memmaps.  Checks: both ranks hold the same results;
they equal the one-process mesh (SED peaks bin for bin and heights rtol
1e-5; the planes and curves within 1e-5 of max, the order of the last sum
differs), the JAX package's mesh on its eight virtual devices (peak
frequencies within 1e-6 THz, heights rtol 1e-4; planes within 1e-5 of
max) and, for the SED, the float64 oracle's peaks; each rank read half of
every pass over the trajectory.
"""
import numpy as np
import pytest
import torch

from psa_tpu import parallel as jpar
from psa_tpu.core.calculator import peaks_np
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu.ops.instantaneous import nearest_commensurate
from psa_tpu_torch.parallel import ArrayBlockSource, make_mesh, smoke

from conftest import reference_sed_oracle

torch.set_num_threads(1)

N_LAGS, N_PEAKS, SC = 8, 2, 8


@pytest.fixture(scope='module')
def case(tmp_path_factory):
    traj = make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2, n_frames=16,
                                          dt_ps=0.02, seed=9)
    freqs = np.fft.fftfreq(traj.n_frames, traj.dt_ps)
    keep = freqs >= 0
    k_dsf = nearest_commensurate(
        np.outer(np.linspace(0.3, 1.5, 6), [1, 0.5, 0]).astype(np.float32), traj.box_lengths)
    inputs = dict(k_sed=np.outer(np.linspace(0, 1.1, 9), [1, 0, 0]).astype(np.float32),
                  k_dsf=k_dsf, freq_idx=np.flatnonzero(keep), freqs_kept=freqs[keep]
                  .astype(np.float32), mean64=traj.positions.astype(np.float64).mean(0),
                  n_peaks=N_PEAKS, n_lags=N_LAGS, t_superchunk=SC, mesh_shape=(2, 2, 2),
                  atom_chunk=traj.n_atoms)
    workdir = tmp_path_factory.mktemp('multiproc')
    smoke.write_inputs(workdir, traj.positions, traj.velocities, **inputs)
    ranks = smoke.launch(workdir, world=2, device='cpu', backend='gloo', positions=4,
                         timeout=120)
    one = smoke.run_sweeps(make_mesh(shape=(2, 2, 2), devices=['cpu'] * 8),
                           ArrayBlockSource(traj.positions), ArrayBlockSource(traj.velocities),
                           inputs)
    return traj, inputs, ranks, one


def within(got, want, tol=1e-5):
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


def test_ranks_agree_and_equal_one_process(case):
    _, _, (r0, r1), one = case
    for key in smoke.RESULTS:
        np.testing.assert_array_equal(r0[key], r1[key])
    np.testing.assert_array_equal(r0['peak_freqs'], one['peak_freqs'])
    np.testing.assert_allclose(r0['peak_heights'], one['peak_heights'], rtol=1e-5)
    for key in smoke.RESULTS[3:]:
        within(r0[key], one[key])


def test_each_rank_reads_half_of_every_pass(case):
    traj, _, ranks, _ = case
    elements = traj.n_frames * traj.n_atoms
    passes = {'vel_elements': 3, 'pos_elements': 5}    # SED, DSF, VACF; DSF, S, ISF, self, MSD
    for key, n in passes.items():
        counts = [int(r[key]) for r in ranks]
        assert sum(counts) == n * elements
        assert all(c <= n * elements // 2 for c in counts), counts


def test_two_processes_match_jax_and_the_oracle(case):
    traj, inp, (r0, _), _ = case
    mesh = jpar.make_mesh(shape=(2, 2, 2))
    jf, jh, _ = jpar.sharded_sed_spectrum(mesh, traj.velocities, inp['mean64'], inp['k_sed'],
                                          t_superchunk=SC, freq_indices=inp['freq_idx'],
                                          n_peaks=N_PEAKS, peak_freqs_thz=inp['freqs_kept'])
    np.testing.assert_allclose(r0['peak_freqs'], jf, atol=1e-6)
    np.testing.assert_allclose(r0['peak_heights'], jh, rtol=1e-4)
    oracle = reference_sed_oracle(traj, inp['k_sed'])[inp['freq_idx']]
    of, oh, _ = peaks_np(np.sum(np.abs(oracle) ** 2, axis=-1), inp['freqs_kept'],
                         n_peaks=N_PEAKS)
    np.testing.assert_allclose(r0['peak_freqs'], of, atol=1e-6)
    np.testing.assert_allclose(r0['peak_heights'], oh, rtol=1e-4)
    s, c_l, c_t = jpar.sharded_dsf(mesh, traj.positions, traj.velocities, inp['k_dsf'],
                                   inp['freq_idx'], t_superchunk=SC)
    want = dict(s=s, c_long=c_l, c_trans=c_t,
                sk=jpar.sharded_sk(mesh, traj.positions, inp['k_dsf'], t_superchunk=SC),
                isf=jpar.sharded_isf(mesh, traj.positions, inp['k_dsf'], N_LAGS,
                                     t_superchunk=SC),
                dsf_self=jpar.sharded_dsf_self(mesh, traj.positions, inp['k_dsf'],
                                               inp['freq_idx'], atom_chunk=traj.n_atoms),
                msd=jpar.sharded_timecorr(mesh, traj.positions, 'msd', N_LAGS,
                                          atom_chunk=traj.n_atoms),
                vacf=jpar.sharded_timecorr(mesh, traj.velocities, 'vacf', N_LAGS,
                                           atom_chunk=traj.n_atoms))
    for key, w in want.items():
        within(r0[key], w)
