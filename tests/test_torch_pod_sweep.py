"""``python -m psa_tpu_torch.pod_sweep`` against ``scripts/pod_sweep.py`` on
one LAMMPS dump: the JAX script on its eight virtual CPU devices, the port
with ``--device cpu --positions 8``, each as a user runs it.  The result
files hold the same arrays under the same keys (peak frequencies within
1e-6 THz, heights and widths rtol 1e-4, DSF planes within 1e-5 of max, the
rest equal), both write their chunks under one cache key, and a rerun of
the port resumes every chunk from its cache.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from psa_tpu.models import make_square_lattice_trajectory

ROOT = Path(__file__).resolve().parents[1]


def within(got, want, tol):
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1.0)


JAX_RUNNER = ("import sys, jax; jax.config.update('jax_platforms', 'cpu'); "
              "sys.argv = ['pod_sweep.py'] + sys.argv[1:]; import runpy; "
              f"runpy.run_path({str(ROOT / 'scripts' / 'pod_sweep.py')!r}, run_name='__main__')")


@pytest.fixture(scope='module')
def square_dump(tmp_path_factory):
    traj = make_square_lattice_trajectory(n_cells=8, n_frames=48, dt_ps=0.01)
    dump = tmp_path_factory.mktemp("podsweep") / "sq.dump"
    with open(dump, "w") as f:
        for t in range(traj.n_frames):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{traj.n_atoms}\n")
            f.write("ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                f.write(f"0.0 {traj.box_matrix[d, d]:.6f}\n")
            f.write("ITEM: ATOMS id type x y z vx vy vz\n")
            for a in range(traj.n_atoms):
                p, v = traj.positions[t, a], traj.velocities[t, a]
                f.write(f"{a + 1} 1 {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
    return dump


def run(cmd, args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), JAX_PLATFORMS='cpu',
               XLA_FLAGS='--xla_force_host_platform_device_count=8')
    proc = subprocess.run(cmd + args, capture_output=True, text=True, timeout=300, env=env,
                          cwd=str(ROOT))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc.stdout + proc.stderr


POD_CASES = {
    'peaks': (['--grid', '8', '--k-chunk', '32', '--peaks', '1'], 'kgrid_peaks.npz'),
    'gridded-peaks': (['--grid', '8', '--k-chunk', '64', '--peaks', '1', '--engine',
                       'gridded', '--t-superchunk', '16'], 'kgrid_peaks.npz'),
    'dsf': (['--grid', '6', '--k-min', '-1.0', '--k-max', '1.0', '--k-chunk', '20', '--dsf'],
            'kgrid_dsf.npz'),
}


@pytest.mark.parametrize('case', list(POD_CASES))
def test_pod_sweep_files_match_the_jax_script(square_dump, tmp_path, case):
    extra, name = POD_CASES[case]
    args = ['--trajectory', str(square_dump), '--dt', '0.01', '--nx', '8', '--ny', '8',
            '--nz', '1', '--k-min', '-1.2', '--k-max', '1.2', '--from-dump'] + extra
    run([sys.executable, '-c', JAX_RUNNER], args + ['--out', str(tmp_path / 'jax')])
    port_args = args + ['--out', str(tmp_path / 'port'), '--device', 'cpu', '--positions', '8']
    run([sys.executable, '-m', 'psa_tpu_torch.pod_sweep'], port_args)
    want, got = (np.load(tmp_path / d / name) for d in ('jax', 'port'))
    assert sorted(got.files) == sorted(want.files)
    # one cache key: the chunk directory names agree
    assert (sorted(os.listdir(tmp_path / 'port' / 'chunks'))
            == sorted(os.listdir(tmp_path / 'jax' / 'chunks')))
    for key in want.files:
        if key == 'peak_freqs':
            np.testing.assert_allclose(got[key], want[key], atol=1e-6)
        elif key in ('peak_heights', 'peak_widths'):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6)
        elif key in ('s', 'c_long', 'c_trans'):
            within(got[key], want[key], 1e-5)
        else:
            np.testing.assert_array_equal(got[key], want[key])
    if case == 'peaks':                               # a rerun resumes from the cache
        out = run([sys.executable, '-m', 'psa_tpu_torch.pod_sweep'], port_args)
        assert '0/64 k-points computed' in out
        np.testing.assert_array_equal(np.load(tmp_path / 'port' / name)['peak_freqs'],
                                      got['peak_freqs'])
