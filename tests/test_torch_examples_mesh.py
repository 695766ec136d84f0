"""The NPT, mesh and plotting examples, ported (``examples_torch/``), against
the JAX scripts (``examples/``): the NPT spectra and browse planes to 1e-6 of
max, equal peak bins where a column holds a line; the mesh example's planes and peak surfaces (its
port on a virtual mesh of eight CPU positions, the JAX side on its eight
virtual CPU devices) to the tolerances of ``tests/test_torch_parallel.py``;
the plotting example's synthetic spectra equal; the same printed checks and
the same files."""
import numpy as np
import torch

from torch_examples_harness import (assert_close, assert_same_checks, run_both, run_jax,
                                    run_port, written)

torch.set_num_threads(1)


def test_npt_cell_sed(tmp_path, monkeypatch, capsys):
    want, jax_out = run_jax('npt_cell_sed', tmp_path, monkeypatch, capsys)
    got, port_out = run_port('npt_cell_sed', tmp_path, monkeypatch, capsys)
    assert_same_checks(port_out, jax_out)
    # the JAX script writes beside itself, the port under sed_output/
    jax_files = sorted(p.name for p in (tmp_path / 'jax' / 'npt_cell_sed' / 'output').iterdir())
    assert written(tmp_path / 'port') == jax_files == ['npt_vs_fixed.png']
    for key in ('I_fix', 'I_npt', 'inten_b'):
        assert_close(got[key], want[key], key)
    assert_close(got['pi'], want['pi'], 'peak heights')
    # peak bins of the columns with a line (the others peak on a residue)
    lines = want['pi'] > 1e-3 * want['pi'].max()
    assert lines[0, want['col']]
    np.testing.assert_array_equal(got['pf'][lines], want['pf'][lines])


def test_pod_mesh_semantics(tmp_path, monkeypatch, capsys):
    _, jax_out = run_jax('pod_mesh_semantics', tmp_path, monkeypatch, capsys,
                         run_name='__main__')
    got, port_out = run_port('pod_mesh_semantics', tmp_path, monkeypatch, capsys)
    assert_same_checks(port_out, jax_out)

    # the script's four sweeps through the JAX package (its main keeps them local)
    from psa_tpu import SEDCalculator
    from psa_tpu.models import make_random_crystal_trajectory
    from psa_tpu.parallel import make_mesh
    traj = make_random_crystal_trajectory(n_cells_xyz=(4, 3, 2), basis=2, n_frames=32,
                                          dt_ps=0.02, seed=0)
    calc = SEDCalculator(traj, nx=4, ny=3, nz=2)
    mesh = make_mesh(n_t=traj.n_frames, n_atoms=traj.n_atoms, hbm_bytes='auto')
    _, k_vecs, shape = calc.get_k_grid('xy', (-1.5, 1.5), (-1.5, 1.5), 16, 16)
    _, inten1, _ = calc.calculate_kgrid_browse_sharded(mesh, k_vecs, basis_atom_types=[1])
    _, inten_inc, _ = calc.calculate_kgrid_browse_sharded(
        mesh, k_vecs, basis_atom_types=[1, 2], summation_mode='incoherent', t_superchunk=16)
    pf, ph, pw, pphase = calc.calculate_kgrid_peaks_sharded(
        mesh, k_vecs, n_peaks=1, chiral=True, chiral_axis='z', width_method='lorentzian')
    gpf, _, _ = calc.calculate_kgrid_peaks_sharded(mesh, k_vecs, n_peaks=1, engine='gridded',
                                                   k_grid_shape=shape)
    np.testing.assert_allclose(got['inten1'], inten1, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got['inten_inc'], inten_inc, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(got['pf'], pf, atol=1e-6)
    np.testing.assert_allclose(got['ph'], ph, rtol=1e-4)
    np.testing.assert_allclose(got['pw'], pw, rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(got['pphase'], pphase, atol=1e-4)
    np.testing.assert_allclose(got['gpf'], gpf, atol=1e-6)


def test_visualization_example(tmp_path, monkeypatch, capsys):
    got, want = run_both('visualization_example', tmp_path, monkeypatch, capsys)
    np.testing.assert_array_equal(got['sed'], want['sed'].sed)
    np.testing.assert_array_equal(got['grid'], want['sed_grid'].sed)
