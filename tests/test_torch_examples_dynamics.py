"""The transport, DSF and liquid examples, ported (``examples_torch/``),
against the JAX scripts (``examples/``) on the same seeded trajectories: the
DSF family's planes, S(k) and F_s to 1e-6 of max, the MSD to rtol
1e-5 and 1e-5 of max (``tests/test_torch_timecorr.py``'s bar), g(r)'s
pair counts but for pairs on a bin edge (C_T, a
cancellation residue on a longitudinal chain, to C_L's scale), the
dispersion sheet's bins equal, group velocities, lifetimes and κ to 1e-6
of max, the same printed checks and the same files."""
import numpy as np
import pytest
import torch

from torch_examples_harness import assert_close, run_both

torch.set_num_threads(1)


@pytest.fixture
def both(tmp_path, monkeypatch, capsys):
    return lambda name: run_both(name, tmp_path, monkeypatch, capsys)


def test_thermal_transport(both):
    got, want = both('thermal_transport')
    np.testing.assert_array_equal(got['band_freqs'], want['band_freqs'])
    assert_close(got['vx'], want['vx'], 'v_x')
    assert_close(got['vy'], want['vy'], 'v_y')
    res = want['res']
    assert_close(got['lifetimes'], res.lifetimes_ps, 'lifetimes')
    assert_close(got['kappa'], [res.kappa_xx, res.kappa_yy, res.kappa_xy], 'kappa')


def test_dynamic_structure_factor(both):
    got, want = both('dynamic_structure_factor')
    np.testing.assert_allclose(got['freqs'], want['freqs'], rtol=1e-6)
    for key in ('S', 'C_L', 'S_s'):
        assert_close(got[key], want[key], key)
    assert_close(got['C_T'], want['C_T'], 'C_T', scale=float(np.abs(want['C_L']).max()))


def moved_pairs(r, got, want, n_frames, n_atoms, box):
    """Per-bin difference of two g(r) of one group in pairs (the ideal-gas
    normalization of ``calculate_rdf``), checked to be whole pairs."""
    r = r.astype(np.float64)
    width = r[1] - r[0]
    edges = np.append(r - width / 2, r[-1] + width / 2)
    shell = 4.0 / 3.0 * np.pi * (edges[1:] ** 3 - edges[:-1] ** 3)
    ideal = n_frames * n_atoms * (n_atoms - 1) * shell / box ** 3
    pairs = (got.astype(np.float64) - want.astype(np.float64)) * ideal
    assert np.abs(pairs - np.rint(pairs)).max() < 0.2, pairs
    return np.rint(pairs).astype(np.int64)


def test_liquid_dynamics(both):
    got, want = both('liquid_dynamics')
    for key in ('s_s', 'sk', 'f_s'):
        assert_close(got[key], want[key], key)
    # two float32 FFT chains: tests/test_torch_timecorr.py's bar against JAX,
    # its atol taken of max (the lag-0 row cancels |r|² of 50 Å positions)
    np.testing.assert_allclose(got['msd'], want['msd'], rtol=1e-5,
                               atol=1e-5 * float(np.abs(want['msd']).max()))
    np.testing.assert_allclose(got['r_g'], want['r_g'], rtol=1e-6)
    # g(r) bin for bin but for pairs within a float32 rounding of a bin edge
    # (tests/test_torch_rdf.py: at most 4, each in the neighbouring bin)
    moved = moved_pairs(want['r_g'], got['g_r'], want['g_r'], 8, 512, 50.0)
    assert moved.sum() == 0 and np.abs(np.cumsum(moved)).max() <= 4
    np.testing.assert_allclose(got['d_est'], want['d_est'], rtol=1e-4)
