"""The examples of BASELINE.json's four configurations, ported
(``examples_torch/``), against the JAX scripts (``examples/``) on the same
seeded trajectories: the spectra to 1e-6 of max, the chiral phase to 1e-4
rad where both components are strong, the iSED dump's coordinates to 2e-5 Å
(its text precision), the same printed checks and the same files."""
import numpy as np
import pytest
import torch

from torch_examples_harness import assert_close, assert_strong_phase, dump_coords, run_both

torch.set_num_threads(1)


@pytest.fixture
def both(tmp_path, monkeypatch, capsys):
    return lambda name: run_both(name, tmp_path, monkeypatch, capsys)


def test_basic_sed_analysis(both):
    got, want = both('basic_sed_analysis')
    assert_close(got['sed'], want['sed'].sed, 'chain SED')
    np.testing.assert_array_equal(got['peaks'], want['peaks'])


def test_chiral_sed_analysis(both):
    got, want = both('chiral_sed_analysis')
    assert_close(got['sed'], want['sed'].sed, '[110] SED')
    assert_strong_phase(got['phase'], want['phase'], want['sed'].sed[:, :, 0],
                        want['sed'].sed[:, :, 1], 'chiral phase')


def test_k_grid_heatmap_example(both):
    got, want = both('k_grid_heatmap_example')
    assert_close(got['sed'], want['sed'].sed, '51x51 k-grid SED')
    assert got['vmax'] == pytest.approx(want['vmax'], rel=1e-6)


def test_ised_reconstruction(both, tmp_path):
    got, _ = both('ised_reconstruction')
    want = tmp_path / 'jax' / 'sed_output' / 'ised_motion.dump'
    np.testing.assert_allclose(dump_coords(got['dump']), dump_coords(want), atol=2e-5)
