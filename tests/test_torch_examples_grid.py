"""The k-grid, DOS and spectral-statistics examples, ported
(``examples_torch/``), against the JAX scripts (``examples/``) on the same
seeded trajectories: planes, spectra and the DOS to 1e-6 of max, peak bins
equal, chiral phases to 1e-4 rad where both components are strong, the
same printed checks and the same files."""
import numpy as np
import pytest
import torch

from torch_examples_harness import assert_close, assert_strong_phase, run_both

torch.set_num_threads(1)


@pytest.fixture
def both(tmp_path, monkeypatch, capsys):
    return lambda name: run_both(name, tmp_path, monkeypatch, capsys)


def test_grid_browse_and_engines(both):
    got, want = both('grid_browse_and_engines')
    np.testing.assert_array_equal(got['freqs'], want['freqs'].astype(got['freqs'].dtype))
    assert_close(got['intensity'], want['intensity'], 'browse intensity')
    rows = want['direct'].sed[:len(want['freqs'])]
    assert_strong_phase(got['phase'], want['phase'], rows[:, :, 0], rows[:, :, 1],
                        'browse chiral phase')
    assert_close(got['sed_g'], want['sed_g'].sed, 'gridded engine')
    assert_close(got['direct'], want['direct'].sed, 'direct engine')
    np.testing.assert_array_equal(got['pk_f'], want['pk_f'])
    assert_close(got['pk_h'], want['pk_h'], 'peak heights')
    assert_close(got['pk_w'], want['pk_w'], 'peak widths')


def test_chiral_phonons_2d(both):
    got, want = both('chiral_phonons_2d')
    np.testing.assert_array_equal(got['peak_freqs'], want['peak_freqs'])
    assert_close(got['peak_inten'], want['peak_inten'], 'peak heights')
    assert_close(got['peak_width'], want['peak_width'], 'peak widths')
    assert_close(got['inten'], want['inten'], 'browse intensity')
    fi, ki = want['fi'], want['ki']
    assert abs(got['phase'][fi, ki] - want['phase'][fi, ki]) < 1e-4


def test_dos_analysis(both):
    got, want = both('dos_analysis')
    np.testing.assert_allclose(got['freqs'], want['freqs'], rtol=1e-6)
    assert_close(got['dos'], want['dos'], 'partial DOS')


def test_spectral_statistics(both):
    got, want = both('spectral_statistics')
    assert_close(got['full'], want['full'].intensity, 'full spectrum')
    assert_close(got['welch'], want['welch'].intensity, 'Welch spectrum')
    assert_close(got['ensemble'], want['ens'].intensity, 'ensemble spectrum')
    for key in ('pk_full', 'pk_welch', 'pk_ens'):
        np.testing.assert_array_equal(got[key], want[key])
