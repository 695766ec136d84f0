"""Tests of the benchmark harness.  They run on the CPU at small sizes:
``pytest benchmark/tests``.  A test marked ``chip`` needs a CUDA card; it
decides inside the test and skips without one."""
import pytest

#: Small sizes of each cell, for the CPU: a few atoms and frames, small k-sets,
#: every k of a checked call compared.
SI = {'n_atoms': 64, 'n_frames': 128, 'waves': {'bins': [9, 25, 45]}}
LJ = {'cells': 2, 'n_frames': 64}
TINY = {
    'si100k.kgrid_peaks': {'config': SI, 'traffic': {'kset': {'n_x': 6, 'n_y': 6}},
                           'check': {'k_per_call': 36}},
    'si100k.kpath_calculate': {'config': SI, 'traffic': {'kset': {'n_k': 12}}},
    'si100k.kgrid200_gridded': {'config': SI,
                                'traffic': {'kset': {'n_x': 8, 'n_y': 8},
                                            'kwargs': {'k_grid_shape': [8, 8]}},
                                'check': {'k_per_call': 64}},
    'lj32k.dsf_path': {'config': LJ, 'traffic': {'kset': {'n_max': 8}}},
}


def pytest_configure(config):
    config.addinivalue_line('markers', 'chip: needs an NVIDIA GPU (CUDA); skipped without one')


@pytest.fixture
def tiny():
    return TINY
