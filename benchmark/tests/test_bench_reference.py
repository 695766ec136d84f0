"""The reference computes on the device it is given, from data held
anywhere: a host NumPy array, a CPU tensor or a tensor on the card give the
same numbers."""
import numpy as np
import pytest
import torch

from benchmark.harness import cell, ksets
from benchmark.reference import dsf, sed

SEED = 2**31 + 77
KPATH = 'si100k.kpath_calculate'


def a_cell_of(system: str) -> str:
    """The first cell whose configuration's system is ``system``."""
    return next(w['name'] for w in cell.load_spec()['workloads']
                if cell.cell_parts(w['name'])[1]['system'] == system)


def inputs_and_k(name, device, overrides=None):
    """The cell's inputs made from :data:`SEED` on ``device``, and its first call's k."""
    _, config, traffic, _ = cell.cell_parts(name, overrides=overrides)
    inputs = cell.module('systems', config['system']).make(config, SEED, device)
    return inputs, ksets.KSets(traffic['kset'], SEED, inputs.box_lengths)(0)


def test_host_held_data_give_the_same_reference_on_the_cpu(tiny):
    cpu = torch.device('cpu')
    crystal = a_cell_of('crystal_waves')
    inputs, k = inputs_and_k(crystal, cpu, tiny[crystal])
    held = sed.phi(inputs.data, inputs.sites64, k)
    assert np.array_equal(sed.phi(inputs.data.numpy(), inputs.sites64, k), held)
    assert np.array_equal(sed.phi(inputs.data.numpy(), inputs.sites64, k, device=cpu), held)
    peaks = sed.kgrid_peaks(inputs.data, inputs.sites64, k, inputs.dt_ps, 3, 4)
    for a, b in zip(sed.kgrid_peaks(inputs.data.numpy(), inputs.sites64, k, inputs.dt_ps, 3, 4,
                                    device=cpu), peaks):
        assert np.array_equal(a, b)

    name = a_cell_of('liquid_walk')
    liquid, k = inputs_and_k(name, cpu, tiny[name])
    held = dsf.planes(torch.from_numpy(liquid.positions), torch.from_numpy(liquid.velocities), k)
    for a, b in zip(dsf.planes(liquid.positions, liquid.velocities, k, device=cpu), held):
        assert np.array_equal(a, b)


@pytest.mark.chip
def test_host_held_data_give_the_same_reference_on_the_card():
    """At the click cell's own size (12.0 GB of velocities), one call's 250 k:
    the float64 Φ from the data copied to the host, computed on the card,
    against the Φ from the data where the cell holds them, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device('cuda', torch.cuda.current_device())
    inputs, k = inputs_and_k(KPATH, dev)
    held = sed.phi(inputs.data, inputs.sites64, k, device=dev)
    host = inputs.data.cpu().numpy()
    from_host = sed.phi(host, inputs.sites64, k, device=dev)
    err = float(np.abs(from_host - held).max() / np.abs(held).max())
    print(f"host-held against device-held reference: {err!r} of max|Phi|")
    assert err <= 1e-12
