"""The reader of the instantaneous-phase counters: the fused kernel's share of
the 'exact' elements with the counters, nothing without them."""
import pytest

from benchmark.harness import cell, trace


def test_phases_fused_share_reader():
    tr = trace.Trace(window=(0.0, 1.0))
    read = cell.module('metrics', 'phases_fused_share').read
    n = 31 * 10_000 * 32_000 * 128
    fused = {'phasor.fused_elems': n, 'phasor.exact_elems': n, 'launch.phasor_modes': 31}
    assert read(tr, {'n_calls': 31, 'work': [], 'counters': fused}) == 1.0
    assert read(tr, {'n_calls': 3, 'work': [],
                     'counters': {'phasor.fused_elems': 3, 'phasor.exact_elems': 4}}) == 0.75
    # the plain chain alone (a CPU run): counted, none fused
    assert read(tr, {'n_calls': 3, 'work': [], 'counters': {'phasor.exact_elems': 4}}) == 0.0
    # a program without the counters (the parent), or a window without calls
    assert read(tr, {'n_calls': 31, 'work': [], 'counters': {}}) is None
    assert read(tr, {'n_calls': 31, 'work': [], 'counters': {'dtoh_bytes': 8}}) is None
    assert read(tr, {'n_calls': 0, 'work': [], 'counters': fused}) is None


def test_the_cpu_dsf_cell_reads_no_fused_share(tiny):
    """On the CPU the DSF cell's 'exact' contractions run the plain chain:
    counted, none fused, so the share reads 0."""
    out = cell.run_cell('lj32k.dsf_path', 11, 0.2, True, device='cpu',
                        overrides=tiny['lj32k.dsf_path'])
    assert out['correct']
    assert out['metrics']['phases_fused_share'] == {'value': pytest.approx(0.0),
                                                    'unit': 'elems/elem'}
