"""The reader of the 'parity' kernel's angle-tile counters, in both cells'
names: the ratio with the counters, nothing without them."""
import pytest

from benchmark.harness import cell, trace


@pytest.mark.parametrize('name', ['proj_angle_reuse', 'proj_angle_reuse_click'])
def test_proj_angle_reuse_reader(name):
    tr = trace.Trace(window=(0.0, 1.0))
    read = cell.module('metrics', name).read
    counted = {'parity.time_tiles': 107 * 2 * 157 * 64, 'parity.angle_tiles': 107 * 2 * 79 * 64}
    assert read(tr, {'n_calls': 107, 'work': [], 'counters': counted}) == pytest.approx(157 / 79)
    assert read(tr, {'n_calls': 107, 'work': [], 'counters': {}}) is None
    assert read(tr, {'n_calls': 107, 'work': [],
                     'counters': {'launch.parity': 214, 'dtoh_bytes': 8}}) is None
    assert read(tr, {'n_calls': 0, 'work': [], 'counters': counted}) is None
