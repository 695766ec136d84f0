"""The check that decides ``correct``: the port agrees with the reference at a
small size on the CPU, and the control and each fault the cells can have
come out as not correct.  (One card, so no exchange between chips can be
left out.)"""
import numpy as np
import pytest
import torch

from benchmark.harness import cell

CELLS = [w['name'] for w in cell.load_spec()['workloads']]
SEED = 2**31 + 4099


def run(name, tiny, **kw):
    return cell.run_cell(name, SEED, 0.2, False, device='cpu', overrides=tiny[name], **kw)


@pytest.mark.parametrize('name', CELLS)
def test_the_port_agrees_with_the_reference(name, tiny):
    r = run(name, tiny)
    assert r['correct'], r['checks']
    assert r['attempted'] > 1 and r['failed'] == 0
    for c in r['checks'].values():
        assert c['value'] <= c['limit']


@pytest.mark.parametrize('name', CELLS)
def test_the_control_is_not_correct(name, tiny):
    r = run(name, tiny, control=True)
    assert not r['correct'], r['checks']


def lagged(call):
    """A step that hands back the previous call's answer."""
    prev = {}

    def f(calc, k, traffic):
        out = call(calc, k, traffic)
        last, prev['out'] = prev.get('out', out), out
        return last
    return f


def altered(call):
    """An answer altered where it is produced: one value of each call's first
    array scaled by 1.001, in a column drawn per call."""
    count = [0]

    def f(calc, k, traffic):
        out = call(calc, k, traffic)
        arrays = [np.array(x) for x in (out if isinstance(out, tuple) else (out,))]
        j = count[0] % arrays[0].shape[-2 if arrays[0].ndim == 3 else -1]
        count[0] += 1
        target = arrays[1] if len(arrays) == 3 and cell_is_peaks(traffic) else arrays[0]
        if target.ndim == 3:
            target[:, j, :] *= 1.001
        else:
            target[:, j] *= 1.001
        return tuple(arrays) if isinstance(out, tuple) else arrays[0]
    return f


def cell_is_peaks(traffic):
    return traffic['surface'] == 'kgrid_peaks'


def half_batch(monkeypatch, name):
    """Half of the atoms left out of every sum, the rest counted double: the
    fault of the cell's system module, where its data reach the sums."""
    system = cell.cell_parts(name)[1]['system']
    cell.module('systems', system).halve_atoms(monkeypatch)


@pytest.mark.parametrize('name', CELLS)
@pytest.mark.parametrize('fault', ['unchanged_state', 'half_batch', 'altered_answer'])
def test_a_broken_timed_path_is_not_correct(name, fault, tiny, monkeypatch):
    if fault == 'half_batch':
        half_batch(monkeypatch, name)
        r = run(name, tiny)
    else:
        r = run(name, tiny, wrap_call=lagged if fault == 'unchanged_state' else altered)
    assert not r['correct'], (fault, r['checks'])


@pytest.mark.chip
@pytest.mark.parametrize('name', CELLS)
def test_the_control_is_not_correct_at_the_cells_size(name):
    """The control at the cell's own size and load, on the card
    (``benchmark/tools/readings.py --control`` reads it on more seeds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    r = cell.run_cell(name, SEED, 4.0, False, device='cuda', control=True)
    assert not r['correct'], r['checks']
