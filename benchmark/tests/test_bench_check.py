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
    """Half of the atoms left out of every sum, the rest counted double."""
    if name == 'lj32k.dsf_path':
        from psa_tpu_torch.ops import instantaneous
        orig = instantaneous.accumulate_modes

        def accumulate(acc_re, acc_im, pos, vel, *args, **kwargs):
            w = torch.full((pos[:, ::2].shape[1],), 2.0, dtype=torch.float32, device=pos.device)
            orig(acc_re, acc_im, pos[:, ::2], None if vel is None else vel[:, ::2], *args,
                 **dict(kwargs, weights=w))
        monkeypatch.setattr(instantaneous, 'accumulate_modes', accumulate)
        return
    from psa_tpu_torch import SEDCalculator
    orig = SEDCalculator._group_device_arrays

    def arrays(self, group_idx):
        data, hi, lo = orig(self, group_idx)
        keep = torch.zeros(data.shape[1], dtype=data.dtype, device=data.device)
        keep[::2] = 2.0
        return data * keep[None, :, None], hi, lo
    monkeypatch.setattr(SEDCalculator, '_group_device_arrays', arrays)


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
