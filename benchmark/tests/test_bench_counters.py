"""The program's counters over the window, in the record a per-layer reader
gets, and the reader of ``dtoh_bytes``."""
import sys

import pytest

from benchmark.harness import cell, trace

KPATH = 'si100k.kpath_calculate'
#: Bytes a wrapped call adds to ``dtoh_bytes`` (on the CPU the program reads nothing back).
PER_CALL = 1000


def counting(call):
    """The call, with ``dtoh_bytes`` raised by :data:`PER_CALL` each time."""
    from psa_tpu_torch.utils import profiling

    def f(calc, k, traffic):
        profiling.count('dtoh_bytes', PER_CALL)
        return call(calc, k, traffic)
    return f


def test_the_record_holds_what_the_window_counted(tiny):
    from psa_tpu_torch.utils import profiling
    profiling.count('dtoh_bytes', 10**12)          # the process's total before the run
    out = cell.run_cell(KPATH, 7, 0.2, True, device='cpu', overrides=tiny[KPATH],
                        wrap_call=counting)
    assert out['correct'] and out['attempted'] > 1
    # neither the total nor the three warm-up calls' counts, which came before the window
    assert out['metrics']['dtoh_mb_per_call'] == {'value': pytest.approx(PER_CALL / 1e6,
                                                                         rel=1e-12),
                                                  'unit': 'MB'}


def test_a_program_without_counters_reads_no_counter_metric(tiny, monkeypatch):
    monkeypatch.setitem(sys.modules, 'psa_tpu_torch.utils.profiling', None)
    assert cell.program_counters() is None
    monkeypatch.undo()
    monkeypatch.setattr(cell, 'program_counters', lambda: None)
    out = cell.run_cell(KPATH, 7, 0.2, True, device='cpu', overrides=tiny[KPATH],
                        wrap_call=counting)
    assert out['correct']
    assert 'dtoh_mb_per_call' not in out['metrics']
    assert 'assemble_idle_ms_per_call' in out['metrics']


def test_dtoh_reader():
    read = cell.module('metrics', 'dtoh_mb_per_call').read
    tr = trace.Trace(window=(0.0, 1.0))
    assert read(tr, {'n_calls': 964, 'work': [],
                     'counters': {'dtoh_bytes': 964 * 60_000_000}}) == 60.0
    assert read(tr, {'n_calls': 4, 'work': [], 'counters': {}}) is None
    assert read(tr, {'n_calls': 4, 'work': [], 'counters': {'htod_bytes': 8}}) is None
    assert read(tr, {'n_calls': 0, 'work': [], 'counters': {'dtoh_bytes': 8}}) is None
