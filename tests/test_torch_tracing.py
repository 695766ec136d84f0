"""The port's own tracing, ``psa_tpu_torch.utils.profiling.span`` and
``counters``, on the CPU.

Under ``torch.profiler`` the surfaces record the spans that
``utils/profiling.py`` documents, nested as documented (``psa.spectrum.peaks``
inside ``psa.spectrum``; the projection beside the spectrum, never inside it),
and return bit for bit what they return without a profiler.  Without one,
:func:`span` hands out one shared no-op and never builds a
``record_function``.  The counters replace the projection module's launch
globals and lose no count to threads; the CPU moves and launches nothing,
so none of them changes here but the count of the plain 'exact' chain's
phasor elements.
"""
import json
import sys
import threading

import numpy as np
import pytest
import torch

from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.models import make_random_crystal_trajectory
from psa_tpu_torch.ops import instantaneous
from psa_tpu_torch.ops import sed_projection as tproj
from psa_tpu_torch.utils import profiling
from psa_tpu_torch.utils.profiling import (count, counted_since, counters, kernel_launches,
                                           snapshot, span, trace)

torch.set_num_threads(1)

#: The spans the module docstring of ``utils/profiling.py`` names.
VOCABULARY = {'psa.project', 'psa.spectrum', 'psa.spectrum.peaks', 'psa.phases',
              'psa.gridded.spread', 'psa.gridded.budget', 'psa.readback.wait',
              'psa.host.assemble', 'psa.stage', 'psa.rdf.host'}
GRID = (4, 4)


@pytest.fixture(scope='module')
def calc():
    traj = make_random_crystal_trajectory(n_cells_xyz=(4, 3, 2), basis=2, n_frames=24,
                                          dt_ps=0.02, seed=8)
    return SEDCalculator(traj, nx=4, ny=3, nz=2, device='cpu')


def surfaces(calc):
    """name -> (call returning a tuple of arrays, spans it must record, spans it must not)."""
    kpath = calc.get_k_path('x', 1.0, 6)
    kgrid = calc.get_k_grid('xy', (-1.0, 1.0), (-1.0, 1.0), *GRID)[1]
    kdsf = instantaneous.nearest_commensurate(kpath[1], calc.traj.box_matrix)
    return {
        'calculate': (lambda: (calc.calculate(*kpath).sed,),
                      {'psa.project', 'psa.spectrum', 'psa.host.assemble'},
                      {'psa.spectrum.peaks', 'psa.phases', 'psa.gridded.spread'}),
        'kgrid_peaks': (lambda: calc.calculate_kgrid_peaks(kgrid, n_peaks=2, k_chunk_size=7),
                        {'psa.project', 'psa.spectrum', 'psa.spectrum.peaks',
                         'psa.host.assemble', 'psa.readback.wait'},
                        {'psa.phases', 'psa.gridded.spread'}),
        'kgrid_peaks_gridded': (lambda: calc.calculate_kgrid_peaks(
                                    kgrid, n_peaks=2, engine='gridded', k_grid_shape=GRID),
                                {'psa.gridded.spread', 'psa.spectrum', 'psa.spectrum.peaks',
                                 'psa.host.assemble'},
                                {'psa.project', 'psa.phases'}),
        'dsf': (lambda: calc.calculate_dsf(kdsf, k_chunk_size=4),
                {'psa.phases', 'psa.spectrum', 'psa.host.assemble'},
                {'psa.project', 'psa.spectrum.peaks', 'psa.gridded.spread'}),
    }


def profiled(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith('psa.')]
    return out, spans


def inside(inner, outers):
    return any(s <= inner[1] and inner[2] <= e for _, s, e in outers)


@pytest.mark.parametrize('name', ['calculate', 'kgrid_peaks', 'kgrid_peaks_gridded', 'dsf'])
def test_surfaces_record_the_documented_spans(calc, name):
    fn, want, absent = surfaces(calc)[name]
    plain = fn()
    got, spans = profiled(fn)
    names = {n for n, _, _ in spans}
    assert names <= VOCABULARY
    assert want <= names and not absent & names, sorted(names)
    by = {n: [sp for sp in spans if sp[0] == n] for n in names}
    for peaks in by.get('psa.spectrum.peaks', []):
        assert inside(peaks, by['psa.spectrum'])
    for proj in by.get('psa.project', []):
        assert not inside(proj, by['psa.spectrum'])
    for phases in by.get('psa.phases', []):
        assert not inside(phases, by['psa.spectrum'])
    assert len(got) == len(plain)
    for a, b in zip(got, plain):
        assert a.dtype == b.dtype and np.array_equal(a, b, equal_nan=True)


def test_the_module_docstring_names_every_span():
    for name in VOCABULARY:
        assert f'``{name}``' in profiling.__doc__, name


def test_span_without_a_profiler_is_one_shared_no_op(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) built with no profiler running")
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    first, second = span('psa.project'), span('psa.spectrum')
    assert first is second
    with first:
        with second:
            pass
    monkeypatch.undo()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with span('psa.stage'):
            torch.ones(4).sum()
    assert span('psa.stage') is first
    assert [e.name for e in prof.events() if e.name.startswith('psa.')] == ['psa.stage']


def test_a_span_records_nothing_outside_the_profiler():
    with span('psa.host.assemble'):
        torch.ones(4).sum()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.ones(4).sum()
    assert not [e for e in prof.events() if e.name.startswith('psa.')]


def test_the_launch_globals_are_counters():
    for gone in ('launches', 'table_launches', 'product_launches'):
        assert not hasattr(tproj, gone)
    assert tproj.counters is counters
    names = ('launch.parity', 'launch.table', 'launch.product', 'launch.phasor_modes')
    saved = {n: counters[n] for n in names}
    every = kernel_launches()
    try:
        for i, n in enumerate(names):
            counters[n] = saved[n] + 10 ** i
        assert tproj.kernel_launches() == sum(saved[n] for n in names[:3]) + 111
        assert kernel_launches() == every + 1111      # every kernel's launches, the phasors' too
    finally:
        counters.update({n: saved[n] - counters[n] for n in names})     # back as they were
    assert {n: counters[n] for n in names} == saved


def test_the_cpu_counts_no_launch_and_moves_no_bytes(calc):
    before = snapshot()
    for fn, _, _ in surfaces(calc).values():
        fn()
    tproj.sed_projection(torch.zeros((2, 4, 3)), torch.zeros((4, 3)), torch.zeros((4, 3)),
                         torch.zeros((3, 3)), precision='fast')
    # the DSF surface's plain 'exact' chain counts its (t, atom, k) elements, and only that
    n_k = len(instantaneous.nearest_commensurate(calc.get_k_path('x', 1.0, 6)[1],
                                                 calc.traj.box_matrix))
    assert counted_since(before) == {
        'phasor.exact_elems': calc.traj.n_frames * calc.traj.n_atoms * n_k}
    assert tproj.kernel_launches() == sum(before.get(n, 0) for n in (
        'launch.parity', 'launch.table', 'launch.product'))


def test_rdf_host_blocks_are_spans_and_the_timer_is_gone(calc):
    assert not hasattr(calc, '_last_rdf_host_seconds')
    _, spans = profiled(lambda: calc.calculate_rdf(r_max=2.0, n_bins=10, method='cells'))
    assert 'psa.rdf.host' in {n for n, _, _ in spans}
    assert not hasattr(calc, '_last_rdf_host_seconds')


def test_trace_writes_the_counters_change_beside_the_trace(tmp_path):
    count('test.tracing', 5)
    try:
        with trace(tmp_path / 'prof'):
            count('test.tracing', 3)
            with span('psa.stage'):
                torch.ones(8).sum()
        assert json.loads((tmp_path / 'prof' / 'counters.json').read_text()) == {
            'test.tracing': 3}
        events = json.loads((tmp_path / 'prof' / 'trace.json').read_text())['traceEvents']
        assert any(e.get('name') == 'psa.stage' for e in events)
    finally:
        del counters['test.tracing']


def test_counted_since_reports_only_what_moved():
    before = snapshot()
    assert counted_since(before) == {}
    count('test.moved', 2)
    try:
        assert counted_since(before) == {'test.moved': 2}
        assert 'test.moved' not in before           # a snapshot is a copy
    finally:
        del counters['test.moved']


def test_count_loses_nothing_across_threads():
    n_threads, n = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [count('test.threads') for _ in range(n)])
                   for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        assert counters['test.threads'] == n_threads * n
    finally:
        sys.setswitchinterval(old)
        del counters['test.threads']
