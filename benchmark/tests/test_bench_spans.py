"""The readers of the program's own ``psa.*`` spans, on synthetic traces and
on a traced CPU run of the click cell."""
import pytest

from benchmark.harness import cell, spans, trace


def _trace():
    # device busy [10, 40] and [60, 70]; idle [0, 10], [40, 60], [70, 100]
    return trace.Trace(window=(0.0, 100.0), calls=[(0.0, 50.0), (50.0, 100.0)],
                       device=[('kernel', 'sed_projection_kernel', 10.0, 40.0),
                               ('copy', 'Memcpy DtoH (Device -> Pinned)', 60.0, 70.0)],
                       host=[('bench.window', 0.0, 100.0), ('bench.call', 0.0, 50.0),
                             ('bench.call', 50.0, 100.0),
                             ('psa.host.assemble', -5.0, 5.0),        # clipped to [0, 5]
                             ('psa.host.assemble', 35.0, 55.0),       # idle [40, 55]
                             ('psa.host.assemble.sub', 50.0, 58.0),   # its child: [55, 58] more
                             ('psa.host.assemblex', 0.0, 100.0),      # another name
                             ('psa.readback.wait', 62.0, 75.0)])      # idle [70, 75]


def test_span_intervals_merge_a_prefix_and_its_children_inside_the_window():
    tr = _trace()
    assert spans.span_intervals(tr, 'psa.host.assemble') == [(0.0, 5.0), (35.0, 58.0)]
    assert spans.span_intervals(tr, 'psa.stage') == []
    assert spans.idle_intervals(tr) == [(0.0, 10.0), (40.0, 60.0), (70.0, 100.0)]


def test_idle_in_span():
    tr = _trace()
    assert spans.idle_in_span_ns(tr, 'psa.host.assemble') == pytest.approx(5.0 + 18.0)
    assert spans.idle_in_span_ns(tr, 'psa.readback.wait') == pytest.approx(5.0)
    assert spans.idle_in_span_ns(tr, 'psa.project') == 0.0
    assert spans.overlap_ns([(0, 2), (5, 9)], [(1, 6), (8, 20)]) == 1 + 1 + 1


def test_assemble_idle_reader():
    read = cell.module('metrics', 'assemble_idle_ms_per_call').read
    assert read(_trace(), {'n_calls': 2, 'work': []}) == pytest.approx(23.0 / 1e6 / 2)
    bare = _trace()
    bare.host = [h for h in bare.host if not h[0].startswith('psa.')]
    assert read(bare, {'n_calls': 2, 'work': []}) is None    # a program without the span
    assert read(_trace(), {'n_calls': 0, 'work': []}) is None


def test_the_click_cell_reads_its_assembly_on_the_cpu(tiny):
    out = cell.run_cell('si100k.kpath_calculate', 3, 0.2, True, device='cpu',
                        overrides=tiny['si100k.kpath_calculate'])
    assert out['correct']
    assert out['metrics']['assemble_idle_ms_per_call']['value'] >= 0.0
    assert out['metrics']['assemble_idle_ms_per_call']['unit'] == 'ms'
