"""The four-card mesh cell on the CPU at its small sizes: the fault only a
mesh can have (the cards' partials left out of the sums) reads not correct;
a traced run shows the mesh's ingest span, and on one CPU no exchange; a
program without
resident meshes fails the cell at set-up; the mesh readers on synthetic
traces; the sharded reference loads nothing of the program."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import cell, trace, workcount

MESH = 'si1m.kgrid_peaks_mesh4'
SEED = 2**31 + 8191
ROOT = Path(__file__).resolve().parents[2]


def run(tiny, traced=False, **kw):
    return cell.run_cell(MESH, SEED, 0.2, traced, device='cpu', overrides=tiny[MESH], **kw)


def test_the_cell_is_correct_and_the_exchange_left_out_is_not(tiny, monkeypatch):
    assert run(tiny)['correct']
    from psa_tpu_torch.parallel import sharded
    exchange = sharded._exchange

    def first_only(dst, device, first, project):
        if first:
            exchange(dst, device, first, project)
    monkeypatch.setattr(sharded, '_exchange', first_only)
    r = run(tiny)
    assert not r['correct'] and r['failed'] == 0, r['checks']


def test_a_traced_run_shows_the_mesh_spans_and_counters(tiny, monkeypatch):
    kept = {}
    from_profiler = trace.from_profiler

    def keep(prof):
        kept['trace'] = from_profiler(prof)
        return kept['trace']
    monkeypatch.setattr(trace, 'from_profiler', keep)
    r = run(tiny, traced=True)
    assert r['correct']
    names = {name for name, _, _ in kept['trace'].host}
    assert {'psa.mesh.ingest', 'psa.project'} <= names
    # four positions of one CPU: the kernel adds every partial in place, none
    # moves between devices (on four cards three do, PERF.md)
    assert 'psa.mesh.exchange' not in names
    assert 'mesh_exchange_mb_per_call' not in r['metrics']
    assert 'mesh_idle_pct' not in r['metrics']            # the CPU records no device events


def test_a_program_without_resident_meshes_fails_at_set_up(tiny, monkeypatch):
    from psa_tpu_torch import SEDCalculator
    monkeypatch.delattr(SEDCalculator, 'preload_mesh_group_data')
    with pytest.raises(AttributeError):
        run(tiny)


def test_the_mesh_readers():
    ms = 1e6
    tr = trace.Trace(window=(0.0, 100 * ms), calls=[(0.0, 50 * ms), (50 * ms, 100 * ms)],
                     device=[('kernel', 'sed_projection_kernel', 0.0, 80 * ms),
                             ('kernel', 'sed_projection_kernel', 0.0, 60 * ms),
                             ('kernel', 'sed_projection_kernel', 0.0, 40 * ms),
                             ('copy', 'Memcpy PtoP (Device -> Device)', 60 * ms, 64 * ms),
                             ('kernel', 'regular_fft_factor', 80 * ms, 90 * ms),
                             ('copy', 'Memcpy DtoH (Device -> Pinned)', 90 * ms, 91 * ms)],
                     cards=[0, 1, 2, 1, 0, 0])
    read = lambda m, rec: cell.module('metrics', m).read(tr, rec)  # noqa: E731
    record = {'n_calls': 2, 'work': [None, None], 'counters': {'mesh.exchange_bytes': 72e8}}
    # idle per card: 0 → 9%, 1 → 36%, 2 → 60%, 3 → 100%
    assert read('mesh_idle_pct', record) == pytest.approx((9 + 36 + 60 + 100) / 4)
    assert read('mesh_exchange_ms_per_call', record) == pytest.approx(2.0)
    assert read('mesh_exchange_mb_per_call', record) == pytest.approx(3600.0)
    assert read('mesh_proj_roofline', record) is None          # no work counted
    flops, nbytes = workcount.projection_flops(20_000, 10**6, 2500), 0.0
    record['work'] = [(flops, nbytes)] * 2
    bound = 2 * workcount.bound_seconds(flops / 4, 0.0)
    # kernels but cuFFT's per card: 80, 60, 40 and 0 ms, mean 45 ms
    assert read('mesh_proj_roofline', record) == pytest.approx(100.0 * bound / 45e-3)
    bare = trace.Trace(window=(0.0, 1.0))
    empty = {'n_calls': 0, 'work': [], 'counters': {}}
    for name in ('mesh_idle_pct', 'mesh_exchange_ms_per_call', 'mesh_exchange_mb_per_call',
                 'mesh_proj_roofline'):
        assert cell.module('metrics', name).read(bare, empty) is None


def test_the_sharded_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference.sed_shards\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {'jax', 'jaxlib', 'flax', 'psa_tpu', 'psa_tpu_torch'}
