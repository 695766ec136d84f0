"""The harness finds its files by name, loads no JAX, and reduces traces right."""
import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark.harness import cell, cli, ksets, trace, workcount
from benchmark.tests.conftest import TINY

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / 'BENCHMARK.json').read_text())
CELLS = [w['name'] for w in SPEC['workloads']]


def test_benchmark_json_keys():
    assert set(SPEC) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                         'end_to_end', 'per_layer'}
    assert SPEC['paths'] == ['benchmark'] and SPEC['command'][1] == 'benchmark/run.py'
    names = [m['name'] for m in SPEC['end_to_end'] + SPEC['per_layer']]
    assert len(names) == len(set(names)) and 'setup_s' in names
    e2e = {m['name'] for m in SPEC['end_to_end']}
    for m in SPEC['per_layer']:
        assert m['moves'] in e2e
        for w in m.get('workloads', CELLS):
            reported = {e['name'] for e in cell.cell_metrics(SPEC, w, 'end_to_end')}
            assert m['moves'] in reported, (m['name'], w)


def four_chip_share_kept(spec) -> bool:
    """Every cell asks for 1 or 4 chips, and at most max(1, ⌊25% of the
    cells⌋) of them for 4."""
    chips = [w['chips'] for w in spec['workloads']]
    return set(chips) <= {1, 4} and chips.count(4) <= max(1, len(chips) // 4)


def assert_found_by_name(spec, name):
    c, config, traffic, check = cell.cell_parts(name, spec)
    assert c['chips'] in (1, 4) and four_chip_share_kept(spec), [
        (w['name'], w['chips']) for w in spec['workloads']]
    for key in ('source', 'precision', 'guarantee', 'reduced', 'assumed'):
        assert key in config
    system = cell.module('systems', config['system'])
    surface = cell.module('surfaces', traffic['surface'])
    assert callable(system.make)
    for fn in ('call', 'select', 'check', 'work'):
        assert callable(getattr(surface, fn))
    assert set(check['limits']) and check['calls'] > 0 and check['k_per_call'] > 0
    assert check['control']['kind'] in ('program_precision', 'reference_tf32')
    for m in cell.cell_metrics(spec, name, 'per_layer'):
        assert callable(cell.module('metrics', m['name']).read)


@pytest.mark.parametrize('name', CELLS)
def test_every_file_is_found_by_name(name):
    assert_found_by_name(SPEC, name)


def test_a_cell_on_four_chips_is_found_within_its_share():
    spec = copy.deepcopy(SPEC)
    cells = spec['workloads']
    allowed = max(1, len(cells) // 4)
    for w in cells[:allowed]:
        w['chips'] = 4
    assert_found_by_name(spec, cells[0]['name'])
    cells[allowed]['chips'] = 4                     # one beyond the 25% share
    with pytest.raises(AssertionError):
        assert_found_by_name(spec, cells[0]['name'])
    cells[allowed]['chips'] = 2                     # neither 1 nor 4
    with pytest.raises(AssertionError):
        assert_found_by_name(spec, cells[allowed]['name'])


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_has_its_small_sizes(name):
    assert (TINY / f'{name}.json').is_file(), f"no {TINY.name}/{name}.json: the cell's small sizes"
    assert set(json.loads((TINY / f'{name}.json').read_text())) <= {'config', 'traffic', 'check'}


def test_every_system_module_has_its_half_atoms_fault():
    systems = sorted(p.stem for p in (ROOT / 'benchmark' / 'systems').glob('*.py')
                     if p.stem != '__init__')
    assert systems
    for name in systems:
        assert callable(cell.module('systems', name).halve_atoms), name


def test_config_files_name_their_source():
    for c in SPEC['configs']:
        config = json.loads((ROOT / c['file']).read_text())
        assert config['name'] == c['name'] and config['source'] == c['source']
        assert config['reduced'] == c['reduced']


def test_forbidden_names_compare_whole_top_level_names():
    assert cli.forbidden_modules(['jax.numpy', 'psa_tpu_torch.ops', 'psa_tpu', 'flaxen',
                                  'numpy']) == ['jax', 'psa_tpu']


def _subprocess(code: str) -> str:
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_a_run_loads_no_jax_nor_the_jax_package(tiny):
    code = ("import json, sys; sys.path.insert(0, '.')\n"
            "from benchmark.harness.cell import run_cell\n"
            "from benchmark.harness.cli import forbidden_modules\n"
            f"tiny = json.loads({json.dumps(tiny)!r})\n"
            "for name, over in tiny.items():\n"
            "    for trace in (False, True):\n"
            "        assert run_cell(name, 5, 0.05, trace, device='cpu', overrides=over)['correct']\n"
            "print(json.dumps(forbidden_modules()))\n")
    assert json.loads(_subprocess(code).strip().splitlines()[-1]) == []


def test_the_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference.sed, benchmark.reference.dsf, benchmark.reference.lattice\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    tops = set(json.loads(_subprocess(code).strip().splitlines()[-1]))
    assert not tops & {'jax', 'jaxlib', 'flax', 'psa_tpu', 'psa_tpu_torch'}


def test_run_py_refuses_without_a_card():
    if __import__('torch').cuda.is_available():
        pytest.skip("a CUDA card is present")
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', CELLS[0],
                          '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ''


def test_run_py_refuses_without_the_program(tmp_path):
    shutil.copy(ROOT / 'BENCHMARK.json', tmp_path)
    shutil.copytree(ROOT / 'benchmark', tmp_path / 'benchmark',
                    ignore=shutil.ignore_patterns('__pycache__'))
    out = subprocess.run([sys.executable, 'benchmark/run.py', '--workload', CELLS[0],
                          '--seed', '1', '--seconds', '1', '--trace', '0'], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ''


def test_union_idle_share_and_per_call_readers():
    tr = trace.Trace(window=(0.0, 100.0), calls=[(0.0, 50.0), (50.0, 100.0)],
                     device=[('kernel', 'sed_projection_kernel', 10.0, 40.0),
                             ('kernel', 'void regular_fft_factor<16u>', 35.0, 50.0),
                             ('kernel', 'sm80_xmma_gemm_f32f32', 52.0, 56.0),
                             ('copy', 'Memcpy DtoH (Device -> Pinned)', 60.0, 70.0),
                             ('memset', 'Memset (Device)', 90.0, 95.0),
                             ('kernel', 'late_kernel', 98.0, 130.0)],
                     host=[('bench.window', 0.0, 100.0), ('bench.call', 0.0, 50.0),
                           ('bench.call', 50.0, 100.0),
                           ('cudaStreamSynchronize', 55.0, 60.0),
                           ('cudaMemcpyAsync', 56.0, 57.0), ('cudaMemcpy', 71.0, 89.0),
                           ('cudaStreamSynchronize', 120.0, 121.0)])
    # busy: [10, 50] + [52, 56] + [60, 70] + [90, 95] + [98, 100] = 40 + 4 + 10 + 5 + 2
    assert tr.busy_ns() == 61.0
    record = {'n_calls': 2, 'work': [None, None]}
    read = lambda m, rec=record: cell.module('metrics', m).read(tr, rec)  # noqa: E731
    assert read('device_idle_pct') == pytest.approx(39.0)
    assert read('host_syncs_per_call') == 1.0          # two blocking calls in the window
    assert read('fft_ms_per_call') == pytest.approx(15.0 / 1e6 / 2)
    assert read('dtoh_ms_per_call') == pytest.approx(10.0 / 1e6 / 2)
    assert read('gridded_gemm_ms_per_call') == pytest.approx(4.0 / 1e6 / 2)
    assert read('phases_ms_per_call') == pytest.approx((30.0 + 4.0 + 2.0) / 1e6 / 2)
    assert read('proj_roofline') is None                 # no work counted
    gaps = dict(tr.idle_gaps())
    # gaps [0,10] and [95,98] and [50,52] fall inside a call outside any op,
    # [56,60] in a stream synchronize, [70,90] in a synchronous copy
    assert gaps == pytest.approx({'bench.call (host code outside torch ops)': 15e-9,
                                  'cudaStreamSynchronize': 4e-9, 'cudaMemcpy': 20e-9})
    assert tr.top_device_ops(1) == [['sed_projection_kernel', 30.0 / 1e9]]


def test_roofline_share_from_the_work_count():
    n_t, a, k = 10_000, 100_000, 500
    flops = workcount.projection_flops(n_t, a, k)
    assert flops == 2 * (3 * n_t) * (2 * k) * a
    nbytes = workcount.projection_bytes(n_t, a, k, 0)
    bound = workcount.bound_seconds(flops, nbytes)
    assert bound == pytest.approx(12.121e-3, rel=1e-3)     # PERF.md's 12.121 ms at 495 TFLOP/s
    tr = trace.Trace(window=(0.0, 1e9), calls=[(0.0, 1e9)],
                     device=[('kernel', 'sed_projection_kernel', 0.0, 2 * bound * 1e9),
                             ('kernel', 'regular_fft', 0.0, 1e6),
                             ('copy', 'Memcpy DtoH', 0.0, 1e6)])
    share = cell.module('metrics', 'proj_roofline').read(tr, {'n_calls': 1,
                                                              'work': [(flops, nbytes)]})
    assert share == pytest.approx(50.0)


def test_ksets_follow_the_calculators_generators_and_the_seed():
    torch = pytest.importorskip('torch')
    from psa_tpu_torch import SEDCalculator
    from psa_tpu_torch.core.trajectory import Trajectory, make_box_arrays
    box = np.diag([10.0] * 3).astype(np.float32)
    traj = Trajectory(np.zeros((4, 2, 3), np.float32), np.zeros((4, 2, 3), np.float32),
                      np.ones(2, np.int32), np.arange(4, dtype=np.float32), box,
                      *make_box_arrays(box), dt_ps=0.01)
    calc = SEDCalculator(traj, 1, 1, 1, device='cpu')
    assert np.array_equal(ksets.grid('xy', (-5, 5), (-5, 5), 50, 50),
                          calc.get_k_grid('xy', (-5, 5), (-5, 5), 50, 50)[1])
    assert np.array_equal(ksets.path([1, 0, 0], 4.0, 250, 5.43)[1],
                          calc.get_k_path('x', bz_coverage=4.0, n_k=250, lat_param=5.43)[1])
    spec = {'kind': 'grid', 'plane': 'xy', 'range_x': [-5, 5], 'range_y': [-5, 5],
            'n_x': 50, 'n_y': 50, 'vary': 'shift'}
    a, b = ksets.KSets(spec, 2**31 + 7, [10] * 3), ksets.KSets(spec, 2**31 + 7, [10] * 3)
    assert np.array_equal(a(3), b(3)) and not np.array_equal(a(3), a(4))
    step = 10 / 49
    off = a(3)[0] - ksets.grid('xy', (-5, 5), (-5, 5), 50, 50)[0]
    assert 0 <= off[0] < step and 0 <= off[1] < step and off[2] == 0
    alt = ksets.KSets(dict(spec, vary='alternate', n_grids=2), 9, [10] * 3)
    assert np.array_equal(alt(0), alt(2)) and not np.array_equal(alt(0), alt(1))
    axis = ksets.KSets({'kind': 'commensurate_axis', 'n_min': 1, 'n_max': 4, 'axes': [0, 1, 2]},
                       1, [10.0, 20.0, 40.0])
    ks = [axis(i) for i in range(3)]
    assert sorted(int(np.flatnonzero(k[0])[0]) for k in ks) == [0, 1, 2]
    for k in ks:
        ax = int(np.flatnonzero(k[0])[0])
        assert np.allclose(k[:, ax], np.arange(1, 5) * 2 * np.pi / [10.0, 20.0, 40.0][ax])


def test_busy_time_of_each_card():
    tr = trace.Trace(window=(0.0, 100.0),
                     device=[('kernel', 'a', 0.0, 40.0), ('kernel', 'b', 20.0, 60.0),
                             ('kernel', 'c', 50.0, 70.0), ('copy', 'Memcpy DtoH', 90.0, 120.0)],
                     cards=[0, 1, 0, 1])
    assert tr.busy_ns() == 80.0                     # [0, 70] and [90, 100], whichever card
    assert tr.busy_ns(card=0) == 60.0               # [0, 40] and [50, 70]
    assert tr.busy_ns(card=1) == 50.0               # [20, 60] and [90, 100]
    assert tr.busy_ns(card=2) == 0.0
    card = __import__('torch').device('cuda', 0)
    assert cell.cards(card, 1) == [card]
    assert [d.index for d in cell.cards(card, 4)] == [0, 1, 2, 3]
