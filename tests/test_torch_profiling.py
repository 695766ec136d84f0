"""psa_tpu_torch's profiling and debug helpers against the JAX package's.

The counterparts of ``tests/test_aux.py::TestProfiling`` on
``psa_tpu_torch.utils.profiling`` (``throughput_report`` equal to the JAX
module's numbers: it is arithmetic), ``trace`` writing a loadable chrome
trace on the CPU, the command line's ``--profile`` writing the same file
through it, and ``psa_tpu_torch.utils.debug``: a NaN fed to a compute raises
``FloatingPointError`` naming the call while the mode is on, and no check is
called while it is off.
"""
import inspect
import json
import logging

import numpy as np
import pytest
import torch

from psa_tpu.utils import debug as jax_debug
from psa_tpu.utils import profiling as jax_profiling
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.models import make_chain_trajectory
from psa_tpu_torch.ops.sed_projection import sed_projection
from psa_tpu_torch.utils import debug, profiling
from psa_tpu_torch.utils.profiling import (Timer, progress_iter, sync, throughput_report, timed,
                                           trace)
from psa_tpu_torch.utils.transfer import DeviceToHost

torch.set_num_threads(1)


@pytest.mark.parametrize("module,twin", [(profiling, jax_profiling), (debug, jax_debug)])
def test_public_names_and_signatures_match_the_jax_module(module, twin):
    for name, obj in vars(twin).items():
        if name.startswith('_') or getattr(obj, '__module__', None) != twin.__name__:
            continue
        mine = getattr(module, name)
        if inspect.isfunction(obj):
            assert list(inspect.signature(mine).parameters) == \
                list(inspect.signature(obj).parameters), name
    assert sorted(Timer.__dataclass_fields__) == sorted(jax_profiling.Timer.__dataclass_fields__)


class TestProfiling:
    def test_timer_sections(self):
        t = Timer()
        with t.section('a'):
            pass
        with t.section('a'):
            pass
        with t.section('b'):
            pass
        assert t.counts == {'a': 2, 'b': 1}
        rep = t.report()
        assert 'TOTAL' in rep and 'a' in rep
        assert rep.splitlines()[0] == jax_profiling.Timer().report().splitlines()[0]

    def test_timer_counts_a_section_that_raises(self):
        t = Timer()
        with pytest.raises(KeyError):
            with t.section('boom'):
                raise KeyError('x')
        assert t.counts == {'boom': 1} and t.sections['boom'] >= 0.0

    @pytest.mark.parametrize("kwargs", [
        dict(n_k=100, seconds=2.0, n_atoms=1000, n_t=512),
        dict(n_k=2500, seconds=0.37, n_atoms=100_000, n_t=10_000),
        dict(n_k=7, seconds=0.0, n_atoms=3, n_t=1),
        dict(n_k=64, seconds=1.5, n_atoms=512, n_t=200, n_pol=2),
    ])
    def test_throughput_report(self, kwargs):
        r = throughput_report(**kwargs)
        assert r == jax_profiling.throughput_report(**kwargs)
        if kwargs['seconds'] > 0:
            assert r['k_points_per_sec'] == kwargs['n_k'] / kwargs['seconds']
            assert r['effective_tflops'] > 0

    def test_sync_and_timed(self, caplog):
        x = torch.ones((4, 4))
        sync(x)
        sync({'a': x, 'b': (x, [x, None]), 'c': np.ones(3)})
        sync(None)
        with caplog.at_level(logging.INFO, logger=profiling.logger.name):
            with timed("block", sync_tree=x):
                pass
        assert any(r.getMessage().startswith("block: ") for r in caplog.records)

    def test_sync_drains_each_cuda_device_once(self, monkeypatch):
        """A tree's CUDA tensors are found wherever they nest; a tree
        without one never touches ``torch.cuda``."""
        class OnCard:
            device = torch.device('cuda', 0)
        drained = []
        monkeypatch.setattr(torch.cuda, 'synchronize', drained.append)
        sync({'a': torch.ones(2), 'b': [np.ones(2), 'text', 3.0]})
        assert drained == []
        sync({'a': OnCard(), 'b': (OnCard(), [torch.ones(2), OnCard()])})
        assert drained == [torch.device('cuda', 0)]

    def test_progress_iter_callback(self):
        seen = []
        out = list(progress_iter(range(4), total=4, callback=lambda d, t: seen.append((d, t))))
        assert out == [0, 1, 2, 3] and seen == [(1, 4), (2, 4), (3, 4), (4, 4)]
        assert list(progress_iter(range(3), total=3, desc="x")) == [0, 1, 2]

    def test_the_loader_uses_the_shared_progress_iter(self):
        from psa_tpu_torch.io import loader
        assert loader.progress_iter is progress_iter
        assert not hasattr(loader, '_progress_iter')

    def test_trace_writes_a_loadable_chrome_trace(self, tmp_path):
        with trace(tmp_path / 'prof'):
            torch.ones((64, 64)) @ torch.ones((64, 64))
        events = json.loads((tmp_path / 'prof' / 'trace.json').read_text())['traceEvents']
        assert any('mm' in e.get('name', '') for e in events)

    def test_trace_is_written_when_the_block_raises(self, tmp_path):
        with pytest.raises(ZeroDivisionError):
            with trace(str(tmp_path / 'prof')):
                1 / 0
        assert json.loads((tmp_path / 'prof' / 'trace.json').read_text())['traceEvents']


def test_cli_profile_goes_through_trace(tmp_path, monkeypatch):
    """``--profile`` writes ``<output-dir>/profile/trace.json`` through
    :func:`psa_tpu_torch.utils.profiling.trace`."""
    from psa_tpu_torch import cli
    traj = make_chain_trajectory(n_cells=8, n_frames=16, dt_ps=0.02, a=2.5, omega_max_thz=6.0)
    dump = tmp_path / 'chain.dump'
    with open(dump, 'w') as f:
        for t in range(traj.n_frames):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{traj.n_atoms}\n"
                    "ITEM: BOX BOUNDS pp pp pp\n")
            f.writelines(f"0.0 {traj.box_matrix[d, d]:.6f}\n" for d in range(3))
            f.write("ITEM: ATOMS id type x y z vx vy vz\n")
            for a in range(traj.n_atoms):
                row = np.concatenate([traj.positions[t, a], traj.velocities[t, a]])
                f.write(f"{a + 1} 1 " + " ".join(f"{v:.6f}" for v in row) + "\n")
    (tmp_path / 'c.json').write_text(json.dumps({
        'md_system': {'dt': 0.02, 'nx': 8, 'ny': 1, 'nz': 1},
        'sed_calculation': {'directions': ['x'], 'n_kpoints': 4, 'bz_coverage': 0.5}}))
    entered = []
    real = cli.trace
    monkeypatch.setattr(cli, 'trace', lambda d: (entered.append(d), real(d))[1])
    cli.main(['--trajectory', str(dump), '--config', str(tmp_path / 'c.json'),
              '--output-dir', str(tmp_path / 'out'), '--device', 'cpu', '--profile'])
    assert entered == [tmp_path / 'out' / 'profile']
    assert json.loads((tmp_path / 'out' / 'profile' / 'trace.json').read_text())['traceEvents']


@pytest.fixture
def chain_calc():
    traj = make_chain_trajectory(n_cells=12, n_frames=32, dt_ps=0.02, a=2.5, omega_max_thz=6.0)
    return SEDCalculator(traj, nx=12, ny=1, nz=1, device='cpu')


@pytest.fixture
def count_checks(monkeypatch):
    """Calls of the debug module's two checks, by name."""
    calls = {'check_tensors': [], 'check_arrays': []}
    for name in calls:
        real = getattr(debug, name)
        monkeypatch.setattr(debug, name, lambda where, xs, name=name, real=real: (
            calls[name].append(where), real(where, xs))[1])
    return calls


class TestDebug:
    def test_modes_switch_on_and_off(self):
        assert not debug.active
        debug.enable_debug_mode(nans=True, infs=False, disable_jit=True)
        assert debug.active
        debug.disable_debug_mode()
        assert not debug.active
        debug.enable_debug_mode(nans=False, infs=False)
        assert not debug.active
        with debug.debug_numerics():
            assert debug.active
        assert not debug.active
        with pytest.raises(KeyError):
            with debug.debug_numerics():
                raise KeyError('x')
        assert not debug.active              # left by the finally

    def test_off_costs_no_check(self, chain_calc, count_checks):
        k_mags, k_vecs = chain_calc.get_k_path('x', bz_coverage=0.5, n_k=6)
        chain_calc.calculate(k_mags, k_vecs)
        chain_calc.calculate_kgrid_peaks(k_vecs)
        chain_calc.calculate_dos()
        assert count_checks == {'check_tensors': [], 'check_arrays': []}

    def test_on_checks_the_kernel_wrapper_and_the_results(self, chain_calc, count_checks):
        k_mags, k_vecs = chain_calc.get_k_path('x', bz_coverage=0.5, n_k=6)
        with debug.debug_numerics():
            sed = chain_calc.calculate(k_mags, k_vecs, k_chunk_size=4)
            chain_calc.calculate_kgrid_peaks(k_vecs)
            chain_calc.calculate_dos()
        assert np.isfinite(sed.sed).all()
        assert count_checks['check_tensors'] == ['sed_projection'] * 3
        assert count_checks['check_arrays'] == ['calculate', 'calculate', 'calculate_kgrid_peaks',
                                                'calculate_dos']

    @pytest.mark.parametrize("bad,kind", [(float('nan'), 'NaN'), (float('inf'), 'Inf')])
    def test_a_bad_velocity_raises_in_the_projection(self, chain_calc, bad, kind):
        """One NaN velocity poisons a whole time row of the projection; an
        infinite one leaves an infinite sum."""
        k_mags, k_vecs = chain_calc.get_k_path('x', bz_coverage=0.5, n_k=6)
        clean = chain_calc.calculate(k_mags, k_vecs)
        chain_calc.traj.velocities[3, 5, 0] = bad
        chain_calc.clear_device_cache()
        silent = chain_calc.calculate(k_mags, k_vecs)          # off: nothing raises
        assert not np.isfinite(silent.sed).all() and np.isfinite(clean.sed).all()
        with debug.debug_numerics():
            with pytest.raises(FloatingPointError, match=f"{kind} in output 0 of sed_projection"):
                chain_calc.calculate(k_mags, k_vecs)
        assert not debug.active

    def test_nans_and_infs_are_trapped_separately(self):
        data = torch.ones((2, 3, 3))
        hi, lo, k = torch.zeros((3, 3)), torch.zeros((3, 3)), torch.zeros((1, 3))
        data[0, 0, 0] = float('inf')            # re: inf · cos 0 = inf; im: inf · sin 0 = NaN
        with debug.debug_numerics(nans=True, infs=False):
            with pytest.raises(FloatingPointError, match="NaN in output 1 of sed_projection"):
                sed_projection(data, hi, lo, k)
        with debug.debug_numerics(nans=False, infs=True):
            with pytest.raises(FloatingPointError, match="Inf in output 0 of sed_projection"):
                sed_projection(data, hi, lo, k)
        with debug.debug_numerics(nans=False, infs=False):     # neither: the mode stays off
            sed_projection(data, hi, lo, k)

    def test_results_are_checked_where_they_reach_the_host(self):
        """The readback names the sweep that pushed the chunk."""
        def some_sweep(tensor):
            readback, seen = DeviceToHost(torch.device('cpu')), []
            readback.push([tensor], seen.append)
            readback.finish()
            return seen
        assert len(some_sweep(torch.tensor([1.0, float('nan')]))) == 1      # off
        with debug.debug_numerics():
            assert len(some_sweep(torch.tensor([1.0, 2.0]))) == 1
            assert len(some_sweep(torch.tensor([1, 2]))) == 1               # integers pass
            with pytest.raises(FloatingPointError, match="NaN in output 0 of some_sweep"):
                some_sweep(torch.tensor([1.0, float('nan')]))
