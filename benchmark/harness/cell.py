"""One run of one cell: set-up, the measured window, the trace, the check.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix; the
files that belong to each are found by name:

- ``configs/<config>.json``: the deployment; its ``system`` names the module
  ``systems/<system>.py`` that makes the inputs from the seed;
- ``traffic/<traffic>.json``: the mix; its ``surface`` names the module
  ``surfaces/<surface>.py`` that calls the calculator and checks the answers,
  its ``kset`` the k-set of each call (:mod:`benchmark.harness.ksets`);
- ``checks/<cell>.json``: how many calls and k-columns are checked, the
  control, the scale of the numbers compared and the limit of each;
- ``metrics/<metric>.py``: one per-layer reader, ``read(trace, record)``;
  ``record`` holds the window's ``n_calls``, each call's ``work`` and
  ``counters``, what each of the program's counters gained over the window.

A cell may ask for 1 or 4 cards; its system module places the work on them.
The peak memory is that of the fullest card, the busy time the mean of the
cards'.

The loop is closed, with one caller: each call starts when the last one
has returned its host-resident answer, for ``seconds`` and then until the
call in flight returns.  The window's rate is all k of the calls completed
over all its time.
"""
from __future__ import annotations

import contextlib
import copy
import gc
import importlib
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from benchmark.harness.ksets import KSets, seed_words

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_spec() -> dict:
    return json.loads((ROOT / 'BENCHMARK.json').read_text())


def merge(base: dict, over: Optional[dict]) -> dict:
    """``base`` with ``over``'s keys replaced, nested dicts merged."""
    out = copy.deepcopy(base)
    for key, val in (over or {}).items():
        out[key] = merge(out[key], val) if isinstance(val, dict) and isinstance(
            out.get(key), dict) else copy.deepcopy(val)
    return out


def cell_parts(name: str, spec: Optional[dict] = None, overrides: Optional[dict] = None):
    """(cell, config, traffic, check) of the workload ``name``, each read by name."""
    spec = spec or load_spec()
    cells = {w['name']: w for w in spec['workloads']}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config_file = {c['name']: c['file'] for c in spec['configs']}[cell['config']]
    over = overrides or {}
    config = merge(json.loads((ROOT / config_file).read_text()), over.get('config'))
    traffic = merge(json.loads((BENCH / 'traffic' / f"{cell['traffic']}.json").read_text()),
                    over.get('traffic'))
    check = merge(json.loads((BENCH / 'checks' / f'{name}.json').read_text()), over.get('check'))
    return cell, config, traffic, check


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py``."""
    return importlib.import_module(f'benchmark.{kind}.{name}')


def cell_metrics(spec: dict, cell_name: str, section: str):
    """The entries of ``section`` ('end_to_end' or 'per_layer') that ``cell_name`` reports."""
    return [m for m in spec[section] if cell_name in m.get('workloads', [cell_name])]


class Reservoir:
    """A uniform sample, drawn from the seed, of at most ``size`` of the items offered."""

    def __init__(self, size: int, seed: int):
        self.size, self.items = size, []
        self.rng = np.random.default_rng([seed_words(seed), 7])

    def offer(self, index: int, item) -> None:
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, index + 1))
            if j < self.size:
                self.items[j] = item


def program_counters():
    """The program's counters (``snapshot()``, ``counted_since(before)``, of
    ``psa_tpu_torch.utils.profiling``), or None for a program that keeps none."""
    try:
        profiling = importlib.import_module('psa_tpu_torch.utils.profiling')
    except ImportError:
        return None
    return profiling if hasattr(profiling, 'counted_since') else None


def cards(dev, chips: int) -> list:
    """The CUDA devices a run on ``chips`` cards uses: ``dev`` alone, or cards 0 … chips − 1."""
    import torch
    if chips == 1:
        return [dev]
    return [torch.device('cuda', i) for i in range(chips)]


def _sync(device) -> None:
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = 'cuda',
             t_start: Optional[float] = None, overrides: Optional[dict] = None,
             control: bool = False, wrap_call: Optional[Callable] = None) -> dict:
    """Run the workload ``name`` once; return the result line (a dict) with
    the check's numbers under ``checks``.

    ``control`` runs the check's control instead of the program's answers:
    the program at the control's precision tier, or the reference itself in
    TF32 in the program's place.  ``wrap_call(call)`` may replace the call
    (the tests break the timed path with it).  ``overrides`` replaces
    entries of the config, traffic and check files (the tests' small sizes).
    """
    import torch
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec()
    cell, config, traffic, check = cell_parts(name, spec, overrides)
    dev = torch.device(device)
    if dev.type == 'cuda' and dev.index is None:
        dev = torch.device('cuda', torch.cuda.current_device())
    system = module('systems', config['system'])
    surface = module('surfaces', traffic['surface'])
    ctl = check['control'] if control else None
    precision = (ctl['precision'] if ctl and ctl['kind'] == 'program_precision'
                 else config['precision'])
    call = surface.call if wrap_call is None else wrap_call(surface.call)

    inputs = system.make(config, seed, dev)
    calc = inputs.calculator(precision)
    ksets = KSets(traffic['kset'], seed, inputs.box_lengths)
    for j in range(traffic['warmup_calls']):
        call(calc, ksets.warm(j), traffic)
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    cuda = dev.type == 'cuda'
    used = cards(dev, cell['chips']) if cuda else []
    setup_peak = max((torch.cuda.max_memory_allocated(d) for d in used), default=0)
    for d in used:
        torch.cuda.reset_peak_memory_stats(d)

    sample = Reservoir(check['calls'], seed)
    walls, kpoints, failed, work = [], 0, 0, []
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        prof = profile(activities=acts)
        span = record_function
    else:
        span = lambda _name: contextlib.nullcontext()  # noqa: E731
    counters = program_counters()
    before = counters.snapshot() if counters else None
    with prof if prof is not None else contextlib.nullcontext():
        with span('bench.window'):
            t0 = time.perf_counter()
            deadline, t_end, i = t0 + seconds, t0, 0
            while True:
                k = ksets(i)
                ts = time.perf_counter()
                if i > 0 and ts >= deadline:
                    break
                out = None
                try:
                    with span('bench.call'):
                        out = call(calc, k, traffic)
                except Exception:       # counted as failed; the window goes on
                    failed += 1
                    if failed == 1:
                        log(f"call {i} failed:\n{traceback.format_exc()}")
                t_end = time.perf_counter()
                walls.append(t_end - ts)
                if out is not None:
                    kpoints += len(k)
                    sample.offer(i, (i, k, out))
                    work.append(surface.work(inputs, k, traffic))
                i += 1
    counted = counters.counted_since(before) if counters else {}
    window_s = t_end - t0
    attempted = len(walls)
    window_peak = max((torch.cuda.max_memory_allocated(d) for d in used), default=0)
    memory_peak = max(setup_peak, window_peak)

    del calc
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    rng = np.random.default_rng([seed_words(seed), 11])
    items = []
    for _, k, out in sorted(sample.items, key=lambda it: it[0]):
        cols = np.sort(rng.choice(len(k), min(len(k), check['k_per_call']), replace=False))
        items.append((k[cols], surface.select(out, cols)))
    tf32 = bool(ctl and ctl['kind'] == 'reference_tf32')
    numbers = (surface.check(inputs, items, traffic, tf32, check['scale'])
               if items else {})
    check_s = time.perf_counter() - t_check
    limits = check['limits']
    correct = (attempted > 0 and failed == 0 and bool(items)
               and all(name_ in numbers and np.isfinite(numbers[name_])
                       and numbers[name_] <= lim for name_, lim in limits.items()))

    result = {'correct': bool(correct), 'attempted': attempted, 'failed': failed}
    device_info = {'platform': 'gpu' if cuda else 'cpu',
                   'kind': torch.cuda.get_device_name(dev) if cuda else 'cpu',
                   'count': cell['chips'], 'memory_peak_bytes': int(memory_peak)}
    e2e = {'kpoints_per_s': kpoints / window_s, 'call_s_p95': float(np.percentile(walls, 95)),
           'peak_device_gb': window_peak / 1e9, 'setup_s': setup_s}
    if not trace:
        result['metrics'] = {m['name']: {'value': e2e[m['name']], 'unit': m['unit']}
                             for m in cell_metrics(spec, name, 'end_to_end')}
    else:
        from benchmark.harness.trace import from_profiler
        tr = from_profiler(prof)
        record = {'n_calls': len(tr.calls), 'work': work, 'counters': counted}
        metrics = {}
        for m in cell_metrics(spec, name, 'per_layer'):
            value = module('metrics', m['name']).read(tr, record)
            if value is not None:
                metrics[m['name']] = {'value': float(value), 'unit': m['unit']}
        result['metrics'] = metrics
        busy = (tr.busy_ns() if len(used) <= 1
                else sum(tr.busy_ns(card=d.index) for d in used) / len(used))
        device_info['busy_s'] = busy / 1e9
        device_info['window_s'] = tr.window_ns() / 1e9
        result['breakdown'] = {'device_ops': tr.top_device_ops(), 'idle_gaps': tr.idle_gaps()}
    result['device'] = device_info
    result['checks'] = {n: {'value': numbers.get(n), 'limit': lim}
                        for n, lim in limits.items()}
    log(f"{name}: seed {seed}, {attempted} calls ({failed} failed) in {window_s:.4f} s, "
        f"{kpoints} k-points, set-up {setup_s:.3f} s, check {check_s:.3f} s on "
        f"{len(items)} calls, window peak {window_peak / 1e9:.4f} GB")
    return result
