"""``SEDCalculator.calculate_kgrid_peaks``: the top peaks of every k of a grid.

The traffic's ``kwargs`` go to the call as they are (a list becomes a
tuple); the reference reads the whole ω ≥ 0 half of the spectrum, so
``max_freq`` is not among them.  Checked: the peaks of the sampled k-columns
against the float64 SED's, per call, on the check's scale.
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import compare, workcount
from benchmark.reference import sed


def kwargs(traffic: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v for k, v in traffic['kwargs'].items()}


def call(calc, k: np.ndarray, traffic: dict):
    return calc.calculate_kgrid_peaks(k, **kwargs(traffic))


def select(out, cols: np.ndarray):
    return tuple(np.asarray(x)[:, cols] for x in out[:3])


def check(inputs, items, traffic: dict, tf32: bool, scale: str) -> dict:
    """``items``: (k of the checked columns, the program's answers there) per checked call."""
    kw = traffic['kwargs']
    n_peaks, excl = kw.get('n_peaks', 1), kw.get('exclusion_bins', 4)
    ks = np.concatenate([k for k, _ in items])
    ref = sed.kgrid_peaks(inputs.data, inputs.sites64, ks, inputs.dt_ps, n_peaks, excl,
                          device=inputs.device)
    if tf32:
        prog = sed.kgrid_peaks(inputs.data, inputs.sites64, ks, inputs.dt_ps, n_peaks, excl,
                               tf32=True, device=inputs.device)
    else:
        prog = tuple(np.concatenate([out[i] for _, out in items], axis=1) for i in range(3))
    df = 1.0 / (inputs.n_t * inputs.dt_ps)
    calls = [compare.peaks(p, r, df, scale) for p, r in compare.per_call(items, prog, tuple(ref))]
    return {name: max(c[name] for c in calls) for name in calls[0]}


def work(inputs, k: np.ndarray, traffic: dict):
    n_out = 3 * traffic['kwargs'].get('n_peaks', 1) * len(k) * 4
    return (workcount.projection_flops(inputs.n_t, inputs.n_atoms, len(k)),
            workcount.projection_bytes(inputs.n_t, inputs.n_atoms, len(k), n_out))
