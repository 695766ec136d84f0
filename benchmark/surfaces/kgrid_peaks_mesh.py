"""``SEDCalculator.calculate_kgrid_peaks_sharded`` on the mesh whose
positions hold the trajectory (``calc.resident_mesh``): the top peaks of
every k of a grid, as :mod:`benchmark.surfaces.kgrid_peaks` asks them of
one device.  Checked against :mod:`benchmark.reference.sed_shards`, computed
on the cards from the shards the timed path read.
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import compare
from benchmark.reference import sed_shards
from benchmark.surfaces.kgrid_peaks import kwargs, select, work  # noqa: F401  (the harness finds them here)


def call(calc, k: np.ndarray, traffic: dict):
    return calc.calculate_kgrid_peaks_sharded(calc.resident_mesh, k, **kwargs(traffic))


def check(inputs, items, traffic: dict, tf32: bool, scale: str) -> dict:
    """``items``: (k of the checked columns, the program's answers there) per checked call."""
    kw = traffic['kwargs']
    n_peaks, excl = kw.get('n_peaks', 1), kw.get('exclusion_bins', 4)
    ks = np.concatenate([k for k, _ in items])
    ref = sed_shards.kgrid_peaks(inputs.shards, inputs.sites64, ks, inputs.dt_ps, n_peaks, excl,
                                 home=inputs.device)
    if tf32:
        prog = sed_shards.kgrid_peaks(inputs.shards, inputs.sites64, ks, inputs.dt_ps, n_peaks,
                                      excl, tf32=True, home=inputs.device)
    else:
        prog = tuple(np.concatenate([out[i] for _, out in items], axis=1) for i in range(3))
    df = 1.0 / (inputs.n_t * inputs.dt_ps)
    calls = [compare.peaks(p, r, df, scale) for p, r in compare.per_call(items, prog, tuple(ref))]
    return {name: max(c[name] for c in calls) for name in calls[0]}
