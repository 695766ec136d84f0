"""``SEDCalculator.calculate_kgrid_peaks`` over the basis groups of a crystal,
summed incoherently: the top peaks of every k of a grid, with the widths the
traffic asks for.

The traffic's ``kwargs`` go to the call as they are: a list stays a list,
since the calculator reads a flat list of types as one group per type.  The
reference reads the whole ω ≥ 0 half of the spectrum, so ``max_freq`` is
not among them.  Checked: the peaks of the sampled k-columns against
:mod:`benchmark.reference.sed_basis`, per call, on the check's scale.
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import compare, workcount
from benchmark.reference import sed_basis
from benchmark.surfaces.kgrid_peaks import select  # noqa: F401  (the harness finds it here)


def call(calc, k: np.ndarray, traffic: dict):
    return calc.calculate_kgrid_peaks(k, **traffic['kwargs'])


def groups(inputs, traffic: dict) -> list:
    """The atoms of each basis type the traffic names, in its order."""
    return [np.flatnonzero(inputs.types == t) for t in traffic['kwargs']['basis_atom_types']]


def check(inputs, items, traffic: dict, tf32: bool, scale: str) -> dict:
    """``items``: (k of the checked columns, the program's answers there) per checked call."""
    kw = traffic['kwargs']
    if kw.get('summation_mode') != 'incoherent' or kw.get('width_method') != 'lorentzian':
        raise ValueError("the basis reference sums the groups incoherently, with Lorentzian widths")
    n_peaks, excl = kw.get('n_peaks', 1), kw.get('exclusion_bins', 4)
    ks = np.concatenate([k for k, _ in items])
    args = (inputs.data, inputs.sites64, inputs.masses, groups(inputs, traffic), ks,
            inputs.dt_ps, n_peaks, excl)
    ref = sed_basis.kgrid_peaks(*args, device=inputs.device)
    if tf32:
        prog = sed_basis.kgrid_peaks(*args, tf32=True, device=inputs.device)
    else:
        prog = tuple(np.concatenate([out[i] for _, out in items], axis=1) for i in range(3))
    df = 1.0 / (inputs.n_t * inputs.dt_ps)
    calls = [compare.peaks(p, r, df, scale) for p, r in compare.per_call(items, prog, tuple(ref))]
    return {name: max(c[name] for c in calls) for name in calls[0]}


def work(inputs, k: np.ndarray, traffic: dict):
    """The projection stage of a call: every group's, at its own atoms."""
    sizes = [len(g) for g in groups(inputs, traffic)]
    n_out = 3 * traffic['kwargs'].get('n_peaks', 1) * len(k) * 4
    return (sum(workcount.projection_flops(inputs.n_t, n, len(k)) for n in sizes),
            sum(workcount.projection_bytes(inputs.n_t, n, len(k), 0) for n in sizes) + n_out)
