"""``SEDCalculator.calculate_dsf``: S(k, ω), C_L(k, ω) and C_T(k, ω) of a k-set.

Checked: the three planes of the sampled k-columns against the float64
reference's, per call, on the check's scale (:mod:`benchmark.harness.compare`).
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import compare
from benchmark.reference import dsf


def call(calc, k: np.ndarray, traffic: dict):
    return calc.calculate_dsf(k, **traffic['kwargs'])[1:]


def select(out, cols: np.ndarray):
    return tuple(np.asarray(x)[:, cols] for x in out)


def check(inputs, items, traffic: dict, tf32: bool, scale: str) -> dict:
    ks = np.concatenate([k for k, _ in items])
    pos, vel, dev = inputs.positions, inputs.velocities, inputs.device
    ref = dsf.planes(pos, vel, ks, device=dev)
    if tf32:
        prog = dsf.planes(pos, vel, ks, tf32=True, device=dev)
    else:
        prog = tuple(np.concatenate([out[i] for _, out in items], axis=1) for i in range(3))
    return {'dsf_err': max(compare.column_error(p, r, k_axis=1, scale=scale)
                           for pc, rc in compare.per_call(items, prog, tuple(ref))
                           for p, r in zip(pc, rc))}


def work(inputs, k: np.ndarray, traffic: dict):
    return None
