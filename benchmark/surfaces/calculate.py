"""``SEDCalculator.calculate``: the full complex Φ (n_t, K, 3) read back to the host.

Checked: Φ of the sampled k-columns against the float64 SED's, per call,
on the check's scale (:mod:`benchmark.harness.compare`).
"""
from __future__ import annotations

import numpy as np

from benchmark.harness import compare, workcount
from benchmark.reference import sed


def call(calc, k: np.ndarray, traffic: dict):
    mags = np.linalg.norm(k, axis=1).astype(np.float32)
    return calc.calculate(mags, k, **traffic['kwargs']).sed


def select(out, cols: np.ndarray):
    return np.asarray(out)[:, cols, :]


def check(inputs, items, traffic: dict, tf32: bool, scale: str) -> dict:
    ks = np.concatenate([k for k, _ in items])
    ref = sed.phi(inputs.data, inputs.sites64, ks, device=inputs.device)
    prog = (sed.phi(inputs.data, inputs.sites64, ks, tf32=True, device=inputs.device) if tf32
            else np.concatenate([out for _, out in items], axis=1))
    return {'phi_err': max(compare.column_error(p, r, k_axis=1, scale=scale)
                           for p, r in compare.per_call(items, prog, ref))}


def work(inputs, k: np.ndarray, traffic: dict):
    n_out = inputs.n_t * len(k) * 3 * 8
    return (workcount.projection_flops(inputs.n_t, inputs.n_atoms, len(k)),
            workcount.projection_bytes(inputs.n_t, inputs.n_atoms, len(k), n_out))
