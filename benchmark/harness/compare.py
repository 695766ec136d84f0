"""The numbers that decide ``correct``: a run's answers against the reference's.

Every number is a worst case over the calls checked.  Its scale is the
check's ``scale``: each k-column's own reference maximum (``'column'``, so a
dim column counts as much as a bright one), or the maximum over the call's
checked columns (``'call'``, "within x of max|Φ|").
"""
from __future__ import annotations

from typing import Dict, Iterator, Sequence

import numpy as np


def per_call(items, *arrays, k_axis: int = 1) -> Iterator[tuple]:
    """Each checked call's columns of ``arrays`` (arrays, or tuples of arrays,
    that hold the calls' columns one after another along ``k_axis``)."""
    ends = np.cumsum([len(k) for k, _ in items])
    for s, e in zip(np.r_[0, ends[:-1]], ends):
        cut = (slice(None),) * k_axis + (slice(int(s), int(e)),)
        yield tuple(tuple(x[cut] for x in a) if isinstance(a, tuple) else a[cut] for a in arrays)


def column_error(prog: np.ndarray, ref: np.ndarray, k_axis: int, scale: str) -> float:
    """max over k-columns of max|prog − ref| / max|ref|, the maxima over
    every other axis of the column, and with ``scale='call'`` the divisor's
    maximum over every column too."""
    diff = np.abs(np.asarray(prog, np.complex128 if np.iscomplexobj(prog) else np.float64)
                  - np.asarray(ref))
    ref_abs = np.abs(np.asarray(ref))
    other = tuple(a for a in range(ref_abs.ndim) if a != k_axis % ref_abs.ndim)
    top = ref_abs.max(axis=other)
    top = np.maximum(top.max() if scale == 'call' else top, 1e-300)
    return float(np.max(diff.max(axis=other) / top))


def peaks(prog: Sequence[np.ndarray], ref: Sequence[np.ndarray], df: float,
          scale: str) -> Dict[str, float]:
    """``peak_height_err``: max |Δheight| / the column's highest reference
    peak (with ``scale='call'``, the highest of all columns);
    ``peak_width_err``: max |Δwidth| in frequency bins.  Each column's
    peaks are matched in frequency order, so peaks of near-equal height may
    come in either order; a column whose peak rows differ from the
    reference's reads 1 on both."""
    pf, ph, pw = (np.asarray(x, np.float64) for x in prog[:3])
    rf, rh, rw = (np.asarray(x, np.float64) for x in ref[:3])
    po, ro = np.argsort(pf, axis=0, kind='stable'), np.argsort(rf, axis=0, kind='stable')
    take = np.take_along_axis
    p_bins, r_bins = np.rint(take(pf, po, 0) / df), np.rint(take(rf, ro, 0) / df)
    moved = np.any(p_bins != r_bins, axis=0)
    top = np.maximum(rh.max() if scale == 'call' else rh.max(axis=0), 1e-300)
    h_err = np.abs(take(ph, po, 0) - take(rh, ro, 0)).max(axis=0) / top
    w_err = np.abs(take(pw, po, 0) - take(rw, ro, 0)).max(axis=0) / df
    h_err, w_err = np.where(moved, 1.0, h_err), np.where(moved, 1.0, w_err)
    return {'peak_height_err': float(h_err.max()), 'peak_width_err': float(w_err.max())}

