"""The k-set of each call of a traffic mix, made from the seed (host NumPy, float32).

A mix's ``kset`` entry names a kind and its parameters:

- ``grid``: ``get_k_grid``'s tensor-product grid on an axis plane (the first
  range varies slowest), ``n_x`` × ``n_y`` points over ``range_x`` ×
  ``range_y``.  ``vary: "shift"`` moves the whole grid of every call by a
  seeded offset under one grid step on each axis; ``vary: "alternate"``
  makes ``n_grids`` such grids once and takes them in turn.
- ``path``: ``get_k_path``'s line from Γ along ``direction``, ``n_k`` points
  up to ``bz_coverage``·2π/``lat_param``, moved along the line by a seeded
  offset under one step per call.
- ``commensurate_axis``: k_n = n·2π/L for n = ``n_min`` … ``n_max`` along one
  cube axis of the box, the axes of ``axes`` taken in turn from a seeded
  first one.

Warm-up calls draw from a stream of their own, so the measured calls'
k-sets do not depend on how many warm-ups ran.
"""
from __future__ import annotations

import numpy as np

_PLANES = {'xy': (0, 1, 2), 'yz': (1, 2, 0), 'zx': (2, 0, 1)}


def seed_words(seed: int) -> int:
    """Any whole number as the non-negative word numpy's and torch's seeding take."""
    return int(seed) % (1 << 63)


def grid(plane: str, range_x, range_y, n_x: int, n_y: int, offset=(0.0, 0.0)) -> np.ndarray:
    """(n_x·n_y, 3) float32 k-vectors of ``get_k_grid(plane, range_x, range_y, n_x,
    n_y)`` with ``offset`` added to both ranges."""
    c1 = np.linspace(range_x[0] + offset[0], range_x[1] + offset[0], n_x, dtype=np.float32)
    c2 = np.linspace(range_y[0] + offset[1], range_y[1] + offset[1], n_y, dtype=np.float32)
    slow, fast, fixed = _PLANES[plane]
    k = np.zeros((n_x * n_y, 3), dtype=np.float32)
    k[:, slow] = np.repeat(c1, n_y)
    k[:, fast] = np.tile(c2, n_x)
    return k


def path(direction, bz_coverage: float, n_k: int, lat_param: float, offset: float = 0.0):
    """(|k| (n_k,), k (n_k, 3)) float32 of ``get_k_path(direction, bz_coverage, n_k,
    lat_param)`` moved by ``offset`` along the line."""
    unit = np.asarray(direction, np.float64)
    unit = (unit / np.linalg.norm(unit)).astype(np.float32)
    k_max = bz_coverage * 2 * np.pi / lat_param
    mags = np.linspace(offset, k_max + offset, n_k, dtype=np.float32)
    return mags, np.outer(mags, unit).astype(np.float32)


class KSets:
    """``ks(i)``: the k-vectors of measured call ``i``; ``ks.warm(j)``: of warm-up ``j``."""

    def __init__(self, spec: dict, seed: int, box_lengths):
        self.spec, self.seed = spec, seed_words(seed)
        self.box_lengths = np.asarray(box_lengths, np.float64)
        kind = spec['kind']
        if kind not in ('grid', 'path', 'commensurate_axis'):
            raise ValueError(f"unknown k-set kind {kind!r}")
        self._fixed = None
        if kind == 'grid' and spec.get('vary') == 'alternate':
            self._fixed = [self._grid(self._rng(2, j)) for j in range(spec['n_grids'])]

    def _rng(self, stream: int, i: int):
        return np.random.default_rng([self.seed, stream, i])

    def _grid(self, rng):
        s = self.spec
        step = ((s['range_x'][1] - s['range_x'][0]) / max(1, s['n_x'] - 1),
                (s['range_y'][1] - s['range_y'][0]) / max(1, s['n_y'] - 1))
        off = rng.uniform(0.0, 1.0, 2) * np.asarray(step)
        return grid(s['plane'], s['range_x'], s['range_y'], s['n_x'], s['n_y'], off)

    def _make(self, stream: int, i: int) -> np.ndarray:
        s, kind = self.spec, self.spec['kind']
        if self._fixed is not None:
            return self._fixed[i % len(self._fixed)]
        if kind == 'grid':
            return self._grid(self._rng(stream, i))
        if kind == 'path':
            k_max = s['bz_coverage'] * 2 * np.pi / s['lat_param']
            off = float(self._rng(stream, i).uniform()) * k_max / max(1, s['n_k'] - 1)
            return path(s['direction'], s['bz_coverage'], s['n_k'], s['lat_param'], off)[1]
        axes = s['axes']
        first = int(self._rng(3, 0).integers(len(axes)))
        axis = int(axes[(first + i) % len(axes)]) if stream == 0 else int(axes[i % len(axes)])
        n = np.arange(s['n_min'], s['n_max'] + 1, dtype=np.float64)
        k = np.zeros((len(n), 3), dtype=np.float32)
        k[:, axis] = (n * 2 * np.pi / self.box_lengths[axis]).astype(np.float32)
        return k

    def __call__(self, i: int) -> np.ndarray:
        return self._make(0, i)

    def warm(self, j: int) -> np.ndarray:
        return self._make(1, j)
