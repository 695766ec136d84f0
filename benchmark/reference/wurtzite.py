"""Sites of a wurtzite crystal (P6₃mc), host NumPy, float64.

The hexagonal cell a₁ = a(1, 0, 0), a₂ = a(−½, √3/2, 0), a₃ = c(0, 0, 1)
holds four basis sites, in fractions of (a₁, a₂, a₃):

    site 0: cation (⅓, ⅔, 0)      site 1: cation (⅔, ⅓, ½)
    site 2: anion  (⅓, ⅔, u)      site 3: anion  (⅔, ⅓, ½ + u)

An orthohexagonal cell a × √3a × c holds two hexagonal cells, the second
moved by (a/2, √3a/2, 0): eight atoms, the four sites twice.  A box of
``cells`` such cells lists its atoms cell-major (the last axis fastest),
each cell's eight in that order, as a lattice build writes them: each site
is every fourth atom.
"""
import numpy as np

#: Fractions of (a₁, a₂, a₃) of the four basis sites; ``u`` is added to the
#: third fraction of the anions.
FRACTIONS = np.array([[1 / 3, 2 / 3, 0.0], [2 / 3, 1 / 3, 0.5],
                      [1 / 3, 2 / 3, 0.0], [2 / 3, 1 / 3, 0.5]])
ANION = np.array([0.0, 0.0, 1.0, 1.0])


def cell_lengths(a: float, c: float) -> np.ndarray:
    """(a, √3·a, c): the edges of one orthohexagonal cell (Å)."""
    return np.array([a, np.sqrt(3.0) * a, c])


def basis(a: float, c: float, u: float) -> np.ndarray:
    """(8, 3) Cartesian sites of one orthohexagonal cell (Å); row i is site i % 4."""
    frac = FRACTIONS + np.outer(ANION, [0.0, 0.0, u])
    hexagonal = np.array([[a, 0.0, 0.0], [-a / 2, np.sqrt(3.0) * a / 2, 0.0], [0.0, 0.0, c]])
    one = frac @ hexagonal
    two = one + np.array([a / 2, np.sqrt(3.0) * a / 2, 0.0])
    # rounded first, so that a site a rounding error below an edge sits on it
    return np.mod(np.round(np.concatenate([one, two]), 12), cell_lengths(a, c))


def sites(cells, a: float, c: float, u: float):
    """(positions (N, 3) float64, site (N,) int in 0…3) of a box of
    ``cells`` = (n_x, n_y, n_z) orthohexagonal cells, N = 8·n_x·n_y·n_z."""
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in cells], indexing='ij'),
                    axis=-1).reshape(-1, 3)
    pos = (grid[:, None, :] * cell_lengths(a, c) + basis(a, c, u)[None]).reshape(-1, 3)
    return pos, np.tile(np.arange(8) % 4, len(grid))


def box_lengths(cells, a: float, c: float) -> np.ndarray:
    """The box's edges (Å)."""
    return np.asarray(cells, np.float64) * cell_lengths(a, c)
