"""Crystal sites of the benchmark's configurations (host NumPy, float64)."""
import numpy as np

DIAMOND_BASIS = np.array([[0, 0, 0], [0.25, 0.25, 0.25], [0.5, 0.5, 0], [0.75, 0.75, 0.25],
                          [0.5, 0, 0.5], [0.75, 0.25, 0.75], [0, 0.5, 0.5], [0.25, 0.75, 0.75]])
FCC_BASIS = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])


def cube_sites(basis: np.ndarray, cells: int, a0: float) -> np.ndarray:
    """(cells³·len(basis), 3) sites of a cube of conventional cells, cell-major."""
    grid = np.stack(np.meshgrid(*[np.arange(cells)] * 3, indexing='ij'), axis=-1).reshape(-1, 3)
    return ((grid[:, None, :] + basis[None, :, :]).reshape(-1, 3) * a0).astype(np.float64)


def diamond_sites(n_atoms: int, a0: float) -> np.ndarray:
    """The first ``n_atoms`` diamond sites of the smallest cube that holds them
    (the repository's single-chip target, ``bench_torch.py::si_mean_positions``)."""
    cells = int(np.ceil((n_atoms / 8) ** (1 / 3)))
    return cube_sites(DIAMOND_BASIS, cells, a0)[:n_atoms]


def fcc_sites(cells: int, a0: float) -> np.ndarray:
    """The 4·cells³ sites of an fcc cube (LAMMPS ``lattice fcc``, ``region box block 0 n``)."""
    return cube_sites(FCC_BASIS, cells, a0)
