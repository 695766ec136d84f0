"""Synthetic lattice models with known phonon physics (fixtures/benchmarks)."""
from .lattices import (
    diatomic_chain_branches, fcc_dynamical_branches, honeycomb_K_point,
    honeycomb_dispersion, honeycomb_structure_factor, make_chain_trajectory,
    make_chiral_chain_trajectory, make_diatomic_chain_trajectory,
    make_fcc_trajectory, make_honeycomb_trajectory,
    make_random_crystal_trajectory, make_square_lattice_trajectory,
    monatomic_chain_modes, square_lattice_dispersion,
)

__all__ = ["make_chain_trajectory", "make_chiral_chain_trajectory",
           "make_diatomic_chain_trajectory", "make_fcc_trajectory",
           "make_honeycomb_trajectory",
           "make_random_crystal_trajectory", "make_square_lattice_trajectory",
           "monatomic_chain_modes", "diatomic_chain_branches",
           "fcc_dynamical_branches", "honeycomb_structure_factor",
           "honeycomb_dispersion", "honeycomb_K_point",
           "square_lattice_dispersion"]
