"""Trajectory readers (LAMMPS dump, extxyz, OUTCAR, H5MD) with the .npy
sidecar cache, writers, and the per-chunk shard cache."""
from .loader import TrajectoryLoader
from .writer import TrajectoryWriter, out_to_qdump
