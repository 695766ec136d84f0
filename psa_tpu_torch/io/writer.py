"""The LAMMPS dump ("qdump") exporter that iSED writes its animation with.

Output matches the reference writer byte-for-byte (reference:
src/psa/io/writer.py:139-228) so downstream tools (OVITO, the GUI's dump
re-parser) keep working.
"""
from __future__ import annotations

import logging
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)


def out_to_qdump(filename: str, positions_tf: np.ndarray, types_tf: np.ndarray,
                 box_matrix: np.ndarray) -> None:
    """Write per-frame ``id type x y z`` records as a LAMMPS dump.

    Box-bounds math follows the LAMMPS triclinic convention with the cell
    matrix [[lx, xy, xz], [0, ly, yz], [0, 0, lz]] and origin at (0,0,0)
    (reference writer.py:139-228): triclinic frames carry
    ``BOX BOUNDS xy xz yz pp pp pp`` with bound extents shifted by the tilt
    extrema; orthogonal frames use the plain ``pp pp pp`` header.

    The per-atom body is assembled with vectorized formatting rather than a
    per-atom Python loop.
    """
    n_fr, n_at, _ = positions_tf.shape
    Path(filename).parent.mkdir(parents=True, exist_ok=True)

    xlo, xhi = 0.0, float(box_matrix[0, 0])
    ylo, yhi = 0.0, float(box_matrix[1, 1])
    zlo, zhi = 0.0, float(box_matrix[2, 2])
    xy, xz, yz = float(box_matrix[0, 1]), float(box_matrix[0, 2]), float(box_matrix[1, 2])
    is_triclinic = not (np.isclose(xy, 0.0) and np.isclose(xz, 0.0) and np.isclose(yz, 0.0))

    if is_triclinic:
        xlo_b = xlo + min(0.0, xy, xz, xy + xz)
        xhi_b = xhi + max(0.0, xy, xz, xy + xz)
        ylo_b = ylo + min(0.0, yz)
        yhi_b = yhi + max(0.0, yz)
        zlo_b, zhi_b = zlo, zhi
        box_block = (f"ITEM: BOX BOUNDS xy xz yz pp pp pp\n"
                     f"{xlo_b:.8f} {xhi_b:.8f} {xy:.8f}\n"
                     f"{ylo_b:.8f} {yhi_b:.8f} {xz:.8f}\n"
                     f"{zlo_b:.8f} {zhi_b:.8f} {yz:.8f}\n")
    else:
        box_block = (f"ITEM: BOX BOUNDS pp pp pp\n"
                     f"{xlo:.8f} {xhi:.8f}\n"
                     f"{ylo:.8f} {yhi:.8f}\n"
                     f"{zlo:.8f} {zhi:.8f}\n")

    ids = np.arange(1, n_at + 1)
    types_int = np.asarray(types_tf).astype(int)
    id_type = [f"{i} {t} " for i, t in zip(ids, types_int)]

    with open(filename, 'w') as f:
        for i_fr in range(n_fr):
            f.write(f"ITEM: TIMESTEP\n{i_fr}\n")
            f.write(f"ITEM: NUMBER OF ATOMS\n{n_at}\n")
            f.write(box_block)
            f.write("ITEM: ATOMS id type x y z\n")
            frame = positions_tf[i_fr]
            rows = [f"{prefix}{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n"
                    for prefix, p in zip(id_type, frame)]
            f.writelines(rows)
    logger.debug("Wrote iSED reconstruction to Qdump: %s", filename)
