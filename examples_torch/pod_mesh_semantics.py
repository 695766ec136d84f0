"""Pod-path group semantics on a device mesh, on one device.

The mesh API carries the calculator's full group semantics:

  * coherent subset (basis types) browse planes,
  * incoherent per-type accumulation in the mesh (one data pass),
  * chiral-phase browse planes and phase-at-peak dispersion surfaces,
  * the NUFFT engine striped over the mesh's positions.

Here the mesh is virtual: 8 positions of one device
(``make_mesh(devices=[device] * 8)``), its (t, a, k) shape chosen from the
workload's size and the device memory (``hbm_bytes``; small workloads
resolve to pure k-parallelism).  On a machine with several cards, list them
in ``devices`` and the same code shards over them.

Run:  python examples_torch/pod_mesh_semantics.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, parse_args, start
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.models import make_random_crystal_trajectory
from psa_tpu_torch.parallel import make_mesh

N_POSITIONS = 8
HOST_BUDGET = 16 << 30   # bytes per position when the mesh lies on the host


def main(device='cuda', out_dir='sed_output'):
    dev, _ = start(device, out_dir)
    print(f"devices: {N_POSITIONS} x {dev.type}")

    traj = make_random_crystal_trajectory(n_cells_xyz=(4, 3, 2), basis=2,
                                          n_frames=32, dt_ps=0.02, seed=0)
    calc = SEDCalculator(traj, nx=4, ny=3, nz=2, device=dev)
    # residency-aware mesh: small workloads resolve to pure k-parallelism
    # ('auto' reads the card's memory; the host has none to read)
    mesh = make_mesh(devices=[dev] * N_POSITIONS, n_t=traj.n_frames, n_atoms=traj.n_atoms,
                     hbm_bytes='auto' if dev.type == 'cuda' else HOST_BUDGET)
    print(f"mesh: {dict(mesh.shape)}")

    _, k_vecs, shape = calc.get_k_grid('xy', (-1.5, 1.5), (-1.5, 1.5), 16, 16)

    # 1. coherent subset: only type-1 atoms form the basis
    freqs, inten1, _ = calc.calculate_kgrid_browse_sharded(mesh, k_vecs, basis_atom_types=[1])
    print(f"coherent type-1 browse: {inten1.shape} planes, {len(freqs)} frequencies")

    # 2. incoherent per-type: intensities accumulate in the mesh, the
    #    trajectory streams through the positions ONCE for both groups
    _, inten_inc, _ = calc.calculate_kgrid_browse_sharded(
        mesh, k_vecs, basis_atom_types=[1, 2], summation_mode='incoherent', t_superchunk=16)
    print(f"incoherent 2-group browse: max intensity {inten_inc.max():.3e}")

    # 3. chiral dispersion surface: phase gathered AT each peak bin:
    #    peak-triplet readback, calibrated FWHM linewidths
    pf, ph, pw, pphase = calc.calculate_kgrid_peaks_sharded(
        mesh, k_vecs, n_peaks=1, chiral=True, chiral_axis='z', width_method='lorentzian')
    print(f"chiral peak surface: freq {pf.min():.2f}..{pf.max():.2f} THz, "
          f"|phase| <= {np.abs(pphase).max():.3f} rad, "
          f"median FWHM {np.median(pw):.3f} THz")
    check(np.abs(pphase).max() <= np.pi / 2 + 1e-6, "chiral phase outside ±π/2")

    # 4. NUFFT engine striped over the mesh positions (uniform grids)
    gpf, gph, gpw = calc.calculate_kgrid_peaks_sharded(
        mesh, k_vecs, n_peaks=1, engine='gridded', k_grid_shape=shape)
    agree = float(np.mean(gpf == pf))
    print(f"gridded-vs-direct peak-bin agreement: {agree:.1%}")
    check(agree >= 0.99, f"gridded and direct peak bins agree on {agree:.1%}")
    return {'inten1': inten1, 'inten_inc': inten_inc, 'pf': pf, 'ph': ph, 'pw': pw,
            'pphase': pphase, 'gpf': gpf}


if __name__ == "__main__":
    main(**parse_args(__doc__))
