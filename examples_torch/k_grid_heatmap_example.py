"""k-grid heatmap sweep: compute once, render frequency slices with a global
color scale.

A 51×51 grid of the xy plane (the reference example uses 201×201 with
k_chunk_size=10,000): the SED is computed once, saved, and reused by the next
run; heat maps of four frequency slices share one color scale.

Run:  python examples_torch/k_grid_heatmap_example.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SED, SEDCalculator, SEDPlotter
from psa_tpu_torch.models import make_random_crystal_trajectory

GRID = 51          # reference example uses 201


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir, 'kgrid')
    traj = make_random_crystal_trajectory(n_cells_xyz=(6, 6, 2), basis=2,
                                          n_frames=128, dt_ps=0.02, a=5.43)
    calc = SEDCalculator(traj, nx=6, ny=6, nz=2, device=dev)

    cache_base = out / "kgrid_sed"
    try:
        sed = SED.load(cache_base)               # reuse a previous run's SED
        print("loaded cached k-grid SED")
    except FileNotFoundError:
        _, k_vecs, shape = calc.get_k_grid('xy', (-2.0, 2.0), (-2.0, 2.0),
                                           GRID, GRID, k_fixed_val=0.0)
        sed = calc.calculate(np.array([]), k_vecs, k_grid_shape=shape,
                             k_chunk_size=4096)
        sed.save(cache_base)
    check(sed.sed.shape == (traj.n_frames, GRID * GRID, 3) and np.all(np.isfinite(sed.sed)),
          f"k-grid SED {sed.sed.shape} finite")

    # Global color scale across the sweep so frames are comparable
    pos = sed.freqs >= 0
    inten = sed.intensity[pos]
    vmax = float(np.sqrt(inten).max())

    if figures():
        for f_target in (2.0, 5.0, 10.0, 15.0):
            SEDPlotter(sed, '3d_heatmap', str(out / f"heatmap_{f_target:.0f}THz.png"),
                       heatmap_target_freq_thz=f_target, heatmap_plane='xy',
                       intensity_scale='sqrt', vmin=0.0, vmax=vmax).generate_plot()
    print(f"outputs in {out}/")
    return {'sed': sed.sed, 'vmax': vmax}


if __name__ == "__main__":
    main(**parse_args(__doc__))
