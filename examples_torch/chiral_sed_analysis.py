"""Chiral SED: phase difference between two polarization components.

The coherent SED of a synthetic crystal along [110], and the phase between
its x and y components (the chiral axis z), saved with the spectrum.

Run:  python examples_torch/chiral_sed_analysis.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SED, SEDCalculator, SEDPlotter
from psa_tpu_torch.models import make_random_crystal_trajectory


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)
    traj = make_random_crystal_trajectory(n_cells_xyz=(6, 6, 4), basis=2,
                                          n_frames=256, dt_ps=0.02, a=5.43)
    calc = SEDCalculator(traj, nx=6, ny=6, nz=4, device=dev)

    # Coherent SED along [110] (chiral analysis needs complex amplitudes)
    k_mags, k_vecs = calc.get_k_path('110', bz_coverage=1.0, n_k=100)
    sed = calc.calculate(k_mags, k_vecs, summation_mode='coherent')

    # Phase between the two components perpendicular to the chiral axis 'z':
    # components (0, 1) = (x, y).
    phase = calc.calculate_chiral_phase(sed.sed[:, :, 0], sed.sed[:, :, 1],
                                        angle_range_opt='C')
    check(np.all(np.isfinite(phase)) and np.abs(phase).max() <= np.pi / 2 + 1e-6,
          "chiral phase (option C) finite and within ±π/2")
    sed_chiral = SED(sed.sed, sed.freqs, sed.k_points, sed.k_vectors, phase=phase)
    sed_chiral.save(out / "chiral_sed")

    if figures():
        SEDPlotter(sed_chiral, '2d_phase', str(out / "chiral_phase.png"),
                   title="Chiral phase Δφ(k, ω), axis z", cmap='twilight',
                   max_freq=25.0).generate_plot()
        SEDPlotter(sed_chiral, '2d_intensity', str(out / "chiral_intensity.png"),
                   max_freq=25.0, intensity_scale='dsqrt').generate_plot()
    print(f"outputs in {out}/")
    return {'sed': sed.sed, 'phase': phase}


if __name__ == "__main__":
    main(**parse_args(__doc__))
