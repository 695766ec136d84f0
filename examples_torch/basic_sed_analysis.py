"""Basic SED analysis: k-path dispersion of a synthetic chain.

A 1D chain whose dispersion is exactly ν = ν_max·|sin(ka/2)| THz is
synthesized, its coherent SED computed along the path from Γ to the zone
edge, and the peak of each k-column checked against the analytic curve (to
within one frequency bin).

Run:  python examples_torch/basic_sed_analysis.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SEDCalculator, SEDPlotter
from psa_tpu_torch.models import make_chain_trajectory

N_CELLS, A0, OMEGA_MAX = 64, 2.5, 10.0


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)

    # 1. Trajectory (swap for: TrajectoryLoader("traj.dump", dt=0.02).load())
    traj = make_chain_trajectory(n_cells=N_CELLS, n_frames=512, dt_ps=0.02,
                                 a=A0, omega_max_thz=OMEGA_MAX)
    print(f"Trajectory: {traj.n_frames} frames, {traj.n_atoms} atoms")

    # 2. Engine
    calc = SEDCalculator(traj, nx=N_CELLS, ny=1, nz=1, device=dev)

    # 3. k-path from Γ to the BZ edge and SED
    k_mags, k_vecs = calc.get_k_path('x', bz_coverage=0.5, n_k=N_CELLS // 2 + 1)
    sed = calc.calculate(k_mags, k_vecs, summation_mode='coherent')
    sed.save(out / "chain_sed")

    # 4. Dispersion plot
    if figures():
        SEDPlotter(sed, '2d_intensity', str(out / "dispersion.png"),
                   title=f"1D chain dispersion (analytic: {OMEGA_MAX}·|sin(ka/2)| THz)",
                   max_freq=OMEGA_MAX * 1.2, intensity_scale='sqrt').generate_plot()

    # 5. Check the peaks against the analytic curve
    inten, freqs = sed.intensity, sed.freqs
    pos = freqs >= 0
    peaks = freqs[pos][np.argmax(inten[pos], axis=0)]
    analytic = OMEGA_MAX * np.abs(np.sin(k_mags * A0 / 2))
    miss = np.abs(peaks[1:] - analytic[1:]).max()
    print("max |peak - analytic| =", miss, "THz")
    resolution = 1.0 / (traj.n_frames * traj.dt_ps)
    check(miss <= resolution, f"peaks {miss} THz off the analytic curve (bin {resolution})")
    print(f"outputs in {out}/")
    return {'sed': sed.sed, 'peaks': peaks, 'max_miss': miss}


if __name__ == "__main__":
    main(**parse_args(__doc__))
