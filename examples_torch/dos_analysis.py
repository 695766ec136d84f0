"""Vibrational DOS: type-projected partial densities of a diatomic chain.

The DOS, the Fourier transform of the velocity autocorrelation, is the
k-independent companion of the SED.  On a diatomic chain the acoustic band
(below the gap) is dominated by the HEAVY sublattice and the optical band
(above the gap) by the LIGHT one; the type-projected partial DOS shows it,
and the band edges land on the analytic ω±(k) extrema.

Run:  python examples_torch/dos_analysis.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.models import diatomic_chain_branches, make_diatomic_chain_trajectory

KAPPA, M1, M2, A = 800.0, 1.0, 3.0, 5.0


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)
    traj = make_diatomic_chain_trajectory(n_cells=64, n_frames=1024, dt_ps=0.02,
                                          a=A, kappa=KAPPA, m1=M1, m2=M2, seed=0)
    calc = SEDCalculator(traj, nx=64, ny=1, nz=1, device=dev)

    freqs, dos = calc.calculate_dos(basis_atom_types=[1, 2], max_freq=12.0)
    light, heavy = dos[0], dos[1]          # type 1 = m1 (light), type 2 = m2

    # analytic band edges (rad/ps -> THz) at the zone boundary / center
    k_edge = np.array([np.pi])             # k·a = π
    w_ac, w_op, _, _ = diatomic_chain_branches(k_edge, KAPPA, M1, M2)
    nu_ac_max = w_ac[0] / (2 * np.pi)      # top of the acoustic band
    nu_op_min = w_op[0] / (2 * np.pi)      # bottom of the optical band
    gap = (freqs > nu_ac_max + 0.3) & (freqs < nu_op_min - 0.3)
    print(f"acoustic top {nu_ac_max:.2f} THz, optical bottom {nu_op_min:.2f} THz")
    print(f"DOS inside the gap: {dos[:, gap].max():.3e} "
          f"(max overall {dos.max():.3e}) — bands are gapped")
    check(dos[:, gap].max() < 1e-2 * dos.max(), "DOS inside the gap above 1% of its max")

    # band character: heavy dominates acoustic, light dominates optical
    ac = (freqs > 0.5) & (freqs < nu_ac_max)
    op = freqs > nu_op_min
    heavy_light = heavy[ac].sum() / max(light[ac].sum(), 1e-30)
    light_heavy = light[op].sum() / max(heavy[op].sum(), 1e-30)
    print(f"acoustic band: heavy/light weight = {heavy_light:.2f} (>1 expected)")
    print(f"optical band:  light/heavy weight = {light_heavy:.2f} (>1 expected)")
    check(heavy_light > 1 and light_heavy > 1, "band character of the partial DOS")

    if figures():
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(freqs, light, label=f"type 1 (m={M1})")
        ax.plot(freqs, heavy, label=f"type 2 (m={M2})")
        ax.axvspan(nu_ac_max, nu_op_min, alpha=0.15, color='gray', label='gap')
        ax.set_xlabel("frequency (THz)")
        ax.set_ylabel("partial DOS (arb.)")
        ax.legend()
        fig.savefig(out / "partial_dos.png", dpi=130, bbox_inches='tight')
        plt.close(fig)
        print(f"plot: {out / 'partial_dos.png'}")
    return {'freqs': freqs, 'dos': dos}


if __name__ == "__main__":
    main(**parse_args(__doc__))
