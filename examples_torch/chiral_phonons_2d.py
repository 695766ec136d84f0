"""2D chiral phonons on a honeycomb lattice: K-point circular polarization.

The chiral-phonon physics behind the chiral SED lives at the K (Dirac) points
of 2D honeycomb materials, where phonon modes carry circular atomic motion of
definite handedness.  This example synthesizes that geometry (a
graphene-like lattice whose out-of-plane bands follow the analytic two-band
dispersion, plus one circularly polarized in-plane mode at K) and recovers
it through the k-grid paths:

  * the dispersion surface via on-device peak extraction
    (``calculate_kgrid_peaks``),
  * the chiral phase map via ``calculate_kgrid_browse(chiral=True)``:
    Δφ = ±π/2 at K, its sign the mode's handedness.

Run:  python examples_torch/chiral_phonons_2d.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.models import (honeycomb_K_point, honeycomb_dispersion,
                                  honeycomb_structure_factor, make_honeycomb_trajectory)

N, A, NU_K = 12, 2.46, 8.0


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)
    traj = make_honeycomb_trajectory(n_cells=N, n_frames=512, dt_ps=0.01, a=A,
                                     nu_K_thz=NU_K, chiral=+1, seed=0)
    calc = SEDCalculator(traj, nx=N, ny=N, nz=1, device=dev)

    # k-grid covering the first Brillouin zone around Γ and K
    kpt = honeycomb_K_point(A)
    kmax = 1.25 * kpt[0]
    _, k_vecs, shape = calc.get_k_grid('xy', (-kmax, kmax), (-kmax, kmax), 48, 48)

    # 1) dispersion surface from on-device peak extraction.  The grid samples
    # arbitrary k, so each point's spectrum is dominated by the NEAREST allowed
    # lattice mode, seen through the coherent visibility weight |1 ± e^{iθ}|²
    # (θ = arg f): predict the top peak from the dominant band at that mode.
    peak_freqs, peak_inten, peak_width = calc.calculate_kgrid_peaks(k_vecs, n_peaks=2)
    b1 = (2 * np.pi / A) * np.array([1.0, -1 / np.sqrt(3.0)])
    b2 = (2 * np.pi / A) * np.array([0.0, 2 / np.sqrt(3.0)])
    mm, nn = np.meshgrid(np.arange(-N, 2 * N), np.arange(-N, 2 * N), indexing='ij')
    allowed = (mm.reshape(-1, 1) * b1 + nn.reshape(-1, 1) * b2) / N
    near = allowed[np.argmin(
        np.linalg.norm(k_vecs[:, None, :2] - allowed[None], axis=-1), axis=1)]
    theta = np.angle(honeycomb_structure_factor(near[:, 0], near[:, 1], A))
    nu_ac, nu_op = honeycomb_dispersion(near[:, 0], near[:, 1], A, NU_K)
    expected = np.where(np.abs(theta) < np.pi / 2, nu_ac, nu_op)
    visible = nu_ac > 1.0
    err = np.median(np.abs(peak_freqs[0][visible] - expected[visible]))
    bin_thz = 1.0 / (traj.n_frames * traj.dt_ps)
    print(f"dispersion surface: median |peak − predicted| = {err:.3f} THz "
          f"(bin {bin_thz:.3f})")
    check(err <= bin_thz, f"median peak error {err:.3f} THz > one bin {bin_thz:.3f}")

    # 2) chiral phase map: ±π/2 island at the K points
    freqs, inten, phase = calc.calculate_kgrid_browse(k_vecs, chiral=True, chiral_axis='z')
    nu_c = 0.6 * NU_K                          # the synthesized chiral mode
    fi = int(np.argmin(np.abs(freqs - nu_c)))
    ki = int(np.argmin(np.linalg.norm(k_vecs - kpt[None, :], axis=1)))
    print(f"chiral phase at (K, {nu_c:.1f} THz): {phase[fi, ki]:+.4f} rad "
          f"(π/2 = {np.pi / 2:.4f}; handedness +1)")
    check(abs(phase[fi, ki] - np.pi / 2) < 0.05, f"chiral phase at K {phase[fi, ki]} != +π/2")

    if figures():
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
        im0 = axes[0].pcolormesh(peak_freqs[0].reshape(shape).T, cmap='inferno',
                                 shading='gouraud')
        axes[0].set_title("top-peak frequency surface (THz)")
        fig.colorbar(im0, ax=axes[0])
        im1 = axes[1].pcolormesh(phase[fi].reshape(shape).T, cmap='twilight',
                                 vmin=-np.pi / 2, vmax=np.pi / 2, shading='gouraud')
        axes[1].set_title(f"chiral phase at {nu_c:.1f} THz (K points: +π/2)")
        fig.colorbar(im1, ax=axes[1])
        fig.savefig(out / "chiral_phonons_2d.png", dpi=130, bbox_inches='tight')
        plt.close(fig)
        print(f"plot: {out / 'chiral_phonons_2d.png'}")
    return {'peak_freqs': peak_freqs, 'peak_inten': peak_inten, 'peak_width': peak_width,
            'freqs': freqs, 'inten': inten, 'phase': phase}


if __name__ == "__main__":
    main(**parse_args(__doc__))
