"""Phonon transport from SED: lifetimes, group velocities, and κ.

The SED method for thermal transport (Thomas et al., PRB 81, 081411): each
mode's spectral peak is a Lorentzian whose width is the inverse phonon
lifetime; with group velocities from the dispersion surface, kinetic theory
gives the single-mode-relaxation-time thermal conductivity
κ_αβ = (k_B/V)·Σ v_α v_β τ.

This example runs the whole chain on a synthetic damped square lattice where
every step has a closed-form answer (every mode's amplitude decays as
e^{-γt}, so τ = 1/(2γ) exactly, and v_g is the analytic surface gradient)
and prints the recovered values next to the truth.  One
``calculate_thermal_conductivity`` call does: on-device Lorentzian peak
extraction → band sorting → ∇_k ν → τ → κ.

Run:  python examples_torch/thermal_transport.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.models import make_square_lattice_trajectory, square_lattice_dispersion
from psa_tpu_torch.ops import dispersion, transport

A, NU_MAX, N_CELLS = 2.5, 10.0, 16
N_FRAMES, DT, GAMMA = 2048, 0.01, 1.0          # γ: amplitude decay, 1/ps


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)
    traj = make_square_lattice_trajectory(n_cells=N_CELLS, n_frames=N_FRAMES,
                                          dt_ps=DT, a=A, nu_max_thz=NU_MAX,
                                          seed=0, amp_decay_per_ps=GAMMA)
    calc = SEDCalculator(traj, nx=N_CELLS, ny=N_CELLS, nz=1, device=dev)

    # k-grid exactly on the supercell's allowed modes, excluding Γ (no mode
    # content there): k = 2π·m/(N·a), m = 1 … N/2
    dk = 2 * np.pi / (N_CELLS * A)
    m = N_CELLS // 2
    _, k_vecs, shape = calc.get_k_grid("xy", (dk, m * dk), (dk, m * dk), m, m)

    res, band_freqs, vx, vy = calc.calculate_thermal_conductivity(
        k_vecs, shape, n_bands=1, exclusion_bins=12)

    tau_want = 1.0 / (2 * GAMMA)
    tau_mean = np.nanmean(res.lifetimes_ps)
    print(f"modes resolved: {res.n_modes_used}/{res.n_modes_total}")
    print(f"lifetime  τ: mean {tau_mean:.3f} ps (analytic {tau_want:.3f} ps)")
    print(f"κ_xx = {res.kappa_xx:.4f} W/m·K   κ_yy = {res.kappa_yy:.4f} W/m·K "
          f"  κ_xy = {res.kappa_xy:+.5f}")

    # closed-form cross-check: analytic v_g on the same grid, τ = 1/(2γ)
    kx = np.unique(k_vecs[:, 0].astype(np.float64))
    ky = np.unique(k_vecs[:, 1].astype(np.float64))
    KX, KY = np.meshgrid(kx, ky, indexing="ij")
    want_vx, want_vy = dispersion.group_velocity_grid(
        square_lattice_dispersion(KX, KY, a=A, nu_max_thz=NU_MAX)[None], kx, ky)
    vol = float(abs(np.linalg.det(traj.box_matrix.astype(np.float64))))
    want = transport.kinetic_kappa(want_vx, want_vy, np.full_like(want_vx, tau_want), vol)
    ratio = res.kappa_xx / want.kappa_xx
    print(f"analytic κ_xx = {want.kappa_xx:.4f} W/m·K (measured/analytic = {ratio:.3f})")
    check(res.n_modes_used == res.n_modes_total, "modes left unresolved")
    check(abs(tau_mean - tau_want) < 0.05 * tau_want, f"mean lifetime {tau_mean} ps")
    check(abs(ratio - 1.0) < 0.05, f"κ_xx measured/analytic {ratio}")

    if figures():
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 3, figsize=(15, 4.2))
        im0 = axes[0].pcolormesh(kx, ky, band_freqs[0].T, shading="gouraud", cmap="inferno")
        fig.colorbar(im0, ax=axes[0], label="ν (THz)")
        axes[0].set_title("dispersion sheet")
        im1 = axes[1].pcolormesh(kx, ky, np.hypot(vx[0], vy[0]).T, shading="gouraud",
                                 cmap="viridis")
        fig.colorbar(im1, ax=axes[1], label="|v_g| (Å/ps)")
        axes[1].set_title("group velocity")
        im2 = axes[2].pcolormesh(kx, ky, res.lifetimes_ps[0].T, shading="gouraud",
                                 cmap="cividis")
        fig.colorbar(im2, ax=axes[2], label="τ (ps)")
        axes[2].set_title(f"lifetimes (analytic {tau_want:.2f} ps)")
        for ax in axes:
            ax.set_xlabel("k_x (2π/Å)")
            ax.set_ylabel("k_y (2π/Å)")
            ax.set_aspect("equal", adjustable="box")
        fig.tight_layout()
        fig.savefig(out / "thermal_transport.png", dpi=160)
        plt.close(fig)
        print(f"wrote {out / 'thermal_transport.png'}")
    return {'band_freqs': band_freqs, 'vx': vx, 'vy': vy, 'lifetimes': res.lifetimes_ps,
            'kappa': np.array([res.kappa_xx, res.kappa_yy, res.kappa_xy])}


if __name__ == "__main__":
    main(**parse_args(__doc__))
