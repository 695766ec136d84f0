"""Dynamic structure factor + current spectra of a vibrating chain.

The SED projects velocities onto STATIC mean-position phases, the harmonic
phonon picture.  ``calculate_dsf`` uses the INSTANTANEOUS phases
exp(i k·r_a(t)) instead, producing the scattering observables:

  * S(k,ω), the coherent dynamic structure factor: Bragg weight at
    reciprocal-lattice k in the elastic (ω=0) row, one-phonon Brillouin
    peaks on the dispersion elsewhere; Σ over all ω rows = S(k);
  * C_L/C_T(k,ω), longitudinal/transverse current spectra, which track the
    SED dispersion at low temperature and carry anharmonic shifts and
    broadening (and liquid dynamics) beyond it;
  * S_s(k,ω), the self (incoherent) part, Σ_ω = 1 per k.

This example checks all three against the chain's analytic dispersion
ν(k) = ν_max·|sin(ka/2)| and the Bragg and Parseval sum rules, then plots
the C_L map.

Run:  python examples_torch/dynamic_structure_factor.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SED, SEDCalculator, SEDPlotter
from psa_tpu_torch.models import make_chain_trajectory
from psa_tpu_torch.ops.instantaneous import nearest_commensurate

N_CELLS, A, NU_MAX = 48, 2.5, 9.0


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)
    traj = make_chain_trajectory(n_cells=N_CELLS, n_frames=512, dt_ps=0.02,
                                 a=A, omega_max_thz=NU_MAX, seed=2)
    calc = SEDCalculator(traj, nx=N_CELLS, ny=1, nz=1, device=dev)

    # box-commensurate k-path: the first Brillouin zone (m = 1 … N/2), plus
    # the reciprocal-lattice point G = 2π/a for the Bragg check.  (Beyond-zone
    # k would alias this synthetic trajectory's one-way travelling waves onto
    # the ω < 0 rows, which the ω ≥ 0 view drops.)
    m = np.arange(1, N_CELLS // 2 + 1)
    k_vecs = np.zeros((len(m) + 1, 3), dtype=np.float32)
    k_vecs[:-1, 0] = 2 * np.pi * m / (N_CELLS * A)
    k_vecs[-1, 0] = 2 * np.pi / A                     # G
    k_vecs = nearest_commensurate(k_vecs, traj.box_lengths)
    k_mags = k_vecs[:, 0]

    freqs, S, C_L, C_T = calc.calculate_dsf(k_vecs, max_freq=12.0)
    _, S_s = calc.calculate_dsf_self(k_vecs[:4])

    # 1) Brillouin peaks of C_L land on the analytic dispersion (first zone)
    nu_pred = NU_MAX * np.abs(np.sin(k_mags[:-1] * A / 2))
    nu_meas = freqs[np.argmax(C_L[:, :-1], axis=0)]
    err, bin_thz = np.abs(nu_meas - nu_pred).max(), freqs[1] - freqs[0]
    print(f"C_L dispersion error: max {err:.3f} THz (bin width {bin_thz:.3f})")
    check(err <= bin_thz, f"C_L peaks {err} THz off the dispersion")

    # 2) Bragg: the reciprocal-lattice point k = G piles its weight into the
    #    elastic (ω=0) row; transverse plane is empty (motion ∥ x)
    g_col = len(m)
    print(f"S at G = 2π/a: elastic row {S[0, g_col]:.1f} (≈ N·|⟨e^{{iku}}⟩|², "
          f"Debye-Waller-reduced from N = {traj.n_atoms}); "
          f"inelastic max {S[1:, g_col].max():.3f}")
    leak = C_T.max() / C_L.max()
    print(f"transverse leakage C_T/C_L = {leak:.2e}")
    check(S[0, g_col] > 100 * S[1:, g_col].max(), "no Bragg weight in the elastic row at G")
    check(leak < 1e-6, f"transverse leakage {leak:.2e}")

    # 3) the self part's ω-sum rule (full-spectrum sum = 1; ω ≥ 0 keeps ~all)
    sums = np.asarray(S_s).sum(axis=0)
    print(f"Σ_ω S_s per k (ω ≥ 0 rows): {sums.round(4)}")
    check(np.all(np.abs(sums - 1.0) < 1e-2), f"self-part sums {sums}")

    # 4) plot the C_L map through the SED plotting stack (it is a plain
    #    (n_freq, n_k) intensity plane, so the SED container carries it)
    if figures():
        sed_like = SED(C_L, freqs, k_mags, k_vecs, is_complex=False, dt_ps=traj.dt_ps)
        SEDPlotter(sed_like, '2d_intensity', str(out / "current_spectrum_CL.png"),
                   intensity_scale='sqrt').generate_plot()
        print(f"wrote {out / 'current_spectrum_CL.png'}")
    return {'freqs': freqs, 'S': S, 'C_L': C_L, 'C_T': C_T, 'S_s': S_s}


if __name__ == "__main__":
    main(**parse_args(__doc__))
