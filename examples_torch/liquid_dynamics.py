"""Liquid dynamics: self-diffusion from the incoherent S_s(k,ω).

Crystals have mean positions to project on; liquids do not: the harmonic SED
(static phases) is meaningless there, and the instantaneous-phase
observables take over.  This example runs the standard liquid-state workflow
on a synthetic Brownian "liquid" whose diffusion constant D is known exactly:

  1. ``calculate_dsf_self`` → S_s(k,ω), the incoherent dynamic structure
     factor (Σ_ω = 1 per k);
  2. the quasi-elastic ω = 0 peak narrows the faster particles diffuse:
     F_s(k, n) = exp(-k²·D·dt·n), so  n_t·S_s(k, 0) = (1+e^{-λ})/(1−e^{-λ})
     with λ = k²·D·dt; inverting gives D per k;
  3. D̂ from the decay of F_s(k, τ) and from the MSD slope, S(k) and g(r)
     of the ideal gas, and the S_s(k,ω) map with its quasi-elastic profile.

The same estimator applied to a real MD trajectory (load it with
``TrajectoryLoader``, positions UNWRAPPED) gives the self-diffusion
coefficient without computing mean-square displacements.

Run:  python examples_torch/liquid_dynamics.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SEDCalculator, Trajectory
from psa_tpu_torch.core.trajectory import make_box_arrays
from psa_tpu_torch.ops.instantaneous import nearest_commensurate

N_T, N_ATOMS = 4096, 512
D_TRUE, DT_PS = 0.5, 0.1                       # Å²/ps, ps per frame


def brownian_liquid():
    """Uncorrelated walkers with diffusion constant D_TRUE in a 50 Å box."""
    rng = np.random.default_rng(0)
    sigma = np.sqrt(2 * D_TRUE * DT_PS)            # per-dimension step std
    pos0 = rng.uniform(0, 50.0, (1, N_ATOMS, 3))   # uncorrelated initial positions
    pos = (pos0 + np.cumsum(rng.normal(0, sigma, (N_T, N_ATOMS, 3)), axis=0)
           ).astype(np.float32)
    box = np.diag([50.0] * 3).astype(np.float32)
    lengths, tilts = make_box_arrays(box)
    return Trajectory(pos, np.zeros_like(pos), np.ones(N_ATOMS, np.int32),
                      np.arange(N_T, dtype=np.float32), box_matrix=box,
                      box_lengths=lengths, box_tilts=tilts, dt_ps=DT_PS)


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)
    traj = brownian_liquid()
    calc = SEDCalculator(traj, nx=1, ny=1, nz=1, device=dev)

    # --- S_s over a commensurate k ladder -------------------------------------
    k_targets = np.zeros((6, 3), np.float32)
    k_targets[:, 0] = np.linspace(0.4, 1.4, 6)
    kv = nearest_commensurate(k_targets, traj.box_matrix)
    freqs, s_s = calc.calculate_dsf_self(kv, max_freq=3.0)
    print(f"S_s planes: {s_s.shape} (Σ_ω≥0 ≈ {s_s.sum(axis=0).round(3)})")

    # equal-time structure: independent Brownian walkers are uncorrelated, so
    # the static structure factor is flat at 1 (no short-range order)
    sk = calc.calculate_sk(kv)
    print(f"S(k) = {sk.round(3)}  (ideal-gas limit: 1)")

    # real-space structure: uncorrelated walkers are an ideal gas, g(r) = 1
    r_g, g_r = calc.calculate_rdf(n_bins=60, max_frames=8)
    print(f"g(r) mean over r > 2 Å = {g_r[r_g > 2].mean():.3f} (ideal-gas limit: 1)")

    # time-domain route: the self intermediate scattering function decays as
    # F_s(k,τ) = exp(−k²·D·τ) for Fickian diffusion
    lags, f_s = calc.calculate_isf_self(kv, n_lags=50)
    k2 = kv[:, 0].astype(np.float64) ** 2
    slopes = [np.polyfit(lags[1:30], np.log(np.maximum(f_s[1:30, j], 1e-6)), 1)[0]
              for j in range(len(kv))]
    d_isf = -np.asarray(slopes) / k2
    print(f"pooled D̂ from F_s decay = {d_isf.mean():.3f} Å²/ps")
    check(abs(d_isf.mean() - D_TRUE) < 0.1 * D_TRUE, f"D from F_s {d_isf.mean()}")

    # real-space route: the Einstein relation MSD(τ) = 6·D·τ
    lags_m, msd = calc.calculate_msd(n_lags=60)
    d_msd = np.polyfit(lags_m[1:], msd[0, 1:].astype(np.float64), 1)[0] / 6.0
    print(f"D̂ from the MSD slope = {d_msd:.3f} Å²/ps")
    check(abs(d_msd - D_TRUE) < 0.1 * D_TRUE, f"D from the MSD {d_msd}")

    # --- invert the quasi-elastic peak for D per k -----------------------------
    s0n = N_T * s_s[0].astype(np.float64)          # n_t · S_s(k, ω=0)
    lam = -np.log((s0n - 1.0) / (s0n + 1.0))       # k²·D·dt
    d_est = lam / (kv[:, 0].astype(np.float64) ** 2 * DT_PS)
    for k, d in zip(kv[:, 0], d_est):
        print(f"  k = {k:.3f} 2π/Å  →  D̂ = {d:.3f} Å²/ps")
    print(f"pooled D̂ = {d_est.mean():.3f} Å²/ps  (injected D = {D_TRUE})")
    check(abs(d_est.mean() - D_TRUE) < 0.1 * D_TRUE, f"D from S_s(k, 0) {d_est.mean()}")

    if figures():
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 3, figsize=(15, 4.2))
        pcm = axes[0].pcolormesh(kv[:, 0], freqs, np.sqrt(s_s), cmap='inferno',
                                 shading='gouraud')
        fig.colorbar(pcm, ax=axes[0], label='√S_s (arb.)')
        axes[0].set_xlabel('k (2π/Å)')
        axes[0].set_ylabel('ν (THz)')
        axes[0].set_title('S_s(k,ω): quasi-elastic ridge broadens as D·k²')
        ki = 3
        axes[1].semilogy(freqs, s_s[:, ki], '.-', label=f'k = {kv[ki, 0]:.2f}')
        hwhm = lam[ki] / (2 * np.pi * DT_PS)           # THz
        axes[1].axvline(hwhm, color='C1', ls='--', label=f'λ/2π·dt = {hwhm:.2f} THz')
        axes[1].set_xlabel('ν (THz)')
        axes[1].set_ylabel('S_s')
        axes[1].set_title('Quasi-elastic profile')
        axes[1].legend()
        axes[2].plot(kv[:, 0], d_est, 'o-', label='D̂(k) from S_s(k, 0)')
        axes[2].axhline(D_TRUE, color='k', ls=':', label=f'injected D = {D_TRUE}')
        axes[2].set_xlabel('k (2π/Å)')
        axes[2].set_ylabel('D (Å²/ps)')
        axes[2].set_ylim(0, 2 * D_TRUE)
        axes[2].set_title('Recovered diffusion constant')
        axes[2].legend()
        fig.tight_layout()
        fig.savefig(out / 'liquid_dynamics.png', dpi=150)
        plt.close(fig)
        print(f"wrote {out / 'liquid_dynamics.png'}")
    return {'s_s': s_s, 'sk': sk, 'r_g': r_g, 'g_r': g_r, 'f_s': f_s, 'msd': msd, 'd_est': d_est}


if __name__ == "__main__":
    main(**parse_args(__doc__))
