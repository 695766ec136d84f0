"""Spectral statistics: Welch segment averaging and ensemble averaging.

A single-trajectory SED estimate carries O(1) relative variance per (ω, k)
bin: lines sit on a ragged background.  Two standard remedies:

  * ``SEDCalculator.calculate_welch(..., segments=S)`` averages S
    non-overlapping time windows of ONE run (variance ÷ S, frequency
    resolution ÷ S);
  * ``psa_tpu_torch.average_seds([...])`` pools full-resolution spectra from
    M independent runs (variance ÷ M at unchanged resolution).

Both run on a noisy monatomic chain whose dispersion ν(k) = ν_max·|sin(ka/2)|
is analytic, so the peak positions are checkable while the background
scatter shrinks.

Run:  python examples_torch/spectral_statistics.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SEDCalculator, average_seds
from psa_tpu_torch.models import make_chain_trajectory

N_CELLS, N_FRAMES, DT, A, NU_MAX = 64, 2048, 0.02, 2.5, 8.0
SEGMENTS, N_RUNS = 8, 4

# commensurate probe k-points (k_m = 2pi m / (N a)) so each sits ON a chain
# normal mode and the analytic line frequency is exact
M_VALS = np.array([4, 8, 12, 16, 20, 24, 28])
K_MAGS = (2 * np.pi * M_VALS / (N_CELLS * A)).astype(np.float32)
K_VECS = np.outer(K_MAGS, [1, 0, 0]).astype(np.float32)
NU_EXPECTED = NU_MAX * np.abs(np.sin(K_MAGS * A / 2))


def make_calc(seed, dev):
    traj = make_chain_trajectory(n_cells=N_CELLS, n_frames=N_FRAMES, dt_ps=DT,
                                 a=A, omega_max_thz=NU_MAX, seed=seed, noise=0.5)
    return SEDCalculator(traj, nx=N_CELLS, ny=1, nz=1, device=dev)


def peak_and_scatter(freqs, inten):
    """Per-k peak frequency (inside the dispersion band) + relative
    scatter of the white-noise floor above the band, where per-bin
    intensity is chi-squared and averaging must shrink rel. std 1/sqrt(S)."""
    band = (freqs > 0) & (freqs <= NU_MAX)
    noise_floor = freqs > NU_MAX * 1.2
    f = freqs[band]
    peaks = [f[np.argmax(inten[band, i])] for i in range(inten.shape[1])]
    floor = inten[noise_floor]
    scatter = float(np.median(np.std(floor, axis=0) / np.mean(floor, axis=0)))
    return np.array(peaks), scatter


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)

    # --- single-run, full-resolution estimate (the classic one) -------------
    calc = make_calc(0, dev)
    full = calc.calculate(K_MAGS, K_VECS)
    pk_full, sc_full = peak_and_scatter(full.freqs, full.intensity)

    # --- Welch: 8 windows of the same run ------------------------------------
    welch = calc.calculate_welch(K_MAGS, K_VECS, segments=SEGMENTS)
    pk_welch, sc_welch = peak_and_scatter(welch.freqs, welch.intensity)

    # --- ensemble: 4 independent runs, full resolution ------------------------
    members = [make_calc(s, dev).calculate(K_MAGS, K_VECS) for s in range(N_RUNS)]
    ens = average_seds(members)
    pk_ens, sc_ens = peak_and_scatter(ens.freqs, ens.intensity)

    res_full = 1.0 / (N_FRAMES * DT)
    res_welch = SEGMENTS / (N_FRAMES * DT)
    print("dispersion check (max |peak - analytic| in THz):")
    print(f"  full   {np.max(np.abs(pk_full - NU_EXPECTED)):.3f}  "
          f"(resolution {res_full:.3f})")
    print(f"  welch  {np.max(np.abs(pk_welch - NU_EXPECTED)):.3f}  "
          f"(resolution {res_welch:.3f})")
    print(f"  ensemble {np.max(np.abs(pk_ens - NU_EXPECTED)):.3f}")
    print("background scatter (median rel. std of off-peak bins):")
    print(f"  full {sc_full:.2f}   welch/{SEGMENTS} {sc_welch:.2f} "
          f"(expect ~{sc_full / np.sqrt(SEGMENTS):.2f})   "
          f"ensemble/{N_RUNS} {sc_ens:.2f} "
          f"(expect ~{sc_full / np.sqrt(N_RUNS):.2f})")

    check(np.max(np.abs(pk_welch - NU_EXPECTED)) < 3 * res_welch, "Welch peaks off the curve")
    check(sc_welch < 0.75 * sc_full and sc_ens < 0.85 * sc_full,
          "averaging did not shrink the background scatter")

    if figures():
        import matplotlib.pyplot as plt
        i_k = len(K_MAGS) // 2
        fig, ax = plt.subplots(figsize=(7, 4.2))
        for sed, label in ((full, 'full FFT'), (welch, f'Welch S={SEGMENTS}'),
                           (ens, f'ensemble M={N_RUNS}')):
            pos = sed.freqs > 0
            ax.semilogy(sed.freqs[pos], sed.intensity[pos, i_k], label=label, alpha=0.85)
        ax.axvline(NU_EXPECTED[i_k], color='k', ls=':', lw=1, label='analytic ν(k)')
        ax.set(xlim=(0, NU_MAX * 1.3), xlabel='frequency (THz)', ylabel='intensity',
               title=f'SED line at |k|={K_MAGS[i_k]:.2f}')
        ax.legend()
        fig.tight_layout()
        fig.savefig(out / 'spectral_statistics.png', dpi=150)
        plt.close(fig)
        print(f"wrote {out / 'spectral_statistics.png'}")
    return {'full': full.intensity, 'welch': welch.intensity, 'ensemble': ens.intensity,
            'pk_full': pk_full, 'pk_welch': pk_welch, 'pk_ens': pk_ens}


if __name__ == "__main__":
    main(**parse_args(__doc__))
