"""NPT SED: phonon spectra under a drifting simulation cell.

The standard SED anchor exp(i k·r̄) maps modes through one fixed cell.
Under an NPT barostat the cell drifts: k-vectors built from the frame-0 box
land INCOMMENSURATE on the time-mean lattice, the per-atom phases dephase,
and a commensurate phonon's projected weight drops and leaks into
neighboring k columns.  ``calculate_npt`` anchors in FRACTIONAL space
instead, exp(2πi m·s̄) with s(t) = h(t)⁻¹ r(t), invariant under any volume
or shape drift.

This example builds a 1D chain carrying ONE commensurate phonon (mode m = 7
at ν = 4 THz) inside a cell that expands linearly by 10% over the run:

  1. the fixed-cell engine with frame-0 k-mapping: the captured peak drops,
     weight spreads across neighbor modes;
  2. ``calculate_npt`` at integer Miller points: the line is clean and the
     neighbors carry ~nothing;
  3. the sweep forms ``calculate_npt_browse``/``calculate_npt_peaks``.

With a real NPT dump (LAMMPS ``fix npt``), ``TrajectoryLoader`` fills
``Trajectory.box_matrices`` from the per-frame BOX BOUNDS, and the command
line exposes this flow as the optional ``npt:`` config section.

Run:  python examples_torch/npt_cell_sed.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SEDCalculator, Trajectory
from psa_tpu_torch.core.trajectory import make_box_arrays

N_CELLS, A, N_FRAMES, DT_PS = 32, 2.5, 512, 0.01
MODE_M, NU_THZ, AMP = 7, 4.0, 0.02


def drifting_chain():
    """The chain with one commensurate phonon in a cell expanding by 10%."""
    L0 = N_CELLS * A
    t = np.arange(N_FRAMES) * DT_PS
    lam = 1.0 + 0.10 * np.linspace(0.0, 1.0, N_FRAMES)      # 10% linear expansion
    x_frac = (np.arange(N_CELLS) + 0.5) / N_CELLS
    phase = 2 * np.pi * (MODE_M * x_frac[None, :] - NU_THZ * t[:, None])
    s = x_frac[None, :] + (AMP / L0) * np.sin(phase)         # fractional coords

    boxes = lam[:, None, None] * np.diag([L0, 10.0, 10.0])[None]
    pos = np.zeros((N_FRAMES, N_CELLS, 3), dtype=np.float32)
    pos[:, :, 0] = (lam[:, None] * L0) * s
    vel = np.zeros_like(pos)                                  # co-moving phonon velocity
    vel[:, :, 0] = (lam[:, None] * AMP * (-2 * np.pi * NU_THZ)
                    * np.cos(phase)).astype(np.float32)
    box0 = boxes[0].astype(np.float32)
    lengths, tilts = make_box_arrays(box0)
    return Trajectory(positions=pos, velocities=vel, types=np.ones(N_CELLS, dtype=np.int32),
                      timesteps=np.arange(N_FRAMES, dtype=np.float32), box_matrix=box0,
                      box_lengths=lengths, box_tilts=tilts, dt_ps=DT_PS,
                      box_matrices=boxes.astype(np.float32))


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir)
    calc = SEDCalculator(drifting_chain(), nx=N_CELLS, ny=1, nz=1, device=dev)
    L0 = N_CELLS * A

    # mode columns m = 1..12 through both engines
    orders = np.arange(1, 13)
    m = np.zeros((orders.size, 3))
    m[:, 0] = orders

    # --- 1. fixed-cell frame-0 mapping: k = 2π m / L0 ------------------------
    kv = (2 * np.pi / L0) * m.astype(np.float32)
    sed_fix = calc.calculate(np.linalg.norm(kv, axis=1), kv)

    # --- 2. fractional anchor at the same Miller points ----------------------
    sed_npt = calc.calculate_npt(m)

    pos_rows = sed_fix.freqs >= 0
    f_pos = sed_fix.freqs[pos_rows]
    I_fix = sed_fix.intensity[pos_rows]                      # (n_freq+, n_m)
    I_npt = sed_npt.intensity[pos_rows]

    col = MODE_M - 1
    peak_fix, peak_npt = I_fix[:, col].max(), I_npt[:, col].max()
    nbr_fix = max(I_fix[:, col - 1].max(), I_fix[:, col + 1].max())
    nbr_npt = max(I_npt[:, col - 1].max(), I_npt[:, col + 1].max())
    print(f"captured peak at m={MODE_M}:  fixed-cell {peak_fix:.3e}   "
          f"NPT anchor {peak_npt:.3e}  ({peak_npt / peak_fix:.2f}x)")
    print(f"worst neighbor-mode leak:   fixed-cell {nbr_fix / peak_fix:.1%}   "
          f"NPT anchor {nbr_npt / peak_npt:.1%}")
    check(peak_npt > 1.2 * peak_fix, "the NPT anchor did not raise the captured peak")
    check(nbr_npt < 0.05 * peak_npt, "the NPT anchor leaks into the neighbor modes")

    if figures():
        import matplotlib.pyplot as plt
        fig, axes = plt.subplots(1, 2, figsize=(11, 4.5), sharey=True)
        for ax, I, title in ((axes[0], I_fix, "fixed cell, frame-0 k-mapping"),
                             (axes[1], I_npt, "NPT fractional anchor")):
            pcm = ax.pcolormesh(orders, f_pos, np.sqrt(I / peak_npt), shading='nearest',
                                cmap='inferno', vmin=0, vmax=1)
            ax.axhline(NU_THZ, color='w', ls=':', lw=0.8)
            ax.axvline(MODE_M, color='w', ls=':', lw=0.8)
            ax.set_xlabel("mode m")
            ax.set_title(title)
        axes[0].set_ylabel("ν (THz)")
        axes[0].set_ylim(0, 10)
        fig.colorbar(pcm, ax=axes, label='√(I / peak)')
        fig.savefig(out / "npt_vs_fixed.png", dpi=200, bbox_inches='tight')
        plt.close(fig)
        print(f"wrote {out / 'npt_vs_fixed.png'}")

    # --- 3. sweep forms: the spectrum never leaves the device ----------------
    # calculate_npt_browse returns only the ω-filtered intensity planes, and
    # calculate_npt_peaks only the top-n (frequency, height, width) triplets
    # per k (pass mesh=make_mesh(...) to run either across a (t, a, k) mesh).
    freqs_b, inten_b, _, k_cart = calc.calculate_npt_browse(m)
    pf, pi, pw, _ = calc.calculate_npt_peaks(m, n_peaks=1)
    check(np.allclose(inten_b, I_npt, rtol=1e-5, atol=1e-8 * I_npt.max()),
          "browse planes differ from calculate_npt")
    print(f"browse planes: {inten_b.shape} at k_cart magnitudes "
          f"{np.linalg.norm(k_cart, axis=1).round(3)[:3]}... (2π/Å)")
    print(f"peak surface: ridden mode m={MODE_M} found at "
          f"{pf[0, col]:.2f} THz (built at {NU_THZ:.1f})")
    check(abs(pf[0, col] - NU_THZ) < 0.5, f"peak at {pf[0, col]} THz, built at {NU_THZ}")
    return {'I_fix': I_fix, 'I_npt': I_npt, 'inten_b': inten_b, 'pf': pf, 'pi': pi, 'pw': pw}


if __name__ == "__main__":
    main(**parse_args(__doc__))
