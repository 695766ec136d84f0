"""Device-reduced k-grid browsing and the two grid engines.

A uniform k-grid is swept with the intensity and chiral phase reduced on the
device: only the ω ≥ 0 / max_freq float32 planes reach the host, which is
what a heat-map browser reads.  The gridded NUFFT engine
(``calculate_gridded``) gives the full complex spectrum of the same grid, and
``calculate_kgrid_peaks`` the dispersion surface from on-device peak
extraction.

Run:  python examples_torch/grid_browse_and_engines.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import check, figures, parse_args, start
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.models import make_random_crystal_trajectory


def two_panels(path, panels):
    """A figure of two pcolormesh panels: (data, title, cmap) each."""
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 2, figsize=(9, 4))
    for ax, (data, title, cmap) in zip(axes, panels):
        im = ax.pcolormesh(data, cmap=cmap, shading='gouraud')
        ax.set_title(title)
        fig.colorbar(im, ax=ax)
    fig.savefig(path, dpi=120, bbox_inches='tight')
    plt.close(fig)


def main(device='cuda', out_dir='sed_output'):
    dev, out = start(device, out_dir, 'browse')
    draw = figures()
    traj = make_random_crystal_trajectory(n_cells_xyz=(6, 6, 2), basis=2,
                                          n_frames=128, dt_ps=0.02, a=5.43)
    calc = SEDCalculator(traj, nx=6, ny=6, nz=2, device=dev)
    _, k_vecs, shape = calc.get_k_grid('xy', (-2.0, 2.0), (-2.0, 2.0), 41, 41)

    # -- browse path: filtered intensity + chiral phase, reduced on device -------
    freqs, intensity, phase = calc.calculate_kgrid_browse(
        k_vecs, max_freq=15.0, chiral=True, chiral_axis='z')
    full_bytes = traj.n_frames * len(k_vecs) * 3 * 8
    print(f"browse planes: {len(freqs)} freqs x {len(k_vecs)} k-points "
          f"({(intensity.nbytes + phase.nbytes) / 1e6:.1f} MB fetched vs "
          f"{full_bytes / 1e6:.0f} MB of complex spectrum)")

    # render one frequency slice each of intensity and phase
    fi = int(np.argmin(np.abs(freqs - 8.0)))
    if draw:
        two_panels(out / "browse_slices.png",
                   ((intensity[fi].reshape(shape).T, f"I(k) @ {freqs[fi]:.2f} THz", 'inferno'),
                    (phase[fi].reshape(shape).T, "chiral phase", 'coolwarm')))
        print(f"wrote {out / 'browse_slices.png'}")

    # -- NUFFT engine: same grid, full complex spectrum ---------------------------
    # cache_dir makes the one-shot result resumable.
    sed_g = calc.calculate_gridded(k_vecs, shape, cache_dir=out / "gridded_cache")
    direct = calc.calculate(np.array([]), k_vecs, k_grid_shape=shape)
    rel = (np.max(np.abs(sed_g.sed - direct.sed)) / np.max(np.abs(direct.sed)))
    print(f"gridded vs direct engine agreement: {rel:.2e} (expect ~1e-6)")
    check(rel <= 1e-5, f"gridded vs direct {rel:.2e} > 1e-5")

    # -- on-device peak extraction: the dispersion surface directly ---------------
    # Dispersion analysis needs only each k-point's spectral peaks; extracting
    # them on device ships 3*n_peaks*K floats instead of the full planes.
    pk_f, pk_h, pk_w = calc.calculate_kgrid_peaks(k_vecs, n_peaks=1, max_freq=15.0)
    if draw:
        two_panels(out / "peak_surface.png",
                   ((pk_f[0].reshape(shape).T, "peak frequency (THz)", 'viridis'),
                    (pk_w[0].reshape(shape).T, "linewidth (THz)", 'magma')))
        print(f"wrote {out / 'peak_surface.png'} "
              f"({(pk_f.nbytes + pk_h.nbytes + pk_w.nbytes) / 1e3:.1f} kB fetched)")
    return {'freqs': freqs, 'intensity': intensity, 'phase': phase, 'sed_g': sed_g.sed,
            'direct': direct.sed, 'pk_f': pk_f, 'pk_h': pk_h, 'pk_w': pk_w}


if __name__ == "__main__":
    main(**parse_args(__doc__))
