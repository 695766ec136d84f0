"""Every plot type on one synthetic SED.

Figures only: where matplotlib is not installed the example says so and
exits non-zero.

Run:  python examples_torch/visualization_example.py [--device cpu]
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # run from anywhere without installing

import numpy as np

from examples_torch._common import parse_args, start
from psa_tpu_torch import SED, SEDPlotter
from psa_tpu_torch.visualization import apply_style, have_matplotlib


def synthetic_seds():
    """(k-path SED with two dispersive branches and a phase, 25x25 grid SED)."""
    n_freq, n_k = 256, 80
    freqs = np.fft.fftfreq(n_freq, d=0.05)
    k_points = np.linspace(0, 2.0, n_k).astype(np.float32)
    k_vectors = np.outer(k_points, [1, 0, 0]).astype(np.float32)
    sed_data = np.zeros((n_freq, n_k, 3), dtype=np.complex64)
    for branch, speed in ((0, 4.0), (1, 7.0)):
        for i, k in enumerate(k_points):
            w = speed * np.abs(np.sin(k * 1.2))
            idx = np.argmin(np.abs(freqs - w))
            sed_data[idx, i, branch] = 10.0 + 5j
    sed_data += 0.05 * (np.random.default_rng(0).normal(size=sed_data.shape)
                        + 1j * np.random.default_rng(1).normal(size=sed_data.shape))
    phase = np.clip(np.angle(sed_data[:, :, 0] + 1e-9), -np.pi / 2, np.pi / 2)
    sed = SED(sed_data.astype(np.complex64), freqs, k_points, k_vectors,
              phase=phase.astype(np.float32))

    gn = 25
    kx = np.linspace(-1, 1, gn, dtype=np.float32)
    kv_grid = np.stack([np.repeat(kx, gn), np.tile(kx, gn), np.zeros(gn * gn, np.float32)], 1)
    r = np.hypot(kv_grid[:, 0], kv_grid[:, 1])
    grid_data = np.zeros((n_freq, gn * gn, 3), dtype=np.complex64)
    for fi in range(n_freq):
        if freqs[fi] < 0:
            continue
        grid_data[fi, :, 0] = np.exp(-((r * 4 - freqs[fi]) ** 2))
    sed_grid = SED(grid_data, freqs, np.array([]), kv_grid, k_grid_shape=(gn, gn))
    return sed, sed_grid


def main(device='cuda', out_dir='sed_output'):
    start(device, out_dir)
    if not have_matplotlib():
        raise SystemExit("visualization_example: matplotlib is not installed, and this "
                         "example only draws figures")
    import matplotlib
    matplotlib.use('Agg')
    out = Path(out_dir) / 'viz'
    out.mkdir(parents=True, exist_ok=True)
    sed, sed_grid = synthetic_seds()

    apply_style(color_scheme='scientific')
    SEDPlotter(sed, '2d_intensity', str(out / "intensity.png"),
               max_freq=8.0, intensity_scale='log').generate_plot()
    SEDPlotter(sed, '2d_phase', str(out / "phase.png"), cmap='twilight',
               max_freq=8.0).generate_plot()
    SEDPlotter(sed, '1d_slice', str(out / "slice_k.png"), k_index=20).generate_plot()
    SEDPlotter(sed, '1d_slice', str(out / "slice_w.png"), freq_index=30).generate_plot()
    SEDPlotter(sed, 'frequency_slice', str(out / "freq_slice.png"),
               target_frequency=4.0).generate_plot()
    SEDPlotter(sed_grid, '3d_heatmap', str(out / "heatmap.png"),
               heatmap_target_freq_thz=2.0, theme='dark').generate_plot()
    print(f"outputs in {out}/")
    return {'sed': sed.sed, 'grid': sed_grid.sed}


if __name__ == "__main__":
    main(**parse_args(__doc__))
