"""SED visualization: the five standard plot types.

Behavioral parity with the reference plotter (reference:
src/psa/visualization/sed_plotter.py:14-823) — same plot types, parameter
names, scaling modes, theming, and data conventions — in a consolidated
implementation: intensity extraction and scaling are shared helpers rather
than copies in each plot method.  Carried over from
:mod:`psa_tpu.visualization.sed_plotter`; it consumes host NumPy arrays.
matplotlib is imported when a plotter is built, not when this module is, so
the package imports where matplotlib is absent.

Plot types:
    2d_intensity    I(k, ω) dispersion map (pcolormesh, gouraud).
    2d_phase        chiral phase map, fixed ±π/2 color range.
    3d_heatmap      k-plane intensity heatmap at the nearest target frequency.
    1d_slice        I vs ω at a k index, or I vs k at a frequency index.
    frequency_slice I vs k at the nearest target frequency.
"""
from __future__ import annotations

import logging
from pathlib import Path
from typing import Tuple

import numpy as np

from ..core.sed import SED
from .styles import pyplot

logger = logging.getLogger(__name__)

VALID_PLOT_TYPES = ('2d_intensity', '2d_phase', '1d_slice', 'frequency_slice', '3d_heatmap')

_SCALE_LABELS = {
    'log': 'Log10(Intensity)',
    'sqrt': 'Sqrt(Intensity)',
    'dsqrt': 'DSqrt(Intensity)',
}


def apply_intensity_scale(values: np.ndarray, scale: str,
                          default_label: str = 'Intensity (arb. units)'
                          ) -> Tuple[np.ndarray, str]:
    """Apply linear/log/sqrt/dsqrt scaling; returns (scaled, colorbar label).

    Matches the reference's guards: log floors at 1e-12, sqrt floors at 0
    (reference sed_plotter.py:161-180).
    """
    scale = (scale or 'linear').lower()
    if scale == 'log':
        if np.any(values > 1e-12):
            return np.log10(np.maximum(values, 1e-12)), _SCALE_LABELS['log']
        logger.warning("Log scaling requested, but all values too small. Using linear scale.")
    elif scale == 'sqrt':
        return np.sqrt(np.maximum(values, 0)), _SCALE_LABELS['sqrt']
    elif scale == 'dsqrt':
        return np.sqrt(np.sqrt(np.maximum(values, 0))), _SCALE_LABELS['dsqrt']
    elif scale != 'linear':
        logger.warning("Unknown intensity_scale_type '%s'. Using linear scale.", scale)
    return values, default_label


def _total_intensity(sed: SED) -> np.ndarray:
    """(n_freq, n_k) intensity regardless of complex/incoherent storage."""
    if sed.is_complex:
        return np.sum(np.abs(sed.sed) ** 2, axis=-1)
    if sed.sed.ndim == 3:
        return np.sum(sed.sed, axis=-1)
    return sed.sed


def _percentile_range(values: np.ndarray, vmin_pct: float, vmax_pct: float):
    valid = values[~np.isnan(values) & ~np.isinf(values)]
    if valid.size == 0:
        return None, None
    vmin = np.percentile(valid, vmin_pct)
    vmax = np.percentile(valid, vmax_pct)
    if vmin == vmax:  # flat data: open a window so pcolormesh has a range
        vmin = vmin - 0.1 if vmin != 0 else -0.1
        vmax = vmax + 0.1 if vmax != 0 else 0.1
    return vmin, vmax


class SEDPlotter:
    """Render one SED object to a file.

    Usage: ``SEDPlotter(sed, '2d_intensity', 'out.png', max_freq=20).generate_plot()``.
    Keyword parameters and defaults follow the reference (sed_plotter.py:31-55).
    """

    DEFAULT_PARAMS = {
        'title': 'SED Spectrum',
        'xlabel': r'k ($2\pi/\AA$)',
        'ylabel': 'Frequency (THz)',
        'cmap': 'inferno',
        'figsize': (10, 8),
        'dpi': 300,
        'max_freq': None,
        'target_frequency': 1.0,
        'heatmap_target_freq_thz': 1.0,
        'heatmap_plane': 'xy',
        'k_index': None,
        'freq_index': None,
        'highlight_region': None,
        'direction_label': '',
        'show_colorbar': True,
        'colorbar_label': 'Intensity (arb. units)',
        'grid': True,
        'tight_layout': True,
        'log_intensity': False,
        'intensity_scale': 'linear',
        'vmin_percentile': 0.0,
        'vmax_percentile': 100.0,
        'theme': 'light',
    }

    def __init__(self, sed_obj: SED, plot_type: str, output_path: str, **kwargs):
        self.sed = sed_obj
        self.plot_type = plot_type
        self.output_path = Path(output_path)
        self.plot_params = {**self.DEFAULT_PARAMS, **kwargs}
        self._plt = pyplot()

    # -- shared helpers -----------------------------------------------------

    def _scale_type(self) -> str:
        scale = self.plot_params.get('intensity_scale', 'linear').lower()
        # Back-compat: log_intensity=True upgrades a default 'linear' to 'log'
        if self.plot_params.get('log_intensity') and scale == 'linear':
            scale = 'log'
        return scale

    def _validate(self) -> None:
        if self.plot_type not in VALID_PLOT_TYPES:
            raise ValueError(f"Invalid plot_type '{self.plot_type}'. Choose from {list(VALID_PLOT_TYPES)}.")
        if not isinstance(self.sed, SED):
            raise TypeError(f"Plot type {self.plot_type} expects SED object, got {type(self.sed)}")
        if any(getattr(self.sed, attr, None) is None for attr in ('sed', 'freqs', 'k_points', 'k_vectors')):
            logger.warning("SED obj for plot %s missing essential data. Plot may fail/be empty.",
                           self.output_path.name)
        if self.plot_type == '3d_heatmap':
            kgs = getattr(self.sed, 'k_grid_shape', None)
            if kgs is None or not isinstance(kgs, tuple) or len(kgs) != 2:
                raise ValueError("For '3d_heatmap', SED.k_grid_shape must be a 2-tuple (e.g., (nkx, nky)).")
            plane = self.plot_params.get('heatmap_plane', 'xy').lower()
            if plane not in ('xy', 'yz', 'zx'):
                raise ValueError(f"Invalid 'heatmap_plane': {plane}. Must be 'xy', 'yz', or 'zx'.")

    def _setup_ax_style(self, fig, ax) -> None:
        theme = self.plot_params.get('theme', 'light')
        if theme == 'dark':
            fig.patch.set_facecolor('black')
            ax.set_facecolor('black')
            fg, grid_color = 'white', 'gray'
        else:
            fig.patch.set_facecolor('white')
            ax.set_facecolor('white')
            fg, grid_color = 'black', 'lightgray'
        ax.tick_params(axis='x', colors=fg)
        ax.tick_params(axis='y', colors=fg)
        ax.xaxis.label.set_color(fg)
        ax.yaxis.label.set_color(fg)
        ax.title.set_color(fg)
        for spine in ax.spines.values():
            spine.set_color(fg)
        if self.plot_params.get('grid', True):
            ax.grid(True, alpha=0.7 if theme == 'light' else 0.3, linestyle=':', color=grid_color)
        else:
            ax.grid(False)
        self._fg_color = fg

    def _style_colorbar(self, cbar, label: str) -> None:
        cbar.set_label(label)
        fg = getattr(self, '_fg_color', 'black')
        cbar.ax.yaxis.label.set_color(fg)
        cbar.ax.tick_params(colors=fg)

    # -- entry point ----------------------------------------------------------

    def generate_plot(self) -> None:
        """Render and save; no-op (with a warning) when the data is unplottable."""
        self._validate()
        fig = None
        try:
            plot_fn = {
                '2d_intensity': self._plot_2d_intensity,
                '2d_phase': self._plot_2d_phase,
                '3d_heatmap': self._plot_3d_heatmap,
                '1d_slice': self._plot_1d_slice,
                'frequency_slice': self._plot_frequency_slice,
            }[self.plot_type]
            fig, _ = plot_fn()
            if fig:
                if self.plot_params.get('tight_layout', True):
                    fig.tight_layout()
                self.output_path.parent.mkdir(parents=True, exist_ok=True)
                fig.savefig(self.output_path, dpi=self.plot_params.get('dpi', 300),
                            bbox_inches='tight')
                logger.info("Plot saved to: %s", self.output_path)
            else:
                logger.warning("Plot generation for %s did not return a figure. "
                               "Output file %s not created.", self.plot_type, self.output_path)
        finally:
            if fig:
                self._plt.close(fig)

    # -- plot types -----------------------------------------------------------

    def _plot_2d_intensity(self):
        fig, ax = self._plt.subplots(figsize=self.plot_params['figsize'],
                               dpi=self.plot_params.get('dpi', 300))
        self._setup_ax_style(fig, ax)

        intensity_raw = _total_intensity(self.sed)
        pos_mask = self.sed.freqs >= 0
        plot_freqs = self.sed.freqs[pos_mask]
        intensity = intensity_raw[pos_mask]
        if self.plot_params['max_freq'] is not None:
            upper = plot_freqs <= self.plot_params['max_freq']
            plot_freqs = plot_freqs[upper]
            intensity = intensity[upper]

        k_points = np.atleast_1d(self.sed.k_points)
        if plot_freqs.size == 0 or k_points.size == 0:
            logger.warning("Not enough data for 2D intensity plot %s.", self.output_path.name)
            self._plt.close(fig)
            return None, None

        intensity, cbar_label = apply_intensity_scale(
            intensity, self._scale_type(), self.plot_params['colorbar_label'])

        K, F = np.meshgrid(k_points, plot_freqs)
        vmin, vmax = _percentile_range(intensity, self.plot_params['vmin_percentile'],
                                       self.plot_params['vmax_percentile'])
        # Cross-direction normalization: the CLI computes a global max across
        # directions so multi-direction figures share one color scale (the
        # reference computed it but its plotter ignored the kwarg).
        global_max = self.plot_params.get('global_max_intensity_val')
        if global_max is not None:
            scaled_max, _ = apply_intensity_scale(
                np.asarray([global_max], dtype=np.float64), self._scale_type())
            vmax = float(scaled_max[0])
        pcm = ax.pcolormesh(K, F, intensity, cmap=self.plot_params['cmap'],
                            shading='gouraud', vmin=vmin, vmax=vmax)

        base_xlabel = self.plot_params['xlabel']
        direction = str(self.plot_params['direction_label'] or '')
        ax.set_xlabel(f"{direction} {base_xlabel}" if direction else base_xlabel)
        ax.set_ylabel(self.plot_params['ylabel'])
        ax.set_title(self.plot_params['title'])

        max_y = (self.plot_params['max_freq'] if self.plot_params['max_freq'] is not None
                 else float(np.max(plot_freqs)))
        ax.set_ylim(0, max_y if max_y > 0 else 1)

        hl = self.plot_params['highlight_region']
        if hl and 'k_point_target' in hl and 'freq_point_target' in hl:
            ax.plot(hl['k_point_target'], hl['freq_point_target'], 'g+',
                    markersize=10, label='Target point')
            if self.plot_params.get('highlight_label', False):
                ax.legend()

        if self.plot_params['show_colorbar'] and pcm.get_array().size > 0:
            self._style_colorbar(fig.colorbar(pcm, ax=ax), cbar_label)
        return fig, ax

    def _plot_2d_phase(self):
        sed = self.sed
        if sed.phase is None:
            logger.warning("No phase data for 2D plot: %s", self.output_path.name)
            return None, None
        if sed.freqs is None or sed.k_points is None:
            logger.warning("Freqs/k_points missing for phase plot %s.", self.output_path.name)
            return None, None

        pos_mask = sed.freqs >= 0
        plot_f = sed.freqs[pos_mask]
        aligned = sed.phase.ndim == 2 and sed.phase.shape[0] == sed.freqs.shape[0]
        plot_p = sed.phase[pos_mask, :] if aligned else sed.phase
        if plot_f.size == 0 or sed.k_points.size == 0 or plot_p.size == 0:
            logger.warning("Not enough data for 2D phase plot %s.", self.output_path.name)
            return None, None

        k_mesh, f_mesh = np.meshgrid(sed.k_points, plot_f)
        fig, ax = self._plt.subplots(figsize=(8, 6))
        self._setup_ax_style(fig, ax)
        pcm = ax.pcolormesh(k_mesh, f_mesh, plot_p, shading='gouraud',
                            cmap=self.plot_params['cmap'],
                            vmin=self.plot_params.get('vmin', -np.pi / 2),
                            vmax=self.plot_params.get('vmax', np.pi / 2))
        ax.set_title(self.plot_params['title'])
        ax.set_xlabel('k (2π/Å)')
        ax.set_ylabel('Frequency (THz)')

        ylim_u = 1.0
        max_f_plot = self.plot_params['max_freq']
        if max_f_plot is not None:
            try:
                cand = float(max_f_plot)
                ylim_u = cand if cand > 0 else ylim_u
            except (ValueError, TypeError):
                pass
        if ylim_u == 1.0 and plot_f.size > 0:
            ylim_u = float(np.max(plot_f)) if np.max(plot_f) > 0 else ylim_u
        ax.set_ylim(0, ylim_u if ylim_u > 0 else 1.0)
        if sed.k_points.size > 0:
            ax.set_xlim(float(np.min(sed.k_points)), float(np.max(sed.k_points)))

        self._style_colorbar(fig.colorbar(pcm, ax=ax), 'Phase diff (rad)')
        return fig, ax

    def _plot_3d_heatmap(self):
        """k-plane intensity heatmap at the nearest target frequency.

        Relies on the grid row-major convention of get_k_grid (first range
        slowest): reshape(n_kx, n_ky) then transpose for pcolormesh axes
        (reference sed_plotter.py:632-823)."""
        fig, ax = self._plt.subplots(figsize=self.plot_params.get('figsize', (8, 6.5)))
        self._setup_ax_style(fig, ax)
        ax.grid(False)

        sed = self.sed
        if sed.freqs is None or sed.freqs.size == 0:
            logger.error("SED object has no frequency data for 3D heatmap.")
            self._plt.close(fig)
            return None, None
        target = self.plot_params.get('heatmap_target_freq_thz', 1.0)
        plane = self.plot_params.get('heatmap_plane', 'xy').lower()
        freq_idx = int(np.argmin(np.abs(sed.freqs - target)))
        actual_freq = float(sed.freqs[freq_idx])

        if sed.is_complex:
            intensity = np.sum(np.abs(sed.sed[freq_idx, :, :]) ** 2, axis=-1)
        elif sed.sed.ndim == 3:
            intensity = np.sum(sed.sed[freq_idx, :, :], axis=-1)
        elif sed.sed.ndim == 2:
            intensity = sed.sed[freq_idx, :]
        else:
            logger.error("Unsupported SED data format for 3D heatmap: ndim=%d", sed.sed.ndim)
            self._plt.close(fig)
            return None, None

        n_kx, n_ky = sed.k_grid_shape
        if intensity.size != n_kx * n_ky:
            logger.error("Intensity data size (%d) does not match k_grid_shape (%dx%d).",
                         intensity.size, n_kx, n_ky)
            self._plt.close(fig)
            return None, None
        intensity_grid = intensity.reshape(sed.k_grid_shape)

        comp = {'xy': (0, 1, r'$k_x$ ($2\pi/\AA$)', r'$k_y$ ($2\pi/\AA$)'),
                'yz': (1, 2, r'$k_y$ ($2\pi/\AA$)', r'$k_z$ ($2\pi/\AA$)'),
                'zx': (2, 0, r'$k_z$ ($2\pi/\AA$)', r'$k_x$ ($2\pi/\AA$)')}[plane]
        c1_flat = sed.k_vectors[:, comp[0]]
        c2_flat = sed.k_vectors[:, comp[1]]
        k1_axis = np.unique(c1_flat)
        k2_axis = np.unique(c2_flat)
        if len(k1_axis) != n_kx:
            k1_axis = np.linspace(c1_flat.min(), c1_flat.max(), n_kx)
        if len(k2_axis) != n_ky:
            k2_axis = np.linspace(c2_flat.min(), c2_flat.max(), n_ky)
        K1, K2 = np.meshgrid(k1_axis, k2_axis)        # shapes (n_ky, n_kx)

        plot_data, cbar_label = apply_intensity_scale(
            intensity_grid.T, self._scale_type(), self.plot_params['colorbar_label'])

        vmin = self.plot_params.get('vmin')
        vmax = self.plot_params.get('vmax')
        if vmin is None or vmax is None:
            calc_vmin, calc_vmax = _percentile_range(
                plot_data, self.plot_params.get('vmin_percentile', 0.0),
                self.plot_params.get('vmax_percentile', 100.0))
            if calc_vmin is None:
                calc_vmin, calc_vmax = 0, 1
            vmin = calc_vmin if vmin is None else vmin
            vmax = calc_vmax if vmax is None else vmax

        pcm = ax.pcolormesh(K1, K2, plot_data, cmap=self.plot_params['cmap'],
                            shading='gouraud', vmin=vmin, vmax=vmax)
        ax.set_xlabel(comp[2])
        ax.set_ylabel(comp[3])
        title = self.plot_params.get('title', 'SED Heatmap')
        ax.set_title(f"{title} @ {actual_freq:.2f} THz (Plane: {plane.upper()})")
        if self.plot_params['show_colorbar'] and pcm.get_array().size > 0:
            self._style_colorbar(fig.colorbar(pcm, ax=ax), cbar_label)
        if self.plot_params.get('grid', False):
            ax.grid(True, alpha=0.3, linestyle=':')
        ax.set_aspect('equal', adjustable='box')
        return fig, ax

    def _plot_1d_slice(self):
        fig, ax = self._plt.subplots(figsize=self.plot_params.get('figsize', (10, 6)))
        self._setup_ax_style(fig, ax)

        k_index = self.plot_params.get('k_index')
        freq_index = self.plot_params.get('freq_index')
        if k_index is None and freq_index is None:
            logger.error("Must specify either k_index or freq_index for 1D slice.")
            self._plt.close(fig)
            return None, None

        intensity, ylabel = apply_intensity_scale(
            _total_intensity(self.sed), self._scale_type())
        plot_title = self.plot_params.get('title', '1D SED Slice')

        if k_index is not None:
            if not (0 <= k_index < self.sed.k_points.shape[0]):
                logger.error("k_index %d is out of bounds for k_points shape %s",
                             k_index, self.sed.k_points.shape)
                self._plt.close(fig)
                return None, None
            data = intensity[:, k_index]
            x = self.sed.freqs
            xlabel = self.plot_params.get('ylabel', 'Frequency (THz)')
            direction = str(self.plot_params.get('direction_label', ''))
            k_val = f"{self.sed.k_points[k_index]:.3f}"
            k_unit = self.plot_params.get('xlabel', r'k ($2\pi/\AA$)')
            label = f"{direction} k={k_val} {k_unit.split(' ', 1)[-1]}"
            ax.plot(x, data, label=label)
            ax.set_title(f"{plot_title}: Intensity vs Frequency")
            if self.plot_params.get('max_freq') is not None:
                ax.set_xlim(0, self.plot_params['max_freq'])
            elif x.size > 0:
                ax.set_xlim(0, float(np.max(x)))
        else:
            if not (0 <= freq_index < self.sed.freqs.shape[0]):
                logger.error("freq_index %d is out of bounds for freqs shape %s",
                             freq_index, self.sed.freqs.shape)
                self._plt.close(fig)
                return None, None
            data = intensity[freq_index, :]
            x = self.sed.k_points
            xlabel = self.plot_params.get('xlabel', r'k ($2\pi/\AA$)')
            direction = str(self.plot_params.get('direction_label', ''))
            if direction:
                xlabel = f"{direction} {xlabel}"
            ax.plot(x, data, label=f"ω = {self.sed.freqs[freq_index]:.3f} THz")
            ax.set_title(f"{plot_title}: Intensity vs K-points")

        ax.set_xlabel(xlabel)
        ax.set_ylabel(ylabel)
        if self.plot_params.get('grid', True):
            ax.grid(True, alpha=0.3)
        ax.legend()
        return fig, ax

    def _plot_frequency_slice(self):
        fig, ax = self._plt.subplots(figsize=self.plot_params.get('figsize', (10, 6)))
        self._setup_ax_style(fig, ax)

        target_freq = self.plot_params.get('target_frequency')
        if target_freq is None:
            logger.error("target_frequency must be specified for frequency_slice plot type.")
            self._plt.close(fig)
            return None, None
        if self.sed.freqs is None or self.sed.freqs.size == 0:
            logger.error("SED object has no frequency data.")
            self._plt.close(fig)
            return None, None

        freq_idx = int(np.argmin(np.abs(self.sed.freqs - target_freq)))
        actual_freq = float(self.sed.freqs[freq_idx])
        intensity_slice = _total_intensity(self.sed)[freq_idx]

        k_points = np.atleast_1d(self.sed.k_points)
        if k_points.size == 0:
            logger.warning("No k-points found for frequency slice plot at %.2f THz.", actual_freq)
            self._plt.close(fig)
            return None, None
        if intensity_slice.shape[0] != k_points.shape[0]:
            logger.error("Shape mismatch: intensity_slice %s vs k_points %s",
                         intensity_slice.shape, k_points.shape)
            self._plt.close(fig)
            return None, None

        plot_data, ylabel = apply_intensity_scale(intensity_slice, self._scale_type())
        ax.plot(k_points, plot_data)

        base_xlabel = self.plot_params.get('xlabel', r'k ($2\pi/\AA$)')
        direction = str(self.plot_params.get('direction_label', ''))
        ax.set_xlabel(f"{direction} {base_xlabel}".strip())
        ax.set_ylabel(ylabel)
        title = f"SED Frequency Slice at {actual_freq:.2f} THz"
        if direction:
            title += f" ({direction})"
        ax.set_title(title)
        if self.plot_params.get('grid', True):
            ax.grid(True, alpha=0.3)
        return fig, ax
