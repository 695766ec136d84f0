"""GUI export backends: .npy sets, CSV, k-grid GIF, iSED copy, plot images.

Carried over from :mod:`psa_tpu.gui.export`: headless re-implementations of
the reference GUI's export actions (reference:
src/psa/gui/psa_gui.py:2472-2977) so they are testable without a display and
reusable from scripts.

The CSV writers need no pandas: they write the header, columns, order and
number text that ``DataFrame.to_csv(index=False)`` writes (each float as the
shortest text that reads back to the same float32 or float64), so a session
on a machine without pandas can export and the files equal the JAX
package's byte for byte.  The GIF and figure exports import ``imageio`` and
``matplotlib`` when called and raise an ``ImportError`` naming the package
that is missing.
"""
from __future__ import annotations

import csv
import importlib
import logging
import shutil
from pathlib import Path
from typing import Optional

import numpy as np

from ..core.sed import SED
from .controller import KGridState, apply_scale

logger = logging.getLogger(__name__)


def _require(module: str, package: str, what: str):
    """``module`` imported, or an ImportError naming the missing ``package``."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise ImportError(f"{what} needs the '{package}' package, which is not "
                          "installed") from e


def _column_text(values) -> np.ndarray:
    """One CSV column as strings: NumPy's shortest round-trip text of each
    float at the column's own precision, integers as they are, NaN empty."""
    values = np.asarray(values)
    text = values.astype(str)
    if np.issubdtype(values.dtype, np.floating):
        text = np.where(np.isnan(values), '', text)
    return text


def _write_rows(f, columns) -> int:
    """Append the rows of equally long ``columns`` to the open CSV ``f``."""
    rows = np.stack([_column_text(c) for c in columns], axis=1)
    f.writelines(','.join(row) + '\n' for row in rows.tolist())
    return len(rows)


def _open_csv(path: Path, names, comment: Optional[str] = None):
    """``path`` opened for writing, an optional comment line and the header
    row (quoted only where a name needs it) written."""
    path.parent.mkdir(parents=True, exist_ok=True)
    f = open(path, 'w', encoding='utf-8', newline='')
    if comment is not None:
        f.write(comment)
    csv.writer(f, lineterminator='\n').writerow(names)
    return f


def export_npy_set(sed: SED, base_path: Path) -> list:
    """Save the SED component arrays as <base>.<component>.npy files."""
    base_path = Path(base_path)
    base_path.parent.mkdir(parents=True, exist_ok=True)
    sed.save(base_path)
    written = [base_path.parent / f"{base_path.name}.{s}.npy"
               for s in ('sed', 'freqs', 'k_points', 'k_vectors')]
    if sed.phase is not None:
        written.append(base_path.parent / f"{base_path.name}.phase.npy")
    return written


def export_kpath_csv(sed: SED, path: Path, scale: str = 'linear') -> Path:
    """Wide-format CSV: rows = frequencies (ω ≥ 0), one column per k-point
    (reference psa_gui.py:2495-2551)."""
    path = Path(path)
    mask = sed.freqs >= 0
    freqs = sed.freqs[mask]
    # non-complex SEDs (reduced k-path / incoherent) already hold intensities
    raw = sed.intensity if sed.is_complex else sed.sed
    inten = apply_scale(raw[mask], scale)
    cols = {'frequency_THz': freqs}
    for i, k in enumerate(np.atleast_1d(sed.k_points)):
        cols[f"k_{k:.4f}"] = inten[:, i]
    if sed.phase is not None:
        phase = sed.phase[mask]
        for i, k in enumerate(np.atleast_1d(sed.k_points)):
            cols[f"phase_k_{k:.4f}"] = phase[:, i]
    with _open_csv(path, cols) as f:
        n_rows = _write_rows(f, cols.values())
    logger.info("k-path CSV written: %s (%d rows)", path, n_rows)
    return path


def export_kgrid_csv(kgrid: KGridState, path: Path) -> Path:
    """Long-format CSV: (frequency, k1, k2, intensity[, phase]) rows
    (reference psa_gui.py:2552-2660)."""
    path = Path(path)
    n_kx, n_ky = kgrid.sed.k_grid_shape
    k1 = _column_text(np.repeat(kgrid.k1_axis, n_ky))
    k2 = _column_text(np.tile(kgrid.k2_axis, n_kx))
    names = ['frequency_THz', kgrid.labels[0], kgrid.labels[1], 'intensity']
    if kgrid.phase is not None:
        names.append('phase')
    n_rows = 0
    with _open_csv(path, names) as out:
        for fi, f in enumerate(kgrid.freqs):      # one frequency's rows at a time
            cols = [np.full(n_kx * n_ky, f), k1, k2, kgrid.intensity[fi]]
            if kgrid.phase is not None:
                cols.append(kgrid.phase[fi])
            n_rows += _write_rows(out, cols)
    logger.info("k-grid CSV written: %s (%d rows)", path, n_rows)
    return path


def export_peaks_csv(peaks, path: Path) -> Path:
    """Long-format CSV of dispersion surfaces: one row per (peak rank,
    k-point) with frequency, intensity, and linewidth (RMS spread or
    Lorentzian FWHM per the state's ``width_method``)."""
    path = Path(path)
    n_peaks, n_kx, n_ky = peaks.freq_surfaces.shape
    k1 = _column_text(np.repeat(peaks.k1_axis, n_ky))
    k2 = _column_text(np.tile(peaks.k2_axis, n_kx))
    width = ('linewidth_THz_fwhm'
             if getattr(peaks, 'width_method', 'rms') == 'lorentzian'
             else 'linewidth_THz_rms')
    n_rows = 0
    with _open_csv(path, ['peak_rank', peaks.labels[0], peaks.labels[1],
                          'frequency_THz', 'intensity', width]) as out:
        for r in range(n_peaks):
            n_rows += _write_rows(out, [
                np.full(n_kx * n_ky, r), k1, k2,
                peaks.freq_surfaces[r].ravel(),
                peaks.intensity_surfaces[r].ravel(),
                peaks.linewidth_surfaces[r].ravel()])
    logger.info("peak-surface CSV written: %s (%d rows)", path, n_rows)
    return path


def export_dsf_csv(dsf, path: Path) -> Path:
    """Wide-format CSV of an instantaneous-phase map (GUI DSF view):
    rows = frequencies, one column per commensurate k-point; a leading
    comment row names the observable and direction."""
    path = Path(path)
    cols = {'frequency_THz': dsf.freqs}
    # the column index disambiguates snapped |k| that collide at 1e-4
    # resolution (large boxes step |k| by ~(2π/L)²/2|k| between kept points)
    for i, k in enumerate(dsf.k_mags):
        cols[f"k{i}_{k:.4f}"] = dsf.plane[:, i]
    comment = (f"# observable={dsf.observable} direction={dsf.direction_text} "
               f"(instantaneous phases, box-commensurate k)\n")
    with _open_csv(path, cols, comment) as f:
        n_rows = _write_rows(f, cols.values())
    logger.info("DSF CSV written: %s (%d rows)", path, n_rows)
    return path


def export_liquid_csv(liquid, path: Path) -> Path:
    """CSV of a liquid-workflow curve set (GUI Liquid view): the x axis
    plus one column per curve, headed by the observable kind."""
    path = Path(path)
    xlabel, ylabel = liquid.labels
    cols = {xlabel.split(' ')[0]: liquid.x}
    for lab, row in zip(liquid.curve_labels, liquid.curves):
        cols[lab.replace(' ', '_')] = row
    with _open_csv(path, cols, f"# observable={liquid.kind} ({ylabel})\n") as f:
        n_rows = _write_rows(f, cols.values())
    logger.info("Liquid CSV written: %s (%d rows)", path, n_rows)
    return path


def export_kgrid_gif(kgrid: KGridState, path: Path, scale: str = 'sqrt',
                     cmap: str = 'inferno', fps: int = 5,
                     max_frames: int = 60, use_phase: bool = False) -> Path:
    """Animated GIF scrubbing through frequency slices with a global color
    scale (reference psa_gui.py:2662-2833)."""
    imageio = _require('imageio.v2', 'imageio', 'export_kgrid_gif')
    matplotlib = _require('matplotlib', 'matplotlib', 'export_kgrid_gif')
    matplotlib.use('Agg')
    plt = _require('matplotlib.pyplot', 'matplotlib', 'export_kgrid_gif')

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    vmin, vmax = kgrid.global_vrange(use_phase=use_phase, scale=scale)
    n = len(kgrid.freqs)
    step = max(1, n // max_frames)
    frames = []
    fig, ax = plt.subplots(figsize=(5, 4.2), dpi=90)
    for fi in range(0, n, step):
        ax.clear()
        data = kgrid.slice_at(fi, use_phase=use_phase)
        if not use_phase:
            data = apply_scale(data, scale)
        ax.pcolormesh(kgrid.k1_axis, kgrid.k2_axis, data, cmap=cmap,
                      shading='gouraud', vmin=vmin, vmax=vmax)
        ax.set_title(f"{kgrid.freqs[fi]:.2f} THz")
        ax.set_xlabel(kgrid.labels[0])
        ax.set_ylabel(kgrid.labels[1])
        ax.set_aspect('equal', adjustable='box')
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[:, :, :3]
        frames.append(buf.copy())
    plt.close(fig)
    imageio.mimsave(path, frames, fps=fps, loop=0)
    logger.info("k-grid GIF written: %s (%d frames)", path, len(frames))
    return path


def export_ised_dump(src_dump: Path, dest: Path,
                     metadata: Optional[dict] = None) -> Path:
    """Copy the reconstruction dump + a sidecar metadata text file
    (reference psa_gui.py:2835-2892)."""
    src_dump, dest = Path(src_dump), Path(dest)
    dest.parent.mkdir(parents=True, exist_ok=True)
    shutil.copyfile(src_dump, dest)
    if metadata:
        meta_path = dest.with_suffix('.info.txt')
        with open(meta_path, 'w') as f:
            f.write("iSED reconstruction metadata\n")
            for k, v in metadata.items():
                f.write(f"{k}: {v}\n")
    logger.info("iSED dump exported: %s", dest)
    return dest


def parse_aspect_ratio(spec) -> Optional[float]:
    """Parse an aspect-ratio spec to width/height, or None for 'keep'.

    Accepts 'W:H' ('16:9'), 'W/H', a bare number, or ''/None/'auto' for the
    figure's current shape (reference psa_gui.py:2894-2977 parses the same
    forms in its save dialog)."""
    if spec is None:
        return None
    if isinstance(spec, (int, float)):
        ratio = float(spec)
    else:
        text = str(spec).strip().lower()
        if text in ('', 'auto', 'keep'):
            return None
        for sep in (':', '/'):
            if sep in text:
                w_s, h_s = text.split(sep, 1)
                try:
                    ratio = float(w_s) / float(h_s)
                except (ValueError, ZeroDivisionError) as e:
                    raise ValueError(f"Invalid aspect ratio {spec!r}") from e
                break
        else:
            try:
                ratio = float(text)
            except ValueError as e:
                raise ValueError(f"Invalid aspect ratio {spec!r}") from e
    if not np.isfinite(ratio) or ratio <= 0:
        raise ValueError(f"Aspect ratio must be positive, got {spec!r}")
    return ratio


def export_figure(fig, path: Path, dpi: int = 300, aspect_ratio=None) -> Path:
    """Save the current figure as png/jpg/svg/pdf by extension
    (reference psa_gui.py:2894-2977).

    ``aspect_ratio``: optional 'W:H' / 'W/H' / number — the figure is
    resized to that width/height ratio (keeping its width) for the save and
    restored afterwards."""
    _require('matplotlib', 'matplotlib', 'export_figure')
    path = Path(path)
    if path.suffix.lower() not in ('.png', '.jpg', '.jpeg', '.svg', '.pdf'):
        raise ValueError(f"Unsupported image format: {path.suffix}")
    path.parent.mkdir(parents=True, exist_ok=True)
    ratio = parse_aspect_ratio(aspect_ratio)
    if ratio is not None:
        orig_w, orig_h = fig.get_size_inches()
        try:
            fig.set_size_inches(orig_w, orig_w / ratio)
            fig.savefig(path, dpi=dpi, bbox_inches='tight')
        finally:
            fig.set_size_inches(orig_w, orig_h)
    else:
        fig.savefig(path, dpi=dpi, bbox_inches='tight')
    logger.info("Figure exported: %s", path)
    return path
