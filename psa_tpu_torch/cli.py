"""Command-line interface: the configured SED pipeline on PyTorch
(counterpart of :mod:`psa_tpu.cli`).

Same flags, config schema, cache naming, output layout and array schemas as
the JAX package's CLI, with these differences:

  * ``--device`` (default ``cuda``) is handed to the calculator as the
    library takes it; without a CUDA device the library's
    error ends the run, nothing moves to the CPU by itself;
  * ``--profile`` writes a ``torch.profiler`` chrome trace to
    ``<output-dir>/profile``;
  * the config file is YAML (``.yaml``/``.yml``, needs PyYAML) or JSON;
  * every section writes its data files first and its figures after; where
    matplotlib is not installed the figures are skipped (logged once) and
    the data files are still written;
  * ``general.phase_mode: auto`` runs the exact phase engine in every
    family of the dsf section and ``kgrid.engine: auto`` the direct engine
    (the JAX package picks by TPU measurements); 'factored', 'incremental'
    and 'gridded' run when the config names them.

Usage:
    python -m psa_tpu_torch.cli --trajectory traj.dump --config Si_config.json --output-dir out/
"""
from __future__ import annotations

import argparse
import json
import logging
from pathlib import Path

import numpy as np

from .core.calculator import SEDCalculator
from .core.sed import SED
from .io.loader import TrajectoryLoader
from .utils.config_manager import ConfigManager
from .utils.helpers import direction_label
from .visualization import SEDPlotter, have_matplotlib

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description='Phonon Spectral Analysis Tool (PyTorch/CUDA).')
    parser.add_argument('--trajectory', type=str, required=True, help='Path to MD trajectory file.')
    parser.add_argument('--config', type=str, help='Path to a YAML or JSON configuration file.')
    parser.add_argument('--output-dir', type=str, default='psa_output', help='Directory for results.')
    parser.add_argument('--chiral', action='store_true', help='Enable chiral SED (overrides config).')
    parser.add_argument('--dt', type=float, help='Override MD timestep from config (ps).')
    parser.add_argument('--nk', type=int, help='Override n_kpoints for SED from config.')
    parser.add_argument('--recalculate-sed', action='store_true', help='Force recalculation of SED data.')
    parser.add_argument('--precision', choices=['parity', 'balanced', 'fast'],
                        default='parity',
                        help="Projection kernel tier: 'parity' (3xTF32 products, IEEE "
                             "float32 sums, 1e-6 of the float64 oracle), 'balanced' "
                             "(3xBF16, ~1e-5) or 'fast' (1xTF32, ~1e-3).")
    parser.add_argument('--device', type=str, default='cuda',
                        help="Device the spectra are computed on: 'cuda' (default; fails "
                             "when no CUDA device is present) or 'cpu'.")
    parser.add_argument('--profile', action='store_true',
                        help='Write a torch.profiler chrome trace to <output-dir>/profile.')
    return parser


def _pyplot():
    """pyplot on the file-only backend (called only when figures are drawn)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    return plt


def _resolve_basis_indices(basis_cfg: dict, traj) -> tuple:
    """Main-SED basis resolution (reference cli.py:79-88)."""
    idx_spec = basis_cfg.get('atom_indices')
    types_spec = basis_cfg.get('atom_types')
    basis_idx = None
    if idx_spec and len(idx_spec) > 0:
        basis_idx = np.asarray(idx_spec, dtype=int)
        if types_spec and len(types_spec) > 0:
            logger.warning("Main SED: atom_indices and atom_types specified; using atom_indices.")
    elif types_spec and len(types_spec) > 0:
        basis_idx = np.where(np.isin(traj.types, types_spec))[0]
        if not basis_idx.size:
            logger.warning("Main SED: No atoms for types %s. Using all.", types_spec)
            basis_idx = None
    if basis_idx is not None and (np.any(basis_idx >= traj.n_atoms) or np.any(basis_idx < 0)):
        raise ValueError("Main SED basis indices out of bounds.")
    return basis_idx, idx_spec, types_spec


def _run_kgrid_section(calc, kg, out_dir: Path, basis_idx, summation_mode, figures: bool):
    """Optional k-grid section (beyond the reference CLI): dispersion
    surfaces via on-device peak extraction, or device-reduced browse
    planes, over an axis-aligned k-plane."""
    plane = str(kg.get('plane', 'xy')).lower()
    lo, hi = (float(kg['k_range'][0]), float(kg['k_range'][1])) \
        if kg.get('k_range') else (-2.0, 2.0)
    n = int(kg.get('n_k', 50))
    _, k_vecs, shape = calc.get_k_grid(plane, (lo, hi), (lo, hi), n, n,
                                       k_fixed_val=float(kg.get('k_fixed', 0.0)))
    mode = kg.get('mode', 'peaks')
    labels = {'xy': ('k_x', 'k_y'), 'yz': ('k_y', 'k_z'),
              'zx': ('k_z', 'k_x')}[plane]
    axis = np.linspace(lo, hi, n)
    welch_n = kg.get('welch_segments')
    welch_n = int(welch_n) if welch_n else None
    welch_window = kg.get('welch_window', 'hann')
    if mode == 'peaks':
        res = calc.calculate_kgrid_peaks(
            k_vecs, basis_atom_indices=basis_idx,
            summation_mode=summation_mode,
            max_freq=kg.get('max_freq'), n_peaks=int(kg.get('n_peaks', 1)),
            engine=kg.get('engine', 'auto'), k_grid_shape=shape,
            chiral=bool(kg.get('chiral', False)),
            chiral_axis=kg.get('chiral_axis', 'z'),
            width_method=kg.get('width_method', 'lorentzian'),
            welch_segments=welch_n, welch_window=welch_window)
        arrays = {'peak_freqs': res[0], 'peak_heights': res[1],
                  'peak_widths': res[2], 'k_vectors': k_vecs,
                  'k_grid_shape': np.asarray(shape)}
        if len(res) == 4:
            arrays['peak_phase'] = res[3]
        if kg.get('group_velocity') or kg.get('thermal_conductivity'):
            # band-sorted sheets + v_g = 2π·∇ν fields (Å/ps) from the
            # peaks already computed — no second sweep; ONE sort carries
            # heights and widths together so both stanzas share it
            from .ops import dispersion
            bf, bh, bw = dispersion.sort_bands_grid(
                res[0].reshape(-1, *shape), res[1].reshape(-1, *shape),
                res[2].reshape(-1, *shape))
            vx, vy = dispersion.group_velocity_grid(bf, axis, axis)
        if kg.get('group_velocity'):
            arrays.update(band_freqs=bf, band_heights=bh,
                          group_velocity_x=vx, group_velocity_y=vy)
        if kg.get('thermal_conductivity'):
            # τ and κ from the peaks already computed (needs the
            # calibrated lorentzian widths — the section default)
            if kg.get('width_method', 'lorentzian') != 'lorentzian':
                raise ValueError("thermal_conductivity needs "
                                 "width_method: lorentzian")
            from .ops import transport
            df = 1.0 / (calc.traj.n_frames * calc.dt_ps)
            tau = transport.phonon_lifetimes(bw, resolution_fwhm_thz=2 * df)
            vol = float(abs(np.linalg.det(
                calc.traj.box_matrix.astype(np.float64))))
            kres = transport.kinetic_kappa(vx, vy, tau, vol)
            arrays.update(lifetimes_ps=kres.lifetimes_ps,
                          group_velocity_x=vx, group_velocity_y=vy)
            (out_dir / f"kappa_{plane}.json").write_text(json.dumps(
                {'kappa_xx_w_per_mk': kres.kappa_xx,
                 'kappa_yy_w_per_mk': kres.kappa_yy,
                 'kappa_xy_w_per_mk': kres.kappa_xy,
                 'n_modes_used': kres.n_modes_used,
                 'n_modes_total': kres.n_modes_total,
                 'volume_a3': vol,
                 'note': 'kinetic-theory single-mode-relaxation estimate '
                         'over the SAMPLED k-plane modes; classical kB '
                         'per mode; see psa_tpu_torch.ops.transport'}, indent=1))
            logger.info("thermal-conductivity estimate written: "
                        "kappa_%s.json (%d/%d modes resolved)", plane,
                        kres.n_modes_used, kres.n_modes_total)
        np.savez(out_dir / f"kgrid_peaks_{plane}.npz", **arrays)
        logger.info("k-grid dispersion surface written: kgrid_peaks_%s.npz", plane)
        if not figures:
            return
        plt = _pyplot()

        def save_map(values, cmap, label, title, fname):
            fig, ax = plt.subplots(figsize=(6, 5))
            pcm = ax.pcolormesh(axis, axis, values.T, shading='gouraud', cmap=cmap)
            fig.colorbar(pcm, ax=ax, label=label)
            ax.set_xlabel(f"{labels[0]} (2π/Å)")
            ax.set_ylabel(f"{labels[1]} (2π/Å)")
            ax.set_title(title)
            ax.set_aspect('equal', adjustable='box')
            fig.savefig(out_dir / fname, dpi=200, bbox_inches='tight')
            plt.close(fig)

        if kg.get('group_velocity'):
            save_map(np.hypot(vx[0], vy[0]), 'viridis', '|v_g| (Å/ps)',
                     f"Group-velocity magnitude ({plane})",
                     f"kgrid_group_velocity_{plane}.png")
        save_map(res[0][0].reshape(shape), 'inferno', 'peak frequency (THz)',
                 f"Dispersion surface ({plane})", f"kgrid_peaks_{plane}.png")
        logger.info("k-grid figures written for plane %s.", plane)
    else:
        freqs, inten, phase = calc.calculate_kgrid_browse(
            k_vecs, basis_atom_indices=basis_idx,
            summation_mode=summation_mode, max_freq=kg.get('max_freq'),
            chiral=bool(kg.get('chiral', False)),
            chiral_axis=kg.get('chiral_axis', 'z'),
            engine='gridded' if kg.get('engine') == 'gridded' else 'direct',
            k_grid_shape=shape,
            welch_segments=welch_n, welch_window=welch_window)
        arrays = {'freqs': freqs, 'intensity': inten, 'k_vectors': k_vecs,
                  'k_grid_shape': np.asarray(shape)}
        if phase is not None:
            arrays['phase'] = phase
        np.savez(out_dir / f"kgrid_browse_{plane}.npz", **arrays)
        logger.info("k-grid browse planes written: kgrid_browse_%s.npz "
                    "(%d frequencies x %d k-points)", plane, len(freqs),
                    inten.shape[1])


def _run_dos_section(calc, dos_cfg, out_dir: Path, traj, figures: bool):
    """Optional vibrational-DOS section (on-device; beyond the reference)."""
    types = (sorted(np.unique(traj.types).tolist())
             if dos_cfg.get('per_type') else None)
    freqs, dos = calc.calculate_dos(basis_atom_types=types,
                                    max_freq=dos_cfg.get('max_freq'))
    header = 'freq_THz,' + ','.join(
        [f"type_{t}" for t in types] if types and dos.shape[0] == len(types)
        else [f"group_{i+1}" for i in range(dos.shape[0])])
    np.savetxt(out_dir / "dos.csv",
               np.column_stack([freqs, dos.T]), delimiter=',',
               header=header, comments='')
    logger.info("DOS written: dos.csv (%d curve(s))", dos.shape[0])
    if not figures:
        return
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for i, row in enumerate(dos):
        lab = (f"type {types[i]}" if types and dos.shape[0] == len(types)
               else (f"group {i+1}" if dos.shape[0] > 1 else "total"))
        ax.plot(freqs, row, label=lab)
    ax.set_xlabel("frequency (THz)")
    ax.set_ylabel("DOS (arb.)")
    if dos.shape[0] > 1:
        ax.legend()
    fig.savefig(out_dir / "dos.png", dpi=200, bbox_inches='tight')
    plt.close(fig)


def _run_timecorr_section(calc, tc_cfg, out_dir: Path, traj, figures: bool):
    """Optional MSD/VACF section (on-device; beyond the reference).

    Writes one CSV + one png per requested observable; ``per_type: true``
    yields one curve per atom type (the incoherent group semantics of
    :meth:`SEDCalculator.calculate_dos`)."""
    types = (sorted(np.unique(traj.types).tolist())
             if tc_cfg.get('per_type') else None)
    n_lags = tc_cfg.get('n_lags')
    n_lags = int(n_lags) if n_lags else None
    observables = tc_cfg.get('observables') or ['msd']
    specs = {'msd': (calc.calculate_msd, 'MSD (Å²)'),
             'vacf': (calc.calculate_vacf, 'VACF ((Å/ps)²)')}
    for obs in observables:
        fn, ylabel = specs[obs]
        lags, curves = fn(basis_atom_types=types, n_lags=n_lags)
        labels = ([f"type_{t}" for t in types]
                  if types and curves.shape[0] == len(types)
                  else [f"group_{i+1}" for i in range(curves.shape[0])])
        np.savetxt(out_dir / f"{obs}.csv",
                   np.column_stack([lags, curves.T]), delimiter=',',
                   header='lag_ps,' + ','.join(labels), comments='')
        logger.info("%s written: %s.csv (%d curve(s))", obs.upper(), obs, curves.shape[0])
        if not figures:
            continue
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(6, 4))
        for lab, row in zip(labels, curves):
            ax.plot(lags, row, label=lab if curves.shape[0] > 1 else 'total')
        ax.set_xlabel("τ (ps)")
        ax.set_ylabel(ylabel)
        if curves.shape[0] > 1:
            ax.legend()
        fig.savefig(out_dir / f"{obs}.png", dpi=200, bbox_inches='tight')
        plt.close(fig)


def _run_rdf_section(calc, rdf_cfg, out_dir: Path, traj, figures: bool):
    """Optional radial-distribution-function section (on-device; beyond
    the reference).  ``per_type: true`` adds every unordered type-pair
    partial g_AB next to the total."""
    kwargs = dict(n_bins=int(rdf_cfg.get('n_bins') or 200),
                  max_frames=int(rdf_cfg.get('max_frames') or 64))
    if rdf_cfg.get('r_max'):
        kwargs['r_max'] = float(rdf_cfg['r_max'])
    curves = {}
    r, curves['total'] = calc.calculate_rdf(**kwargs)
    if rdf_cfg.get('per_type'):
        types = sorted(np.unique(traj.types).tolist())
        for i, ta in enumerate(types):
            for tb in types[i:]:
                _, g = calc.calculate_rdf(basis_atom_types=[ta],
                                          basis_atom_types_b=(
                                              None if ta == tb else [tb]),
                                          **kwargs)
                curves[f"{ta}-{tb}"] = g
    np.savetxt(out_dir / "rdf.csv",
               np.column_stack([r] + list(curves.values())), delimiter=',',
               header='r_angstrom,' + ','.join(curves), comments='')
    logger.info("RDF written: rdf.csv (%d curve(s))", len(curves))
    if not figures:
        return
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 4))
    for lab, g in curves.items():
        ax.plot(r, g, label=lab)
    ax.axhline(1.0, color='k', ls=':', lw=0.8)
    ax.set_xlabel("r (Å)")
    ax.set_ylabel("g(r)")
    if len(curves) > 1:
        ax.legend()
    fig.savefig(out_dir / "rdf.png", dpi=200, bbox_inches='tight')
    plt.close(fig)


def _run_npt_section(calc, npt_cfg, out_dir: Path, figures: bool):
    """Optional NPT (time-dependent cell) SED section — beyond the
    reference, whose engine assumes a constant box (reference
    sed_calculator.py:30-56).  Projects onto per-frame fractional
    coordinates (:meth:`SEDCalculator.calculate_npt`), so phonon lines stay
    sharp under cell breathing/drift.  Requires a trajectory whose reader
    filled per-frame cells (``Trajectory.box_matrices`` — the LAMMPS/H5MD
    parsers do for NPT dumps); a fixed-cell trajectory errors cleanly.

    The k-path lives in FRACTIONAL (Miller) space: either explicit
    ``k_miller`` rows, or ``direction`` (integer Miller vector) swept in
    ``n_kpoints`` steps up to ``max_order`` multiples.  Outputs carry the
    mean-cell Cartesian k-vectors for physical axes."""
    from .utils.helpers import miller_line

    def path_coord_of(k_mags):
        # |k| is only a valid x axis when strictly increasing: explicit
        # k_miller rows in arbitrary order have distinct-but-unsorted
        # magnitudes, and gouraud pcolormesh would render a folded
        # surface (ADVICE r4)
        return k_mags if np.all(np.diff(k_mags) > 0) \
            else np.arange(len(k_mags), dtype=np.float64)

    def save_heatmap(path_coord, freqs, inten, title, fname):
        if not figures:
            return
        plt = _pyplot()
        fig, ax = plt.subplots(figsize=(7, 5))
        pcm = ax.pcolormesh(path_coord, freqs,
                            np.sqrt(np.maximum(inten, 0.0)),
                            shading='gouraud', cmap='inferno')
        fig.colorbar(pcm, ax=ax, label='√I (arb.)')
        ax.set_xlabel("|k| along path, mean cell (2π/Å)")
        ax.set_ylabel("ν (THz)")
        ax.set_title(title)
        fig.savefig(out_dir / fname, dpi=200, bbox_inches='tight')
        plt.close(fig)

    basis = npt_cfg.get('basis') or {}
    km = npt_cfg.get('k_miller')
    if km is not None:
        m = np.asarray(km, dtype=np.float64)
    else:
        m = miller_line(npt_cfg.get('direction') or [1, 0, 0],
                        int(npt_cfg.get('n_kpoints') or 50),
                        float(npt_cfg.get('max_order') or 1.0))
    max_freq = (float(npt_cfg['max_freq'])
                if npt_cfg.get('max_freq') else None)
    group_kwargs = dict(
        basis_atom_indices=basis.get('atom_indices'),
        basis_atom_types=basis.get('atom_types'),
        summation_mode=npt_cfg.get('summation_mode', 'coherent'))
    sweep = npt_cfg.get('sweep', 'full')
    if sweep == 'peaks':
        # on-device dispersion surface: only (freq, height, width) triplets
        # per k transfer — the batch analog of the GUI peak surface.
        # max_freq caps the SEARCH (like the GUI path), not just the plot.
        n_peaks = int(npt_cfg.get('n_peaks', 1))
        pf, pi, pw, k_cart = calc.calculate_npt_peaks(m, n_peaks=n_peaks,
                                                      max_freq=max_freq,
                                                      **group_kwargs)
        k_mags = np.linalg.norm(k_cart, axis=1)
        np.savez(out_dir / "npt_peaks.npz", peak_freqs=pf,
                 peak_intensities=pi, peak_widths=pw, k_miller=m,
                 k_vectors=k_cart, k_mags=k_mags)
        logger.info("NPT peaks written: npt_peaks.npz (%d k-points, %d surfaces)",
                    m.shape[0], n_peaks)
        if not figures:
            return
        plt = _pyplot()
        path_coord = path_coord_of(k_mags)
        fig, ax = plt.subplots(figsize=(7, 5))
        for r in range(n_peaks):
            ax.scatter(path_coord, pf[r], s=12,
                       label=f"peak {r + 1}" if n_peaks > 1 else None)
        if max_freq is not None:
            ax.set_ylim(0, max_freq)
        if n_peaks > 1:
            ax.legend()
        ax.set_xlabel("|k| along path, mean cell (2π/Å)")
        ax.set_ylabel("ν (THz)")
        ax.set_title("NPT peak surfaces (fractional phase anchor)")
        fig.savefig(out_dir / "npt_peaks.png", dpi=200,
                    bbox_inches='tight')
        plt.close(fig)
        return
    if sweep == 'browse':
        # device-reduced ω ≥ 0 intensity planes (never the complex spectrum)
        freqs_kept, inten, _, k_cart = calc.calculate_npt_browse(
            m, max_freq=max_freq, **group_kwargs)
        k_mags = np.linalg.norm(k_cart, axis=1)
        np.savez(out_dir / "npt_sed.npz", intensity=inten, freqs=freqs_kept,
                 k_miller=m, k_vectors=k_cart, k_mags=k_mags)
        save_heatmap(path_coord_of(k_mags), freqs_kept, inten,
                     "NPT SED (fractional phase anchor, device-reduced)",
                     "npt_sed.png")
        logger.info("NPT SED written: npt_sed.npz (%d k-points, browse sweep)", m.shape[0])
        return
    sed = calc.calculate_npt(m, **group_kwargs)
    inten = sed.intensity
    freqs = sed.freqs
    keep = freqs >= 0
    if max_freq is not None:
        keep &= freqs <= max_freq
    np.savez(out_dir / "npt_sed.npz", intensity=inten, freqs=freqs,
             k_miller=m, k_vectors=sed.k_vectors, k_mags=sed.k_points)
    save_heatmap(path_coord_of(sed.k_points), freqs[keep], inten[keep],
                 "NPT SED (fractional phase anchor)", "npt_sed.png")
    logger.info("NPT SED written: npt_sed.npz (%d k-points)", m.shape[0])


def _run_dsf_section(calc, dsf_cfg, sed_cfg, out_dir: Path, eff_lat_param,
                     traj, figures: bool):
    """Optional instantaneous-phase section (beyond the reference).

    For each direction, snaps the k-path onto the box reciprocal lattice
    and writes the requested planes — S(k,ω) / C_L / C_T from one device
    sweep, plus the self part S_s(k,ω) when asked — as one npz and one png
    per observable.
    """
    from .ops.instantaneous import commensurate_kpath

    observables = dsf_cfg.get('observables') or ['total']
    basis_cfg = dsf_cfg.get('basis') or {}
    basis_idx, _, _ = _resolve_basis_indices(basis_cfg, traj)
    dirs_list = dsf_cfg.get('directions') or sed_cfg['directions']
    n_k = int(dsf_cfg.get('n_kpoints') or sed_cfg['n_kpoints'])
    bz_cov = float(dsf_cfg.get('bz_coverage') or sed_cfg['bz_coverage'])
    max_freq = dsf_cfg.get('max_freq')
    welch_n = dsf_cfg.get('welch_segments')
    welch_n = int(welch_n) if welch_n else None
    welch_window = dsf_cfg.get('welch_window', 'hann')

    for i_d, dir_spec in enumerate(dirs_list, 1):
        d_lbl = direction_label(dir_spec, i_d)
        _, k_vecs = calc.get_k_path(dir_spec, bz_cov, n_k, eff_lat_param)
        k_vecs = commensurate_kpath(k_vecs, calc.traj.box_matrix)
        k_mags = np.linalg.norm(k_vecs, axis=1)

        arrays = {'k_mags': k_mags, 'k_vectors': k_vecs}
        planes = {}
        if {'total', 'longitudinal', 'transverse'} & set(observables):
            freqs, s, c_l, c_t = calc.calculate_dsf(
                k_vecs, basis_atom_indices=basis_idx, max_freq=max_freq,
                welch_segments=welch_n, welch_window=welch_window)
            arrays.update(freqs=freqs, s=s, c_l=c_l, c_t=c_t)
            planes.update(total=(s, 'S(k,ω)'),
                          longitudinal=(c_l, 'C_L(k,ω)'),
                          transverse=(c_t, 'C_T(k,ω)'))
        if 'self' in observables:
            freqs_s, s_self = calc.calculate_dsf_self(
                k_vecs, basis_atom_indices=basis_idx, max_freq=max_freq)
            arrays.update(freqs=freqs_s, s_self=s_self)
            planes['self'] = (s_self, 'S_s(k,ω)')
        if 'sk' in observables:
            arrays['sk'] = calc.calculate_sk(
                k_vecs, basis_atom_indices=basis_idx)
        n_lags = dsf_cfg.get('n_lags')
        n_lags = int(n_lags) if n_lags else None
        isf_planes = {}
        if 'isf' in observables:
            lags, f = calc.calculate_isf(k_vecs, basis_atom_indices=basis_idx,
                                         n_lags=n_lags)
            arrays.update(lags_ps=lags, isf=f)
            isf_planes['isf'] = (f, 'F(k,τ)')
        if 'isf_self' in observables:
            lags, f_s = calc.calculate_isf_self(
                k_vecs, basis_atom_indices=basis_idx, n_lags=n_lags)
            arrays.update(lags_ps=lags, isf_self=f_s)
            isf_planes['isf_self'] = (f_s, 'F_s(k,τ)')
        if dsf_cfg.get('kww') and isf_planes:
            from .utils import isf_relaxation_time, kww_fit
            window = dsf_cfg.get('kww_window')
            window = tuple(float(v) for v in window) if window else None
            for obs, (plane, _) in isf_planes.items():
                amp, tau, beta, rms = kww_fit(arrays['lags_ps'], plane,
                                              fit_window=window)
                arrays.update({f'kww_amp_{obs}': amp, f'kww_tau_{obs}': tau,
                               f'kww_beta_{obs}': beta,
                               f'kww_rms_{obs}': rms,
                               f'tau_alpha_{obs}': isf_relaxation_time(
                                   arrays['lags_ps'], plane)})
        np.savez(out_dir / f"dsf_{d_lbl}.npz", **arrays)
        logger.info("DSF maps written for %s: dsf_%s.npz (%d observable(s), "
                    "%d commensurate k-points)", d_lbl, d_lbl,
                    len(observables), len(k_mags))
        if not figures:
            continue
        plt = _pyplot()

        if 'sk' in observables:
            fig, ax = plt.subplots(figsize=(7, 5))
            ax.plot(k_mags, arrays['sk'], 'o-')
            ax.axhline(1.0, color='k', ls=':', lw=0.8)
            ax.set_xlabel('k (2π/Å)')
            ax.set_ylabel('S(k)')
            ax.set_title(f"Static structure factor — {d_lbl}")
            fig.savefig(out_dir / f"dsf_sk_{d_lbl}.png", dpi=200,
                        bbox_inches='tight')
            plt.close(fig)

        for obs, (plane, sym) in isf_planes.items():
            fig, ax = plt.subplots(figsize=(7, 5))
            pcm = ax.pcolormesh(k_mags, arrays['lags_ps'], plane,
                                cmap='viridis', shading='gouraud')
            fig.colorbar(pcm, ax=ax, label=sym)
            ax.set_xlabel('k (2π/Å)')
            ax.set_ylabel('τ (ps)')
            ax.set_title(f"{sym} — intermediate scattering, {d_lbl}")
            fig.savefig(out_dir / f"dsf_{obs}_{d_lbl}.png", dpi=200,
                        bbox_inches='tight')
            plt.close(fig)

        for obs in observables:
            if obs in ('sk', 'isf', 'isf_self'):
                continue
            plane, sym = planes[obs]
            fig, ax = plt.subplots(figsize=(7, 5))
            shown = np.sqrt(np.maximum(plane, 0.0))
            pcm = ax.pcolormesh(k_mags, arrays['freqs'], shown,
                                cmap='inferno', shading='gouraud')
            fig.colorbar(pcm, ax=ax, label=f"√{sym} (arb.)")
            ax.set_xlabel('k (2π/Å)')
            ax.set_ylabel('Frequency (THz)')
            ax.set_title(f"{sym} — instantaneous phases, {d_lbl}")
            fig.savefig(out_dir / f"dsf_{obs}_{d_lbl}.png", dpi=200,
                        bbox_inches='tight')
            plt.close(fig)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO,
                        format='%(asctime)s - %(levelname)s - %(message)s',
                        datefmt='%H:%M:%S')
    args = build_parser().parse_args(argv)

    out_dir = Path(args.output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    manager = ConfigManager()
    if args.config:
        try:
            manager.load(args.config)
        except FileNotFoundError:
            logger.error("Config file not found: %s. Using defaults.", args.config)
        except ValueError as e:
            logger.error("Invalid configuration: %s", e)
            raise SystemExit(1)
    config = manager.config
    if args.dt is not None:
        config['md_system']['dt'] = args.dt
    if args.nk is not None:
        config['sed_calculation']['n_kpoints'] = args.nk
    if args.chiral:
        config['general']['chiral_mode_enabled'] = True
    try:
        # Re-validate: the flag overrides above can create combinations the
        # file alone did not have (e.g. --chiral with welch_segments).
        manager.validate()
    except ValueError as e:
        logger.error("Invalid configuration: %s", e)
        raise SystemExit(1)

    figures = have_matplotlib()
    if not figures:
        logger.warning("matplotlib is not installed: figures are skipped; every data "
                       "file is still written.")

    gen_cfg = config['general']
    md_cfg = config['md_system']
    sed_cfg = config['sed_calculation']
    plot_cfg = config['plotting']
    ised_cfg = config['ised']

    if md_cfg['dt'] <= 0:
        logger.error("Timestep 'dt' must be positive.")
        raise SystemExit(1)

    try:
        logger.info("Loading trajectory: %s (dt=%.4f ps)", args.trajectory, md_cfg['dt'])
        loader = TrajectoryLoader(args.trajectory, dt=md_cfg['dt'],
                                  file_format=gen_cfg['trajectory_file_format'])
        traj = loader.load()
        if gen_cfg['save_npy_trajectory']:
            loader.save_trajectory_npy(traj)

        calc = SEDCalculator(traj=traj, nx=md_cfg['nx'], ny=md_cfg['ny'], nz=md_cfg['nz'],
                             use_displacements=gen_cfg.get('use_displacements', False),
                             precision=args.precision,
                             mass_weighted=gen_cfg.get('mass_weighted', False),
                             phase_mode=gen_cfg.get('phase_mode', 'auto'),
                             device=args.device)

        profiler = None
        if args.profile:
            import torch
            activities = [torch.profiler.ProfilerActivity.CPU]
            if calc.device.type == 'cuda':
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()

        eff_lat_param = md_cfg.get('lattice_parameter')
        if eff_lat_param is None or eff_lat_param <= 1e-6:
            norm_a1 = float(np.linalg.norm(calc.a1))
            if norm_a1 > 1e-6:
                eff_lat_param = norm_a1
                logger.info("Using |a1| (%.3f Å) as effective lattice parameter.", eff_lat_param)
            else:
                raise ValueError("Cannot determine valid effective_lattice_parameter. "
                                 "Specify in config or check box/nx,ny,nz.")
        md_cfg['lattice_parameter'] = eff_lat_param

        basis_idx, idx_spec, types_spec = _resolve_basis_indices(sed_cfg['basis'], traj)
        basis_sfx = ""
        if basis_idx is not None:
            if idx_spec and len(idx_spec) > 0:
                basis_sfx = "_idxbasis"
            elif types_spec and len(types_spec) > 0:
                basis_sfx = f"_typebasis{'_'.join(map(str, types_spec))}"

        dirs_list = sed_cfg['directions']
        summation_mode = sed_cfg.get('summation_mode', 'coherent')
        k_chunk = int(sed_cfg.get('k_chunk_size', 500))
        welch_n = sed_cfg.get('welch_segments')
        polarization = sed_cfg.get('polarization', 'total')

        def _path_sed(k_m, k_v):
            """One k-path SED by the configured estimator (full FFT, Welch
            segment averaging when sed_calculation.welch_segments is set, or
            the on-device L/T split when sed_calculation.polarization is
            'longitudinal'/'transverse' — ConfigManager guarantees the
            combinations are chiral/Welch-compatible)."""
            if polarization != 'total':
                freqs, i_l, i_t = calc.calculate_lt(
                    k_v, basis_atom_indices=basis_idx,
                    summation_mode=summation_mode, k_chunk_size=k_chunk)
                plane = i_l if polarization == 'longitudinal' else i_t
                return SED(plane, freqs, k_m, k_v, is_complex=False,
                           dt_ps=calc.dt_ps)
            if welch_n:
                return calc.calculate_welch(
                    k_m, k_v, segments=int(welch_n),
                    window=sed_cfg.get('welch_window', 'hann'),
                    basis_atom_indices=basis_idx,
                    summation_mode=summation_mode, k_chunk_size=k_chunk)
            return calc.calculate(k_m, k_v, basis_atom_indices=basis_idx,
                                  summation_mode=summation_mode,
                                  k_chunk_size=k_chunk)

        # Optional global-max normalization pass across directions
        # (reference cli.py:90-104).
        global_max_i = None
        if len(dirs_list) > 1 and not gen_cfg['chiral_mode_enabled']:
            logger.info("Calculating global max intensity for plot normalization...")
            max_vals = []
            for dir_s in dirs_list:
                k_m, k_v = calc.get_k_path(dir_s, sed_cfg['bz_coverage'],
                                           sed_cfg['n_kpoints'], eff_lat_param)
                sed_n = _path_sed(k_m, k_v)
                inten = sed_n.intensity
                if inten.size > 0:
                    max_vals.append(float(np.max(inten)))
            if max_vals:
                global_max_i = max(max_vals)
                logger.info("Global max intensity: %.4e", global_max_i)

        all_sed_results = []
        for i_d, dir_spec in enumerate(dirs_list, 1):
            d_lbl = direction_label(dir_spec, i_d)
            logger.info("Processing direction %d/%d: %s", i_d, len(dirs_list), d_lbl)

            sed_sfx = "chiral" if gen_cfg['chiral_mode_enabled'] else "regular"
            if welch_n:
                sed_sfx = f"welch{int(welch_n)}"  # do not collide with full-FFT caches
            if polarization != 'total':          # ditto for the L/T planes
                sed_sfx = f"lt_{'long' if polarization == 'longitudinal' else 'trans'}"
            sed_base = out_dir / f"sed_data_{sed_sfx}_{d_lbl}{basis_sfx}"

            sed_res = None
            if gen_cfg['save_npy_sed_data'] and not args.recalculate_sed:
                try:
                    sed_res = SED.load(sed_base)
                    logger.info("Loaded SED data for %s.", d_lbl)
                except FileNotFoundError:
                    logger.info("No pre-calculated SED for %s. Will calculate.", d_lbl)
                except Exception as e:
                    logger.warning("Failed to load SED for %s: %s. Recalculating.", d_lbl, e)

            needs_phase = (gen_cfg['chiral_mode_enabled']
                           and (sed_res is None or sed_res.phase is None))
            if sed_res is None or needs_phase:
                k_m, k_v = calc.get_k_path(dir_spec, sed_cfg['bz_coverage'],
                                           sed_cfg['n_kpoints'], eff_lat_param)
                sed_res = _path_sed(k_m, k_v)
                if gen_cfg['chiral_mode_enabled']:
                    pol = sed_cfg['polarization_indices_chiral']
                    if len(pol) >= 2 and sed_res.is_complex and sed_res.sed.shape[-1] > max(pol):
                        sed_res.phase = calc.calculate_chiral_phase(
                            sed_res.sed[:, :, pol[0]], sed_res.sed[:, :, pol[1]])
                    else:
                        logger.error("Chiral mode error for %s: insufficient polarizations "
                                     "or invalid indices %s.", d_lbl, pol)
                if gen_cfg['save_npy_sed_data']:
                    sed_res.save(sed_base)

            all_sed_results.append((d_lbl, sed_res))

            plot_args = {'direction_label': d_lbl, 'max_freq': plot_cfg['max_freq_2d'],
                         'theme': plot_cfg.get('theme', 'light'),
                         'cmap': plot_cfg.get('cmap', 'inferno'),
                         'intensity_scale': plot_cfg.get('intensity_scale', 'sqrt')}
            if not figures:
                continue
            if gen_cfg['chiral_mode_enabled']:
                if sed_res.phase is not None:
                    SEDPlotter(sed_res, '2d_phase',
                               str(out_dir / f"sed_phase_2D_{d_lbl}{basis_sfx}.png"),
                               **plot_args).generate_plot()
                else:
                    logger.info("Skipping 2D phase plot for %s (no phase data).", d_lbl)
            else:
                if global_max_i is not None:
                    plot_args['global_max_intensity_val'] = global_max_i
                hl = plot_cfg['highlight_2d_intensity']
                if all(hl.get(k) is not None for k in ('k_min', 'k_max', 'w_min', 'w_max')):
                    plot_args['highlight_region'] = {
                        'k_range': (float(hl['k_min']), float(hl['k_max'])),
                        'freq_range': (float(hl['w_min']), float(hl['w_max']))}
                SEDPlotter(sed_res, '2d_intensity',
                           str(out_dir / f"sed_intensity_2D_{d_lbl}{basis_sfx}.png"),
                           **plot_args).generate_plot()

        if figures and plot_cfg.get('enable_3d_dispersion_plot') and all_sed_results:
            # The reference requested plot types its plotter never implemented
            # (cli.py:177,183); we render per-direction frequency-slice summary
            # plots under the same switch.
            logger.info("Generating dispersion summary plots...")
            for d_lbl, sed_res in all_sed_results:
                target = plot_cfg.get('max_freq_2d') or 1.0
                SEDPlotter(sed_res, 'frequency_slice',
                           str(out_dir / f"disp_summary_{d_lbl}{basis_sfx}.png"),
                           target_frequency=float(target) / 2,
                           direction_label=d_lbl).generate_plot()

        kgrid_cfg = config.get('kgrid', {})
        if kgrid_cfg.get('apply'):
            _run_kgrid_section(calc, kgrid_cfg, out_dir, basis_idx,
                               summation_mode, figures)

        dos_cfg = config.get('dos', {})
        if dos_cfg.get('apply'):
            _run_dos_section(calc, dos_cfg, out_dir, traj, figures)

        dsf_cfg = config.get('dsf', {})
        if dsf_cfg.get('apply'):
            _run_dsf_section(calc, dsf_cfg, sed_cfg, out_dir, eff_lat_param,
                             traj, figures)

        tc_cfg = config.get('timecorr', {})
        if tc_cfg.get('apply'):
            _run_timecorr_section(calc, tc_cfg, out_dir, traj, figures)

        rdf_cfg = config.get('rdf', {})
        if rdf_cfg.get('apply'):
            _run_rdf_section(calc, rdf_cfg, out_dir, traj, figures)

        npt_cfg = config.get('npt', {})
        if npt_cfg.get('apply'):
            _run_npt_section(calc, npt_cfg, out_dir, figures)

        if ised_cfg['apply']:
            logger.info("Performing iSED reconstruction...")
            kp, tgt = ised_cfg['k_path'], ised_cfg['target_point']
            basis_i, recon = ised_cfg['basis'], ised_cfg['reconstruction']
            char_len = kp['characteristic_length'] or md_cfg['lattice_parameter']
            bz_cov = kp['bz_coverage'] or sed_cfg['bz_coverage']
            calc.ised(
                k_dir_spec=kp['direction'], k_target=float(tgt['k_value']),
                w_target=float(tgt['w_value_thz']), char_len_k_path=float(char_len),
                nk_on_path=int(kp['n_points']), bz_cov_ised=float(bz_cov),
                basis_atom_idx_ised=basis_i.get('atom_indices'),
                basis_atom_types_ised=basis_i.get('atom_types'),
                rescale_factor=recon['rescaling_factor'],
                n_recon_frames=int(recon['num_animation_timesteps']),
                dump_filepath=str(out_dir / recon['output_dump_filename']),
                plot_dir_ised=out_dir if figures else None,
                plot_max_freq=plot_cfg.get('max_freq_2d'))

        if profiler is not None:
            profiler.stop()
            profile_dir = out_dir / 'profile'
            profile_dir.mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(str(profile_dir / 'trace.json'))
            logger.info("Profiler trace written to %s", profile_dir)

        logger.info("PSA processing completed.")

    except FileNotFoundError as e:
        logger.error("File Error: %s", e)
        raise SystemExit(1)
    except ValueError as e:
        logger.error("Value Error: %s", e)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
