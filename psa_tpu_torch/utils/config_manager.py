"""Unified configuration management (carried over from
:mod:`psa_tpu.utils.config_manager`: the same schema, defaults and
validation).

A config file is YAML (``.yaml``/``.yml``, read with PyYAML, imported only
when such a file is read or written) or JSON (any other suffix, read with
the standard library; JSON is a subset of YAML, so the JAX package's CLI
reads the same file).

The reference shipped a ConfigManager validating a vestigial schema
(``trajectory/analysis/output``) that neither the CLI nor the GUI used
(reference: src/psa/utils/config_manager.py:46-74 vs cli.py:38-44).  Here the
ConfigManager IS the CLI/GUI schema: the five sections of the documented config
format (``general / md_system / sed_calculation / plotting / ised``, as in
examples/Si_config.yaml) with the CLI defaults, recursive overlay, and
validation of the fields the pipeline actually consumes.
"""
from __future__ import annotations

import copy
import json
import logging
import math
from pathlib import Path
from typing import Any, Dict, Optional, Union

from .helpers import update_dict_recursively

logger = logging.getLogger(__name__)


def default_config() -> Dict[str, Any]:
    """Pipeline defaults (reference cli.py:38-44, with the same section names)."""
    return {
        'general': {
            'trajectory_file_format': 'auto',
            'use_displacements': False,
            'save_npy_trajectory': True,
            'save_npy_sed_data': True,
            'chiral_mode_enabled': False,
            'mass_weighted': False,
            # instantaneous-phase engine for the dsf section: 'exact' ('auto'
            # resolves to it), 'factored' or 'incremental'
            'phase_mode': 'auto',
        },
        'md_system': {
            'dt': 0.001, 'nx': 1, 'ny': 1, 'nz': 1, 'lattice_parameter': None,
        },
        'sed_calculation': {
            'directions': [[1, 0, 0]],
            'n_kpoints': 100,
            'bz_coverage': 1.0,
            'polarization_indices_chiral': [0, 1],
            'summation_mode': 'coherent',
            'k_chunk_size': 500,
            'welch_segments': None,
            'welch_window': 'hann',
            'polarization': 'total',
            'basis': {'atom_indices': None, 'atom_types': None},
        },
        'plotting': {
            'max_freq_2d': None,
            'theme': 'light',
            'intensity_scale': 'sqrt',
            'cmap': 'inferno',
            'highlight_2d_intensity': {'k_min': None, 'k_max': None,
                                       'w_min': None, 'w_max': None},
            'enable_3d_dispersion_plot': False,
            '3d_plot_settings': {'intensity_log_scale': True,
                                 'intensity_threshold_rel': 0.05},
        },
        'ised': {
            'apply': False,
            'k_path': {'direction': 'x', 'characteristic_length': None,
                       'n_points': 50, 'bz_coverage': None},
            'target_point': {'k_value': 6.283, 'w_value_thz': 10.0},
            'basis': {'atom_indices': None, 'atom_types': None},
            'reconstruction': {'rescaling_factor': 'auto',
                               'num_animation_timesteps': 100,
                               'output_dump_filename': 'ised_motion.dump'},
        },
        # Optional sections beyond the reference CLI (absent from the
        # reference schema; apply=False keeps Si_config.yaml behavior
        # unchanged).
        'kgrid': {
            'apply': False,
            'plane': 'xy',
            'k_range': [-2.0, 2.0],           # both in-plane axes
            'n_k': 50,                         # points per axis
            'k_fixed': 0.0,
            'max_freq': None,
            'engine': 'auto',
            'mode': 'peaks',                   # 'peaks' | 'browse'
            'n_peaks': 1,
            'width_method': 'lorentzian',
            'chiral': False,
            'chiral_axis': 'z',
            'welch_segments': None,            # Welch segment averaging
            'welch_window': 'hann',
        },
        'dos': {
            'apply': False,
            'max_freq': None,
            'per_type': False,                 # one curve per atom type
        },
        'dsf': {
            'apply': False,
            # None ⇒ inherit the matching sed_calculation values, so a
            # config's k-paths get both the harmonic SED and the DSF maps.
            'directions': None,
            'n_kpoints': None,
            'bz_coverage': None,
            'max_freq': None,
            # which instantaneous-phase planes to write: any subset of
            # 'total' (S(k,ω)), 'longitudinal' (C_L), 'transverse' (C_T),
            # 'self' (S_s(k,ω), incoherent/self part), 'sk' (static S(k)),
            # 'isf'/'isf_self' (intermediate scattering functions over τ)
            'observables': ['total', 'longitudinal', 'transverse'],
            'n_lags': None,                    # ISF τ rows (None ⇒ n_t // 2)
            'kww': False,                      # per-k KWW fit of isf planes
            'kww_window': None,                # [τ_min, τ_max] ps fit window
            'welch_segments': None,            # Welch-averaged S(k,ω) planes
            'welch_window': 'hann',
            'basis': {'atom_indices': None, 'atom_types': None},
        },
        'timecorr': {
            'apply': False,
            'observables': ['msd'],            # any subset of msd / vacf
            'n_lags': None,                    # τ rows (None ⇒ n_t // 2)
            'per_type': False,                 # one curve per atom type
        },
        'rdf': {
            'apply': False,
            'r_max': None,                     # None ⇒ min-image validity radius
            'n_bins': 200,
            'max_frames': 64,                  # evenly strided frame sample
            'per_type': False,                 # add every type-pair partial
        },
        'npt': {
            'apply': False,
            # fractional-space k-path: either explicit Miller rows...
            'k_miller': None,                  # (n_k, 3) rows override the path
            # ...or a swept integer direction
            'direction': [1, 0, 0],
            'n_kpoints': 50,
            'max_order': None,                 # path end, multiples of direction (None ⇒ 1)
            'max_freq': None,                  # plot cap (THz)
            'summation_mode': 'coherent',
            'basis': {'atom_indices': None, 'atom_types': None},
            # 'full' = complex spectrum to host; 'browse' = device-reduced
            # intensity planes; 'peaks' = on-device peak surfaces only
            'sweep': 'full',
            'n_peaks': 1,                      # peaks-sweep surfaces per k
        },
    }


def _yaml():
    """PyYAML, imported on first use; a clear error where it is absent."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading or writing a YAML config needs PyYAML, which is not "
                          "installed; use a JSON config (any suffix but .yaml/.yml)") from e
    return yaml


def _is_yaml(path: Path) -> bool:
    return path.suffix.lower() in ('.yaml', '.yml')


class ConfigManager:
    """Load/validate/save pipeline configs.

    Usage:
        cfg = ConfigManager('Si_config.yaml')   # or a .json file, or ConfigManager() for defaults
        cfg.get('md_system', 'dt')
        cfg.update({'md_system': {'dt': 0.02}})
        cfg.save('out.yaml')
    """

    SECTIONS = ('general', 'md_system', 'sed_calculation', 'plotting', 'ised',
                'kgrid', 'dos', 'dsf', 'timecorr', 'rdf', 'npt')

    def __init__(self, config_path: Optional[Union[str, Path]] = None):
        self.config: Dict[str, Any] = default_config()
        self.config_path = Path(config_path) if config_path else None
        if self.config_path is not None:
            self.load(self.config_path)

    def load(self, config_path: Union[str, Path]) -> Dict[str, Any]:
        """Overlay a YAML or JSON file onto the defaults; validates the result."""
        config_path = Path(config_path)
        if not config_path.exists():
            raise FileNotFoundError(f"Config file not found: {config_path}")
        with open(config_path, 'r') as f:
            if _is_yaml(config_path):
                user_cfg = _yaml().safe_load(f)
            else:
                try:
                    user_cfg = json.load(f)
                except json.JSONDecodeError as e:
                    raise ValueError(f"{config_path} is not valid JSON ({e}); YAML configs "
                                     "need a .yaml or .yml suffix") from e
        if user_cfg:
            unknown = set(user_cfg) - set(self.SECTIONS)
            if unknown:
                logger.warning("Unknown config sections ignored by the pipeline: %s",
                               sorted(unknown))
            update_dict_recursively(self.config, user_cfg)
        self.validate()
        self.config_path = config_path
        logger.info("Loaded config from %s", config_path)
        return self.config

    def validate(self) -> None:
        """Check the fields the pipeline consumes. Raises ValueError on errors."""
        cfg = self.config
        md = cfg['md_system']
        if md['dt'] is None or md['dt'] <= 0:
            raise ValueError("md_system.dt must be positive.")
        for dim in ('nx', 'ny', 'nz'):
            if int(md[dim]) <= 0:
                raise ValueError(f"md_system.{dim} must be positive.")
        pm = cfg['general'].get('phase_mode', 'auto')
        if pm not in ('auto', 'exact', 'factored', 'incremental'):
            raise ValueError("general.phase_mode must be 'auto', 'exact', "
                             f"'factored' or 'incremental'; got {pm!r}.")
        sed = cfg['sed_calculation']
        if int(sed['n_kpoints']) < 1:
            raise ValueError("sed_calculation.n_kpoints must be >= 1.")
        if float(sed['bz_coverage']) <= 0:
            raise ValueError("sed_calculation.bz_coverage must be positive.")
        if sed.get('summation_mode', 'coherent') not in ('coherent', 'incoherent'):
            raise ValueError("sed_calculation.summation_mode must be 'coherent' or 'incoherent'.")
        if not isinstance(sed['directions'], list) or len(sed['directions']) == 0:
            raise ValueError("sed_calculation.directions must be a non-empty list.")
        welch_n = sed.get('welch_segments')
        if welch_n is not None:
            if int(welch_n) < 1:
                raise ValueError("sed_calculation.welch_segments must be >= 1.")
            if cfg['general'].get('chiral_mode_enabled'):
                raise ValueError(
                    "chiral mode needs complex spectra; disable "
                    "sed_calculation.welch_segments (use average_seds with "
                    "chiral_pair for ensemble chiral statistics).")
        if sed.get('welch_window', 'hann') not in ('rect', 'hann'):
            raise ValueError("sed_calculation.welch_window must be 'rect' or 'hann'.")
        pol = sed.get('polarization', 'total')
        if pol not in ('total', 'longitudinal', 'transverse'):
            raise ValueError("sed_calculation.polarization must be 'total', "
                             "'longitudinal' or 'transverse'.")
        if pol != 'total':
            if cfg['general'].get('chiral_mode_enabled'):
                raise ValueError("chiral mode compares Cartesian components; "
                                 "set sed_calculation.polarization to 'total'.")
            if welch_n is not None:
                raise ValueError("Welch averaging is not available for the "
                                 "L/T split; set sed_calculation.polarization "
                                 "to 'total'.")
        fmt = cfg['general']['trajectory_file_format']
        if fmt not in ('auto', 'lammps', 'vasp_outcar', 'extxyz', 'h5md'):
            raise ValueError(f"general.trajectory_file_format invalid: {fmt}")
        kg = cfg.get('kgrid', {})
        if kg.get('apply'):
            if kg.get('mode', 'peaks') not in ('peaks', 'browse'):
                raise ValueError("kgrid.mode must be 'peaks' or 'browse'.")
            if str(kg.get('plane', 'xy')).lower() not in ('xy', 'yz', 'zx'):
                raise ValueError("kgrid.plane must be 'xy', 'yz' or 'zx'.")
            if int(kg.get('n_k', 50)) < 1:
                raise ValueError("kgrid.n_k must be >= 1.")
            self._check_welch(kg, 'kgrid')
        ds = cfg.get('dsf', {})
        if ds.get('apply'):
            obs = ds.get('observables') or []
            bad = set(obs) - {'total', 'longitudinal', 'transverse', 'self',
                              'sk', 'isf', 'isf_self'}
            if not obs or bad:
                raise ValueError(
                    "dsf.observables must be a non-empty subset of "
                    "'total'/'longitudinal'/'transverse'/'self'/'sk'/"
                    f"'isf'/'isf_self'; got {obs!r}.")
            dirs = ds.get('directions')
            if dirs is not None and (not isinstance(dirs, list) or not dirs):
                raise ValueError(
                    "dsf.directions must be a non-empty list or null "
                    "(null inherits sed_calculation.directions).")
            nl = ds.get('n_lags')
            if nl is not None and (isinstance(nl, bool)
                                   or not isinstance(nl, int) or nl < 1):
                raise ValueError(
                    f"dsf.n_lags must be a positive integer or null "
                    f"(null ⇒ n_frames // 2); got {nl!r}.")
            kw = ds.get('kww_window')
            if kw is not None and (
                    not isinstance(kw, (list, tuple)) or len(kw) != 2
                    or any(isinstance(v, bool)
                           or not isinstance(v, (int, float)) for v in kw)
                    or not kw[0] < kw[1]):
                raise ValueError(
                    f"dsf.kww_window must be null or an ascending "
                    f"[tau_min, tau_max] pair (ps); got {kw!r}.")
            if ds.get('kww') and not ({'isf', 'isf_self'}
                                      & set(ds.get('observables') or [])):
                raise ValueError("dsf.kww needs 'isf' and/or 'isf_self' in "
                                 "dsf.observables.")
            self._check_welch(ds, 'dsf')
        rd = cfg.get('rdf', {})
        if rd.get('apply'):
            rm = rd.get('r_max')
            if rm is not None and (not isinstance(rm, (int, float))
                                   or isinstance(rm, bool) or rm <= 0):
                raise ValueError(f"rdf.r_max must be a positive number or "
                                 f"null; got {rm!r}.")
            for key in ('n_bins', 'max_frames'):
                v = rd.get(key)
                if v is not None and (isinstance(v, bool)
                                      or not isinstance(v, int) or v < 1):
                    raise ValueError(f"rdf.{key} must be a positive "
                                     f"integer or null; got {v!r}.")
        np_cfg = cfg.get('npt', {})
        if np_cfg.get('apply'):
            km = np_cfg.get('k_miller')
            if km is not None:
                ok = (isinstance(km, (list, tuple)) and len(km) > 0
                      and all(isinstance(r, (list, tuple)) and len(r) == 3
                              and all(isinstance(v, (int, float))
                                      and not isinstance(v, bool)
                                      and math.isfinite(v) for v in r)
                              for r in km))
                if not ok:
                    raise ValueError("npt.k_miller must be null or a "
                                     "non-empty list of finite [m1, m2, m3] "
                                     "rows.")
            else:
                d = np_cfg.get('direction')
                if (not isinstance(d, (list, tuple)) or len(d) != 3
                        or all(v == 0 for v in d)
                        or any(isinstance(v, bool)
                               or not isinstance(v, (int, float))
                               or not math.isfinite(v) for v in d)):
                    raise ValueError("npt.direction must be a non-zero "
                                     f"[m1, m2, m3] vector; got {d!r}.")
                nk = np_cfg.get('n_kpoints')
                if nk is not None and (isinstance(nk, bool)
                                       or not isinstance(nk, int) or nk < 1):
                    raise ValueError(f"npt.n_kpoints must be a positive "
                                     f"integer; got {nk!r}.")
                mo = np_cfg.get('max_order')
                if mo is not None and (isinstance(mo, bool)
                                       or not isinstance(mo, (int, float))
                                       or mo <= 0):
                    raise ValueError(f"npt.max_order must be a positive "
                                     f"number or null; got {mo!r}.")
            if np_cfg.get('summation_mode', 'coherent') not in (
                    'coherent', 'incoherent'):
                raise ValueError("npt.summation_mode must be 'coherent' or "
                                 "'incoherent'.")
            if np_cfg.get('sweep', 'full') not in ('full', 'browse',
                                                   'peaks'):
                raise ValueError("npt.sweep must be 'full', 'browse' or "
                                 f"'peaks'; got {np_cfg.get('sweep')!r}.")
            npk = np_cfg.get('n_peaks', 1)
            if isinstance(npk, bool) or not isinstance(npk, int) or npk < 1:
                raise ValueError(f"npt.n_peaks must be a positive integer; "
                                 f"got {npk!r}.")
        tc = cfg.get('timecorr', {})
        if tc.get('apply'):
            obs = tc.get('observables') or []
            bad = set(obs) - {'msd', 'vacf'}
            if not obs or bad:
                raise ValueError("timecorr.observables must be a non-empty "
                                 f"subset of 'msd'/'vacf'; got {obs!r}.")
            nl = tc.get('n_lags')
            if nl is not None and (isinstance(nl, bool)
                                   or not isinstance(nl, int) or nl < 1):
                raise ValueError(
                    f"timecorr.n_lags must be a positive integer or null "
                    f"(null ⇒ n_frames // 2); got {nl!r}.")

    def get(self, *keys: str, default: Any = None) -> Any:
        """Nested lookup: cfg.get('md_system', 'dt')."""
        node: Any = self.config
        for key in keys:
            if not isinstance(node, dict) or key not in node:
                return default
            node = node[key]
        return node

    def update(self, updates: Dict[str, Any]) -> None:
        update_dict_recursively(self.config, updates)
        self.validate()

    def save(self, path: Optional[Union[str, Path]] = None) -> None:
        path = Path(path) if path else self.config_path
        if path is None:
            raise ValueError("No path given and no config_path set.")
        path.parent.mkdir(parents=True, exist_ok=True)
        with open(path, 'w') as f:
            if _is_yaml(path):
                _yaml().dump(self.config, f, default_flow_style=False)
            else:
                json.dump(self.config, f, indent=2)
        logger.info("Saved config to %s", path)

    def to_json(self) -> str:
        return json.dumps(self.config, indent=2, default=str)

    def as_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self.config)

    @staticmethod
    def _check_welch(section, name):
        """Shared welch_segments/welch_window validation for the optional
        spectral sections (Welch estimates)."""
        wn = section.get('welch_segments')
        if wn is not None and (isinstance(wn, bool)
                               or not isinstance(wn, int) or wn < 1):
            raise ValueError(f"{name}.welch_segments must be a positive "
                             f"integer or null; got {wn!r}.")
        if section.get('welch_window', 'hann') not in ('rect', 'hann'):
            raise ValueError(f"{name}.welch_window must be 'rect' or "
                             f"'hann'.")
