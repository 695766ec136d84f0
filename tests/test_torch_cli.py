"""psa_tpu_torch's command line against the JAX package's, flow by flow.

Each flow of ``tests/test_cli.py`` that has a ported surface runs through
both ``main`` functions on the same dump and the same config (a JSON file:
JSON is YAML, so the JAX CLI reads it too), the port with ``--device cpu``.
Both must write the same files, and every saved array must agree to the
library tolerance: 1e-6 of the array's maximum (the parity bar; 2e-5 Å for
the iSED dump's coordinates, its text precision).  Chiral phases are
compared where the spectrum is above 1e-3 of its maximum (below that the
phase of a rounding residue is compared, not of a signal).
"""
import json

import numpy as np
import pytest
import torch
import yaml

from psa_tpu.cli import main as jax_main
from psa_tpu.models import make_chain_trajectory
from psa_tpu_torch import SED
from psa_tpu_torch.cli import build_parser, main
from psa_tpu_torch.utils.config_manager import ConfigManager

torch.set_num_threads(1)

TOL = 1e-6
KWW_WINDOW = [0.0, 0.3]
MD = {'dt': 0.02, 'nx': 12, 'ny': 1, 'nz': 1}
SED_X = {'directions': ['x'], 'n_kpoints': 8, 'bz_coverage': 0.5}


def write_dump(path, traj):
    with open(path, "w") as f:
        for t in range(traj.n_frames):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{traj.n_atoms}\n")
            f.write("ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                f.write(f"0.0 {traj.box_matrix[d, d]:.6f}\n")
            f.write("ITEM: ATOMS id type x y z vx vy vz\n")
            for a_ in range(traj.n_atoms):
                p, v = traj.positions[t, a_], traj.velocities[t, a_]
                f.write(f"{a_ + 1} {traj.types[a_]} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")


def write_npt_dump(path, n_at=12, n_frames=32, a=2.5, breathe=0.01):
    """The breathing-box chain of ``tests/test_cli.py::test_cli_npt_section``."""
    L0 = n_at * a
    rng = np.random.default_rng(0)
    lam = 1.0 + breathe * np.sin(2 * np.pi * np.arange(n_frames) / n_frames)
    x_frac = (np.arange(n_at) + 0.5) / n_at
    with open(path, "w") as f:
        for t in range(n_frames):
            L = lam[t] * L0
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{n_at}\n")
            f.write(f"ITEM: BOX BOUNDS pp pp pp\n0.0 {L:.6f}\n0.0 10.0\n0.0 10.0\n")
            f.write("ITEM: ATOMS id type x y z vx vy vz\n")
            for i in range(n_at):
                f.write(f"{i + 1} 1 {L * x_frac[i]:.6f} 1.0 1.0 {rng.normal(0, 0.1):.6f} 0.0 0.0\n")
    return lam.mean() * L0


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    traj = make_chain_trajectory(n_cells=12, n_frames=48, dt_ps=0.02, a=2.5, omega_max_thz=6.0)
    path = tmp_path_factory.mktemp('chain') / 'chain.dump'
    write_dump(path, traj)
    return path.read_text()


def run_port(tmp_path, dump_text, config, *flags, name='port', suffix='.json'):
    """Run the port's CLI in its own directory; returns the output dir."""
    work = tmp_path / name
    work.mkdir(exist_ok=True)
    (work / 'traj.dump').write_text(dump_text)
    cfg = work / f'config{suffix}'
    cfg.write_text(json.dumps(config) if suffix == '.json' else yaml.dump(config))
    main(['--trajectory', str(work / 'traj.dump'), '--config', str(cfg),
          '--output-dir', str(work / 'out'), '--device', 'cpu', *flags])
    return work / 'out'


def run_jax(tmp_path, dump_text, config, *flags):
    work = tmp_path / 'jax'
    work.mkdir(exist_ok=True)
    (work / 'traj.dump').write_text(dump_text)
    (work / 'config.json').write_text(json.dumps(config))
    jax_main(['--trajectory', str(work / 'traj.dump'), '--config', str(work / 'config.json'),
              '--output-dir', str(work / 'out'), *flags])
    return work / 'out'


def names(out):
    return sorted(p.name for p in out.iterdir() if p.name != 'profile')


def assert_arrays_close(got, want, what, tol=TOL, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    if got.dtype.kind in 'iub' or want.size == 0:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    scale = scale or float(np.nanmax(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what,
                               equal_nan=True)


def dump_coords(path):
    rows = [ln.split() for ln in path.read_text().splitlines()]
    return np.array([r for r in rows if len(r) == 5], dtype=float)


def assert_fits_follow_their_planes(got, want, fit_keys):
    """The KWW fit of a chain's oscillating ISF is ill-conditioned (it turns
    1e-7 of the plane into 1e-4 of β), so the saved fits are not compared
    across packages: each package's saved fit must be the port's fit of that
    package's own saved plane, to 1e-9."""
    from psa_tpu_torch.utils import isf_relaxation_time, kww_fit
    for obs in sorted({k.split('_', 2)[2] for k in fit_keys}):
        for saved in (got, want):
            window = tuple(float(v) for v in KWW_WINDOW)
            amp, tau, beta, rms = kww_fit(saved['lags_ps'], saved[obs], fit_window=window)
            fit = {'kww_amp': amp, 'kww_tau': tau, 'kww_beta': beta, 'kww_rms': rms,
                   'tau_alpha': isf_relaxation_time(saved['lags_ps'], saved[obs])}
            for name, value in fit.items():
                np.testing.assert_allclose(saved[f'{name}_{obs}'], value, rtol=1e-9, atol=1e-12,
                                           equal_nan=True, err_msg=f'{name}_{obs}')


def assert_same_output(port_out, jax_out, npz_keys=None):
    """The same files; every data file's arrays equal to the tolerance."""
    assert names(port_out) == names(jax_out)
    for path in sorted(port_out.iterdir()):
        other = jax_out / path.name
        if path.name.endswith('.phase.npy'):
            base = path.name[:-len('.phase.npy')]
            inten = SED.load(jax_out / base).intensity
            strong = inten > 1e-3 * inten.max()
            assert strong.any()
            assert_arrays_close(np.load(path)[strong], np.load(other)[strong], path.name, 1e-4)
        elif path.suffix == '.npy':
            assert_arrays_close(np.load(path), np.load(other), path.name)
        elif path.suffix == '.npz':
            got, want = np.load(path), np.load(other)
            keys = npz_keys or sorted(want.files)
            if npz_keys is None:
                assert sorted(got.files) == keys, path.name
            fits = [k for k in keys if k.startswith(('kww_', 'tau_alpha_'))]
            keys = [k for k in keys if k not in fits]
            assert_fits_follow_their_planes(got, want, fits)
            for key in keys:
                # C_T = total − C_L is a cancellation residue on a longitudinal
                # chain: it is held to C_L's scale
                scale = float(np.abs(want['c_l']).max()) if key == 'c_t' else None
                assert_arrays_close(got[key], want[key], f"{path.name}:{key}",
                                    1e-4 if key in ('peak_phase', 'phase') else TOL, scale)
        elif path.suffix == '.csv':
            assert path.read_text().splitlines()[0] == other.read_text().splitlines()[0]
            assert_arrays_close(np.loadtxt(path, delimiter=',', skiprows=1),
                                np.loadtxt(other, delimiter=',', skiprows=1), path.name)
        elif path.suffix == '.json':
            got, want = json.loads(path.read_text()), json.loads(other.read_text())
            assert set(got) == set(want)
            for key, value in want.items():
                if isinstance(value, (int, float)):
                    np.testing.assert_allclose(got[key], value, rtol=1e-4, err_msg=key)
        elif path.suffix == '.dump':
            np.testing.assert_allclose(dump_coords(path), dump_coords(other), atol=2e-5)
        elif path.suffix == '.png':
            assert path.stat().st_size > 1000


ISED = {'apply': True,
        'k_path': {'direction': 'x', 'characteristic_length': 2.5, 'n_points': 12,
                   'bz_coverage': 0.5},
        'target_point': {'k_value': 0.6, 'w_value_thz': 4.0},
        'reconstruction': {'rescaling_factor': 'auto', 'num_animation_timesteps': 6,
                           'output_dump_filename': 'motion.dump'}}
KGRID = {'apply': True, 'plane': 'xy', 'k_range': [-1.0, 1.0], 'n_k': 6, 'max_freq': 10.0}

FLOWS = {
    'two-directions': ({'sed_calculation': {'directions': ['x', [1, 0, 0]], 'n_kpoints': 10,
                                            'bz_coverage': 0.5},
                        'plotting': {'max_freq_2d': 8.0}}, ()),
    'chiral-flag': ({'sed_calculation': dict(SED_X, directions=['x', [1, 0, 0]])},
                    ('--chiral', '--nk', '8')),
    'ised': ({'sed_calculation': SED_X, 'ised': ISED}, ()),
    'dispersion-summary': ({'sed_calculation': SED_X,
                            'plotting': {'max_freq_2d': 8.0,
                                         'enable_3d_dispersion_plot': True}}, ()),
    'type-basis-incoherent': ({'sed_calculation': dict(
        SED_X, summation_mode='incoherent', basis={'atom_types': [1], 'atom_indices': None})}, ()),
    'index-basis': ({'sed_calculation': dict(
        SED_X, basis={'atom_indices': [0, 2, 4, 6], 'atom_types': None})}, ()),
    'displacements-dt': ({'general': {'use_displacements': True}, 'sed_calculation': SED_X},
                         ('--dt', '0.01')),
    'welch': ({'sed_calculation': dict(SED_X, welch_segments=4)}, ()),
    'lt-longitudinal': ({'sed_calculation': dict(SED_X, polarization='longitudinal')}, ()),
    'lt-transverse': ({'sed_calculation': dict(SED_X, polarization='transverse')}, ()),
    'kgrid-peaks': ({'sed_calculation': SED_X,
                     'kgrid': dict(KGRID, n_peaks=2, group_velocity=True,
                                   thermal_conductivity=True)}, ()),
    'kgrid-browse-chiral': ({'sed_calculation': SED_X,
                             'kgrid': dict(KGRID, mode='browse', chiral=True,
                                           chiral_axis='z')}, ()),
    'kgrid-browse-welch': ({'sed_calculation': SED_X,
                            'kgrid': dict(KGRID, mode='browse', welch_segments=2)}, ()),
    'dos-per-type': ({'sed_calculation': SED_X,
                      'dos': {'apply': True, 'max_freq': 12.0, 'per_type': True}}, ()),
    'dsf-planes': ({'general': {'phase_mode': 'exact'}, 'sed_calculation': SED_X,
                    'dsf': {'apply': True, 'n_kpoints': 6, 'bz_coverage': 1.0,
                            'observables': ['total', 'longitudinal', 'transverse', 'self',
                                            'sk']}}, ()),
    'dsf-isf-kww': ({'general': {'phase_mode': 'exact'}, 'sed_calculation': SED_X,
                     'dsf': {'apply': True, 'n_kpoints': 6, 'bz_coverage': 1.0, 'n_lags': 16,
                             'observables': ['isf', 'isf_self'], 'kww': True,
                             'kww_window': KWW_WINDOW}}, ()),
    'dsf-welch': ({'general': {'phase_mode': 'exact'}, 'sed_calculation': SED_X,
                   'dsf': {'apply': True, 'n_kpoints': 6, 'bz_coverage': 1.0,
                           'observables': ['total'], 'welch_segments': 2}}, ()),
    'timecorr': ({'sed_calculation': SED_X,
                  'timecorr': {'apply': True, 'observables': ['msd', 'vacf'], 'n_lags': 20,
                               'per_type': True}}, ()),
    'timecorr-default': ({'sed_calculation': SED_X, 'timecorr': {'apply': True}}, ()),
    'rdf': ({'sed_calculation': SED_X,
             'rdf': {'apply': True, 'n_bins': 30, 'max_frames': 4, 'r_max': 4.0}}, ()),
    'rdf-per-type': ({'sed_calculation': SED_X,
                      'rdf': {'apply': True, 'n_bins': 20, 'max_frames': 3,
                              'per_type': True}}, ()),
}


@pytest.mark.parametrize("flow", list(FLOWS))
def test_flow_matches_the_jax_cli(tmp_path, chain, flow):
    config, flags = FLOWS[flow]
    config = dict({'md_system': MD}, **config)
    port_out = run_port(tmp_path, chain, config, *flags)
    jax_out = run_jax(tmp_path, chain, config, *flags)
    assert_same_output(port_out, jax_out)
    assert any(p.suffix == '.png' for p in port_out.iterdir())


@pytest.mark.parametrize("sweep", ['full', 'browse', 'peaks'])
def test_npt_section_matches_the_jax_cli(tmp_path, sweep):
    """The breathing-box chain: the loader fills the per-frame cells and the
    section writes the fractional-anchor outputs.  Of ``npt_sed.npz`` only
    the keys of ``test_cli_npt_section`` are compared (its other keys depend
    on the sweep mode in both packages)."""
    mean_l = write_npt_dump(tmp_path / 'npt.dump')
    config = {'md_system': dict(MD, lattice_parameter=2.5),
              'sed_calculation': dict(SED_X, n_kpoints=4),
              'npt': {'apply': True, 'direction': [1, 0, 0], 'n_kpoints': 6, 'sweep': sweep,
                      'max_freq': 20.0, 'n_peaks': 2}}
    dump_text = (tmp_path / 'npt.dump').read_text()
    port_out = run_port(tmp_path, dump_text, config)
    jax_out = run_jax(tmp_path, dump_text, config)
    stem = 'npt_peaks' if sweep == 'peaks' else 'npt_sed'
    keys = (['peak_freqs', 'peak_intensities', 'peak_widths', 'k_miller', 'k_vectors', 'k_mags']
            if sweep == 'peaks' else ['intensity', 'k_miller', 'k_vectors', 'k_mags'])
    assert names(port_out) == names(jax_out)
    got, want = np.load(port_out / f'{stem}.npz'), np.load(jax_out / f'{stem}.npz')
    for key in keys:
        assert_arrays_close(got[key], want[key], key)
    np.testing.assert_allclose(got['k_mags'], 2 * np.pi * got['k_miller'][:, 0] / mean_l,
                               rtol=1e-4)
    assert (port_out / f'{stem}.png').exists()


def test_npt_section_on_a_fixed_cell_exits(tmp_path):
    write_npt_dump(tmp_path / 'fixed.dump', n_frames=8, breathe=0.0)
    config = {'md_system': dict(MD, lattice_parameter=2.5),
              'sed_calculation': dict(SED_X, n_kpoints=4),
              'npt': {'apply': True, 'direction': [1, 0, 0], 'n_kpoints': 6}}
    with pytest.raises(SystemExit):
        run_port(tmp_path, (tmp_path / 'fixed.dump').read_text(), config)


def test_json_config_and_its_yaml_twin_give_the_same_output(tmp_path, chain):
    config = {'md_system': MD, 'sed_calculation': SED_X,
              'dos': {'apply': True}, 'timecorr': {'apply': True, 'n_lags': 8}}
    from_json = run_port(tmp_path, chain, config, name='json')
    from_yaml = run_port(tmp_path, chain, config, name='yaml', suffix='.yaml')
    assert_same_output(from_yaml, from_json)
    for name in ('sed_data_regular_x.sed.npy',):
        np.testing.assert_array_equal(np.load(from_yaml / name), np.load(from_json / name))


def test_rerun_loads_the_cached_sed(tmp_path, chain, monkeypatch):
    """Without ``--recalculate-sed`` a second run loads the saved SED and
    projects nothing; with it, it computes again."""
    from psa_tpu_torch.core import calculator
    config = {'md_system': MD, 'sed_calculation': SED_X}
    out = run_port(tmp_path, chain, config)
    first = np.load(out / 'sed_data_regular_x.sed.npy')
    calls = []
    real = calculator.sed_projection
    monkeypatch.setattr(calculator, 'sed_projection',
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    run_port(tmp_path, chain, config)
    assert not calls
    run_port(tmp_path, chain, config, '--recalculate-sed')
    assert calls
    np.testing.assert_array_equal(np.load(out / 'sed_data_regular_x.sed.npy'), first)


def test_profile_flag_writes_a_trace(tmp_path, chain):
    out = run_port(tmp_path, chain, {'md_system': MD, 'sed_calculation': SED_X},
                   '--nk', '6', '--profile')
    trace = json.loads((out / 'profile' / 'trace.json').read_text())
    assert trace['traceEvents']


@pytest.mark.parametrize("precision", ['parity', 'balanced', 'fast'])
def test_precision_flag_reaches_the_calculator(tmp_path, chain, precision):
    out = run_port(tmp_path, chain, {'md_system': MD, 'sed_calculation': SED_X},
                   '--precision', precision)
    got = np.load(out / 'sed_data_regular_x.sed.npy')
    if precision == 'parity':
        assert 'TF32' in build_parser().format_help()
        return
    want = np.load(run_port(tmp_path, chain, {'md_system': MD, 'sed_calculation': SED_X},
                            name='parity') / 'sed_data_regular_x.sed.npy')
    err = np.abs(got - want).max() / np.abs(want).max()
    assert 0 < err < (5e-5 if precision == 'balanced' else 5e-3)


def test_missing_trajectory_exits(tmp_path):
    with pytest.raises(SystemExit):
        main(['--trajectory', str(tmp_path / "nope.dump"), '--output-dir', str(tmp_path / "o"),
              '--device', 'cpu'])


def test_default_device_is_the_card(tmp_path, chain):
    """No ``--device``: the run asks for CUDA and, without a card, ends with
    the library's error; it does not carry on on the CPU."""
    assert build_parser().parse_args(['--trajectory', 'x']).device == 'cuda'
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    (tmp_path / 'traj.dump').write_text(chain)
    (tmp_path / 'c.json').write_text(json.dumps({'md_system': MD, 'sed_calculation': SED_X}))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(['--trajectory', str(tmp_path / 'traj.dump'), '--config', str(tmp_path / 'c.json'),
              '--output-dir', str(tmp_path / 'out')])
    assert not list((tmp_path / 'out').glob('sed_data*'))


BAD_CONFIGS = {
    'welch-with-chiral-flag': ({'sed_calculation': dict(SED_X, welch_segments=4)}, ('--chiral',)),
    'lt-with-chiral-flag': ({'sed_calculation': dict(SED_X, polarization='transverse')},
                            ('--chiral',)),
    'negative-dt': ({'md_system': dict(MD, dt=-1.0)}, ()),
    'zero-nx': ({'md_system': dict(MD, nx=0)}, ()),
    'phase-mode': ({'general': {'phase_mode': 'bogus'}}, ()),
    'npt-zero-direction': ({'npt': {'apply': True, 'direction': [0, 0, 0]}}, ()),
    'npt-short-direction': ({'npt': {'apply': True, 'direction': [1, 0]}}, ()),
    'npt-nonfinite-k': ({'npt': {'apply': True, 'k_miller': [[1, float('inf'), 0]]}}, ()),
    'npt-bad-sweep': ({'npt': {'apply': True, 'sweep': 'all'}}, ()),
    'npt-bad-peaks': ({'npt': {'apply': True, 'n_peaks': 0}}, ()),
    'dsf-observable': ({'dsf': {'apply': True, 'observables': ['everything']}}, ()),
    'dsf-kww-without-isf': ({'dsf': {'apply': True, 'observables': ['sk'], 'kww': True}}, ()),
    'dsf-kww-window': ({'dsf': {'apply': True, 'observables': ['isf'], 'kww_window': [2, 1]}}, ()),
    'dsf-lags': ({'dsf': {'apply': True, 'n_lags': 0}}, ()),
    'timecorr-observable': ({'timecorr': {'apply': True, 'observables': ['rmsd']}}, ()),
    'timecorr-lags': ({'timecorr': {'apply': True, 'n_lags': -3}}, ()),
    'rdf-r-max': ({'rdf': {'apply': True, 'r_max': -1.0}}, ()),
    'rdf-bins': ({'rdf': {'apply': True, 'n_bins': 0}}, ()),
    'kgrid-mode': ({'kgrid': {'apply': True, 'mode': 'planes'}}, ()),
    'kgrid-plane': ({'kgrid': {'apply': True, 'plane': 'xx'}}, ()),
    'kgrid-welch': ({'kgrid': {'apply': True, 'welch_segments': 0}}, ()),
    'file-format': ({'general': {'trajectory_file_format': 'pdb'}}, ()),
    'no-directions': ({'sed_calculation': dict(SED_X, directions=[])}, ()),
}


@pytest.mark.parametrize("case", list(BAD_CONFIGS))
def test_config_validation_errors_exit_1(tmp_path, chain, case):
    config, flags = BAD_CONFIGS[case]
    config = dict({'md_system': MD, 'sed_calculation': SED_X}, **config)
    with pytest.raises(SystemExit) as exit_info:
        run_port(tmp_path, chain, config, *flags)
    assert exit_info.value.code == 1
    assert not list((tmp_path / 'port' / 'out').glob('*.npy'))
    # without flags, the schema alone rejects the file
    manager = ConfigManager()
    (tmp_path / 'c.json').write_text(json.dumps(config))
    if not flags:
        with pytest.raises(ValueError):
            manager.load(tmp_path / 'c.json')


@pytest.mark.parametrize("config,row", [
    ({'general': {'phase_mode': 'incremental'}}, 'A10'),
    ({'general': {'phase_mode': 'factored'}}, 'A10'),
    ({'kgrid': dict(KGRID, engine='gridded')}, 'A12'),
    ({'kgrid': dict(KGRID, mode='browse', engine='gridded')}, 'A12'),
], ids=['incremental', 'factored', 'gridded-peaks', 'gridded-browse'])
def test_unported_requests_fail_loudly(tmp_path, chain, config, row):
    """What is not ported ends the run with the library's error, which names
    the ROADMAP row; nothing is skipped or replaced."""
    config = dict({'md_system': MD, 'sed_calculation': SED_X}, **config)
    with pytest.raises(NotImplementedError, match=row):
        run_port(tmp_path, chain, config)


def test_invalid_json_is_a_config_error(tmp_path, chain):
    (tmp_path / 'traj.dump').write_text(chain)
    (tmp_path / 'c.json').write_text("md_system: {dt: 0.02}\n")       # YAML in a .json file
    with pytest.raises(SystemExit) as exit_info:
        main(['--trajectory', str(tmp_path / 'traj.dump'), '--config', str(tmp_path / 'c.json'),
              '--output-dir', str(tmp_path / 'out'), '--device', 'cpu'])
    assert exit_info.value.code == 1


@pytest.mark.parametrize("suffix", ['.json', '.yaml', '.yml'])
def test_config_manager_round_trip(tmp_path, suffix):
    """``save`` then ``load`` in either format returns the same config, and
    the defaults are the JAX package's."""
    from psa_tpu.utils.config_manager import default_config as jax_defaults
    from psa_tpu_torch.utils.config_manager import default_config
    assert default_config() == jax_defaults()
    manager = ConfigManager()
    manager.update({'md_system': {'dt': 0.02, 'nx': 3}, 'rdf': {'apply': True, 'r_max': 4.5}})
    manager.save(tmp_path / f'cfg{suffix}')
    again = ConfigManager(tmp_path / f'cfg{suffix}')
    assert again.as_dict() == manager.as_dict()
    assert again.get('rdf', 'r_max') == 4.5 and again.get('nope', default=7) == 7
    assert json.loads(again.to_json())['md_system']['nx'] == 3
