"""psa_tpu_torch's plotter and styles (carried over; matplotlib imported
when a plotter is built): the cases of ``tests/test_visualization.py`` on
the port's ``SED``, a PNG written and non-empty for each plot type, the
iSED input-spectrum figure and ``average_seds``."""
import matplotlib
matplotlib.use('Agg')

import numpy as np
import pytest
import torch

import psa_tpu
from psa_tpu.models import make_chain_trajectory
from psa_tpu_torch import SED, SEDPlotter, average_seds
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.visualization import styles
from psa_tpu_torch.visualization.sed_plotter import VALID_PLOT_TYPES, apply_intensity_scale

torch.set_num_threads(1)


def make_path_sed(n_freq=32, n_k=10, with_phase=False, seed=0):
    rng = np.random.default_rng(seed)
    sed = (rng.normal(size=(n_freq, n_k, 3))
           + 1j * rng.normal(size=(n_freq, n_k, 3))).astype(np.complex64)
    k_points = np.linspace(0, 2, n_k).astype(np.float32)
    phase = (rng.uniform(-np.pi / 2, np.pi / 2, size=(n_freq, n_k)).astype(np.float32)
             if with_phase else None)
    return SED(sed, np.fft.fftfreq(n_freq, d=0.05), k_points,
               np.outer(k_points, [1, 0, 0]).astype(np.float32), phase=phase)


def make_grid_sed(n_freq=16, n1=6, n2=5):
    rng = np.random.default_rng(1)
    kx = np.linspace(-1, 1, n1, dtype=np.float32)
    ky = np.linspace(-1, 1, n2, dtype=np.float32)
    kv = np.stack([np.repeat(kx, n2), np.tile(ky, n1), np.zeros(n1 * n2, np.float32)], axis=1)
    sed = (rng.normal(size=(n_freq, n1 * n2, 3))
           + 1j * rng.normal(size=(n_freq, n1 * n2, 3))).astype(np.complex64)
    return SED(sed, np.fft.fftfreq(n_freq, d=0.05), np.array([]), kv, k_grid_shape=(n1, n2))


def test_linear_passthrough():
    x = np.array([1.0, 4.0])
    out, label = apply_intensity_scale(x, 'linear')
    np.testing.assert_array_equal(out, x)
    assert 'Intensity' in label


@pytest.mark.parametrize("scale,fn,label", [
    ('log', lambda x: np.log10(np.maximum(x, 1e-12)), 'Log10'),
    ('sqrt', np.sqrt, 'Sqrt'),
    ('dsqrt', lambda x: np.sqrt(np.sqrt(x)), 'DSqrt'),
])
def test_scales(scale, fn, label):
    x = np.array([0.01, 1.0, 100.0])
    out, lbl = apply_intensity_scale(x, scale)
    np.testing.assert_allclose(out, fn(x), rtol=1e-6)
    assert label in lbl


def test_unknown_scale_falls_back():
    out, _ = apply_intensity_scale(np.array([1.0]), 'bogus')
    np.testing.assert_array_equal(out, [1.0])


PLOTS = {
    '2d_intensity': (make_path_sed, dict(max_freq=8.0, intensity_scale='dsqrt',
                                         highlight_region={'k_point_target': 1.0,
                                                           'freq_point_target': 3.0})),
    '2d_phase': (lambda: make_path_sed(with_phase=True), dict(cmap='twilight')),
    '3d_heatmap': (make_grid_sed, dict(heatmap_target_freq_thz=2.0, heatmap_plane='xy')),
    '1d_slice': (make_path_sed, dict(k_index=3)),
    'frequency_slice': (make_path_sed, dict(target_frequency=4.0, intensity_scale='log')),
}


def test_every_plot_type_is_covered():
    assert set(PLOTS) == set(VALID_PLOT_TYPES)


@pytest.mark.parametrize("plot_type", list(PLOTS))
@pytest.mark.parametrize("theme", ['light', 'dark'])
def test_plot_written_and_non_empty(tmp_path, plot_type, theme):
    make, kwargs = PLOTS[plot_type]
    out = tmp_path / f"{plot_type}_{theme}.png"
    SEDPlotter(make(), plot_type, str(out), theme=theme, **kwargs).generate_plot()
    assert out.exists() and out.stat().st_size > 5000
    assert out.read_bytes()[:8] == b'\x89PNG\r\n\x1a\n'


@pytest.mark.parametrize("plot_type,kwargs", [
    ('2d_phase', {}),                       # no phase data
    ('1d_slice', {}),                       # neither index
    ('1d_slice', {'k_index': 99}),          # out of bounds
    ('1d_slice', {'freq_index': 99}),
], ids=['phase-without-phase', 'slice-no-index', 'slice-k-oob', 'slice-freq-oob'])
def test_unplottable_is_a_noop(tmp_path, plot_type, kwargs):
    out = tmp_path / "none.png"
    SEDPlotter(make_path_sed(), plot_type, str(out), **kwargs).generate_plot()
    assert not out.exists()


@pytest.mark.parametrize("make,plot_type,kwargs,match", [
    (make_path_sed, '3d_heatmap', {}, "k_grid_shape"),
    (make_grid_sed, '3d_heatmap', {'heatmap_plane': 'ab'}, "heatmap_plane"),
    (make_path_sed, 'nope', {}, "Invalid plot_type"),
], ids=['heatmap-needs-grid', 'heatmap-bad-plane', 'bad-type'])
def test_invalid_requests_raise(tmp_path, make, plot_type, kwargs, match):
    with pytest.raises(ValueError, match=match):
        SEDPlotter(make(), plot_type, str(tmp_path / "x.png"), **kwargs).generate_plot()


def test_plotter_wants_the_ports_sed(tmp_path):
    ref = psa_tpu.SED(np.zeros((4, 3, 3), np.complex64), np.arange(4.0), np.arange(3.0),
                      np.zeros((3, 3), np.float32))
    with pytest.raises(TypeError, match="expects SED"):
        SEDPlotter(ref, '2d_intensity', str(tmp_path / "x.png")).generate_plot()


@pytest.mark.parametrize("kwargs", [{'freq_index': 5}, {'k_index': 0, 'max_freq': 6.0}], ids=str)
def test_1d_slice_forms(tmp_path, kwargs):
    out = tmp_path / "s.png"
    SEDPlotter(make_path_sed(), '1d_slice', str(out), **kwargs).generate_plot()
    assert out.exists() and out.stat().st_size > 5000


def test_incoherent_sed_plots(tmp_path):
    s = make_path_sed()
    inc = SED(np.abs(s.sed[:, :, 0]).astype(np.float32) ** 2, s.freqs, s.k_points, s.k_vectors,
              is_complex=False)
    out = tmp_path / "inc.png"
    SEDPlotter(inc, '2d_intensity', str(out)).generate_plot()
    assert out.exists()


@pytest.mark.parametrize("kwargs", [{'vmin_percentile': 5.0, 'vmax_percentile': 95.0},
                                    {'global_max_intensity_val': 50.0, 'intensity_scale': 'sqrt'},
                                    {'log_intensity': True}], ids=str)
def test_2d_intensity_color_ranges(tmp_path, kwargs):
    out = tmp_path / "pct.png"
    SEDPlotter(make_path_sed(), '2d_intensity', str(out), **kwargs).generate_plot()
    assert out.exists()


def test_apply_known_schemes():
    for scheme in styles.COLOR_SCHEMES:
        styles.apply_style(color_scheme=scheme)
    styles.reset_style()


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="Unknown color scheme"):
        styles.apply_style(color_scheme='nope')


def test_cycle_roundtrip():
    orig = styles.get_color_cycle()
    styles.set_color_cycle(['#112233', '#445566'])
    assert styles.get_color_cycle()[:2] == ['#112233', '#445566']
    styles.set_color_cycle(orig)


def test_colormap_and_params():
    assert styles.get_colormap('viridis') is not None
    assert 'figure.figsize' in styles.get_style_params()
    assert styles.have_matplotlib()


def test_styles_are_the_reference_values():
    from psa_tpu.visualization import styles as ref
    assert styles.DEFAULT_STYLE == ref.DEFAULT_STYLE
    assert styles.COLOR_SCHEMES == ref.COLOR_SCHEMES


# ---------------------------------------------------------------------------
# The iSED figure and average_seds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("direction,stem", [('x', 'iSED_x_0p60_4p00'),
                                            ([1, 0, 0], 'iSED_1.00,0.00,0.00_0p60_4p00')],
                         ids=['named', 'vector'])
def test_ised_writes_its_input_spectrum_figure(tmp_path, direction, stem):
    """``ised(plot_dir_ised=...)`` draws the summed input spectrum under the
    JAX package's file name, and the dump is the JAX package's."""
    traj = make_chain_trajectory(n_cells=12, n_frames=48, dt_ps=0.02, a=2.5, omega_max_thz=6.0)
    ref = psa_tpu.SEDCalculator(traj, 12, 1, 1)
    port = from_reference_calculator(ref, device='cpu')
    kwargs = dict(k_dir_spec=direction, k_target=0.6, w_target=4.0, char_len_k_path=2.5,
                  nk_on_path=12, bz_cov_ised=0.5, n_recon_frames=6, rescale_factor='auto',
                  plot_max_freq=8.0)
    for calc, name in ((ref, 'ref'), (port, 'port')):
        (tmp_path / name).mkdir()
        calc.ised(dump_filepath=str(tmp_path / name / 'motion.dump'),
                  plot_dir_ised=tmp_path / name, **kwargs)
    png = tmp_path / 'port' / f'{stem}.png'
    assert png.exists() and png.stat().st_size > 5000
    assert (tmp_path / 'ref' / f'{stem}.png').exists()

    def coords(path):
        rows = [ln.split() for ln in path.read_text().splitlines()]
        return np.array([r for r in rows if len(r) == 5], dtype=float)
    np.testing.assert_allclose(coords(tmp_path / 'port' / 'motion.dump'),
                               coords(tmp_path / 'ref' / 'motion.dump'), atol=2e-5)


def test_ised_without_plot_dir_draws_nothing(tmp_path):
    traj = make_chain_trajectory(n_cells=12, n_frames=48, dt_ps=0.02, a=2.5, omega_max_thz=6.0)
    port = from_reference_calculator(psa_tpu.SEDCalculator(traj, 12, 1, 1), device='cpu')
    port.ised('x', 0.6, 4.0, 2.5, nk_on_path=12, bz_cov_ised=0.5, n_recon_frames=4,
              dump_filepath=str(tmp_path / 'm.dump'))
    assert [p.name for p in tmp_path.iterdir()] == ['m.dump']


@pytest.mark.parametrize("kwargs", [{}, {'weights': [1.0, 3.0, 2.0]}, {'chiral_pair': (0, 1)},
                                    {'chiral_pair': (2, 0), 'weights': [2.0, 1.0, 1.0]}], ids=str)
def test_average_seds_matches_the_reference(kwargs):
    """Ensemble average and cross-spectrum chiral phase: intensities to 1e-6
    of the maximum, phases to 1e-5 rad (float32 atan2 on both sides)."""
    members = [make_path_sed(seed=s) for s in range(3)]
    ref_members = [psa_tpu.SED(m.sed, m.freqs, m.k_points, m.k_vectors) for m in members]
    got, want = average_seds(members, **kwargs), psa_tpu.average_seds(ref_members, **kwargs)
    assert isinstance(got, SED) and not got.is_complex
    np.testing.assert_allclose(got.sed, want.sed, rtol=0, atol=1e-6 * want.sed.max())
    assert got.trajectory_metadata == {'ensemble_members': 3}
    if 'chiral_pair' in kwargs:
        np.testing.assert_allclose(got.phase, np.asarray(want.phase), atol=1e-5)
        assert np.abs(got.phase).max() <= np.pi / 2 + 1e-6
    else:
        assert got.phase is None


@pytest.mark.parametrize("members,kwargs,match", [
    ([], {}, "at least one"),
    ([0, 1], {'weights': [1.0]}, "weights must be"),
    ([0, 1], {'weights': [-1.0, 1.0]}, "weights must be"),
    ([0, 'short'], {}, "frequency axis differs"),
    ([0, 'incoherent'], {'chiral_pair': (0, 1)}, "complex"),
], ids=['empty', 'weights-shape', 'weights-negative', 'axes-differ', 'chiral-needs-complex'])
def test_average_seds_rejects(members, kwargs, match):
    def member(m):
        if m == 'short':
            return make_path_sed(n_freq=16)
        if m == 'incoherent':
            s = make_path_sed()
            return SED(s.intensity, s.freqs, s.k_points, s.k_vectors, is_complex=False)
        return make_path_sed(seed=m)
    with pytest.raises(ValueError, match=match):
        average_seds([member(m) for m in members], **kwargs)
