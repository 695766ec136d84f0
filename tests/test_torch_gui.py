"""psa_tpu_torch's GUI controller and exports against the JAX package's.

Every case of ``tests/test_gui_controller.py`` runs here on the port's
controller with ``device='cpu'``, on the same dump; wherever the case yields
arrays, the JAX controller runs the same call on its own copy of that dump
and the two are compared:

  * frequencies, k axes and labels exactly;
  * reduced planes, peak surfaces, DSF planes, liquid curves and the DOS to
    ``TOL`` = 1e-5 of the array's maximum (the bar of
    ``tests/test_torch_cli.py`` for the same surfaces);
  * 'float16' display planes to ``TOL_F16`` = 2e-3 of the maximum (the
    sqrt-domain float16 quantization is 2⁻¹⁰ relative per pixel, and the two
    packages may round a pixel to neighbouring float16 values);
  * chiral phases to ``TOL_PHASE`` = 1e-3 rad where the intensity is above
    1e-3 of its maximum (below that the phase of a rounding residue is
    compared, not of a signal);
  * CSV files column by column, and byte for byte when both exporters are
    given the same state;
  * the iSED dump's positions to 1e-5 Å.

The view (``psa_tpu_torch.gui.app``) gets the three static audits of
``TestViewCallbackWiring``.  Two threads on one controller queue on its lock.
"""
import inspect
import re
import sys
import threading

import numpy as np
import pandas as pd
import pytest
import torch

from psa_tpu.gui import controller as jax_controller
from psa_tpu.gui import export as jax_export
from psa_tpu.models import make_chain_trajectory
from psa_tpu_torch.gui import export
from psa_tpu_torch.gui.controller import (CHIRAL_AXIS_COMPONENTS, AnalysisController, DSFState,
                                          KGridPeaksState, KGridState, LiquidState, apply_scale,
                                          parse_direction_input)

torch.set_num_threads(1)

TOL = 1e-5
TOL_F16 = 2e-3
TOL_PHASE = 1e-3
BRIGHT = 1e-3
TOL_DUMP = 1e-5


def write_chain_dump(path):
    traj = make_chain_trajectory(n_cells=12, n_frames=64, dt_ps=0.02, a=2.5, omega_max_thz=6.0)
    with open(path, "w") as f:
        for t in range(traj.n_frames):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{traj.n_atoms}\n")
            f.write("ITEM: BOX BOUNDS pp pp pp\n")
            for d in range(3):
                f.write(f"0.0 {traj.box_matrix[d, d]:.6f}\n")
            f.write("ITEM: ATOMS id type x y z vx vy vz\n")
            for a_ in range(traj.n_atoms):
                p, v = traj.positions[t, a_], traj.velocities[t, a_]
                f.write(f"{a_+1} 1 {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                        f"{v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")


def write_npt_dump(path, n_at=12, n_fr=48, a0=2.5):
    """The breathing-cell chain of ``TestNPTKPath.npt_loaded``."""
    L0 = n_at * a0
    rng = np.random.default_rng(11)
    lam = 1.0 + 0.03 * np.sin(np.linspace(0, 2 * np.pi, n_fr))
    x_frac = (np.arange(n_at) + 0.5) / n_at
    tt = np.arange(n_fr) * 0.02
    ph = 2 * np.pi * (4 * x_frac[None, :] - 3.0 * tt[:, None])
    s = x_frac[None, :] + (0.02 / L0) * np.sin(ph)
    pos_x = (lam[:, None] * L0) * s
    vel_x = (lam[:, None] * 0.02 * (-6 * np.pi) * np.cos(ph) + rng.normal(0, 0.05, (n_fr, n_at)))
    with open(path, "w") as f:
        for t in range(n_fr):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{n_at}\n")
            f.write("ITEM: BOX BOUNDS pp pp pp\n")
            f.write(f"0.0 {lam[t] * L0:.8f}\n0.0 10.0\n0.0 10.0\n")
            f.write("ITEM: ATOMS id type x y z vx vy vz\n")
            for a_ in range(n_at):
                f.write(f"{a_ + 1} 1 {pos_x[t, a_]:.8f} 1.0 1.0 {vel_x[t, a_]:.8f} 0.0 0.0\n")


class Pair:
    """The port's controller and the JAX package's, each loaded from its own
    copy of one dump."""

    def __init__(self, dumps, nx):
        self.dumps = dumps
        self.port = AnalysisController(device='cpu')
        self.jax = jax_controller.AnalysisController()
        for ctrl, dump in zip((self.port, self.jax), dumps):
            ctrl.load_trajectory(str(dump), dt=0.02, file_format='lammps', nx=nx, ny=1, nz=1)

    def both(self, method, *args, **kwargs):
        """(port result, JAX result) of one controller call."""
        return tuple(getattr(c, method)(*args, **kwargs) for c in (self.port, self.jax))


def _dumps(tmp_path_factory, name, write):
    out = []
    for side in ('port', 'jax'):
        path = tmp_path_factory.mktemp(f'{name}_{side}') / f'{name}.dump'
        write(path)
        out.append(path)
    return out


@pytest.fixture(scope='module')
def chain_dumps(tmp_path_factory):
    return _dumps(tmp_path_factory, 'chain', write_chain_dump)


@pytest.fixture(scope='module')
def npt_dumps(tmp_path_factory):
    return _dumps(tmp_path_factory, 'npt_chain', write_npt_dump)


@pytest.fixture
def pair(chain_dumps):
    return Pair(chain_dumps, nx=12)


@pytest.fixture
def loaded(pair):
    return pair.port


@pytest.fixture
def npt_pair(npt_dumps):
    both = Pair(npt_dumps, nx=12)
    assert both.port.trajectory.box_matrices is not None
    return both


@pytest.fixture
def npt_loaded(npt_pair):
    return npt_pair.port


def close(got, want, what, tol=TOL, scale=None):
    """|got − want| ≤ tol · max|want| (or · ``scale``), shapes equal."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{what}: {got.shape} vs {want.shape}"
    if want.size == 0:
        return
    scale = scale or float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


def same(got, want, what):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=what)


def float32_rows(freqs):
    """The JAX package's NPT browse hands its kept frequencies back in
    float64 (``np.fft.fftfreq``'s), its other surfaces and the port in
    float32: the same numbers once rounded to float32."""
    return np.asarray(freqs).astype(np.float32)


def phases_close(got, want, intensity, what):
    """Phases agree where the spectrum is bright (mod π: the range is ±π/2)."""
    bright = np.asarray(intensity) >= BRIGHT * np.max(intensity)
    diff = np.abs(np.asarray(got) - np.asarray(want))[bright]
    diff = np.minimum(diff, np.pi - diff)
    assert diff.max() <= TOL_PHASE, f"{what}: {diff.max()}"


def seds_close(got, want, what, tol=TOL):
    """Two display SEDs (reduced planes or complex spectra) agree."""
    same(got.freqs, want.freqs, f"{what} freqs")
    same(got.k_points, want.k_points, f"{what} k_points")
    same(got.k_vectors, want.k_vectors, f"{what} k_vectors")
    assert got.is_complex == want.is_complex
    close(got.sed, want.sed, f"{what} sed", tol)
    assert (got.phase is None) == (want.phase is None)
    if got.phase is not None:
        inten = np.asarray(want.intensity if want.is_complex else want.sed)
        phases_close(got.phase, want.phase, inten, f"{what} phase")


def kgrids_close(got, want, what, tol=TOL):
    assert got.plane == want.plane and got.labels == want.labels
    assert tuple(got.sed.k_grid_shape) == tuple(want.sed.k_grid_shape)
    same(got.freqs, float32_rows(want.freqs), f"{what} freqs")
    for name in ('k1_axis', 'k2_axis'):
        same(getattr(got, name), getattr(want, name), f"{what} {name}")
    close(got.intensity, want.intensity, f"{what} intensity", tol)
    assert (got.phase is None) == (want.phase is None)
    if got.phase is not None:
        phases_close(got.phase, want.phase, want.intensity, f"{what} phase")


def peaks_close(got, want, what):
    """Peak surfaces agree: frequencies exactly (they are bin centres),
    heights and widths to TOL of the surface's maximum."""
    assert got.plane == want.plane and got.labels == want.labels
    assert got.width_method == want.width_method
    same(got.k1_axis, want.k1_axis, f"{what} k1")
    same(got.k2_axis, want.k2_axis, f"{what} k2")
    close(got.freq_surfaces, want.freq_surfaces, f"{what} freq", 1e-6)
    close(got.intensity_surfaces, want.intensity_surfaces, f"{what} intensity")
    close(got.linewidth_surfaces, want.linewidth_surfaces, f"{what} linewidth",
          scale=float(np.max(np.abs(want.freq_surfaces))) or 1.0)
    assert (got.phase_surfaces is None) == (want.phase_surfaces is None)


# -- pure helpers ---------------------------------------------------------------

class TestParseDirectionInput:
    @pytest.mark.parametrize("text,expected", [
        ("[1,0,0]", [1, 0, 0]),
        ("(0, 1, 0)", (0, 1, 0)),
        ("45.0", 45.0),
        ("x", "x"),
        ("110", 110),                       # literal int -> angle semantics
        ("{'h': 1, 'k': 1, 'l': 0}", {'h': 1, 'k': 1, 'l': 0}),
    ])
    def test_forms(self, text, expected):
        assert parse_direction_input(text) == expected
        assert jax_controller.parse_direction_input(text) == expected

    def test_empty_raises(self):
        with pytest.raises(ValueError):
            parse_direction_input("  ")


def test_chiral_axis_component_pairs():
    assert CHIRAL_AXIS_COMPONENTS == {'x': (1, 2), 'y': (0, 2), 'z': (0, 1)}
    assert CHIRAL_AXIS_COMPONENTS == jax_controller.CHIRAL_AXIS_COMPONENTS


def test_apply_scale_modes():
    x = np.array([0.0, 1.0, 100.0])
    np.testing.assert_allclose(apply_scale(x, 'linear'), x)
    np.testing.assert_allclose(apply_scale(x, 'sqrt'), np.sqrt(x))
    np.testing.assert_allclose(apply_scale(x, 'dsqrt'), np.sqrt(np.sqrt(x)))
    assert apply_scale(x, 'log')[0] == np.log10(1e-12)
    for scale in ('linear', 'log', 'sqrt', 'dsqrt', None):
        same(apply_scale(x, scale), jax_controller.apply_scale(x, scale), str(scale))


def test_public_names_and_signatures_match_the_jax_modules():
    """Every public name of the JAX controller and export modules is in the
    port with the same parameters (the controller's ``__init__`` gains
    ``device``)."""
    import psa_tpu_torch.gui.controller as port_controller
    for port_mod, jax_mod in ((port_controller, jax_controller), (export, jax_export)):
        for name, obj in vars(jax_mod).items():
            if name.startswith('_') or getattr(obj, '__module__', None) != jax_mod.__name__:
                continue
            twin = getattr(port_mod, name)
            if inspect.isfunction(obj):
                assert list(inspect.signature(twin).parameters) == \
                    list(inspect.signature(obj).parameters), name
    for name, fn in inspect.getmembers(jax_controller.AnalysisController, inspect.isfunction):
        if name.startswith('_') and name != '__init__':
            continue
        got = list(inspect.signature(getattr(AnalysisController, name)).parameters)
        want = list(inspect.signature(fn).parameters)
        assert got == want + (['device'] if name == '__init__' else []), name
    for cls in (KGridState, KGridPeaksState, DSFState, LiquidState):
        twin = getattr(jax_controller, cls.__name__)
        assert list(cls.__dataclass_fields__) == list(twin.__dataclass_fields__)


def test_default_device_is_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AnalysisController()
    from psa_tpu_torch.gui import app
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        app.main([])                      # before any window is opened
    assert app.build_parser().parse_args([]).device == 'cuda'


def test_cache_detection(pair):
    for ctrl, dump in zip((pair.port, pair.jax), pair.dumps):
        assert ctrl.has_cache(str(dump))                       # load wrote the cache
        assert not ctrl.has_cache(str(dump.with_name("other.dump")))
    assert str(pair.port.calculator.device) == 'cpu'
    # the sidecars both loaders wrote hold the same arrays
    for part in ('positions', 'velocities', 'types', 'box_matrix'):
        a, b = (np.load(d.parent / f'{d.stem}.{part}.npy') for d in pair.dumps)
        same(a, b, part)


# -- k-path ----------------------------------------------------------------------

class TestKPathFlow:
    def test_compute_and_click(self, pair):
        loaded = pair.port
        sed, want = pair.both('compute_kpath_sed', "x", n_k=16, bz_coverage=0.5)
        assert not sed.is_complex         # device-reduced intensity planes
        seds_close(sed, want, "reduced k-path")
        (k, f, c), (k2, f2, c2) = pair.both('kpath_plot_arrays', scale='dsqrt', max_freq=8.0)
        assert c.shape == (len(f), len(k))
        assert np.all(f >= 0) and np.all(f <= 8.0)
        same(k, k2, "k")
        same(f, f2, "f")
        close(c, c2, "dsqrt plane", 1e-4)      # ⁴√ of a 1e-5 pixel error near zero
        (ksel, wsel), picked = pair.both('select_nearest', 0.62, 5.1)
        assert abs(ksel - 0.62) < np.diff(k)[0]
        assert loaded.selected_point == (ksel, wsel) == picked

    def test_chiral_forces_coherent(self, pair):
        sed, want = pair.both('compute_kpath_sed', "x", n_k=8, bz_coverage=0.5,
                              summation_mode='incoherent', chiral=True, chiral_axis='z')
        assert sed.phase is not None      # forced coherent -> phase computed
        assert sed.phase.shape == sed.sed.shape  # same filtered planes
        seds_close(sed, want, "chiral reduced")
        full, want = pair.both('compute_kpath_sed', "x", n_k=8, bz_coverage=0.5,
                               summation_mode='incoherent', chiral=True, chiral_axis='z',
                               reduced=False)
        assert full.is_complex            # full path keeps complex amplitudes
        assert full.phase.shape == full.sed.shape[:2]
        seds_close(full, want, "chiral full")

    def test_reduced_kpath_matches_full(self, loaded):
        """The device-reduced k-path display shows the same intensity and
        phase planes as the full complex flow (exact float32 by default)."""
        loaded.compute_kpath_sed("x", n_k=12, bz_coverage=0.5, chiral=True)
        k1, f1, c1 = loaded.kpath_plot_arrays(scale='linear')
        _, fp1, p1 = loaded.kpath_plot_arrays(show_phase=True)
        loaded.compute_kpath_sed("x", n_k=12, bz_coverage=0.5, chiral=True, reduced=False)
        k2, f2, c2 = loaded.kpath_plot_arrays(scale='linear')
        _, fp2, p2 = loaded.kpath_plot_arrays(show_phase=True)
        np.testing.assert_allclose(f1, f2, atol=0)
        np.testing.assert_allclose(c1, c2, rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(p1, p2, atol=1e-5)

    def test_f16_display_optin(self, pair):
        """Opting into the f16 readback keeps every display pixel within
        the sqrt-domain bound: ≤ ~2⁻¹⁰ RELATIVE error for pixels ≥ 4e-9 of
        the plane max — so log/dsqrt backgrounds don't posterize."""
        loaded = pair.port
        exact = loaded.compute_kpath_sed("x", n_k=12, bz_coverage=0.5).sed
        for ctrl in (pair.port, pair.jax):
            ctrl.readback_dtype = 'float16'
        quant, want = (s.sed for s in pair.both('compute_kpath_sed', "x", n_k=12,
                                                bz_coverage=0.5))
        floor = 4e-9 * exact.max()
        bright = exact >= floor
        rel = np.abs(quant[bright] - exact[bright]) / exact[bright]
        assert rel.max() <= 2.0 ** -9        # one ulp slack over 2^-10
        assert np.abs(quant[~bright] - exact[~bright]).max() <= floor
        close(quant, want, "float16 display plane", TOL_F16)

    def test_readback_dtype_follows_the_environment(self, monkeypatch):
        monkeypatch.setenv('PSA_DISPLAY_READBACK', 'float16')
        assert AnalysisController(device='cpu').readback_dtype == 'float16'
        monkeypatch.delenv('PSA_DISPLAY_READBACK')
        assert AnalysisController(device='cpu').readback_dtype == 'float32'

    def test_phase_plot_arrays(self, loaded):
        loaded.compute_kpath_sed("x", n_k=8, bz_coverage=0.5, chiral=True)
        _, f, c = loaded.kpath_plot_arrays(show_phase=True)
        assert np.all(np.abs(c) <= np.pi / 2 + 1e-6)


def test_full_kpath_sed_for_export(pair):
    """.npy export keeps the historical complex layout: the reduced display
    path recomputes the full spectrum on demand."""
    loaded = pair.port
    sed, _ = pair.both('compute_kpath_sed', "x", n_k=10, bz_coverage=0.5, chiral=True)
    assert not sed.is_complex
    full, want = pair.both('full_kpath_sed')
    assert full.is_complex and full.sed.shape == (64, 10, 3)
    assert full.phase is not None
    seds_close(full, want, "full k-path")
    assert loaded.sed_result is sed          # display state untouched
    mask = full.freqs >= 0
    np.testing.assert_allclose(sed.sed, full.intensity[mask], rtol=1e-5, atol=1e-8)
    sed2 = loaded.compute_kpath_sed("x", n_k=10, bz_coverage=0.5, reduced=False)
    assert loaded.full_kpath_sed() is sed2   # non-reduced flow passes through


class TestWelchKPath:
    def test_welch_kpath_and_full_export_recompute(self, pair):
        sed, want = pair.both('compute_kpath_sed', '[1,0,0]', n_k=6, bz_coverage=0.5,
                              welch_segments=4)
        assert not sed.is_complex
        assert sed.sed.shape[0] == 64 // 4
        seds_close(sed, want, "welch k-path")
        full = pair.port.full_kpath_sed()    # the complex spectrum is recomputed
        assert full.is_complex
        assert full.sed.shape[0] == 64

    def test_welch_chiral_rejected(self, loaded):
        with pytest.raises(ValueError, match="Welch"):
            loaded.compute_kpath_sed('[1,0,0]', n_k=6, bz_coverage=0.5,
                                     welch_segments=4, chiral=True)


class TestLTKPath:
    def test_lt_planes_sum_to_total(self, pair):
        loaded = pair.port
        tot = loaded.compute_kpath_sed('x', n_k=6, bz_coverage=0.5)
        il, want_l = pair.both('compute_kpath_sed', 'x', n_k=6, bz_coverage=0.5,
                               polarization='longitudinal')
        it, want_t = pair.both('compute_kpath_sed', 'x', n_k=6, bz_coverage=0.5,
                               polarization='transverse')
        assert not il.is_complex and not it.is_complex
        np.testing.assert_allclose(il.sed + it.sed, tot.sed, rtol=1e-4, atol=1e-7)
        # the chain moves along x only: k ∥ x puts everything in I_L
        assert il.sed.sum() > 1e6 * max(it.sed.sum(), 1e-30)
        seds_close(il, want_l, "longitudinal")
        # I_T is the rounding residue of total − I_L here: hold it to the total's scale
        close(it.sed, want_t.sed, "transverse", scale=float(tot.sed.max()))
        assert loaded.full_kpath_sed().is_complex

    def test_lt_rejects_chiral_welch_and_bad_value(self, loaded):
        with pytest.raises(ValueError, match="Chiral"):
            loaded.compute_kpath_sed('x', n_k=6, bz_coverage=0.5,
                                     polarization='longitudinal', chiral=True)
        with pytest.raises(ValueError, match="Welch"):
            loaded.compute_kpath_sed('x', n_k=6, bz_coverage=0.5,
                                     polarization='transverse', welch_segments=4)
        with pytest.raises(ValueError, match="polarization"):
            loaded.compute_kpath_sed('x', n_k=6, bz_coverage=0.5, polarization='LA')


# -- k-grid ----------------------------------------------------------------------

class TestKGridFlow:
    def test_grid_state(self, pair):
        kg, want = pair.both('compute_kgrid_sed', 'xy', (-1, 1), (-1, 1), 6, 5, max_freq=10.0)
        assert kg.sed.k_grid_shape == (6, 5)
        assert kg.intensity.shape == (len(kg.freqs), 30)
        assert np.all(kg.freqs >= 0) and np.all(kg.freqs <= 10.0)
        s = kg.slice_at(0)
        assert s.shape == (5, 6)          # transposed for pcolormesh
        vmin, vmax = kg.global_vrange(scale='sqrt')
        assert vmax >= vmin
        assert kg.global_vrange(scale='sqrt') == (vmin, vmax)     # cached
        kgrids_close(kg, want, "browse grid")
        close(kg.slice_at(3), want.slice_at(3), "slice", scale=float(want.intensity.max()))

    @pytest.mark.parametrize("engine", ['direct', 'gridded'])
    def test_grid_engines(self, pair, engine):
        """Both engines through the controller, against the JAX controller's
        same engine and (the gridded one) against the direct planes."""
        kg, want = pair.both('compute_kgrid_sed', 'xy', (-1, 1), (-1, 1), 6, 6, max_freq=10.0,
                             engine=engine)
        kgrids_close(kg, want, f"{engine} browse grid")
        direct = pair.port.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 6, 6, max_freq=10.0)
        close(kg.intensity, direct.intensity, f"{engine} vs direct")
        pk, want = pair.both('compute_kgrid_peaks', 'xy', (-1, 1), (-1, 1), 6, 6, max_freq=10.0,
                             engine=engine)
        peaks_close(pk, want, f"{engine} peaks")

    def test_peaks_state(self, pair):
        pk, want = pair.both('compute_kgrid_peaks', 'xy', (-1, 1), (-1, 1), 6, 5,
                             n_peaks=2, max_freq=10.0)
        assert pk.freq_surfaces.shape == (2, 6, 5)
        assert pk.intensity_surfaces.shape == (2, 6, 5)
        assert pk.linewidth_surfaces.shape == (2, 6, 5)
        assert pk.surface(0, 'freq').shape == (5, 6)   # plot orientation
        assert np.all(pk.freq_surfaces >= 0)
        assert np.all(pk.freq_surfaces <= 10.0 + 1e-6)
        assert pk.labels == ('k_x', 'k_y')
        # rank order: top peak carries at least rank-2's intensity
        assert np.all(pk.intensity_surfaces[0] >= pk.intensity_surfaces[1])
        peaks_close(pk, want, "peaks")

    @pytest.mark.parametrize("width_method", ['rms', 'lorentzian'])
    def test_peaks_width_methods(self, pair, width_method):
        pk, want = pair.both('compute_kgrid_peaks', 'xy', (-1, 1), (-1, 1), 5, 4,
                             max_freq=10.0, width_method=width_method)
        assert pk.width_method == width_method
        peaks_close(pk, want, f"peaks {width_method}")

    def test_last_grid_kind_tracks_most_recent(self, loaded):
        """CSV export follows the most recently computed grid result."""
        assert loaded.last_grid_kind is None
        loaded.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 5, 5)
        assert loaded.last_grid_kind == 'browse'
        loaded.compute_kgrid_peaks('xy', (-1, 1), (-1, 1), 5, 5)
        assert loaded.last_grid_kind == 'peaks'
        loaded.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 5, 5)
        assert loaded.last_grid_kind == 'browse'

    def test_grid_lt_polarization(self, pair):
        """L/T split on the grid: a longitudinal chain (motion ∥ x) puts
        everything in I_L along k̂=x̂ columns; L+T = total browse intensity."""
        loaded = pair.port
        total = loaded.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 5, 4, max_freq=10.0)
        ti = total.intensity.copy()
        lg, want_l = pair.both('compute_kgrid_sed', 'xy', (-1, 1), (-1, 1), 5, 4,
                               max_freq=10.0, polarization='longitudinal')
        assert loaded.last_grid_kind == 'browse'
        il = lg.intensity.copy()
        tr, want_t = pair.both('compute_kgrid_sed', 'xy', (-1, 1), (-1, 1), 5, 4,
                               max_freq=10.0, polarization='transverse')
        it = tr.intensity.copy()
        assert il.shape == ti.shape == it.shape
        np.testing.assert_allclose(il + it, ti, atol=1e-5 * ti.max())
        # pure-x motion: on the k_y axis (k ⟂ motion) everything transverse
        # (grid is comp1-outer row-major: flat index = i1 * n_k2 + i2)
        kv = lg.sed.k_vectors.reshape(5, 4, 3)
        i1 = int(np.flatnonzero(np.abs(kv[:, 0, 0]) < 1e-9)[0])  # kx == 0 row
        col = i1 * 4 + np.arange(4)            # ky ∈ {-1,-1/3,1/3,1}, no Γ
        assert il[:, col].max() <= 1e-6 * ti.max()
        close(il, want_l.intensity, "grid I_L", scale=float(ti.max()))
        close(it, want_t.intensity, "grid I_T", scale=float(ti.max()))

    def test_grid_lt_rejects_bad_combos(self, loaded):
        with pytest.raises(ValueError, match="chiral"):
            loaded.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 4, 4,
                                     chiral=True, polarization='transverse')
        with pytest.raises(ValueError, match="direct engine"):
            loaded.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 4, 4,
                                     engine='gridded', polarization='longitudinal')
        with pytest.raises(ValueError, match="reduced"):
            loaded.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 4, 4,
                                     reduced=False, polarization='transverse')

    def test_dos(self, pair):
        (freqs, dos), (f2, d2) = pair.both('compute_dos', max_freq=10.0)
        assert dos.shape == (1, len(freqs))
        assert np.all(freqs >= 0) and np.all(freqs <= 10.0)
        assert np.all(dos >= 0) and dos.max() > 0
        same(freqs, f2, "DOS freqs")
        close(dos, d2, "DOS")
        # all atoms are type 1 in this fixture: the type-1 partial IS the total
        _, per_type = pair.port.compute_dos(basis_atom_types=[1], max_freq=10.0)
        np.testing.assert_allclose(per_type, dos, rtol=1e-5)

    def test_liquid_curves(self, loaded):
        """The Liquid button's curve observables come back plottable and
        physically sane on the chain fixture."""
        x, sk, xl, yl = loaded.compute_liquid_curve(
            'sk', direction_text='x', n_k=8, bz_coverage=0.5)
        assert sk.shape == (1, len(x)) and '2π' in xl and yl == 'S(k)'
        assert np.all(sk >= 0)
        r, g, xl, _ = loaded.compute_liquid_curve('rdf')
        assert g.shape == (1, len(r)) and xl.startswith('r')
        # chain with a = 2.5: no pairs below the nearest-neighbor distance
        assert g[0][r < 2.0].max() == 0.0 and g[0].max() > 0
        lags, msd, _, _ = loaded.compute_liquid_curve('msd')
        assert msd.shape == (1, len(lags)) and lags[0] == 0.0
        lags, vacf, _, _ = loaded.compute_liquid_curve('vacf')
        # VACF(0) = <|v|^2> is the maximum for a stationary signal
        assert vacf[0, 0] > 0
        assert vacf[0, 0] >= np.abs(vacf[0, 1:]).max() - 1e-6
        # state tracks the most recent compute for CSV export
        assert loaded.last_compute == 'liquid'
        assert loaded.liquid.kind == 'vacf'
        assert loaded.liquid.curve_labels == ('total',)
        # F_s decay curves: one per sampled k, starting at 1
        lags, fs, _, yl = loaded.compute_liquid_curve(
            'isf_self', direction_text='x', n_k=8, bz_coverage=0.5)
        assert yl == 'F_s(k,τ)' and fs.shape[1] == len(lags)
        np.testing.assert_allclose(fs[:, 0], 1.0, rtol=1e-5)
        assert all(lab.startswith('k = ') for lab in loaded.liquid.curve_labels)
        with pytest.raises(ValueError):
            loaded.compute_liquid_curve('nope')

    @pytest.mark.parametrize("kind", ['sk', 'rdf', 'msd', 'vacf', 'isf_self'])
    def test_liquid_curve_matches_jax(self, pair, kind):
        kwargs = dict(direction_text='x', n_k=8, bz_coverage=0.5)
        (x, curves, xl, yl), (x2, c2, xl2, yl2) = pair.both('compute_liquid_curve', kind,
                                                            **kwargs)
        assert (xl, yl) == (xl2, yl2)
        close(x, x2, f"{kind} x", 1e-6)
        # S(k) off the Bragg points is a float32 residue of an O(N) sum: hold
        # every curve to its own maximum
        close(curves, c2, f"{kind} curves")
        for field in ('kind', 'labels', 'curve_labels'):
            assert getattr(pair.port.liquid, field) == getattr(pair.jax.liquid, field)

    def test_liquid_csv_export(self, loaded, tmp_path):
        loaded.compute_liquid_curve('rdf')
        out = export.export_liquid_csv(loaded.liquid, tmp_path / "liq.csv")
        lines = out.read_text().splitlines()
        assert lines[0].startswith("# observable=rdf")
        assert lines[1] == "r,total"
        data = np.loadtxt(out, delimiter=',', skiprows=2)
        assert data.shape == (len(loaded.liquid.x), 2)
        np.testing.assert_allclose(data[:, 1], loaded.liquid.curves[0], rtol=1e-6)

    def test_grid_chiral_phase_same_mask(self, pair):
        """Phase must be filtered with the same freq mask as intensity
        (the reference's off-by-mask bug, psa_gui.py:2382)."""
        kg, want = pair.both('compute_kgrid_sed', 'xy', (-1, 1), (-1, 1), 4, 4,
                             max_freq=6.0, chiral=True)
        assert kg.phase is not None
        assert kg.phase.shape == kg.intensity.shape
        kgrids_close(kg, want, "chiral grid")


class TestReducedKGrid:
    """The controller's default (reduced) k-grid path must produce the same
    browse state as the full-transfer path."""

    def test_reduced_equals_full(self, pair):
        ctrl = pair.port
        kg_red = ctrl.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 5, 4, max_freq=15.0,
                                        chiral=True, engine='direct', reduced=True)
        red = (kg_red.freqs.copy(), kg_red.intensity.copy(), kg_red.phase.copy())
        kg_full, want = pair.both('compute_kgrid_sed', 'xy', (-1, 1), (-1, 1), 5, 4,
                                  max_freq=15.0, chiral=True, engine='direct', reduced=False)
        np.testing.assert_allclose(red[0], kg_full.freqs)
        np.testing.assert_allclose(red[1], kg_full.intensity, rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(red[2], kg_full.phase, rtol=0, atol=1e-5)
        assert not kg_red.sed.is_complex      # complex Phi never fetched
        assert kg_red.slice_at(0).shape == (4, 5)
        lo, hi = kg_red.global_vrange()
        assert lo <= hi
        kgrids_close(kg_full, want, "full-transfer grid")
        assert kg_full.sed.is_complex and want.sed.is_complex
        close(kg_full.sed.sed, want.sed.sed, "full-transfer complex spectrum")

    def test_gridded_full_transfer(self, pair):
        kg, want = pair.both('compute_kgrid_sed', 'xy', (-1, 1), (-1, 1), 6, 6, max_freq=15.0,
                             engine='gridded', reduced=False)
        assert kg.sed.is_complex
        kgrids_close(kg, want, "gridded full-transfer grid")


def test_incoherent_kgrid_full_path_intensity(pair):
    """Non-reduced incoherent grids must pass through .sed (already an
    intensity), not re-square it through .intensity."""
    kg, want = pair.both('compute_kgrid_sed', 'xy', (-1, 1), (-1, 1), 4, 3,
                         basis_atom_types=[1], summation_mode='incoherent',
                         engine='direct', reduced=False)
    assert kg.intensity.ndim == 2 and kg.intensity.shape[1] == 12
    assert kg.slice_at(0).shape == (3, 4)
    kgrids_close(kg, want, "incoherent grid")


def test_peaks_chiral_phase_surface(pair):
    pk, want = pair.both('compute_kgrid_peaks', 'xy', (-1, 1), (-1, 1), 4, 4,
                         chiral=True, chiral_axis='x')
    assert pk.phase_surfaces is not None
    assert pk.phase_surfaces.shape == (1, 4, 4)
    assert pk.surface(0, 'phase').shape == (4, 4)
    assert np.all(np.abs(pk.phase_surfaces) <= np.pi / 2 + 1e-6)
    peaks_close(pk, want, "chiral peaks")
    pk2 = pair.port.compute_kgrid_peaks('xy', (-1, 1), (-1, 1), 4, 4)
    assert pk2.phase_surfaces is None
    with pytest.raises(ValueError, match="phase"):
        pk2.surface(0, 'phase')


# -- iSED ------------------------------------------------------------------------

class TestISEDFlow:
    def test_requires_selection(self, loaded):
        loaded.compute_kpath_sed("x", n_k=8, bz_coverage=0.5)
        with pytest.raises(RuntimeError, match="Select"):
            loaded.reconstruct_ised("x", char_len=2.5, n_frames=4)

    def test_full_flow(self, pair, tmp_path):
        pair.both('compute_kpath_sed', "x", n_k=16, bz_coverage=0.5)
        assert len(set(pair.both('select_nearest', 0.6, 4.0))) == 1
        dumps = [c.reconstruct_ised("x", char_len=2.5, n_k=12, bz_coverage=0.5, n_frames=5,
                                    out_dir=tmp_path / name)
                 for c, name in ((pair.port, "ised"), (pair.jax, "ised_jax"))]
        assert all(d.exists() for d in dumps)
        (pos, types, box), (pos2, types2, box2) = pair.both('load_ised_motion')
        assert pos.shape == (5, 12, 3)
        same(types, types2, "iSED types")
        same(box, box2, "iSED box")
        np.testing.assert_allclose(pos, pos2, rtol=0, atol=TOL_DUMP)
        pair.port.cleanup()

    def test_temporary_directory_lives_until_cleanup(self, loaded):
        loaded.compute_kpath_sed("x", n_k=16, bz_coverage=0.5)
        loaded.select_nearest(0.6, 4.0)
        dump = loaded.reconstruct_ised("x", char_len=2.5, n_k=12, bz_coverage=0.5, n_frames=3)
        assert dump.exists() and len(loaded.temp_dirs) == 1
        loaded.cleanup()
        assert not dump.parent.exists() and loaded.temp_dirs == []


# -- exports ---------------------------------------------------------------------

def frames_equal(got_path, want_path, skiprows=0):
    """Two CSV files hold the same header and, column by column, the same
    values (read with pandas)."""
    got, want = (pd.read_csv(p, skiprows=skiprows, float_precision='round_trip') for p in (got_path, want_path))
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        same(got[col].to_numpy(), want[col].to_numpy(), col)


def frames_close(got_path, want_path, skiprows=0, tol=TOL):
    """Two packages' CSV files: same header and rows; each column within
    ``tol`` of the largest value of its kind (all intensity-like columns
    share the file's largest)."""
    got, want = (pd.read_csv(p, skiprows=skiprows, float_precision='round_trip') for p in (got_path, want_path))
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    axes = [c for c in want.columns
            if c in ('frequency_THz', 'peak_rank', 'k_x', 'k_y', 'k', 'r', 'τ')]
    values = [c for c in want.columns if c not in axes and not c.startswith('phase')]
    scale = float(np.max(np.abs(want[values].to_numpy())))
    for col in axes:
        close(got[col], want[col], col, 1e-6)
    for col in values:
        close(got[col], want[col], col, tol, scale=scale)


def _states(ctrl):
    """One state per CSV writer, computed on ``ctrl``."""
    sed = ctrl.compute_kpath_sed("x", n_k=8, bz_coverage=0.5, chiral=True)
    kgrid = ctrl.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 4, 4, max_freq=8.0, chiral=True)
    peaks = ctrl.compute_kgrid_peaks('xy', (-1, 1), (-1, 1), 4, 4, n_peaks=2,
                                     width_method='lorentzian')
    ctrl.compute_kpath_dsf('x', n_k=12, bz_coverage=0.5, observable='longitudinal')
    ctrl.compute_liquid_curve('isf_self', direction_text='x', n_k=8, bz_coverage=0.5)
    return {'kpath': (sed, 0), 'kgrid': (kgrid, 0), 'peaks': (peaks, 0),
            'dsf': (ctrl.dsf, 1), 'liquid': (ctrl.liquid, 1)}


@pytest.fixture(scope='module')
def csv_states(chain_dumps):
    both = Pair(chain_dumps, nx=12)
    return _states(both.port), _states(both.jax)


class TestExports:
    @pytest.mark.parametrize("writer", ['kpath', 'kgrid', 'peaks', 'dsf', 'liquid'])
    def test_csv_equals_the_jax_writer_byte_for_byte(self, csv_states, writer, tmp_path):
        """One state through both packages' writers: the same bytes (header,
        columns, order, the text of every number), and every column reads
        back to the state's array exactly."""
        state, skip = csv_states[0][writer]
        got = getattr(export, f'export_{writer}_csv')(state, tmp_path / 'port' / 'out.csv')
        want = getattr(jax_export, f'export_{writer}_csv')(state, tmp_path / 'jax' / 'out.csv')
        assert got.read_bytes() == want.read_bytes()
        frames_equal(got, want, skip)
        df = pd.read_csv(got, skiprows=skip, float_precision='round_trip')
        if writer == 'kpath':
            mask = state.freqs >= 0
            same(df['frequency_THz'].to_numpy(np.float32), state.freqs[mask], "freqs")
            same(df.iloc[:, 1:9].to_numpy(np.float32), state.sed[mask], "planes")
            same(df.iloc[:, 9:].to_numpy(np.float32), state.phase[mask], "phases")
        elif writer == 'kgrid':
            same(df['intensity'].to_numpy(np.float32), state.intensity.ravel(), "intensity")
            same(df['phase'].to_numpy(np.float32), state.phase.ravel(), "phase")
            same(df['frequency_THz'].to_numpy(np.float32), np.repeat(state.freqs, 16), "freqs")
        elif writer == 'peaks':
            same(df['frequency_THz'].to_numpy(np.float32), state.freq_surfaces.ravel(), "freq")
            same(df['linewidth_THz_fwhm'].to_numpy(np.float32),
                 state.linewidth_surfaces.ravel(), "fwhm")
            same(df['peak_rank'].to_numpy(), np.repeat([0, 1], 16), "rank")
        elif writer == 'dsf':
            same(df.iloc[:, 1:].to_numpy(np.float32), state.plane, "plane")
        else:
            same(df.iloc[:, 1:].to_numpy(np.float32), state.curves.T, "curves")

    @pytest.mark.parametrize("writer", ['kpath', 'kgrid', 'peaks', 'dsf', 'liquid'])
    def test_csv_of_each_package_agrees_column_by_column(self, csv_states, writer, tmp_path):
        """The port's file of the port's state against the JAX package's
        file of its own state."""
        (state, skip), (jax_state, _) = csv_states[0][writer], csv_states[1][writer]
        got = getattr(export, f'export_{writer}_csv')(state, tmp_path / 'port.csv')
        want = getattr(jax_export, f'export_{writer}_csv')(jax_state, tmp_path / 'jax.csv')
        assert got.read_text().splitlines()[:skip + 1] == want.read_text().splitlines()[:skip + 1]
        frames_close(got, want, skip)

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_csv_numbers_read_back_exactly(self, dtype, tmp_path):
        """Floats of every magnitude, zero, negative zero and infinities are
        written as the shortest text that reads back to the same value, as
        pandas writes them; NaN as an empty field."""
        rng = np.random.default_rng(3)
        vals = (rng.standard_normal(4000) * 10.0 ** rng.integers(-30, 30, 4000)).astype(dtype)
        vals[:8] = [0.0, -0.0, np.inf, -np.inf, 1e16, 1e15, 1e-5, np.nan]
        state = LiquidState(kind='msd', x=np.arange(4000, dtype=np.float32),
                            curves=np.stack([vals, vals[::-1]]), labels=('τ (ps)', 'MSD (Å²)'),
                            curve_labels=('type 1', 'type 2'))
        got = export.export_liquid_csv(state, tmp_path / 'port.csv')
        want = jax_export.export_liquid_csv(state, tmp_path / 'jax.csv')
        assert got.read_bytes() == want.read_bytes()
        back = pd.read_csv(got, skiprows=1, float_precision='round_trip')
        assert list(back.columns) == ['τ', 'type_1', 'type_2']
        same(back['type_1'].to_numpy(dtype), vals, "values")

    def test_npy_and_csv(self, pair, tmp_path):
        sed, want = pair.both('compute_kpath_sed', "x", n_k=8, bz_coverage=0.5, chiral=True)
        files = export.export_npy_set(sed, tmp_path / "exp" / "sed")
        jax_files = jax_export.export_npy_set(want, tmp_path / "exp_jax" / "sed")
        assert all(f.exists() for f in files)
        assert [f.name for f in files] == [f.name for f in jax_files]
        for f, g in zip(files, jax_files):
            if f.name.endswith('phase.npy'):
                phases_close(np.load(f), np.load(g), want.sed, f.name)
            else:
                close(np.load(f), np.load(g), f.name)
        csv = export.export_kpath_csv(sed, tmp_path / "kpath.csv")
        df = pd.read_csv(csv)
        assert 'frequency_THz' in df.columns
        assert any(c.startswith('k_') for c in df.columns)
        assert any(c.startswith('phase_k_') for c in df.columns)

    def test_kgrid_csv_and_gif(self, loaded, tmp_path):
        kg = loaded.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 4, 4, max_freq=8.0)
        csv = export.export_kgrid_csv(kg, tmp_path / "grid.csv")
        df = pd.read_csv(csv)
        assert set(df.columns) >= {'frequency_THz', 'k_x', 'k_y', 'intensity'}
        assert len(df) == len(kg.freqs) * 16
        gif = export.export_kgrid_gif(kg, tmp_path / "grid.gif", max_frames=5)
        assert gif.exists() and gif.stat().st_size > 1000
        import imageio.v2 as imageio
        want = jax_export.export_kgrid_gif(kg, tmp_path / "grid_jax.gif", max_frames=5)
        frames, jax_frames = imageio.mimread(gif), imageio.mimread(want)
        assert len(frames) == len(jax_frames)
        assert all(np.array_equal(a, b) for a, b in zip(frames, jax_frames))

    def test_peaks_csv(self, loaded, tmp_path):
        pk = loaded.compute_kgrid_peaks('xy', (-1, 1), (-1, 1), 4, 4, n_peaks=2)
        csv = export.export_peaks_csv(pk, tmp_path / "peaks.csv")
        df = pd.read_csv(csv)
        assert set(df.columns) == {'peak_rank', 'k_x', 'k_y', 'frequency_THz',
                                   'intensity', 'linewidth_THz_rms'}
        assert len(df) == 2 * 16
        np.testing.assert_allclose(df[df.peak_rank == 0].frequency_THz.to_numpy(),
                                   pk.freq_surfaces[0].ravel(), atol=1e-6)

    def test_ised_dump_export(self, loaded, tmp_path):
        loaded.compute_kpath_sed("x", n_k=12, bz_coverage=0.5)
        loaded.select_nearest(0.6, 4.0)
        src = loaded.reconstruct_ised("x", char_len=2.5, n_k=8, n_frames=3,
                                      out_dir=tmp_path / "i")
        dest = export.export_ised_dump(src, tmp_path / "out" / "motion.dump",
                                       {'k': 0.6, 'w': 4.0})
        assert dest.exists()
        assert dest.read_bytes() == src.read_bytes()
        want = jax_export.export_ised_dump(src, tmp_path / "out_jax" / "motion.dump",
                                           {'k': 0.6, 'w': 4.0})
        assert dest.with_suffix('.info.txt').read_text() == \
            want.with_suffix('.info.txt').read_text()

    def test_figure_export_aspect_ratio(self, tmp_path):
        """Saved-image aspect ratio (reference psa_gui.py:2894-2977): the
        figure is resized for the save and restored afterwards."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        from PIL import Image
        fig, ax = plt.subplots(figsize=(6, 6))
        ax.plot([0, 1], [0, 1])
        ax.axis('off')
        p = tmp_path / "wide.png"
        export.export_figure(fig, p, dpi=50, aspect_ratio='2:1')
        with Image.open(p) as im:
            w, h = im.size
        # bbox_inches='tight' trims margins, so compare loosely
        assert w / h > 1.5
        assert tuple(fig.get_size_inches()) == (6, 6)   # restored
        plt.close(fig)

    @pytest.mark.parametrize("spec,want", [('16:9', 16 / 9), ('4/3', 4 / 3), (2.5, 2.5),
                                           ('', None), ('auto', None), (None, None),
                                           ('keep', None), (' 2 : 1 ', 2.0)])
    def test_parse_aspect_ratio(self, spec, want):
        got = export.parse_aspect_ratio(spec)
        assert got == jax_export.parse_aspect_ratio(spec)
        assert got is None if want is None else got == pytest.approx(want)

    @pytest.mark.parametrize("bad", ['0:1', '-2', 'x:y', 'nan', '1:0'])
    def test_parse_aspect_ratio_rejects(self, bad):
        with pytest.raises(ValueError):
            export.parse_aspect_ratio(bad)

    def test_figure_export_format_guard(self, tmp_path):
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig = plt.figure()
        with pytest.raises(ValueError, match="Unsupported image format"):
            export.export_figure(fig, tmp_path / "x.bmp")
        out = export.export_figure(fig, tmp_path / "x.png")
        assert out.exists()
        plt.close(fig)


# -- DSF view --------------------------------------------------------------------

class TestKPathDSF:
    """GUI DSF view: instantaneous-phase map over a snapped k-path."""

    def test_shapes_and_state_untouched(self, loaded):
        k, f, plane = loaded.compute_kpath_dsf('x', n_k=16, bz_coverage=0.5, max_freq=8.0,
                                               observable='longitudinal')
        assert plane.shape == (len(f), len(k))
        assert plane.dtype == np.float32
        assert len(k) >= 2 and np.all(np.diff(k) > 0)
        assert np.all(f >= 0) and np.all(f <= 8.0)
        # the DSF view must not clobber the SED state iSED relies on
        assert loaded.sed_result is None

    @pytest.mark.parametrize("observable", ['total', 'longitudinal', 'transverse', 'self'])
    def test_observable_matches_jax(self, pair, observable):
        (k, f, plane), (k2, f2, p2) = pair.both('compute_kpath_dsf', 'x', n_k=12,
                                                bz_coverage=0.5, max_freq=8.0,
                                                observable=observable)
        close(k, k2, "k", 1e-6)
        same(f, f2, "f")
        # C_T of a chain that moves along k is a rounding residue of C_L:
        # held to the longitudinal map's scale
        scale = (float(pair.jax.compute_kpath_dsf('x', n_k=12, bz_coverage=0.5, max_freq=8.0,
                                                  observable='longitudinal')[2].max())
                 if observable == 'transverse' else None)
        close(plane, p2, observable, scale=scale)
        assert pair.port.dsf.observable == observable and pair.port.dsf.direction_text == 'x'

    def test_matches_direct_calculate_dsf(self, loaded):
        from psa_tpu_torch.ops.instantaneous import nearest_commensurate
        k, f, plane = loaded.compute_kpath_dsf('x', n_k=12, bz_coverage=0.5,
                                               observable='total')
        calc = loaded.calculator
        _, k_vecs = calc.get_k_path('x', bz_coverage=0.5, n_k=12)
        k_vecs = nearest_commensurate(k_vecs, calc.traj.box_lengths)
        _, first = np.unique(np.round(k_vecs, 7), axis=0, return_index=True)
        k_vecs = k_vecs[np.sort(first)]
        f2, s, _, _ = calc.calculate_dsf(k_vecs)
        np.testing.assert_allclose(plane, s, rtol=1e-6)
        np.testing.assert_allclose(f, f2, rtol=1e-6)

    def test_self_observable_matches_calculate_dsf_self(self, loaded):
        from psa_tpu_torch.ops.instantaneous import commensurate_kpath
        k, f, plane = loaded.compute_kpath_dsf('x', n_k=12, bz_coverage=0.5,
                                               observable='self')
        calc = loaded.calculator
        _, k_vecs = calc.get_k_path('x', bz_coverage=0.5, n_k=12)
        k_vecs = commensurate_kpath(k_vecs, calc.traj.box_matrix)
        f2, s_s = calc.calculate_dsf_self(k_vecs)
        np.testing.assert_allclose(plane, s_s, rtol=1e-6)
        np.testing.assert_allclose(f, f2, rtol=1e-6)
        assert loaded.dsf.observable == 'self'

    def test_rejects_bad_observable_and_degenerate_path(self, loaded):
        with pytest.raises(ValueError, match="observable"):
            loaded.compute_kpath_dsf('x', n_k=8, bz_coverage=0.5, observable='density')
        with pytest.raises(ValueError, match="commensurate"):
            # a 2-point path over a tiny k range snaps to a single point
            loaded.compute_kpath_dsf('x', n_k=2, bz_coverage=0.01)


def test_dsf_csv_export_and_recency(loaded, tmp_path):
    """DSF CSV export carries the plane wide-format; the last_compute
    marker lets the save menu prefer the most recent result."""
    loaded.compute_kpath_sed('x', n_k=8, bz_coverage=0.5)
    assert loaded.last_compute == 'kpath'
    k, f, plane = loaded.compute_kpath_dsf('x', n_k=12, bz_coverage=0.5,
                                           observable='transverse')
    assert loaded.last_compute == 'dsf'
    out = tmp_path / "dsf.csv"
    export.export_dsf_csv(loaded.dsf, out)
    lines = out.read_text().splitlines()
    assert lines[0].startswith("# observable=transverse direction=x")
    data = np.loadtxt(out.as_posix(), delimiter=',', skiprows=2)
    assert data.shape == (len(f), len(k) + 1)
    np.testing.assert_allclose(data[:, 1:], plane, rtol=1e-5)
    # a later grid compute takes back the preference
    loaded.compute_kgrid_sed('xy', (-0.5, 0.5), (-0.5, 0.5), 4, 4, max_freq=8.0)
    assert loaded.last_compute == 'browse'


def test_dsf_csv_keeps_columns_on_magnitude_collision(tmp_path):
    """Snapped k-points whose |k| collide at 1e-4 resolution must not
    overwrite each other's CSV column (the index disambiguates)."""
    freqs = np.linspace(0, 5, 4)
    plane = np.arange(12, dtype=np.float32).reshape(4, 3)
    dsf = DSFState(k_mags=np.array([0.12345, 0.123452, 0.2]), freqs=freqs,
                   plane=plane, observable='total', direction_text='x')
    out = tmp_path / "collide.csv"
    export.export_dsf_csv(dsf, out)
    data = np.loadtxt(out.as_posix(), delimiter=',', skiprows=2)
    assert data.shape == (4, 4)           # freq + one column per k-point
    np.testing.assert_allclose(data[:, 1:], plane, rtol=1e-5)


# -- NPT -------------------------------------------------------------------------

class TestNPTKPath:
    """GUI surface of the NPT (time-dependent cell) family: the controller
    sweeps FRACTIONAL Miller space through calculate_npt_browse and exports
    recompute via calculate_npt."""

    @staticmethod
    def _oracle_intensity(traj, m):
        h = traj.box_matrices.astype(np.float64)
        s = np.einsum('tij,taj->tai', np.linalg.inv(h), traj.positions.astype(np.float64))
        phase = np.exp(2j * np.pi * (m @ s.mean(axis=0).T))
        proj = np.einsum('tac,ka->tkc', traj.velocities.astype(np.float64), phase)
        spec = np.fft.fft(proj, axis=0) / traj.n_frames
        return np.sum(np.abs(spec) ** 2, axis=-1)

    def test_reduced_matches_oracle(self, npt_pair):
        sed, jax_sed = npt_pair.both('compute_npt_sed', 'x', n_k=6, max_order=6.0)
        assert not sed.is_complex
        m = np.array([1, 0, 0], float)[None] * np.linspace(1.0, 6.0, 6)[:, None]
        want = self._oracle_intensity(npt_pair.port.trajectory, m)
        mask = np.fft.fftfreq(48, d=0.02) >= 0
        np.testing.assert_allclose(sed.sed, want[mask], rtol=2e-5, atol=1e-6 * want.max())
        # physical axes: mean-cell Cartesian magnitudes, increasing
        assert np.all(np.diff(sed.k_points) > 0)
        same(sed.freqs, float32_rows(jax_sed.freqs), "NPT freqs")
        close(sed.k_points, jax_sed.k_points, "NPT k axis", 1e-6)
        close(sed.sed, jax_sed.sed, "NPT reduced planes")

    def test_click_and_plot_flow(self, npt_loaded):
        npt_loaded.compute_npt_sed('x', n_k=6, max_order=6.0)
        k, f, c = npt_loaded.kpath_plot_arrays(scale='dsqrt')
        assert c.shape == (len(f), len(k))
        ksel, wsel = npt_loaded.select_nearest(float(k[2]), 3.0)
        assert npt_loaded.selected_point == (ksel, wsel)
        # the ridden commensurate phonon (m=4, nu=3 THz) peaks where built
        inten = npt_loaded.sed_result.sed
        nu_peak = f[np.argmax(inten[:, 3])]
        assert abs(nu_peak - 3.0) < 0.6

    @pytest.mark.parametrize("chiral", [False, True])
    def test_full_export_recompute(self, npt_pair, chiral):
        sed, _ = npt_pair.both('compute_npt_sed', 'x', n_k=5, max_order=5.0, chiral=chiral)
        full, want = npt_pair.both('full_kpath_sed')
        assert full.is_complex and (full.phase is not None) == chiral
        mask = full.freqs >= 0
        np.testing.assert_allclose(sed.sed, full.intensity[mask], rtol=1e-5, atol=1e-8)
        np.testing.assert_allclose(full.k_vectors, np.asarray(sed.k_vectors), atol=0)
        close(full.sed, want.sed, "NPT complex spectrum")
        close(full.k_vectors, want.k_vectors, "NPT k vectors", 1e-6)

    def test_unreduced_npt_sed(self, npt_pair):
        sed, want = npt_pair.both('compute_npt_sed', 'x', n_k=4, max_order=4.0, chiral=True,
                                  reduced=False)
        assert sed.is_complex and sed.phase is not None
        close(sed.sed, want.sed, "NPT unreduced spectrum")
        assert npt_pair.port.full_kpath_sed() is sed

    def test_requires_npt_cells(self, loaded):
        with pytest.raises(RuntimeError, match="NPT"):
            loaded.compute_npt_sed('x', n_k=4)

    def test_chiral_and_welch_guards(self, npt_pair):
        with pytest.raises(ValueError, match="Welch"):
            npt_pair.port.compute_npt_sed('x', n_k=4, chiral=True, welch_segments=4)
        sed, want = npt_pair.both('compute_npt_sed', 'x', n_k=4, max_order=4.0,
                                  welch_segments=4)
        assert sed.sed.shape[0] == (48 // 4) // 2   # ω ≥ 0 of 12 Welch bins
        close(sed.sed, want.sed, "NPT Welch planes")

    def test_npt_ised_follows_the_last_kpath(self, npt_pair, tmp_path):
        """A mode clicked on an NPT dispersion reconstructs with the
        fractional anchor (``npt=None`` follows the last k-path compute)."""
        npt_pair.both('compute_npt_sed', 'x', n_k=6, max_order=6.0)
        k = npt_pair.port.sed_result.k_points
        assert len(set(npt_pair.both('select_nearest', float(k[3]), 3.0))) == 1
        for ctrl, name in ((npt_pair.port, 'port'), (npt_pair.jax, 'jax')):
            ctrl.reconstruct_ised('x', char_len=2.5, n_k=6, bz_coverage=6.0, n_frames=4,
                                  out_dir=tmp_path / name)
        (pos, types, _), (pos2, types2, _) = npt_pair.both('load_ised_motion')
        assert pos.shape == (4, 12, 3)
        same(types, types2, "types")
        np.testing.assert_allclose(pos, pos2, rtol=0, atol=TOL_DUMP)

    # -- NPT grids (fractional Miller plane) --------------------------------

    def test_npt_grid_browse_matches_oracle(self, npt_pair):
        kg, jax_kg = npt_pair.both('compute_kgrid_sed', 'xy', (1.0, 4.0), (0.0, 1.0), 4, 3,
                                   npt=True)
        assert kg.labels == ('m_x', 'm_y')
        m = np.zeros((12, 3))
        m[:, 0] = np.repeat(np.linspace(1.0, 4.0, 4), 3)
        m[:, 1] = np.tile(np.linspace(0.0, 1.0, 3), 4)
        want = self._oracle_intensity(npt_pair.port.trajectory, m)
        mask = np.fft.fftfreq(48, d=0.02) >= 0
        np.testing.assert_allclose(kg.intensity, want[mask], rtol=2e-5, atol=1e-6 * want.max())
        assert kg.slice_at(1).shape == (3, 4)   # (n_ky, n_kx) plot view
        kgrids_close(kg, jax_kg, "NPT grid")

    def test_npt_grid_peaks_surface(self, npt_pair):
        kg = npt_pair.port.compute_kgrid_sed('xy', (1.0, 4.0), (0.0, 1.0), 4, 3, npt=True)
        pk, want = npt_pair.both('compute_kgrid_peaks', 'xy', (1.0, 4.0), (0.0, 1.0), 4, 3,
                                 npt=True)
        assert pk.labels == ('m_x', 'm_y')
        expect = kg.freqs[np.argmax(kg.intensity, axis=0)].reshape(4, 3)
        np.testing.assert_allclose(pk.freq_surfaces[0], expect, atol=1e-6)
        peaks_close(pk, want, "NPT peaks")

    def test_npt_grid_guards(self, npt_loaded, loaded):
        with pytest.raises(RuntimeError, match="NPT"):
            loaded.compute_kgrid_sed('xy', (0, 1), (0, 1), 2, 2, npt=True)
        with pytest.raises(ValueError, match="direct engine"):
            npt_loaded.compute_kgrid_sed('xy', (0, 1), (0, 1), 2, 2, npt=True, engine='gridded')
        with pytest.raises(ValueError, match="total"):
            npt_loaded.compute_kgrid_sed('xy', (0, 1), (0, 1), 2, 2, npt=True,
                                         polarization='longitudinal')
        with pytest.raises(ValueError, match="reduced"):
            npt_loaded.compute_kgrid_sed('xy', (0, 1), (0, 1), 2, 2, npt=True, reduced=False)


# -- threads ---------------------------------------------------------------------

def run_in_threads(*jobs):
    """Start every job on its own thread at once; results in order, the
    first exception re-raised here."""
    out, errors = [None] * len(jobs), []
    gate = threading.Barrier(len(jobs))

    def work(i, job):
        try:
            gate.wait(timeout=60)
            out[i] = job()
        except BaseException as e:      # noqa: BLE001 - handed to the main thread
            errors.append(e)
    threads = [threading.Thread(target=work, args=(i, job), daemon=True)
               for i, job in enumerate(jobs)]
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)         # many thread switches inside each compute
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads), "a worker thread did not finish"
    if errors:
        raise errors[0]
    return out


class TestWorkerThreads:
    def test_two_computes_at_once_queue_on_the_lock(self, npt_loaded):
        """An NPT sweep (it sets and resets the calculator's phase anchor)
        and a fixed-cell sweep started together from two threads give what
        each gives alone, bit for bit."""
        ctrl = npt_loaded
        alone_npt = ctrl.compute_kgrid_sed('xy', (1.0, 4.0), (0.0, 1.0), 4, 3, npt=True)
        alone_peaks = ctrl.compute_kgrid_peaks('xy', (-1, 1), (-1, 1), 5, 4, n_peaks=2)
        for _ in range(3):
            got_npt, got_peaks = run_in_threads(
                lambda: ctrl.compute_kgrid_sed('xy', (1.0, 4.0), (0.0, 1.0), 4, 3, npt=True),
                lambda: ctrl.compute_kgrid_peaks('xy', (-1, 1), (-1, 1), 5, 4, n_peaks=2))
            same(got_npt.intensity, alone_npt.intensity, "NPT grid from a thread")
            for field in ('freq_surfaces', 'intensity_surfaces', 'linewidth_surfaces'):
                same(getattr(got_peaks, field), getattr(alone_peaks, field), field)
        assert ctrl.calculator._phase_anchor == 'cartesian'

    def test_the_lock_serializes(self, loaded, monkeypatch):
        """While one compute holds the lock no other enters the calculator."""
        inside, overlaps = [0], [0]
        real = loaded.calculator.calculate_kgrid_browse

        def watched(*args, **kwargs):
            inside[0] += 1
            overlaps[0] += inside[0] > 1
            try:
                return real(*args, **kwargs)
            finally:
                inside[0] -= 1
        monkeypatch.setattr(loaded.calculator, 'calculate_kgrid_browse', watched)
        run_in_threads(*[lambda: loaded.compute_kpath_sed('x', n_k=8, bz_coverage=0.5)] * 4)
        assert overlaps[0] == 0 and inside[0] == 0

    def test_a_bare_cuda_is_pinned_to_the_building_threads_card(self, monkeypatch):
        """PyTorch's current device is per thread: the controller keeps the
        index its own thread had, so a worker thread lands on the same card."""
        from psa_tpu_torch.core.calculator import resolve_device
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
        monkeypatch.setattr(torch.cuda, 'current_device', lambda: 1)
        assert resolve_device('cuda') == torch.device('cuda', 1)
        assert resolve_device(torch.device('cuda')) == torch.device('cuda', 1)
        assert resolve_device('cuda:0') == torch.device('cuda', 0)
        assert resolve_device('cpu') == torch.device('cpu')
        assert AnalysisController().device == torch.device('cuda', 1)

    def test_a_thread_failure_reaches_the_caller(self, loaded):
        with pytest.raises(RuntimeError, match="k-path SED first"):
            run_in_threads(loaded.full_kpath_sed)


# -- the view --------------------------------------------------------------------

def test_gui_app_importable():
    """The Tk view must import headless (construction needs a display)."""
    import psa_tpu_torch.gui.app  # noqa: F401
    import psa_tpu_torch.gui.widgets  # noqa: F401


class TestViewCallbackWiring:
    """Static audit of the Tk view: every widget callback, slider command,
    and event binding in gui/app.py must name a method that actually exists
    on PSAMainWindow (no display needed — the class is inspected, not
    instantiated)."""

    @staticmethod
    def _source():
        from psa_tpu_torch.gui import app
        return app, inspect.getsource(app)

    def test_all_command_targets_exist(self):
        app, src = self._source()
        targets = set(re.findall(r"command=self\.(\w+)", src))
        targets |= set(re.findall(r"\.bind\([^)]*self\.(\w+)", src))
        targets |= set(re.findall(r"mpl_connect\([^)]*self\.(\w+)", src))
        targets |= set(re.findall(r"\.after\(\s*\d+\s*,\s*self\.(\w+)", src))
        targets |= set(re.findall(r"protocol\([^)]*self\.(\w+)", src))
        assert targets, "no callbacks found — the audit regexes went stale"
        missing = [t for t in sorted(targets)
                   if not callable(getattr(app.PSAMainWindow, t, None))]
        assert not missing, f"dangling GUI callbacks: {missing}"

    def test_callback_signatures(self):
        """Every wired callback must be CALLABLE with the arguments Tk will
        pass: command=/after → no args; bind/mpl_connect → one event arg."""
        app, src = self._source()
        # command= passes 0 args from Button/Checkbutton but 1 (the value)
        # from Scale — accept either arity for that group
        cmd = (set(re.findall(r"command=self\.(\w+)", src))
               | set(re.findall(r"\.after\(\s*\d+\s*,\s*self\.(\w+)", src))
               | set(re.findall(r"protocol\([^)]*self\.(\w+)", src)))
        one_arg = (set(re.findall(r"\.bind\([^)]*self\.(\w+)", src))
                   | set(re.findall(r"mpl_connect\([^)]*self\.(\w+)", src)))

        def accepts(name, n_args):
            sig = inspect.signature(getattr(app.PSAMainWindow, name))
            try:       # bound call: drop self, pass n_args positionals
                sig.bind(None, *(object(),) * n_args)
                return True
            except TypeError:
                return False

        bad = [t for t in sorted(cmd) if not (accepts(t, 0) or accepts(t, 1))]
        bad += [f"{t}(event)" for t in sorted(one_arg) if not accepts(t, 1)]
        assert not bad, f"callback signature mismatches: {bad}"

    def test_controller_calls_resolve(self):
        """Every ``self.controller.<name>`` in the view must name a real
        AnalysisController attribute (static execution audit)."""
        _, src = self._source()
        names = set(re.findall(r"self\.controller\.(\w+)", src))
        assert names, "no controller references found — regex went stale"
        missing = [n for n in sorted(names)
                   if not hasattr(AnalysisController, n)
                   and n not in AnalysisController.__init__.__code__.co_names
                   and n not in ('trajectory', 'calculator', 'sed_result',
                                 'kpath_mags', 'kgrid', 'kgrid_peaks', 'dsf',
                                 'liquid', 'last_compute', 'last_grid_kind',
                                 'selected_point', 'ised_dump_path',
                                 'temp_dirs', 'readback_dtype', 'device')]
        assert not missing, f"view references unknown controller API: {missing}"

    def test_the_view_is_the_jax_view_but_for_the_device(self):
        """The port's view wires the same callbacks, passes the controller
        the same keyword arguments and starts the same worker threads as the
        JAX package's."""
        from psa_tpu.gui import app as jax_app
        app, src = self._source()
        assert list(inspect.signature(app.PSAMainWindow.__init__).parameters) == \
            list(inspect.signature(jax_app.PSAMainWindow.__init__).parameters) + ['device']
        jax_src = inspect.getsource(jax_app)
        for pattern in (r"command=self\.(\w+)", r"self\.controller\.(\w+)\(",
                        r"^\s+(\w+)=self\.\w+_var\.get\(\)", r"def (\w+)\("):
            got = sorted(re.findall(pattern, src, re.M))
            want = sorted(re.findall(pattern, jax_src, re.M))
            if pattern.startswith('def'):
                want += ['build_parser']
            assert got == sorted(want), pattern
        assert src.count("threading.Thread(target=work, daemon=True)") == \
            jax_src.count("threading.Thread(target=work, daemon=True)") == 9
        assert 'TPU' not in src and 'jax' not in src.lower().replace('psa_tpu.gui', '')
