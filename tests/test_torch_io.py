"""psa_tpu_torch's trajectory readers against the JAX package's.

Every reader of the port reads the same seeded file as its counterpart in
``psa_tpu.io`` and must return equal arrays (bit for bit: both are the same
host parsing).  Files are written here with NumPy from fixed seeds.
"""
import builtins
import logging
import sys
import types

import numpy as np
import pytest
import torch

from psa_tpu.io import h5md as jh5md
from psa_tpu.io import lammps as jlammps
from psa_tpu.io import native as jnative
from psa_tpu.io.loader import TrajectoryLoader as JaxLoader
from psa_tpu.io.writer import out_to_qdump as jax_qdump
from psa_tpu_torch.core.sed import SED
from psa_tpu_torch.io import h5md as th5md
from psa_tpu_torch.io import lammps as tlammps
from psa_tpu_torch.io import native as tnative
from psa_tpu_torch.io.loader import TrajectoryLoader
from psa_tpu_torch.io.writer import TrajectoryWriter, out_to_qdump
from psa_tpu_torch.models import make_chain_trajectory

torch.set_num_threads(1)

TRAJ_FIELDS = ('positions', 'velocities', 'types', 'box_matrix', 'box_lengths', 'box_tilts',
               'timesteps', 'masses', 'box_matrices')


def assert_same(got, want):
    """Equal tuples of arrays (or None) from the two packages' readers."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype
            np.testing.assert_array_equal(g, w)


def assert_same_traj(got, want):
    for name in TRAJ_FIELDS:
        g, w = getattr(got, name), getattr(want, name)
        if w is None:
            assert g is None, name
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got.dt_ps == want.dt_ps


# ---------------------------------------------------------------------------
# dump writers (seeded, NumPy)
# ---------------------------------------------------------------------------

def write_dump(path, n_frames=5, n_atoms=17, vel=True, mass=False, shuffle=True, seed=3,
               box="0 12\n0 13\n0 14\n"):
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        for t in range(n_frames):
            f.write(f"ITEM: TIMESTEP\n{t * 10}\nITEM: NUMBER OF ATOMS\n{n_atoms}\n")
            f.write(f"ITEM: BOX BOUNDS pp pp pp\n{box}")
            cols = "id type" + (" mass" if mass else "") + " x y z" + (" vx vy vz" if vel else "")
            f.write(f"ITEM: ATOMS {cols}\n")
            for a in (rng.permutation(n_atoms) if shuffle else range(n_atoms)):
                row = [str(a + 1), str(a % 2 + 1)] + ([f"{28.09 * (a % 3 + 1):.3f}"] if mass else [])
                row += [f"{v:.6f}" for v in rng.uniform(0, 12, 3)]
                if vel:
                    row += [f"{v:.6f}" for v in rng.normal(0, 1, 3)]
                f.write(" ".join(row) + "\n")
    return path


def write_scaled_triclinic(path):
    H = np.array([[10., 1.5, 0.5], [0., 11., 2.0], [0., 0., 12.]])
    frac = np.random.default_rng(7).uniform(0, 1, (2, 6, 3))
    with open(path, "w") as f:
        for t in range(2):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n6\n"
                    "ITEM: BOX BOUNDS xy xz yz pp pp pp\n"
                    f"0.0 {10 + 2.0:f} 1.5\n0.0 {11 + 2.0:f} 0.5\n0.0 12.0 2.0\n"
                    "ITEM: ATOMS id type xs ys zs\n")
            for i in range(6):
                f.write(f"{i + 1} 1 " + " ".join(f"{v:.10f}" for v in frac[t, i]) + "\n")
    return path


def write_npt_scaled(path, n_t=3, n_a=5):
    frac = np.random.default_rng(11).uniform(0, 1, (n_t, n_a, 3))
    with open(path, "w") as f:
        for t in range(n_t):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{n_a}\n"
                    "ITEM: BOX BOUNDS pp pp pp\n")
            for d, L in enumerate((10. + t, 11. + 2 * t, 12. - t)):
                f.write(f"0 {L}\n")
            f.write("ITEM: ATOMS id type xs ys zs\n")
            for a in range(n_a):
                f.write(f"{a + 1} 1 " + " ".join(f"{v:.10f}" for v in frac[t, a]) + "\n")
    return path


def write_crossing(path):
    """One atom walking +0.4 per frame across the x boundary at 10 (wrapped)."""
    with open(path, "w") as f:
        for t in range(6):
            x = (9.0 + 0.4 * t) % 10.0
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n2\n"
                    "ITEM: BOX BOUNDS pp pp pp\n0 10\n0 10\n0 10\n"
                    f"ITEM: ATOMS id type x y z vx vy vz\n1 1 {x:.6f} 1.0 1.0 0.4 0 0\n"
                    "2 2 5.0 5.0 5.0 0 0 0\n")
    return path


def write_growing(path):
    with open(path, "w") as f:
        for t, n_a in enumerate([3, 3, 5]):
            f.write(f"ITEM: TIMESTEP\n{t}\nITEM: NUMBER OF ATOMS\n{n_a}\n"
                    "ITEM: BOX BOUNDS pp pp pp\n0 10\n0 10\n0 10\nITEM: ATOMS id type x y z\n")
            for a in range(n_a):
                f.write(f"{a + 1} 1 {a}.0 {a}.5 {t}.0\n")
    return path


def write_qdump(path, triclinic):
    pos = np.random.default_rng(1).uniform(0, 8, (3, 5, 3)).astype(np.float32)
    box = (np.array([[10., 1.5, 0.5], [0., 11., 2.0], [0., 0., 12.]], np.float32) if triclinic
           else np.diag([10., 11., 12.]).astype(np.float32))
    out_to_qdump(str(path), pos, np.array([1, 2, 1, 2, 1]), box)
    return path


DUMPS = {
    'orthogonal_qdump': lambda p: write_qdump(p, False),
    'triclinic_qdump': lambda p: write_qdump(p, True),
    'scaled_triclinic': write_scaled_triclinic,
    'per_frame_boxes': write_npt_scaled,
    'unwrapped_crossing': write_crossing,
    'velocities_shuffled_ids': lambda p: write_dump(p),
    'no_velocities': lambda p: write_dump(p, vel=False),
    'mass_column': lambda p: write_dump(p, mass=True, shuffle=False),
}


@pytest.mark.parametrize('reader', ['bulk', 'streaming'])
@pytest.mark.parametrize('kind', sorted(DUMPS))
def test_lammps_dump_matches_jax(tmp_path, monkeypatch, kind, reader):
    path = DUMPS[kind](tmp_path / f"{kind}.dump")
    if reader == 'streaming':
        monkeypatch.setattr(tlammps, '_read_dump_bulk', lambda *a, **k: None)
        monkeypatch.setattr(jlammps, '_read_dump_bulk', lambda *a, **k: None)
    for unwrap in (False, True):
        kw = dict(unwrap=unwrap, with_masses=True, with_boxes=True)
        assert_same(tlammps.read_lammps_dump(path, **kw), jlammps.read_lammps_dump(path, **kw))


def test_qdump_writer_matches_jax(tmp_path):
    traj = make_chain_trajectory(n_cells=6, n_frames=4, dt_ps=0.01)
    out_to_qdump(str(tmp_path / "t.dump"), traj.positions, traj.types, traj.box_matrix)
    jax_qdump(str(tmp_path / "j.dump"), traj.positions, traj.types, traj.box_matrix)
    assert (tmp_path / "t.dump").read_bytes() == (tmp_path / "j.dump").read_bytes()


def test_unwrap_recovers_crossing(tmp_path):
    pos, *_ = tlammps.read_lammps_dump(write_crossing(tmp_path / "c.dump"), unwrap=True)
    np.testing.assert_allclose(pos[:, 0, 0], 9.0 + 0.4 * np.arange(6), atol=1e-5)


def test_per_frame_boxes_kept(tmp_path):
    *_, boxes = tlammps.read_lammps_dump(write_npt_scaled(tmp_path / "n.dump"), unwrap=False,
                                         with_boxes=True)
    assert boxes.shape == (3, 3, 3) and boxes[2, 0, 0] == 12.0


@pytest.mark.parametrize('reader', ['read_dump', 'mmap_source'])
def test_varying_atom_counts_raise(tmp_path, monkeypatch, reader):
    path = write_growing(tmp_path / "grow.dump")
    monkeypatch.setenv('PSA_BULK_PARSER', '1')
    for mod in (tlammps, jlammps):
        with pytest.raises(ValueError, match="atom"):
            if reader == 'read_dump':
                mod.read_lammps_dump(path, unwrap=False)
            else:
                mod.MmapDumpFrames(path)


@pytest.mark.parametrize('damage', ['truncated', 'bad_number', 'no_positions'])
def test_malformed_dump_raises(tmp_path, damage):
    path = write_dump(tmp_path / "m.dump", n_frames=3)
    text = path.read_text()
    if damage == 'truncated':
        text = "".join(text.splitlines(keepends=True)[:-2])
    elif damage == 'bad_number':
        lines = text.splitlines(keepends=True)
        lines[-1] = "abc" + lines[-1][lines[-1].index(' '):]
        text = "".join(lines)
    else:
        text = text.replace(" x y z", " q r s")
    path.write_text(text)
    for mod in (tlammps, jlammps):
        with pytest.raises(ValueError):
            mod.read_lammps_dump(path)


def test_mmap_source_matches_jax(tmp_path):
    path = write_dump(tmp_path / "w.dump", n_frames=6)
    src, ref = tlammps.MmapDumpFrames(path), jlammps.MmapDumpFrames(path)
    try:
        assert (src.n_frames, src.n_atoms, src.columns) == (ref.n_frames, ref.n_atoms, ref.columns)
        assert_same(src.frames(1, 5), ref.frames(1, 5))
        assert_same((src.types, src.timesteps), (ref.types, ref.timesteps))
    finally:
        src.close()
        ref.close()


# ---------------------------------------------------------------------------
# the C parser, built into psa_tpu_torch/_build/, and the NumPy fallback
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('text,n', [(b"1.5 -2e3 0.001 +4.25e-2 700\n-0.0 1e-30 3.14159", 8),
                                    (" ".join(repr(float(v)) for v in np.random.default_rng(1)
                                              .normal(scale=1e3, size=500)).encode(), 500)])
def test_native_parse_matches_jax(text, n):
    np.testing.assert_array_equal(tnative.parse_doubles(text, n), jnative.parse_doubles(text, n))


@pytest.mark.parametrize('text,n,match', [(b"1.0 abc 2.0", 3, "Malformed|Expected"),
                                          (b"1 2 3", 5, "Expected")])
def test_native_parse_malformed_raises(text, n, match):
    with pytest.raises(ValueError, match=match):
        tnative.parse_doubles(text, n)


def test_c_parser_built_into_build_dir():
    assert tnative.available()
    assert tnative.LIB_PATH.parent.name == '_build'
    assert tnative.LIB_PATH.parent.parent.name == 'psa_tpu_torch'
    assert tnative.LIB_PATH.is_file() and not tnative._stale()
    assert not (tnative.SOURCE.parent / 'libpsa_fastparse.so').exists()


def test_c_parser_rebuilds_when_stale(tmp_path, monkeypatch):
    monkeypatch.setattr(tnative, 'LIB_PATH', tmp_path / 'libpsa_fastparse.so')
    assert tnative._stale()
    tnative.build()
    assert not tnative._stale()
    monkeypatch.setattr(tnative, 'CC_FLAGS', tnative.CC_FLAGS + ('-g',))
    assert tnative._stale()


def test_numpy_fallback_matches_native_and_warns(tmp_path, monkeypatch, caplog):
    path = write_dump(tmp_path / "f.dump")
    native_read = tlammps.read_lammps_dump(path, with_masses=True)
    monkeypatch.setattr(tnative, 'get_lib', lambda: None)
    with caplog.at_level(logging.WARNING, logger='psa_tpu_torch.io.lammps'):
        fallback = tlammps.read_lammps_dump(path, with_masses=True)
    assert any("NumPy" in r.getMessage() for r in caplog.records)
    assert_same(fallback, native_read)


# ---------------------------------------------------------------------------
# extxyz, OUTCAR, H5MD
# ---------------------------------------------------------------------------

def write_extxyz(path, case):
    rng = np.random.default_rng(5)
    pos, vel = rng.uniform(0, 8, (3, 4, 3)), rng.normal(0, 1, (3, 4, 3))
    species = ['Si', 'O', 'Si', 'O']
    with open(path, "w") as f:
        for t in range(3):
            f.write("4\n")
            if case == 'plain':
                f.write(f"frame {t}\n")
            else:
                lattice = ('Lattice="10 0 0 1.5 11 0 0.5 2 12" ' if case == 'triclinic'
                           else 'Lattice="8 0 0 0 9 0 0 0 10" ' if case == 'full' else '')
                props = "Properties=species:S:1:pos:R:3" + (":vel:R:3" if case != 'no_lattice' else '')
                f.write(f"{lattice}{props} Time={t}\n")
            for a in range(4):
                row = [species[a]] + [f"{v:.8f}" for v in pos[t, a]]
                if case in ('full', 'triclinic'):
                    row += [f"{v:.8f}" for v in vel[t, a]]
                f.write(" ".join(row) + "\n")
    return path


@pytest.mark.parametrize('case', ['full', 'plain', 'triclinic', 'no_lattice'])
def test_extxyz_matches_jax(tmp_path, case):
    path = write_extxyz(tmp_path / "t.extxyz", case)
    assert_same(tlammps.read_extxyz(path), jlammps.read_extxyz(path))


def write_outcar(path, case):
    dash = " " + "-" * 83 + "\n"
    lines = ["   ions per type =    2   2\n", "  number of ions     NIONS =      4\n"]
    for scale in ((4.0, 4.0, 8.0), (4.1, 4.1, 8.2))[:1 if case == 'minimal' else 2]:
        lines += [" direct lattice vectors                 reciprocal\n"]
        lines += [" ".join(f"{scale[r] if c == r else 0.0:.1f}" for c in range(3)) + "  0 0 0\n"
                  for r in range(3)]
    rng = np.random.default_rng(0)
    for _ in range(3):
        lines += [" POSITION                 TOTAL-FORCE (eV/Angst)\n", dash]
        lines += [" ".join(f"{v:.5f}" for v in rng.uniform(0, 4, 3)) + "   0.01 -0.02 0.03\n"
                  for _ in range(4)]
        lines += [dash, "  total drift: 0.0 0.0 0.0\n"]
    if case == 'truncated_block':
        lines += [" POSITION                 TOTAL-FORCE (eV/Angst)\n", dash,
                  "     1.0 1.0 1.0   0 0 0\n", dash]
    path.write_text("".join(lines))
    return path


@pytest.mark.parametrize('case', ['minimal', 'relaxed_lattice', 'truncated_block'])
def test_outcar_matches_jax(tmp_path, case):
    path = write_outcar(tmp_path / "md.OUTCAR", case)
    got = tlammps.read_vasp_outcar(path)
    assert_same(got, jlammps.read_vasp_outcar(path))
    assert got[0].shape == (3, 4, 3)


def write_h5md(path, case):
    h5py = pytest.importorskip("h5py")
    rng = np.random.default_rng(8)
    n_t, n_a = 4, 6
    pos = rng.uniform(0, 9, (n_t, n_a, 3)).astype(np.float32)
    with h5py.File(path, "w") as f:
        g = f.create_group("particles/all")
        p = g.create_group("position")
        p.create_dataset("value", data=pos)
        p.create_dataset("step", data=np.arange(n_t) * 10)
        if case != 'no_velocity':
            g.create_group("velocity").create_dataset(
                "value", data=rng.normal(0, 1, (n_t, n_a, 3)).astype(np.float32))
        if case == 'no_velocity':
            g.create_group("species").create_dataset("value", data=np.tile([1, 2] * 3, (n_t, 1)))
        else:
            g.create_dataset("species", data=np.array([1, 2] * 3))
        if case == 'mass':
            g.create_dataset("mass", data=np.array([1., 3.] * 3))
        if case == 'image':
            g.create_group("image").create_dataset("value", data=np.floor(
                rng.uniform(-1, 2, (n_t, n_a, 3))))
        box = g.create_group("box")
        if case == 'npt_box':
            box.create_group("edges").create_dataset(
                "value", data=np.stack([np.diag([9. + t, 10., 11.]) for t in range(n_t)]))
        elif case == 'rows':
            box.create_dataset("edges", data=np.array([[9., 0., 0.], [1.5, 10., 0.],
                                                       [0.5, 2.0, 11.]]))
        else:
            box.create_dataset("edges", data=np.array([9., 10., 11.]))
    return path


@pytest.mark.parametrize('case', ['full', 'rows', 'no_velocity', 'npt_box', 'mass', 'image'])
def test_h5md_matches_jax(tmp_path, case):
    path = write_h5md(tmp_path / "t.h5md", case)
    for unwrap in (False, True):
        assert_same(th5md.read_h5md(path, unwrap=unwrap, with_boxes=True),
                    jh5md.read_h5md(path, unwrap=unwrap, with_boxes=True))


def test_h5md_not_h5md_raises(tmp_path):
    h5py = pytest.importorskip("h5py")
    path = tmp_path / "empty.h5"
    with h5py.File(path, "w") as f:
        f.create_group("not_particles")
    with pytest.raises(ValueError, match="particles"):
        th5md.read_h5md(path)


def test_h5md_without_h5py_names_the_package(tmp_path, monkeypatch):
    real_import = builtins.__import__

    def no_h5py(name, *a, **k):
        if name == 'h5py':
            raise ImportError('no h5py here')
        return real_import(name, *a, **k)
    monkeypatch.delitem(sys.modules, 'h5py', raising=False)
    monkeypatch.setattr(builtins, '__import__', no_h5py)
    with pytest.raises(ImportError, match="h5py"):
        th5md.read_h5md(tmp_path / "x.h5md")


# ---------------------------------------------------------------------------
# TrajectoryLoader: formats, the .npy sidecar cache, mmap; writer
# ---------------------------------------------------------------------------

LOADER_FILES = {
    'lammps': lambda p: write_dump(p / "t.dump", mass=True),
    'extxyz': lambda p: write_extxyz(p / "t.extxyz", 'full'),
    'outcar': lambda p: write_outcar(p / "t.OUTCAR", 'minimal'),
    'h5md': lambda p: write_h5md(p / "t.h5md", 'mass'),
}


@pytest.mark.parametrize('fmt', sorted(LOADER_FILES))
def test_loader_matches_jax_and_caches(tmp_path, fmt):
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    got = TrajectoryLoader(str(LOADER_FILES[fmt](tmp_path / "port")), dt=0.02, unwrap=False).load()
    want = JaxLoader(str(LOADER_FILES[fmt](tmp_path / "jax")), dt=0.02, unwrap=False).load()
    assert_same_traj(got, want)
    sidecars = sorted(p.name for p in (tmp_path / "port").glob("*.npy"))
    assert sidecars == sorted(p.name for p in (tmp_path / "jax").glob("*.npy"))
    assert {'t.positions.npy', 't.velocities.npy', 't.mean_positions.npy',
            't.displacements.npy'} <= set(sidecars)
    # the port's sidecars load in both packages, and the cache hit equals the parse
    src =[p for p in (tmp_path / "port").iterdir() if not p.name.endswith('.npy')][0]
    assert_same_traj(TrajectoryLoader(str(src), dt=0.02).load(), got)
    assert_same_traj(JaxLoader(str(src), dt=0.02).load(), got)


def test_loader_mmap_cache(tmp_path):
    path = write_dump(tmp_path / "m.dump")
    TrajectoryLoader(str(path), dt=0.01).load()
    traj = TrajectoryLoader(str(path), dt=0.01, mmap=True).load()
    assert isinstance(traj.positions, np.memmap) and isinstance(traj.velocities, np.memmap)
    assert_same_traj(traj, JaxLoader(str(path), dt=0.01, mmap=True).load())


@pytest.mark.parametrize('bad', ['format', 'missing', 'dt', 'backend'])
def test_loader_validation(tmp_path, bad):
    (tmp_path / "x.dump").write_text("data")
    kw = {'format': dict(file_format='xyz'), 'dt': dict(dt=0.0),
          'backend': dict(backend='mdanalysis')}.get(bad, {})
    name = str(tmp_path / ("absent.dump" if bad == 'missing' else "x.dump"))
    with pytest.raises(FileNotFoundError if bad == 'missing' else ValueError):
        TrajectoryLoader(name, **kw)


def _fake_ovito(monkeypatch, with_velocities=True):
    rng = np.random.default_rng(0)
    positions = rng.uniform(0, 5, size=(3, 4, 3)).astype(np.float32)
    velocities = rng.normal(size=(3, 4, 3)).astype(np.float32)

    class Frame:
        def __init__(self, i):
            self.particles = types.SimpleNamespace(
                positions=positions[i], velocities=velocities[i] if with_velocities else None,
                particle_types=np.array([1, 1, 2, 2], dtype=np.int32))
            self.cell = types.SimpleNamespace(matrix=np.hstack(
                [np.diag([5.0, 5.0, 5.0]), np.zeros((3, 1))]).astype(np.float32))

    class Pipeline:
        source = types.SimpleNamespace(num_frames=3)

        def __init__(self):
            self.modifiers = []

        def compute(self, i):
            return Frame(i)

    ovito = types.ModuleType('ovito')
    ovito.io = types.ModuleType('ovito.io')
    ovito.io.import_file = lambda path, input_format=None: Pipeline()
    ovito.modifiers = types.ModuleType('ovito.modifiers')
    ovito.modifiers.UnwrapTrajectoriesModifier = type('UnwrapTrajectoriesModifier', (), {})
    for name, mod in (('ovito', ovito), ('ovito.io', ovito.io),
                      ('ovito.modifiers', ovito.modifiers)):
        monkeypatch.setitem(sys.modules, name, mod)


@pytest.mark.parametrize('with_velocities', [True, False])
def test_ovito_backend_matches_jax(tmp_path, monkeypatch, with_velocities):
    _fake_ovito(monkeypatch, with_velocities)
    f = tmp_path / "exotic.dump"
    f.write_text("parsed by the stand-in\n")
    calls = []
    got = TrajectoryLoader(str(f), dt=0.01, backend='ovito',
                           progress=lambda d, t: calls.append((d, t)))._load_via_ovito()
    assert_same_traj(got, JaxLoader(str(f), dt=0.01, backend='ovito')._load_via_ovito())
    assert calls == [(1, 3), (2, 3), (3, 3)]


def test_trajectory_writer_matches_jax(tmp_path):
    from psa_tpu.core.sed import SED as JaxSED
    from psa_tpu.io.writer import TrajectoryWriter as JaxWriter
    traj = make_chain_trajectory(n_cells=4, n_frames=6, dt_ps=0.01)
    args = (np.ones((4, 3, 3), np.complex64), np.zeros(4), np.zeros(3), np.zeros((3, 3)))
    for writer, sed, sub in ((TrajectoryWriter, SED, 'port'), (JaxWriter, JaxSED, 'jax')):
        w = writer(tmp_path / sub)
        w.save_sed_data(sed(*args, phase=np.ones((4, 3), np.float32)))
        w.save_trajectory_data(traj)
        w.save_config({'a': {'b': 1}})
        w.save_analysis_results({'metric': 1.0})
        w.save_log("hello")
    for name in ('config.yaml', 'analysis_results.json', 'analysis.log'):
        assert (tmp_path / 'port' / name).read_bytes() == (tmp_path / 'jax' / name).read_bytes()
    for name in ('sed_data.npz', 'sed_data.phase.npz', 'trajectory_data.npz'):
        got, want = np.load(tmp_path / 'port' / name), np.load(tmp_path / 'jax' / name)
        assert sorted(got.files) == sorted(want.files)
        for key in want.files:
            np.testing.assert_array_equal(got[key], want[key])
