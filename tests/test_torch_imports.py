"""Import hygiene of psa_tpu_torch: the package, its command line, its
config manager and its plotter import with ``jax``, ``psa_tpu``, ``yaml`` and
``matplotlib`` all absent (blocked in ``sys.modules`` in a subprocess), and
the command line then runs a JSON-configured SED with its figures skipped
and its data written; the bench, the graft entry and every example import
the same way, and an example then runs with its figures skipped.  The headless half of the GUI (controller, exports)
and the profiling and debug helpers import with ``tkinter``, ``pandas`` and
``imageio`` blocked as well, and a session then computes and exports; the
Tk view imports with ``jax`` and ``psa_tpu`` blocked."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
BLOCK = ("import sys\n"
         "for name in ('jax', 'jaxlib', 'psa_tpu', 'yaml', 'matplotlib', 'h5py'):\n"
         "    sys.modules[name] = None\n")
MODULES = ['psa_tpu_torch', 'psa_tpu_torch.cli', 'psa_tpu_torch.utils.config_manager',
           'psa_tpu_torch.visualization', 'psa_tpu_torch.visualization.sed_plotter',
           'psa_tpu_torch.visualization.styles', 'psa_tpu_torch.utils.fits',
           'psa_tpu_torch.ops.timecorr', 'psa_tpu_torch.ops.structure',
           'psa_tpu_torch.ops.gridded', 'psa_tpu_torch.ops.instantaneous',
           'psa_tpu_torch.parallel', 'psa_tpu_torch.parallel.smoke', 'psa_tpu_torch.pod_sweep',
           'psa_tpu_torch.graft_entry', 'bench_torch', 'examples_torch._common',
           *sorted(f'examples_torch.{p.stem}' for p in (REPO / 'examples_torch').glob('*.py')
                   if not p.stem.startswith('_'))]


HEADLESS = ('jax', 'jaxlib', 'psa_tpu', 'tkinter', 'matplotlib', 'pandas', 'imageio')
HEADLESS_MODULES = ['psa_tpu_torch.gui', 'psa_tpu_torch.gui.controller', 'psa_tpu_torch.gui.export',
                    'psa_tpu_torch.utils.profiling', 'psa_tpu_torch.utils.debug']


def block(names):
    return f"import sys\nfor name in {tuple(names)!r}:\n    sys.modules[name] = None\n"


def run(code, blocked=None, **kwargs):
    head = BLOCK if blocked is None else block(blocked)
    return subprocess.run([sys.executable, '-c', head + code], cwd=REPO, timeout=300,
                          capture_output=True, text=True, **kwargs)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_with_everything_optional_blocked(module):
    done = run(f"import {module}\n"
               "bad = [m for m in ('jax', 'psa_tpu', 'yaml', 'matplotlib') "
               "if sys.modules.get(m) is not None]\n"
               "assert not bad, bad\n")
    assert done.returncode == 0, done.stderr


@pytest.mark.parametrize("module", HEADLESS_MODULES)
def test_headless_module_imports_without_tk_matplotlib_pandas_imageio(module):
    done = run(f"import {module}\n"
               f"bad = [m for m in {HEADLESS!r} if sys.modules.get(m) is not None]\n"
               "assert not bad, bad\n", blocked=HEADLESS)
    assert done.returncode == 0, done.stderr


def test_the_view_imports_without_jax():
    """``gui.app`` needs tkinter and matplotlib (and no display) but neither
    jax nor the JAX package; importing it opens no window."""
    done = run("import psa_tpu_torch.gui.app, psa_tpu_torch.gui.widgets\n"
               "assert sys.modules['tkinter'] is not None\n"
               "bad = [m for m in ('jax', 'jaxlib', 'psa_tpu') if sys.modules.get(m) is not None]\n"
               "assert not bad, bad\n", blocked=('jax', 'jaxlib', 'psa_tpu'))
    assert done.returncode == 0, done.stderr


def test_headless_session_computes_and_exports_without_the_optional_packages(tmp_path):
    """Load, compute, click, reconstruct and write every CSV with tkinter,
    matplotlib, pandas and imageio absent; the GIF and figure exports then
    raise an ImportError naming the package they miss."""
    done = run(
        "import numpy as np\n"
        "from psa_tpu_torch.gui import export\n"
        "from psa_tpu_torch.gui.controller import AnalysisController\n"
        "from psa_tpu_torch.models import make_chain_trajectory\n"
        f"out = {str(tmp_path)!r}\n"
        "traj = make_chain_trajectory(n_cells=12, n_frames=32, dt_ps=0.02, a=2.5, "
        "omega_max_thz=6.0)\n"
        "for part in ('positions', 'velocities', 'types', 'box_matrix'):\n"
        "    np.save(f'{out}/chain.{part}.npy', getattr(traj, part))\n"
        "open(out + '/chain.dump', 'w').close()\n"
        "ctrl = AnalysisController(device='cpu')\n"
        "assert ctrl.has_cache(out + '/chain.dump')\n"
        "ctrl.load_trajectory(out + '/chain.dump', dt=0.02, file_format='lammps', nx=12, ny=1, "
        "nz=1)\n"
        "sed = ctrl.compute_kpath_sed('x', n_k=8, bz_coverage=0.5)\n"
        "export.export_kpath_csv(sed, out + '/kpath.csv')\n"
        "ctrl.select_nearest(0.6, 4.0)\n"
        "ctrl.reconstruct_ised('x', char_len=2.5, n_k=8, bz_coverage=0.5, n_frames=3)\n"
        "assert ctrl.load_ised_motion()[0].shape == (3, 12, 3)\n"
        "export.export_ised_dump(ctrl.ised_dump_path, out + '/motion.dump', {'k': 0.6})\n"
        "kg = ctrl.compute_kgrid_sed('xy', (-1, 1), (-1, 1), 4, 4, max_freq=8.0)\n"
        "export.export_kgrid_csv(kg, out + '/grid.csv')\n"
        "export.export_peaks_csv(ctrl.compute_kgrid_peaks('xy', (-1, 1), (-1, 1), 4, 4), "
        "out + '/peaks.csv')\n"
        "ctrl.compute_kpath_dsf('x', n_k=8, bz_coverage=0.5)\n"
        "export.export_dsf_csv(ctrl.dsf, out + '/dsf.csv')\n"
        "ctrl.compute_liquid_curve('msd')\n"
        "export.export_liquid_csv(ctrl.liquid, out + '/msd.csv')\n"
        "export.export_npy_set(ctrl.full_kpath_sed(), out + '/npy/sed')\n"
        "ctrl.cleanup()\n"
        "for call in (lambda: export.export_kgrid_gif(kg, out + '/grid.gif'),\n"
        "             lambda: export.export_figure(object(), out + '/fig.png')):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        print('ImportError:', e)\n"
        "    else:\n"
        "        raise SystemExit('no ImportError')\n"
        f"bad = [m for m in {HEADLESS!r} if sys.modules.get(m) is not None]\n"
        "assert not bad, bad\n", blocked=HEADLESS)
    assert done.returncode == 0, done.stderr
    assert "needs the 'imageio' package" in done.stdout
    assert "needs the 'matplotlib' package" in done.stdout
    written = sorted(p.name for p in tmp_path.iterdir() if p.suffix in ('.csv', '.dump', '.txt'))
    assert written == ['chain.dump', 'dsf.csv', 'grid.csv', 'kpath.csv', 'motion.dump',
                       'motion.info.txt', 'msd.csv', 'peaks.csv']
    assert len(list((tmp_path / 'npy').iterdir())) == 4


SOURCES = sorted(str(p.relative_to(REPO)) for p in
                 [*(REPO / 'psa_tpu_torch').rglob('*.py'), REPO / 'chip_smoke.py',
                  REPO / 'chip_profile.py', REPO / 'chip_kernel_ab.py',
                  REPO / 'psa_gui_torch_launcher.py', REPO / 'bench_torch.py',
                  *(REPO / 'examples_torch').glob('*.py')])


def test_no_source_of_the_port_names_jax_or_the_jax_package():
    """No module of the port, nor a script that drives it on the card (its
    bench and examples included), has an import statement of ``jax``,
    ``jaxlib``, ``psa_tpu``, ``bench`` or ``__graft_entry__`` anywhere in it,
    function bodies included."""
    assert 'psa_tpu_torch/ops/gridded.py' in SOURCES and 'chip_smoke.py' in SOURCES
    assert {'psa_tpu_torch/parallel/sharded.py', 'psa_tpu_torch/parallel/distributed.py',
            'psa_tpu_torch/parallel/smoke.py', 'psa_tpu_torch/pod_sweep.py',
            'psa_tpu_torch/graft_entry.py', 'bench_torch.py',
            'examples_torch/basic_sed_analysis.py'} <= set(SOURCES)
    bad = []
    for rel in SOURCES:
        for node in ast.walk(ast.parse((REPO / rel).read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            bad += [(rel, n) for n in names if n.split('.')[0] in
                    ('jax', 'jaxlib', 'psa_tpu', 'bench', '__graft_entry__')]
    assert not bad, bad


def test_blocked_modules_raise_where_they_are_needed(tmp_path):
    """A YAML config or a plotter asks for the missing module by name; a
    JSON config and ``have_matplotlib`` do not."""
    (tmp_path / 'c.yaml').write_text("md_system: {dt: 0.02}\n")
    (tmp_path / 'c.json').write_text(json.dumps({'md_system': {'dt': 0.02}}))
    done = run(
        "import numpy as np\n"
        "from psa_tpu_torch import ConfigManager, SED, SEDPlotter\n"
        "from psa_tpu_torch.visualization import have_matplotlib\n"
        f"assert ConfigManager({str(tmp_path / 'c.json')!r}).get('md_system', 'dt') == 0.02\n"
        "assert not have_matplotlib()\n"
        "for build in (lambda: ConfigManager(" + repr(str(tmp_path / 'c.yaml')) + "),\n"
        "              lambda: ConfigManager().save(" + repr(str(tmp_path / 'o.yml')) + "),\n"
        "              lambda: SEDPlotter(SED(np.zeros((2, 2, 3)), np.zeros(2), np.zeros(2),\n"
        "                                     np.zeros((2, 3))), '2d_intensity', 'x.png')):\n"
        "    try:\n"
        "        build()\n"
        "    except ImportError as e:\n"
        "        print('ImportError:', e)\n"
        "    else:\n"
        "        raise SystemExit('no ImportError')\n")
    assert done.returncode == 0, done.stderr
    assert done.stdout.count('ImportError:') == 3 and 'PyYAML' in done.stdout


def test_cli_runs_a_json_config_without_yaml_or_matplotlib(tmp_path):
    """Figures are skipped, once and in the log; every data file is there."""
    config = {'md_system': {'dt': 0.02, 'nx': 12, 'ny': 1, 'nz': 1},
              'sed_calculation': {'directions': ['x'], 'n_kpoints': 8, 'bz_coverage': 0.5},
              'dos': {'apply': True}, 'timecorr': {'apply': True, 'n_lags': 8},
              'rdf': {'apply': True, 'n_bins': 10, 'max_frames': 2},
              'ised': {'apply': True,
                       'k_path': {'direction': 'x', 'characteristic_length': 2.5,
                                  'n_points': 12, 'bz_coverage': 0.5},
                       'target_point': {'k_value': 0.6, 'w_value_thz': 4.0},
                       'reconstruction': {'num_animation_timesteps': 4}}}
    (tmp_path / 'c.json').write_text(json.dumps(config))
    done = run(
        "from psa_tpu_torch.cli import main\n"
        "from psa_tpu_torch.models import make_chain_trajectory\n"
        "from psa_tpu_torch.io.writer import TrajectoryWriter\n"
        "traj = make_chain_trajectory(n_cells=12, n_frames=48, dt_ps=0.02, a=2.5, "
        "omega_max_thz=6.0)\n"
        f"out = {str(tmp_path)!r}\n"
        "import numpy as np\n"
        "with open(out + '/chain.dump', 'w') as f:\n"
        "    for t in range(traj.n_frames):\n"
        "        f.write(f'ITEM: TIMESTEP\\n{t}\\nITEM: NUMBER OF ATOMS\\n{traj.n_atoms}\\n')\n"
        "        f.write('ITEM: BOX BOUNDS pp pp pp\\n')\n"
        "        for d in range(3):\n"
        "            f.write(f'0.0 {traj.box_matrix[d, d]:.6f}\\n')\n"
        "        f.write('ITEM: ATOMS id type x y z vx vy vz\\n')\n"
        "        for a in range(traj.n_atoms):\n"
        "            row = np.concatenate([traj.positions[t, a], traj.velocities[t, a]])\n"
        "            f.write(f'{a + 1} 1 ' + ' '.join(f'{v:.6f}' for v in row) + '\\n')\n"
        "main(['--trajectory', out + '/chain.dump', '--config', out + '/c.json',\n"
        "      '--output-dir', out + '/out', '--device', 'cpu'])\n")
    assert done.returncode == 0, done.stderr
    assert done.stderr.count('figures are skipped') == 1
    written = sorted(p.name for p in (tmp_path / 'out').iterdir())
    assert written == ['dos.csv', 'ised_motion.dump', 'msd.csv', 'rdf.csv',
                       'sed_data_regular_x.freqs.npy', 'sed_data_regular_x.k_points.npy',
                       'sed_data_regular_x.k_vectors.npy', 'sed_data_regular_x.sed.npy']


def test_example_runs_without_matplotlib(tmp_path):
    """An example draws no figure where matplotlib is absent: one warning,
    and every data file written; the figures-only example says so and
    exits non-zero."""
    done = subprocess.run(
        [sys.executable, '-c', BLOCK + "import runpy\nsys.argv = ['x', '--device', 'cpu']\n"
         f"runpy.run_path({str(REPO / 'examples_torch' / 'basic_sed_analysis.py')!r}, "
         "run_name='__main__')\n"], cwd=tmp_path, timeout=300, capture_output=True, text=True)
    assert done.returncode == 0, done.stderr
    assert done.stderr.count('figures are skipped') == 1
    assert sorted(p.name for p in (tmp_path / 'sed_output').iterdir()) == [
        'chain_sed.freqs.npy', 'chain_sed.k_points.npy', 'chain_sed.k_vectors.npy',
        'chain_sed.sed.npy']
    assert 'max |peak - analytic|' in done.stdout
    done = subprocess.run(
        [sys.executable, '-c', BLOCK + "import runpy\nsys.argv = ['x', '--device', 'cpu']\n"
         f"runpy.run_path({str(REPO / 'examples_torch' / 'visualization_example.py')!r}, "
         "run_name='__main__')\n"], cwd=tmp_path, timeout=300, capture_output=True, text=True)
    assert done.returncode != 0 and 'matplotlib is not installed' in done.stderr
