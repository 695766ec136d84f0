"""Import hygiene of psa_tpu_torch: the package, its command line, its
config manager and its plotter import with ``jax``, ``psa_tpu``, ``yaml`` and
``matplotlib`` all absent (blocked in ``sys.modules`` in a subprocess), and
the command line then runs a JSON-configured SED with its figures skipped
and its data written."""
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
           'psa_tpu_torch.ops.timecorr', 'psa_tpu_torch.ops.structure']


def run(code, **kwargs):
    return subprocess.run([sys.executable, '-c', BLOCK + code], cwd=REPO, timeout=300,
                          capture_output=True, text=True, **kwargs)


@pytest.mark.parametrize("module", MODULES)
def test_module_imports_with_everything_optional_blocked(module):
    done = run(f"import {module}\n"
               "bad = [m for m in ('jax', 'psa_tpu', 'yaml', 'matplotlib') "
               "if sys.modules.get(m) is not None]\n"
               "assert not bad, bad\n")
    assert done.returncode == 0, done.stderr


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
