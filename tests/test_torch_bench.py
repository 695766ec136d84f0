"""bench_torch.py, the port's benchmark entry point, on the CPU at a tiny size.

Run as a command with ``PSA_BENCH_DEVICE=cpu`` (2,000 atoms x 256 steps, an
8x8 grid, the NumPy baseline on 64 steps x 2 k-points): one JSON line with
bench.py's keys plus ``device``; its op sweep against the JAX package's
``sed_spectrum`` on the same seeded data to 1e-6 of max; the signal contract
(a SIGTERM after the provisional headline prints it and exits 0, one before
any measurement prints nothing and exits 1); without a card and without
``PSA_BENCH_DEVICE`` it fails before measuring; and the JAX bench's sidecars
under ``scripts/tpu_campaign/`` are left byte for byte as they were.
"""
import hashlib
import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import bench_torch  # noqa: E402
from psa_tpu.ops import spectral as jax_spectral  # noqa: E402

SMALL = {'PSA_BENCH_DEVICE': 'cpu', 'PSA_BENCH_ATOMS': '2000', 'PSA_BENCH_STEPS': '256',
         'PSA_BENCH_GRID': '8', 'PSA_BENCH_BASELINE_K': '2', 'PSA_BENCH_BASELINE_T': '64',
         'PSA_BENCH_KBLOCK': '24'}
KEYS = {'metric', 'value', 'unit', 'vs_baseline', 'compile_s', 'headline_user', 'device'}


def bench_env(tmp_path, **knobs):
    env = {k: v for k, v in os.environ.items() if not k.startswith('PSA_BENCH_')}
    return dict(env, PSA_BENCH_OUT_DIR=str(tmp_path), OMP_NUM_THREADS='2', **knobs)


def run_bench(tmp_path, **knobs):
    return subprocess.run([sys.executable, str(REPO / 'bench_torch.py')], cwd=tmp_path,
                          env=bench_env(tmp_path, **knobs), capture_output=True, text=True,
                          timeout=300)


def campaign_sidecars():
    return {p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((REPO / 'scripts' / 'tpu_campaign').glob('*.json'))}


def test_one_json_line_with_the_headline_keys(tmp_path):
    before = campaign_sidecars()
    done = run_bench(tmp_path, **SMALL)
    assert done.returncode == 0, done.stderr
    lines = done.stdout.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert set(line) == KEYS
    assert line['value'] > 0 and line['vs_baseline'] > 0 and line['compile_s'] > 0
    assert line['unit'] == 'k-points/sec' and line['device'] == 'cpu'
    assert 'device=cpu' in line['metric'] and '8x8 grid' in line['metric']
    user = line['headline_user']
    assert set(user) == {'metric', 'value', 'unit', 'first_s'} and user['value'] > 0
    assert 'provisional headline after the first block' in done.stderr   # 3 blocks
    kept = json.loads((tmp_path / bench_torch.BASELINE_SIDECAR).read_text())
    assert [k.split('@')[0] for k in kept] == ['2000x256']
    assert campaign_sidecars() == before


def test_op_sweep_matches_the_jax_sed_spectrum():
    n_t, n_atoms = 64, 300
    data = torch.randn((n_t, n_atoms, 3), generator=torch.Generator('cpu').manual_seed(0))
    mean64 = bench_torch.si_mean_positions(n_atoms)
    hi, lo = jax_spectral.split_f64(mean64)
    k = bench_torch.grid_k_vectors(4)                     # 16 k in blocks of 5, 5, 5, 1
    sweep = bench_torch.op_sweep(data, torch.from_numpy(np.asarray(hi)),
                                 torch.from_numpy(np.asarray(lo)), torch.from_numpy(k),
                                 block=5, keep=np.arange(len(k)))
    assert sweep.launches == 5 and sweep.sweep_s > 0
    re, im = jax_spectral.sed_spectrum(data.numpy(), hi, lo, k)
    want = np.asarray(re) + 1j * np.asarray(im)
    got = sweep.kept.numpy()
    assert got.dtype == np.complex64 and got.shape == want.shape == (n_t, len(k), 3)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


def start_bench(tmp_path, **knobs):
    return subprocess.Popen([sys.executable, str(REPO / 'bench_torch.py')], cwd=tmp_path,
                            env=bench_env(tmp_path, **knobs), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def stop_when(proc, text):
    """SIGTERM ``proc`` once its stderr shows ``text``; (rc, stdout, stderr)."""
    seen = []
    for line in proc.stderr:
        seen.append(line)
        if text in line:
            proc.send_signal(signal.SIGTERM)
            break
    out, err = proc.communicate(timeout=120)
    return proc.returncode, out, ''.join(seen) + err


def test_sigterm_after_the_first_block_prints_the_provisional_headline(tmp_path):
    # 128 blocks of 2 k-points over 20,000 atoms: the sweep outlasts the signal
    proc = start_bench(tmp_path, **dict(SMALL, PSA_BENCH_ATOMS='20000', PSA_BENCH_GRID='16',
                                        PSA_BENCH_KBLOCK='2'))
    rc, out, err = stop_when(proc, 'provisional headline')
    assert rc == 0, err
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert 'provisional (first block only)' in line['metric'] and line['value'] > 0
    assert "signal 15 during stage 'timed sweep'" in err


def test_sigterm_before_any_measurement_prints_nothing(tmp_path):
    proc = start_bench(tmp_path, **SMALL)
    rc, out, err = stop_when(proc, 'bench_torch:')
    assert rc == 1, err
    assert out == ''
    assert 'nothing (no measurement yet)' in err


def test_no_card_fails_before_measuring(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    knobs = {k: v for k, v in SMALL.items() if k != 'PSA_BENCH_DEVICE'}
    done = run_bench(tmp_path, **knobs)
    assert done.returncode != 0
    assert done.stdout == ''
    assert 'CUDA is not available' in done.stderr
    assert not (tmp_path / bench_torch.BASELINE_SIDECAR).exists()
