"""Running one example through both packages, for the ``test_torch_examples_*`` files.

The JAX script ``examples/<name>.py`` runs from a copy in a temporary
directory (``runpy.run_path``; its module globals are what it computed), the
port's ``examples_torch.<name>.main(device='cpu')`` in another, each with
that directory as the working directory, so nothing is written into the tree.
Both print their physics checks; :func:`assert_same_checks` holds the two
outputs to the same lines, each number within the place it was printed to.
"""
import importlib
import re
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))      # examples_torch, whatever the working directory
TOL = 1e-6
RESIDUE = 1e-5
#: Lines that name a written file, not a check.
FILE_LINE = re.compile(r'^(wrote |plot: |outputs in )')
NUMBER = re.compile(r'[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?')


def run_jax(name, tmp_path, monkeypatch, capsys, run_name='<run_path>'):
    """(module globals, stdout) of the JAX example run from a copy."""
    work = tmp_path / 'jax'
    work.mkdir()
    script = work / f'{name}.py'
    shutil.copy(REPO / 'examples' / f'{name}.py', script)
    monkeypatch.chdir(work)
    capsys.readouterr()
    found = runpy.run_path(str(script), run_name=run_name)
    return found, capsys.readouterr().out


def run_port(name, tmp_path, monkeypatch, capsys):
    """(the returned key arrays, stdout) of the port's ``main(device='cpu')``."""
    work = tmp_path / 'port'
    work.mkdir()
    monkeypatch.chdir(work)
    capsys.readouterr()
    found = importlib.import_module(f'examples_torch.{name}').main(device='cpu')
    return found, capsys.readouterr().out


def run_both(name, tmp_path, monkeypatch, capsys):
    """(the port's key arrays, the JAX script's globals) of one example run
    through both packages, their printed checks and written files held to
    each other."""
    want, jax_out = run_jax(name, tmp_path, monkeypatch, capsys)
    got, port_out = run_port(name, tmp_path, monkeypatch, capsys)
    assert_same_checks(port_out, jax_out)
    assert written(tmp_path / 'port') == written(tmp_path / 'jax')
    return got, want


def checks(text):
    """[(line with its numbers as '#', [numbers as printed])] of the check lines."""
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line and not FILE_LINE.match(line):
            out.append((NUMBER.sub('#', line), NUMBER.findall(line)))
    return out


def last_place(s):
    """One unit in the last printed place of the number ``s``."""
    mant, _, exp = s.lower().partition('e')
    decimals = len(mant.partition('.')[2])
    return 10.0 ** (int(exp or 0) - decimals)


def assert_same_checks(port_out, jax_out):
    """The same check lines; each number equal to the place it was printed
    to, but for residues (an engine's disagreement, a leakage): two numbers
    both below ``RESIDUE`` are each package's float32 rounding and pass."""
    got, want = checks(port_out), checks(jax_out)
    assert [t for t, _ in got] == [t for t, _ in want], (port_out, jax_out)
    for (line, g_nums), (_, w_nums) in zip(got, want):
        for g, w in zip(g_nums, w_nums):
            g_f, w_f = float(g), float(w)
            if abs(g_f) < RESIDUE and abs(w_f) < RESIDUE:
                continue
            assert abs(g_f - w_f) <= max(last_place(g), last_place(w)) * 1.0001, (line, g, w)


def written(work):
    """Names of the files under ``work/sed_output``, relative to it."""
    root = work / 'sed_output'
    return sorted(str(p.relative_to(root)) for p in root.rglob('*') if p.is_file())


def assert_close(got, want, what, tol=TOL, scale=None):
    """max|got − want| ≤ tol · (scale or max|want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = float(np.abs(want).max()) if scale is None else scale
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * scale, f"{what}: {err:.3e} > {tol} x {scale:.3e}"


def assert_strong_phase(got, want, z1, z2, what):
    """Phases of the pair (z1, z2) within 1e-4 rad where both components'
    power is above 1e-3 of the pair's largest (below that the phase of a
    rounding residue would be compared)."""
    p1, p2 = np.abs(z1) ** 2, np.abs(z2) ** 2
    strong = np.minimum(p1, p2) > 1e-3 * (p1 + p2).max()
    assert strong.any()
    assert_close(got[strong], want[strong], what, tol=1e-4, scale=1.0)


def dump_coords(path):
    rows = [ln.split() for ln in Path(path).read_text().splitlines()]
    return np.array([r for r in rows if len(r) == 5], dtype=float)
