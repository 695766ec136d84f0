"""The basis cell's own pieces: the wurtzite sites, the reference of the
published SED (``reference/sed_basis.py``), the reader of the resident
share, and the faults only a basis sweep can have: a basis group left out of
the sum, and the √m weights left out.  Each fault must make ``correct``
false at the cell's small sizes on the CPU."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import cell, trace
from benchmark.reference import sed, sed_basis, wurtzite
from benchmark.systems import wurtzite_waves

CELL = 'gan100k.basis_kgrid_peaks'
SEED = 2**31 + 4099


@pytest.mark.parametrize('fault', ['leave_out_group', 'drop_mass_weights'])
def test_a_basis_fault_is_not_correct(fault, tiny, monkeypatch):
    getattr(wurtzite_waves, fault)(monkeypatch)
    r = cell.run_cell(CELL, SEED, 0.2, False, device='cpu', overrides=tiny[CELL])
    assert not r['correct'], (fault, r['checks'])
    assert r['checks']['peak_height_err']['value'] > 1e-2


def test_the_basis_reference_loads_nothing_of_the_program():
    code = ("import json, sys; sys.path.insert(0, '.')\n"
            "import benchmark.reference.sed_basis, benchmark.reference.wurtzite\n"
            "import benchmark.surfaces.kgrid_peaks_basis, benchmark.systems.wurtzite_waves\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, '-c', code], cwd=cell.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert not tops & {'jax', 'jaxlib', 'flax', 'psa_tpu', 'psa_tpu_torch'}


def test_wurtzite_sites():
    a, c, u = 3.189, 5.185, 0.377
    pos, site = wurtzite.sites((3, 2, 2), a, c, u)
    assert pos.shape == (96, 3) and np.array_equal(site[:8], [0, 1, 2, 3, 0, 1, 2, 3])
    for s in range(4):
        assert np.array_equal(np.flatnonzero(site == s), np.arange(s, 96, 4))
    box = wurtzite.box_lengths((3, 2, 2), a, c)
    assert np.all(pos >= 0) and np.all(pos < box)
    # every cation has its anion u·c above it and three more at the tetrahedron's base
    d = pos[site >= 2][None] - pos[site < 2][:, None]
    d -= box * np.rint(d / box)
    near = np.sort(np.linalg.norm(d, axis=-1), axis=1)[:, :5]
    base = np.sqrt(a ** 2 / 3 + ((0.5 - u) * c) ** 2)
    np.testing.assert_allclose(near[:, :4], np.sort([u * c] + [base] * 3) * np.ones((48, 1)),
                               rtol=1e-12)
    assert np.all(near[:, 4] > 3.0)
    assert len(np.unique(np.round(pos, 9), axis=0)) == 96


def test_one_group_of_unit_masses_is_the_coherent_reference():
    rng = np.random.default_rng(1)
    data = rng.normal(size=(32, 24, 3)).astype(np.float32)
    sites = rng.uniform(0, 10, size=(24, 3))
    k = rng.uniform(-2, 2, size=(7, 3)).astype(np.float32)
    got = sed_basis.power(data, sites, np.ones(24), [np.arange(24)], k)
    spec = sed.spectrum(*sed.projection(data, sites, k))
    want = (spec.real.double() ** 2 + spec.imag.double() ** 2).sum(dim=-1)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=0)
    # two groups with masses: the sum of each group's weighted spectrum
    masses = rng.uniform(1, 70, 24)
    split = [np.arange(0, 24, 2), np.arange(1, 24, 2)]
    parts = sum(sed_basis.power(data * np.sqrt(masses)[None, :, None], sites, np.ones(24), [g], k)
                for g in split)
    torch.testing.assert_close(sed_basis.power(data, sites, masses, split, k), parts,
                               rtol=1e-12, atol=0)


def test_the_lorentzian_width_of_a_lorentzian_line():
    df, gamma = 0.005, 0.0123
    freqs = np.arange(400) * df
    centres = np.array([100, 250, 3])
    inten = torch.as_tensor(7.0 / (1 + ((freqs[:, None] - centres * df) / gamma) ** 2))
    f, h, w = sed_basis.lorentzian_peaks(inten, freqs, df, 1, 4)
    np.testing.assert_allclose(w[0].numpy(), 2 * gamma, rtol=1e-9)
    np.testing.assert_allclose(f[0].numpy(), centres * df)
    np.testing.assert_allclose(h[0].numpy(), 7.0)
    flat = torch.ones((50, 1), dtype=torch.float64)            # no peak shape: the cap
    assert sed_basis.lorentzian_peaks(flat, np.arange(50) * df, df, 1, 4)[2][0, 0] == 8 * df


def test_resident_share_reader():
    read = cell.module('metrics', 'basis_resident_share').read
    tr = trace.Trace(window=(0.0, 1.0))
    counters = {'groups.requested_bytes': 1000, 'groups.resident_bytes': 750}
    assert read(tr, {'n_calls': 3, 'work': [], 'counters': counters}) == 0.75
    assert read(tr, {'n_calls': 3, 'work': [],
                     'counters': {'groups.requested_bytes': 1000}}) == 0.0
    assert read(tr, {'n_calls': 3, 'work': [], 'counters': {}}) is None
    assert read(tr, {'n_calls': 0, 'work': [], 'counters': counters}) is None
