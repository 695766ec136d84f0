"""psa_tpu_torch's precision tiers of the projection kernel on the CPU.

'parity' is 3xTF32 with IEEE float32 sums, 'balanced' 3xBF16, 'fast' one
TF32 product.  On the CPU each tier runs its plain version, which rounds
the operands as the kernel does; the kernels themselves run only in
``chip_smoke.py``.  Bars of max against the float64 oracle: parity 1e-6,
balanced 5e-5, fast 5e-3.  The JAX package on the CPU ignores
``precision`` (its result is parity), so it is held to the same bars.
Every surface that takes a tier passes it to every projection it makes,
and the shard-cache key carries it.
"""
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu_torch.core import calculator as tcalc
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.ops import sed_projection as tproj
from psa_tpu_torch.ops import spectral as tspec

from conftest import reference_sed_oracle
from test_npt import _npt_traj

torch.set_num_threads(1)

BARS = {'parity': 1e-6, 'balanced': 5e-5, 'fast': 5e-3}
N_T, DT = 16, 0.02


def of_max(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.fixture(scope='module')
def crystal():
    return make_random_crystal_trajectory(n_cells_xyz=(3, 2, 2), basis=2, n_frames=N_T,
                                          dt_ps=DT, seed=11)


@pytest.fixture(scope='module')
def kv(crystal):
    calc = JaxCalculator(crystal, nx=3, ny=2, nz=2)
    return calc.get_k_grid('xy', (-1, 1), (-1, 1), 5, 4)[1]


@pytest.fixture(scope='module')
def oracle(crystal, kv):
    return reference_sed_oracle(crystal, kv)


def pair(traj, precision, nx=3, ny=2, nz=2, **kw):
    ref = JaxCalculator(traj, nx=nx, ny=ny, nz=nz, precision=precision, **kw)
    return ref, from_reference_calculator(ref, device='cpu')


@pytest.mark.parametrize('tier', list(BARS))
def test_calculate_meets_the_tier_bar(crystal, kv, oracle, tier):
    ref, port = pair(crystal, tier)
    assert port.precision == tier
    got = port.calculate(np.linalg.norm(kv, axis=1), kv, k_chunk_size=7).sed
    assert of_max(got, oracle) < BARS[tier]
    assert of_max(got, ref.calculate(np.linalg.norm(kv, axis=1), kv).sed) < BARS[tier]


@pytest.mark.parametrize('tier', ['balanced', 'fast'])
def test_tier_is_not_parity(crystal, kv, tier):
    """The plain tiers round their operands: they differ from parity by
    more than parity's own error, within their bar."""
    _, par = pair(crystal, 'parity')
    _, low = pair(crystal, tier)
    a = par.calculate(np.linalg.norm(kv, axis=1), kv).sed
    b = low.calculate(np.linalg.norm(kv, axis=1), kv).sed
    assert BARS['parity'] < of_max(b, a) < BARS[tier]


@pytest.mark.parametrize('tier', list(BARS))
def test_ops_tier_against_the_oracle(tier):
    rng = np.random.default_rng(3)
    data = rng.normal(size=(12, 300, 3)).astype(np.float32)
    mean64 = rng.uniform(0, 40.0, size=(300, 3))
    hi, lo = tspec.split_f64(mean64)
    kv = rng.uniform(-2, 2, size=(9, 3)).astype(np.float32)
    spec = tspec.sed_spectrum(*(torch.from_numpy(x) for x in (data, hi, lo, kv)),
                              precision=tier).numpy()
    s = np.einsum('tac,ka->tkc', data.astype(np.float64),
                  np.exp(1j * (kv.astype(np.float64) @ mean64.T)))
    assert of_max(spec, np.fft.fft(s, axis=0) / 12) < BARS[tier]


def test_plain_tiers_block_the_atoms(monkeypatch):
    """The tiers' plain versions sum atom blocks (their copies of the data
    stay small): blocks of 7 atoms give the one-block result."""
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(x) for x in (
        rng.normal(size=(6, 50, 3)).astype(np.float32),
        *tspec.split_f64(rng.uniform(0, 9, size=(50, 3))),
        rng.uniform(-2, 2, size=(5, 3)).astype(np.float32))]
    for tier in ('balanced', 'fast'):
        whole = tproj.sed_projection_plain(*args, precision=tier)
        monkeypatch.setattr(tproj, 'PLAIN_BLOCK_ELEMS', 7 * 3 * 6)
        blocked = tproj.sed_projection_plain(*args, precision=tier)
        monkeypatch.undo()
        for w, b in zip(whole, blocked):
            assert of_max(b.numpy(), w.numpy()) < 1e-6


def test_invalid_tier_raises(crystal):
    with pytest.raises(ValueError, match="precision"):
        tcalc.SEDCalculator(crystal, nx=3, ny=2, nz=2, precision='bogus', device='cpu')
    x = torch.zeros((2, 3, 3))
    with pytest.raises(ValueError, match="precision"):
        tproj.sed_projection(x, x[0], x[0], x[0], precision='half')


@pytest.mark.parametrize('tier', ['balanced', 'fast'])
def test_every_surface_passes_the_tier(crystal, kv, tier, monkeypatch):
    """Each projection of calculate (resident and streamed), the grid
    reductions, Welch and the NPT family runs at the calculator's tier."""
    seen = []
    real = tcalc.sed_projection

    def spy(*args, **kwargs):
        seen.append(kwargs.get('precision'))
        return real(*args, **kwargs)
    monkeypatch.setattr(tcalc, 'sed_projection', spy)
    _, port = pair(crystal, tier)
    km = np.linalg.norm(kv, axis=1)
    port.calculate(km, kv, k_chunk_size=7)
    port.calculate_kgrid_browse(kv, k_chunk_size=7)
    port.calculate_kgrid_peaks(kv, n_peaks=2, k_chunk_size=7)
    port.calculate_lt(kv)
    port.calculate_welch(km, kv, segments=2)
    _, stream = pair(crystal, tier, max_device_bytes=1000)
    streamed = stream.calculate(km, kv, k_chunk_size=7).sed
    assert stream.streamed_bytes > 0
    _, npt = pair(_npt_traj(1.0 + 0.02 * np.sin(np.linspace(0, 6, 32)), n_frames=32), tier,
                  nx=16, ny=1, nz=1)
    npt.calculate_npt(np.stack([np.arange(1, 5), np.zeros(4), np.zeros(4)], axis=1))
    assert len(seen) > 10 and set(seen) == {tier}
    assert of_max(streamed, reference_sed_oracle(crystal, kv)) < BARS[tier]


def test_shard_cache_keys_the_tier(crystal, kv, tmp_path):
    """A cache written at one tier is not resumed at another."""
    km = np.linalg.norm(kv, axis=1)
    _, par = pair(crystal, 'parity')
    _, fast = pair(crystal, 'fast')
    a = par.calculate(km, kv, k_chunk_size=7, cache_dir=tmp_path).sed
    b = fast.calculate(km, kv, k_chunk_size=7, cache_dir=tmp_path).sed
    assert of_max(b, a) > BARS['parity']
    assert len({p.parent.name for p in tmp_path.glob('*/chunk_*.npy')}) == 2
    np.testing.assert_array_equal(fast.calculate(km, kv, k_chunk_size=7,
                                                 cache_dir=tmp_path).sed, b)


@pytest.mark.parametrize('tier', ['balanced', 'fast'])
def test_cpu_tensor_takes_the_plain_version(tier):
    """A CPU tensor runs the tier's plain version and counts no launch."""
    x = torch.zeros((2, 4, 3))
    before = tproj.kernel_launches()
    tproj.sed_projection(x, x[0], x[0], x[0, :3], precision=tier)
    assert tproj.kernel_launches() == before
