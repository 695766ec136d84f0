"""``calculate``'s pinned host result and its direct readback, on a CUDA card.

Every test here is marked ``chip`` and skips without a card.  The file
imports neither JAX nor the JAX package, so on the card (which has neither)
it runs without the suite's ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pinned_result.py -q

The CPU halves of these checks (ragged chunks bit for bit, an array per
call, ``push`` into a destination) are in ``test_torch_calculator.py`` and
``test_torch_profiling.py``.
"""
import numpy as np
import pytest
import torch

from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.core import calculator as tcalc
from psa_tpu_torch.models import make_chain_trajectory
from psa_tpu_torch.utils import profiling
from psa_tpu_torch.utils.transfer import DeviceToHost

pytestmark = pytest.mark.chip


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the pinned result and its readback exist only there")
    return torch.device('cuda')


@pytest.fixture
def chain(card):
    traj = make_chain_trajectory(n_cells=32, n_frames=256, dt_ps=0.02, seed=0)
    calc = SEDCalculator(traj, nx=32, ny=1, nz=1, device=card)
    return calc, calc.get_k_path('x', bz_coverage=1.0, n_k=33)


def staging(monkeypatch, fn):
    """``fn()`` with the pinned result capped away: the path before it existed
    (a fresh ``np.zeros``, every chunk through a staging block)."""
    with monkeypatch.context() as m:
        m.setattr(tcalc, 'PINNED_RESULT_BYTES', 0)
        return fn()


@pytest.mark.parametrize('kw', [dict(), dict(summation_mode='incoherent',
                                             basis_atom_indices=[list(range(16)),
                                                                 list(range(16, 32))])],
                         ids=['coherent', 'incoherent'])
def test_one_chunk_is_pinned_read_back_directly_and_equals_staging(chain, monkeypatch, kw):
    calc, (mags, k) = chain
    before = profiling.snapshot()
    got = calc.calculate(mags, k, **kw).sed
    moved = profiling.counted_since(before)
    want = staging(monkeypatch, lambda: calc.calculate(mags, k, **kw).sed)
    assert torch.from_numpy(got).is_pinned() and not torch.from_numpy(want).is_pinned()
    assert moved['readback.direct_bytes'] == got.nbytes
    assert got.dtype == want.dtype and np.array_equal(got, want)


def test_chunks_land_in_their_slices_of_a_pinned_result(chain, monkeypatch):
    """Three chunks: the result is pinned, each chunk goes through a staging
    block (a slice of the k axis is strided), and it equals one chunk and the
    staging path bit for bit."""
    calc, (mags, k) = chain
    before = profiling.snapshot()
    got = calc.calculate(mags, k, k_chunk_size=12).sed
    assert profiling.counted_since(before).get('readback.direct_bytes', 0) == 0
    one = calc.calculate(mags, k, k_chunk_size=1000).sed
    want = staging(monkeypatch, lambda: calc.calculate(mags, k, k_chunk_size=12).sed)
    assert torch.from_numpy(got).is_pinned()
    assert np.array_equal(got, one) and np.array_equal(got, want)


def test_results_over_the_cap_keep_the_staging_path(chain, monkeypatch):
    calc, (mags, k) = chain
    want = calc.calculate(mags, k).sed
    with monkeypatch.context() as m:
        m.setattr(tcalc, 'PINNED_RESULT_BYTES', want.nbytes - 1)
        before = profiling.snapshot()
        got = calc.calculate(mags, k).sed
        assert profiling.counted_since(before).get('readback.direct_bytes', 0) == 0
    assert not torch.from_numpy(got).is_pinned() and np.array_equal(got, want)


def test_kept_results_stay_distinct_and_unchanged(chain):
    """Five results kept alive across ten more calls, on other k-sets, keep
    their blocks: no two share memory, and none changes."""
    calc, (mags, k) = chain
    kept = [calc.calculate(mags, k + 0.01 * i).sed for i in range(5)]
    copies = [a.copy() for a in kept]
    for i in range(10):
        calc.calculate(mags, k - 0.01 * (i + 1))
    assert not any(np.shares_memory(a, b) for i, a in enumerate(kept) for b in kept[i + 1:])
    assert all(np.array_equal(a, c) for a, c in zip(kept, copies))


def test_push_into_a_pinned_destination_counts_it(card):
    src = torch.randn(64, 5, 3, dtype=torch.complex64, device=card)
    dst = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    readback, seen = DeviceToHost(card), []
    before = profiling.snapshot()
    readback.push([src], seen.append, into=[dst])
    readback.finish()
    assert profiling.counted_since(before) == {'dtoh_bytes': src.nbytes,
                                               'readback.direct_bytes': src.nbytes}
    assert torch.equal(dst, src.cpu()) and np.shares_memory(seen[0][0], dst.numpy())
