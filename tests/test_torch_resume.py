"""Kill-and-resume of psa_tpu_torch's sweeps through the per-k-chunk shard
cache (``cache_dir`` on ``calculate``, ``calculate_kgrid_browse`` and
``calculate_kgrid_peaks``), and resume across packages.

The CPU runs the kernel's plain version, which counts no launches, so the
projections a run computes are counted by wrapping the calculator's
``sed_projection``.  Each surface gets: a full-cache replay (no projection,
bitwise equal), a deleted chunk (exactly that chunk's projections, bitwise
equal), a corrupt chunk (recomputed), and keys that separate what differs.
A cache written by the JAX package resumes in the port and the other way
round: the keys and the chunk layout are the same.
"""
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu_torch.core import calculator as tcalc
from psa_tpu_torch.core.convert import from_reference_calculator

torch.set_num_threads(1)


@pytest.fixture(scope='module')
def crystal():
    return make_random_crystal_trajectory(n_cells_xyz=(3, 3, 2), basis=2, n_frames=20,
                                          dt_ps=0.02, seed=3)


@pytest.fixture(scope='module')
def kv():
    return np.outer(np.linspace(0.1, 1.4, 12), [1, 0.3, 0]).astype(np.float32)


@pytest.fixture
def pair(crystal):
    ref = JaxCalculator(crystal, nx=3, ny=3, nz=2)
    return ref, from_reference_calculator(ref, device='cpu')


@pytest.fixture
def count(monkeypatch):
    """Number of projections the calculator computes (one per group and chunk)."""
    calls = [0]
    real = tcalc.sed_projection

    def counted(*args, **kw):
        calls[0] += 1
        return real(*args, **kw)
    monkeypatch.setattr(tcalc, 'sed_projection', counted)
    return calls


def chunk_files(root, idx=None):
    pattern = '*/chunk_*.npy' if idx is None else f'*/chunk_{idx:05d}.npy'
    return sorted(root.glob(pattern))


# the same calls run on either package's calculator
RUNS = {
    'calculate': lambda c, kv, d: c.calculate(np.zeros(len(kv)), kv, k_chunk_size=4,
                                              cache_dir=d).sed,
    'calculate_incoherent': lambda c, kv, d: c.calculate(
        np.zeros(len(kv)), kv, k_chunk_size=4, summation_mode='incoherent',
        basis_atom_types=[1, 2], cache_dir=d).sed,
    'browse': lambda c, kv, d: c.calculate_kgrid_browse(kv, k_chunk_size=4, cache_dir=d)[1],
    'browse_chiral': lambda c, kv, d: np.stack(c.calculate_kgrid_browse(
        kv, k_chunk_size=4, chiral=True, cache_dir=d)[1:]),
    'peaks': lambda c, kv, d: np.stack(c.calculate_kgrid_peaks(kv, n_peaks=2, k_chunk_size=4,
                                                               cache_dir=d)),
}
GROUPS = {'calculate_incoherent': 2}


@pytest.mark.parametrize('surface', sorted(RUNS))
def test_replay_and_partial_recompute(pair, kv, tmp_path, count, surface):
    _, port = pair
    run = RUNS[surface]
    first = run(port, kv, tmp_path)
    per_chunk = GROUPS.get(surface, 1)
    assert count[0] == 3 * per_chunk and len(chunk_files(tmp_path)) == 3
    count[0] = 0
    np.testing.assert_array_equal(run(port, kv, tmp_path), first)
    assert count[0] == 0                                    # full replay: nothing computed
    chunk_files(tmp_path, 1)[0].unlink()                    # "killed" before chunk 1 landed
    np.testing.assert_array_equal(run(port, kv, tmp_path), first)
    assert count[0] == per_chunk                            # exactly chunk 1 again
    np.testing.assert_array_equal(run(port, kv, None), first)   # no cache: the same numbers


@pytest.mark.parametrize('surface', ['calculate', 'browse', 'peaks'])
def test_corrupt_chunk_recomputed(pair, kv, tmp_path, count, surface):
    _, port = pair
    first = RUNS[surface](port, kv, tmp_path)
    chunk_files(tmp_path, 2)[0].write_bytes(b'truncated write')
    count[0] = 0
    np.testing.assert_array_equal(RUNS[surface](port, kv, tmp_path), first)
    assert count[0] == 1
    np.load(chunk_files(tmp_path, 2)[0])                    # rewritten whole


@pytest.mark.parametrize('change', ['k_chunk_size', 'k_vectors', 'mode', 'displacements',
                                    'welch', 'readback', 'n_peaks', 'observable'])
def test_keys_separate(pair, kv, tmp_path, change):
    _, port = pair
    base = dict(k_chunk_size=4, cache_dir=tmp_path)
    port.calculate_kgrid_browse(kv, **base)
    kw, call = dict(base), port.calculate_kgrid_browse
    if change == 'k_chunk_size':
        kw['k_chunk_size'] = 5
    elif change == 'k_vectors':
        kv = kv * 1.01
    elif change == 'mode':
        kw.update(summation_mode='incoherent', basis_atom_types=[1, 2])
    elif change == 'displacements':
        port.use_displacements = True
    elif change == 'welch':
        kw['welch_segments'] = 2
    elif change == 'readback':
        kw['readback_dtype'] = 'float16'
    elif change == 'n_peaks':
        port.calculate_kgrid_peaks(kv, n_peaks=1, **base)
        kw['n_peaks'], call = 2, port.calculate_kgrid_peaks
    else:
        call = port.calculate_kgrid_peaks
    call(kv, **kw)
    keys = {p.parent.name for p in chunk_files(tmp_path)}
    assert len(keys) == (3 if change == 'n_peaks' else 2)


def test_oversize_peaks_checkpoint(pair, kv, tmp_path, count):
    """An oversize group streams into the same on-device peak reduction as a
    resident one, and its peaks are checkpointed and resumed per chunk."""
    ref, port = pair
    port.max_device_bytes = 1000
    first = port.calculate_kgrid_peaks(kv, n_peaks=2, k_chunk_size=4, cache_dir=tmp_path)
    assert len(chunk_files(tmp_path)) == 3 and port.streamed_bytes > 0
    chunk_files(tmp_path, 1)[0].unlink()
    count[0] = 0
    again = port.calculate_kgrid_peaks(kv, n_peaks=2, k_chunk_size=4, cache_dir=tmp_path)
    n = ref.traj.n_atoms
    assert count[0] == -(-n // port.stream_block_atoms(n))   # chunk 1, every atom block
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)


def _poison(ref):
    """Any computation by the JAX calculator after this raises."""
    ref._group_device_arrays = None
    ref._streamed_spectrum = None
    return ref


@pytest.mark.parametrize('surface', sorted(RUNS))
def test_jax_cache_resumes_in_port(pair, kv, tmp_path, count, surface):
    ref, port = pair
    want = RUNS[surface](ref, kv, tmp_path)
    chunk_files(tmp_path, 1)[0].unlink()
    got = RUNS[surface](port, kv, tmp_path)
    assert count[0] == GROUPS.get(surface, 1)               # only the missing chunk
    assert len({p.parent.name for p in chunk_files(tmp_path)}) == 1
    if surface == 'calculate':                              # (n_t, n_k, 3): k last
        got, want = np.moveaxis(got, 1, -1), np.moveaxis(want, 1, -1)
    np.testing.assert_array_equal(got[..., :4], want[..., :4])
    np.testing.assert_array_equal(got[..., 8:], want[..., 8:])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize('surface', sorted(RUNS))
def test_port_cache_resumes_in_jax(pair, kv, tmp_path, surface):
    ref, port = pair
    want = RUNS[surface](port, kv, tmp_path)
    got = RUNS[surface](_poison(ref), kv, tmp_path)
    np.testing.assert_array_equal(got, want)
