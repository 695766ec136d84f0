"""psa_tpu_torch.graft_entry against the JAX package's ``__graft_entry__``:
``entry('cpu')``'s forward step against the JAX step on the same seeded
inputs to 1e-6 of max, and ``dryrun_multichip`` on virtual meshes of 1, 2,
4 and 8 CPU positions (the JAX dry run's composite shapes), its extended
tier at 8.  On the CPU every shard projects through the kernel's wrapper,
which runs the plain version; the wrapper is counted to show it."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as jax_graft  # noqa: E402
from psa_tpu_torch import graft_entry  # noqa: E402
from psa_tpu_torch.parallel import sharded  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture
def projections(monkeypatch):
    """Count the mesh's projections (the CPU launches no kernel)."""
    calls = []
    real = sharded.sed_projection

    def counted(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)
    monkeypatch.setattr(sharded, 'sed_projection', counted)
    return calls


def test_entry_matches_the_jax_forward_step():
    fn, args = graft_entry.entry('cpu')
    jfn, jargs = jax_graft.entry()
    assert [tuple(a.shape) for a in args] == [a.shape for a in jargs]
    for a, j in zip(args, jargs):
        assert a.device.type == 'cpu'
        np.testing.assert_array_equal(a.numpy(), j)
    got = fn(*args)
    assert got.dtype == torch.complex64 and tuple(got.shape) == (128, 64, 3)
    re, im = jax.jit(jfn)(*jargs)
    want = np.asarray(re) + 1j * np.asarray(im)
    assert np.abs(got.numpy() - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("n, shape", [(1, (1, 1, 1)), (2, (2, 1, 1)), (4, (2, 1, 2)),
                                      (8, (2, 2, 2))])
def test_dryrun_multichip(n, shape, projections, capsys):
    assert graft_entry.mesh_shape(n) == shape
    graft_entry.dryrun_multichip(n, device='cpu')
    out = capsys.readouterr().out
    assert f"mesh {dict(zip('tak', shape))} over {n} positions of cpu OK" in out
    assert projections   # every shard through the kernel's wrapper


def test_dryrun_multichip_full_tier(projections, capsys):
    graft_entry.dryrun_multichip(8, full=True, device='cpu')
    assert '+ extended' in capsys.readouterr().out


def test_entry_points_run_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        graft_entry.dryrun_multichip(1)
