"""The 'balanced' and 'fast' tiers of the projection: table, tiles, atom blocks.

On the card these tiers run two kernels (``psa_tpu_torch/csrc/
sed_projection_tiers.cu``): the table kernel writes the tier's split
[cos | sin] table once per call, in the product kernel's tile layout, into a
scratch of at most ``TABLE_CAP_BYTES``; past the cap the atom axis goes in
blocks, the later ones added through ``accumulate``.  The kernels run only
on the card (``chip_smoke.py`` phase 5d); here the wrappers take their plain
versions, and these tests hold what surrounds the kernels: the block plan,
the tile layout against the kernel's byte formula, the blocked sum against
the unblocked one (1e-6 of max), and the port at each tier against the JAX
package's ``sed_spectrum`` and the float64 oracle at the tier's bar.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psa_tpu.models import make_random_crystal_trajectory
from psa_tpu.ops import spectral as jspec
from psa_tpu_torch.ops import sed_projection as tproj
from psa_tpu_torch.ops import spectral as tspec

from conftest import reference_sed_oracle

torch.set_num_threads(1)

SOURCE = Path(__file__).resolve().parents[1] / 'psa_tpu_torch' / 'csrc' / 'sed_projection_tiers.cu'
BARS = {'balanced': 5e-5, 'fast': 5e-3}


def source_constant(name):
    return int(re.search(rf'constexpr int {name} = (\d+);', SOURCE.read_text()).group(1))


def of_max(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def problem(n_t, n_atoms, n_k, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.normal(size=(n_t, n_atoms, 3)).astype(np.float32)
    hi, lo = tspec.split_f64(rng.uniform(0, 40.0, size=(n_atoms, 3)))
    kv = rng.uniform(-2, 2, size=(n_k, 3)).astype(np.float32)
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in (data, hi, lo, kv))


def b_byte(al, n, precision):
    """``sed_projection_tiers.cu::b_byte``: byte of atom ``al`` and column
    ``n`` in one tile."""
    katoms, elem, parts = (16, 2, 2) if precision == 'balanced' else (8, 4, 1)
    core = 16 // elem
    ks, a = divmod(al, katoms)
    return (ks * parts * 2 + a // core) * 2048 + (n // 8) * 128 + (n % 8) * 16 + (a % core) * elem


def test_tile_constants_match_the_kernel():
    assert tproj.TABLE_ATOMS == source_constant('BA')
    assert tproj.TABLE_K == source_constant('BK')
    assert tproj.TABLE_K * 2 == 128 and tproj.TABLE_TILE_BYTES == tproj.TABLE_ATOMS * 128 * 4
    assert source_constant('SUM_ATOMS') % source_constant('BA') == 0


@pytest.mark.parametrize('n_atoms,n_k,stages', [(100_000, 500, None), (1, 1, 1), (32, 64, 1),
                                                (33, 65, 1), (1000, 77, 3), (5003, 201, 7),
                                                (100_000, 1280, None), (64, 500, 2)])
def test_atom_blocks_cover_every_atom_once(n_atoms, n_k, stages):
    """Blocks are whole stages but the last, cover each atom once in order,
    and each block's table fits the cap; the default cap takes the working
    chunk and the peaks chunks of 1,280 k in one block."""
    cap = None if stages is None else tproj.table_bytes(stages * tproj.TABLE_ATOMS, n_k)
    blocks = tproj.atom_blocks(n_atoms, n_k, cap)
    assert blocks[0][0] == 0 and blocks[-1][1] == n_atoms
    assert all(a1 == b0 for (_, a1), (b0, _) in zip(blocks, blocks[1:]))
    limit = tproj.TABLE_CAP_BYTES if cap is None else cap
    for a0, a1 in blocks:
        assert 0 < a1 - a0 and tproj.table_bytes(a1 - a0, n_k) <= limit
    for a0, a1 in blocks[:-1]:
        assert (a1 - a0) % tproj.TABLE_ATOMS == 0
    if stages is None:
        assert len(blocks) == 1
    else:
        assert len(blocks) == -(-n_atoms // (stages * tproj.TABLE_ATOMS))


def test_atom_blocks_raise_below_one_stage():
    with pytest.raises(ValueError, match="holds no stage"):
        tproj.atom_blocks(100, 500, tproj.table_bytes(tproj.TABLE_ATOMS, 500) - 1)


def test_table_bytes_of_the_working_chunk():
    """(A, K) = (1e5, 500): 8 k-tiles x 3,125 stages x 16 KB = 0.41 GB,
    the same for either tier."""
    assert tproj.table_bytes(100_000, 500) == 8 * 3125 * 16384


@pytest.mark.parametrize('precision', ['balanced', 'fast'])
@pytest.mark.parametrize('shape', [(77, 9), (130, 70), (32, 64), (1, 1)])
def test_tile_round_trip(precision, shape):
    """The tiled table reads back as the plain table's parts, with zeros
    past the last atom and k-point."""
    n_atoms, n_k = shape
    _, hi, lo, kv = problem(2, n_atoms, n_k)
    parts = tproj.tier_table_plain(hi, lo, kv, precision)
    table = tproj.tile_table(parts, n_k, precision)
    assert table.dtype == torch.uint8 and table.numel() == tproj.table_bytes(n_atoms, n_k)
    back = tproj.untile_table(table, n_atoms, n_k, precision)
    assert len(back) == len(parts) == (2 if precision == 'balanced' else 1)
    assert all(torch.equal(a, b) for a, b in zip(back, parts))
    filled = sum(int((p != 0).sum()) for p in parts) * (2 if precision == 'balanced' else 4)
    assert int((table != 0).sum()) <= filled


@pytest.mark.parametrize('precision', ['balanced', 'fast'])
def test_tile_layout_is_the_kernels(precision):
    """Each element lands where the kernel's b_byte puts it: tile
    (k-tile, stage) at (k-tile * stages + stage) * 16 KB, cos in the tile's
    first 64 columns, sin in the next 64."""
    n_atoms, n_k = 70, 130
    stages = -(-n_atoms // tproj.TABLE_ATOMS)
    elem = 2 if precision == 'balanced' else 4
    for al, k, half in ((0, 0, 0), (37, 70, 1), (69, 129, 0), (47, 64, 1), (15, 5, 1)):
        for part in range(2 if precision == 'balanced' else 1):
            parts = [torch.zeros(n_atoms, 2 * n_k) for _ in range(2 if precision == 'balanced' else 1)]
            parts[part][al, half * n_k + k] = 1.0
            table = tproj.tile_table(tuple(parts), n_k, precision)
            kt, s = k // tproj.TABLE_K, al // tproj.TABLE_ATOMS
            at = ((kt * stages + s) * tproj.TABLE_TILE_BYTES
                  + b_byte(al % tproj.TABLE_ATOMS, half * tproj.TABLE_K + k % tproj.TABLE_K, precision)
                  + part * 4096)
            got = torch.nonzero(table).flatten().tolist()
            assert got and min(got) >= at and max(got) < at + elem, (al, k, half, part, got, at)


@pytest.mark.parametrize('precision', ['balanced', 'fast'])
@pytest.mark.parametrize('stages', [1, 3])
def test_blocked_plain_path_matches_unblocked(precision, stages):
    """The plain version run block by block, the later blocks added with
    ``accumulate``, gives the unblocked result to 1e-6 of max; so does the
    wrappers' table-then-product path on the CPU."""
    data, hi, lo, kv = problem(6, 1001, 77, seed=stages)
    whole = tproj.sed_projection_plain(data, hi, lo, kv, precision=precision)
    blocks = tproj.atom_blocks(1001, 77, tproj.table_bytes(stages * tproj.TABLE_ATOMS, 77))
    assert len(blocks) > 1
    out = tuple(torch.full((6, 3, 77), 7.0) for _ in range(2))
    tiled = tuple(torch.zeros((6, 3, 77)) for _ in range(2))
    for i, (a0, a1) in enumerate(blocks):
        tproj.sed_projection_plain(data[:, a0:a1], hi[a0:a1], lo[a0:a1], kv, out=out,
                                   accumulate=i > 0, precision=precision)
        table = tproj.tier_table(hi, lo, kv, precision, atoms=(a0, a1))
        tproj.tier_product(data, table, 77, precision, tiled, accumulate=i > 0, atoms=(a0, a1))
    for w, b, t in zip(whole, out, tiled):
        assert of_max(b.numpy(), w.numpy()) < 1e-6
        assert of_max(t.numpy(), w.numpy()) < 1e-6


@pytest.mark.parametrize('precision', ['balanced', 'fast'])
def test_table_wrapper_writes_into_out(precision):
    _, hi, lo, kv = problem(1, 50, 10)
    want = tproj.tile_table(tproj.tier_table_plain(hi, lo, kv, precision), 10, precision)
    out = torch.full((want.numel() + 32,), 255, dtype=torch.uint8)
    assert tproj.tier_table(hi, lo, kv, precision, out=out) is out
    assert torch.equal(out[:want.numel()], want)
    with pytest.raises(ValueError, match="uint8"):
        tproj.tier_table(hi, lo, kv, precision, out=out[:want.numel() - 1])


def test_product_takes_balanced_or_fast_only():
    data, hi, lo, kv = problem(2, 10, 3)
    table = tproj.tier_table(hi, lo, kv, 'fast')
    out = tuple(torch.zeros((2, 3, 3)) for _ in range(2))
    with pytest.raises(ValueError, match="'balanced' or 'fast'"):
        tproj.tier_product(data, table, 3, 'parity', out)


@pytest.mark.parametrize('stage', ['tier_table', 'tile_table', 'untile_table', 'tier_split'])
@pytest.mark.parametrize('precision', ['parity', 'exact'])
def test_table_stages_take_balanced_or_fast_only(stage, precision):
    """'parity' runs the fused kernel, which keeps no table: no table
    stage takes it, nor a name that is no tier."""
    _, hi, lo, kv = problem(1, 10, 3)
    calls = {'tier_table': lambda: tproj.tier_table(hi, lo, kv, precision),
             'tile_table': lambda: tproj.tile_table((torch.zeros(10, 6),), 3, precision),
             'untile_table': lambda: tproj.untile_table(
                 torch.zeros(tproj.table_bytes(10, 3), dtype=torch.uint8), 10, 3, precision),
             'tier_split': lambda: tproj.tier_split(torch.zeros(10, 6), precision)}
    with pytest.raises(ValueError, match="'balanced' or 'fast'"):
        calls[stage]()


def test_cpu_stages_count_no_launch():
    data, hi, lo, kv = problem(2, 40, 5)
    names = ('launch.parity', 'launch.table', 'launch.product')
    before = tuple(tproj.counters[n] for n in names)
    for precision in ('balanced', 'fast'):
        table = tproj.tier_table(hi, lo, kv, precision)
        tproj.tier_product(data, table, 5, precision, tuple(torch.zeros((2, 3, 5)) for _ in range(2)))
        tproj.sed_projection(data, hi, lo, kv, precision=precision)
    assert tuple(tproj.counters[n] for n in names) == before
    assert tproj.kernel_launches() == sum(before)


@pytest.fixture(scope='module')
def crystal():
    return make_random_crystal_trajectory(n_cells_xyz=(4, 3, 3), basis=2, n_frames=12,
                                          dt_ps=0.02, seed=21)


@pytest.mark.parametrize('precision', ['balanced', 'fast'])
def test_tier_against_jax_sed_spectrum_and_oracle(crystal, precision):
    """The port's sed_spectrum at the tier and the JAX package's at the same
    precision on the same NumPy inputs (JAX on the CPU, where its matmul
    precision is float32), each within the tier's bar of the float64 oracle
    and of each other; the port through atom blocks too."""
    rng = np.random.default_rng(8)
    kv = rng.uniform(-1.5, 1.5, size=(23, 3)).astype(np.float32)
    mean64 = crystal.positions.astype(np.float64).mean(axis=0)
    hi, lo = tspec.split_f64(mean64)
    oracle = reference_sed_oracle(crystal, kv)
    re, im = jspec.sed_spectrum(jnp.asarray(crystal.velocities), jnp.asarray(hi), jnp.asarray(lo),
                                jnp.asarray(kv), precision=precision)
    ref = np.asarray(re) + 1j * np.asarray(im)
    args = [torch.from_numpy(np.ascontiguousarray(x)) for x in (crystal.velocities, hi, lo, kv)]
    port = tspec.sed_spectrum(*args, precision=precision).numpy()
    assert of_max(port, oracle) < BARS[precision]
    assert of_max(ref, oracle) < BARS[precision]
    assert of_max(port, ref) < BARS[precision]
    n_atoms = crystal.n_atoms
    blocks = tproj.atom_blocks(n_atoms, 23, tproj.table_bytes(tproj.TABLE_ATOMS, 23))
    assert len(blocks) == -(-n_atoms // tproj.TABLE_ATOMS) > 1
    out = tuple(torch.zeros((crystal.n_frames, 3, 23)) for _ in range(2))
    for i, (a0, a1) in enumerate(blocks):
        table = tproj.tier_table(args[1], args[2], args[3], precision, atoms=(a0, a1))
        tproj.tier_product(args[0], table, 23, precision, out, accumulate=i > 0, atoms=(a0, a1))
    assert of_max(tspec.finalize_spectrum(*out).numpy(), oracle) < BARS[precision]
