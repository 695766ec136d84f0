"""psa_tpu_torch's g(r) against the JAX package and the float64 all-images
oracle of ``tests/test_rdf.py``.

The same seeded positions go through both packages on the CPU.  Tolerances:
pair counts of the ops against JAX: the total equal, per-bin counts equal
but for pairs within a float32 rounding of a bin edge, whose number is
counted and bounded (≤ 4 per case, each moving to the neighbouring bin);
g against ``rdf_oracle`` at rtol 1e-4, atol 1e-5; cells against brute bin
for bin (exact); block and chunk invariance exact (integer counts).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psa_tpu import SEDCalculator as JaxCalculator
from psa_tpu.ops import structure as jst
from psa_tpu_torch import SEDCalculator
from psa_tpu_torch.core.convert import from_reference_calculator
from psa_tpu_torch.ops import structure as tst

from test_rdf import _traj, rdf_oracle

torch.set_num_threads(1)

TRICLINIC = np.array([[10.0, 2.0, 1.0], [0.0, 9.0, 1.5], [0.0, 0.0, 8.0]])
CUBE = np.diag([12.0] * 3)
EDGE_PAIRS = 4          # pairs allowed to sit on the other side of a bin edge


def pair(traj, **kwargs):
    ref = JaxCalculator(traj, nx=1, ny=1, nz=1, **kwargs)
    return ref, from_reference_calculator(ref, device='cpu')


def positions(seed, box, n_t, n_a, spread=1.0):
    """Uniform in ``spread`` images of the cell (columns = cell vectors)."""
    frac = np.random.default_rng(seed).uniform(0, spread, (n_t, n_a, 3))
    return np.einsum('ij,taj->tai', np.asarray(box, float), frac)


def assert_counts_close(got, want):
    """Equal totals; per-bin differences only from edge pairs, bounded."""
    got, want = np.asarray(got, np.int64), np.asarray(want, np.int64)
    assert got.shape == want.shape
    assert abs(int(got.sum()) - int(want.sum())) <= EDGE_PAIRS     # the last edge
    assert int(np.abs(got - want).sum()) <= 2 * EDGE_PAIRS
    assert np.abs(np.cumsum(got - want)).max() <= EDGE_PAIRS       # moved to a neighbour


def jax_block(pa, pb, box, r_max, n_bins, ida, idb):
    h = jnp.asarray(box, jnp.float32)
    hinv = jnp.asarray(np.linalg.inv(box), jnp.float32)
    return np.asarray(jst.rdf_block(
        jnp.asarray(pa, jnp.float32), jnp.asarray(pb, jnp.float32),
        jnp.ones(pa.shape[1], jnp.float32), jnp.ones(pb.shape[1], jnp.float32), h, hinv,
        jnp.float32(r_max), n_bins, jnp.asarray(ida, jnp.int32), jnp.asarray(idb, jnp.int32)))


def t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


# ---------------------------------------------------------------------------
# The ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("box,r_max,n_bins", [(CUBE, 5.0, 25), (TRICLINIC, 3.5, 35),
                                              (CUBE, 6.0, 200), (TRICLINIC, 2.0, 7)],
                         ids=['cube', 'triclinic', 'cube-200-bins', 'triclinic-7-bins'])
def test_rdf_block_matches_jax(box, r_max, n_bins):
    pos = positions(0, box, 3, 40, spread=2.0)
    ids = np.arange(40)
    got = tst.rdf_block(t(pos), t(pos), box, np.linalg.inv(box), r_max, n_bins,
                        t(ids, torch.int64), t(ids, torch.int64))
    assert got.dtype == torch.int64 and got.shape == (n_bins,)
    assert_counts_close(got.numpy(), jax_block(pos, pos, box, r_max, n_bins, ids, ids))


def test_rdf_block_drops_pairs_by_global_id():
    """Overlapping A and B: equal ids are dropped by identity, coincident
    distinct atoms still count (in the first bin)."""
    pos = positions(1, CUBE, 2, 12)
    pos[:, 5] = pos[:, 4]                                   # two atoms on one site
    ida, idb = np.arange(0, 8), np.arange(4, 12)
    got = tst.rdf_block(t(pos[:, ida]), t(pos[:, idb]), CUBE, np.linalg.inv(CUBE), 6.0, 12,
                        t(ida, torch.int64), t(idb, torch.int64)).numpy()
    want = jax_block(pos[:, ida], pos[:, idb], CUBE, 6.0, 12, ida, idb)
    assert_counts_close(got, want)
    assert got[0] >= 2 * 2                                  # (4,5) and (5,4), both frames


@pytest.mark.parametrize("block,b_block", [(7, None), (16, 16), (16, 50), (64, None), (5, 11)])
def test_rdf_sweep_is_tiling_invariant_and_matches_jax(block, b_block):
    """Ragged tiles (50 atoms in tiles of 7, 16, 64; a wider B side) give
    the counts of one whole tile, and JAX's padded sweep's."""
    pos = positions(2, TRICLINIC, 2, 50)
    ids = t(np.arange(50), torch.int64)
    hinv = np.linalg.inv(TRICLINIC)
    whole = tst.rdf_block(t(pos), t(pos), TRICLINIC, hinv, 3.0, 30, ids, ids)
    got = tst.rdf_sweep(t(pos), ids, t(pos), ids, TRICLINIC, hinv, 3.0, 30, block, b_block)
    assert torch.equal(got, whole)
    pad = np.zeros((2, 64, 3), np.float32)
    pad[:, :50] = pos
    mask = np.zeros(64, np.float32)
    mask[:50] = 1
    jid = np.full(64, -1, np.int32)
    jid[:50] = np.arange(50)
    rows = np.asarray(jst.rdf_sweep(
        jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(jid), jnp.asarray(pad),
        jnp.asarray(mask), jnp.asarray(np.where(jid < 0, -2, jid)),
        jnp.asarray(TRICLINIC, jnp.float32), jnp.asarray(hinv, jnp.float32), jnp.float32(3.0),
        n_bins=30, block=16))
    assert_counts_close(got.numpy(), rows.sum(axis=0))


@pytest.mark.parametrize("box,n_xyz,r_max", [(CUBE, (6, 6, 6), 2.0), (CUBE, (2, 2, 2), 5.5),
                                             (TRICLINIC, (5, 4, 4), 1.9), (CUBE, (1, 3, 2), 3.9)],
                         ids=['6x6x6', '2x2x2-dedup', 'triclinic', '1x3x2'])
@pytest.mark.parametrize("cell_block", [5, 64])
def test_rdf_cells_sweep_equals_brute_and_matches_jax(box, n_xyz, r_max, cell_block):
    n_t, n_a, n_bins = 2, 120, 20
    pos = positions(3, box, n_t, n_a).astype(np.float32)
    hinv = np.linalg.inv(box)
    frac = np.einsum('ij,taj->tai', hinv, pos.astype(np.float64))
    frac -= np.floor(frac)
    nc = int(np.prod(n_xyz))
    lin = tst.cell_counts(frac, n_xyz)
    cap = -(-max(np.bincount(l, minlength=nc).max() for l in lin) // 8) * 8
    ids = np.arange(n_a)

    idx = tst.bucketize_frames(lin, n_a, nc, nc + 1, cap)
    neigh = tst.neighbor_table(n_xyz, nc + 1)
    got = tst.rdf_cells_sweep(t(pos), t(idx, torch.int32), t(ids, torch.int64), t(pos),
                              t(idx, torch.int32), t(ids, torch.int64), t(neigh, torch.int32),
                              box, hinv, r_max, n_bins, cell_block)
    brute = tst.rdf_block(t(pos), t(pos), box, hinv, r_max, n_bins, t(ids, torch.int64),
                          t(ids, torch.int64))
    assert torch.equal(got, brute)                          # bin for bin

    nc_pad = -(-(nc + 1) // 8) * 8                          # JAX needs whole blocks
    rows = np.asarray(jst.rdf_cells_sweep(
        jnp.asarray(pos), jnp.asarray(jst.bucketize_frames(lin, n_a, nc, nc_pad, cap)),
        jnp.asarray(ids, jnp.int32), jnp.asarray(pos),
        jnp.asarray(jst.bucketize_frames(lin, n_a, nc, nc_pad, cap)), jnp.asarray(ids, jnp.int32),
        jnp.asarray(jst.neighbor_table(n_xyz, nc_pad)), jnp.asarray(box, jnp.float32),
        jnp.asarray(hinv, jnp.float32), jnp.float32(r_max), n_bins=n_bins, cell_block=8))
    assert_counts_close(got.numpy(), rows.sum(axis=0))


@pytest.mark.parametrize("name,args", [
    ('cell_counts', (np.random.default_rng(4).uniform(0, 1, (3, 30, 3)), (3, 4, 5))),
    ('bucketize_frames', (np.random.default_rng(5).integers(0, 12, (2, 40)), 40, 12, 16, 16)),
    ('neighbor_table', ((4, 3, 2), 32)), ('neighbor_table', ((1, 1, 2), 3)),
], ids=['cell_counts', 'bucketize_frames', 'neighbor_table', 'neighbor_table-degenerate'])
def test_host_helpers_are_the_reference(name, args):
    np.testing.assert_array_equal(getattr(tst, name)(*args), getattr(jst, name)(*args))


def test_neighbor_table_needs_a_sentinel():
    with pytest.raises(ValueError, match="sentinel"):
        tst.neighbor_table((2, 2, 2), 8)


def test_edges_are_formed_in_float32():
    edges = tst._edges(3.3, 7, 'cpu').numpy()
    want = np.asarray(jnp.arange(1, 8, dtype=jnp.float32) * (jnp.float32(3.3) / 7))
    np.testing.assert_array_equal(edges, want)


# ---------------------------------------------------------------------------
# calculate_rdf against the JAX calculator and the float64 oracle
# ---------------------------------------------------------------------------

CASES = {
    'orthorhombic': dict(box=np.diag([9.0, 11.0, 10.0]), n_t=4, n_a=40, r_max=4.0, n_bins=40),
    'triclinic': dict(box=TRICLINIC, n_t=3, n_a=30, r_max=3.5, n_bins=35),
    'unwrapped': dict(box=CUBE, n_t=2, n_a=60, r_max=5.5, n_bins=22, spread=5.0),
}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("method", ['brute', 'cells', 'auto'])
def test_rdf_matches_oracle_and_jax(case, method):
    c = dict(CASES[case])
    box, spread = c.pop('box'), c.pop('spread', 1.0)
    pos = positions(7, box, c.pop('n_t'), c.pop('n_a'), spread) - (spread > 1) * 24.0
    ref, port = pair(_traj(pos, box))
    r, g = port.calculate_rdf(method=method, **c)
    r_ref, g_ref = ref.calculate_rdf(method=method, **c)
    assert port._last_rdf_method == ref._last_rdf_method
    np.testing.assert_array_equal(r, r_ref)
    assert g.dtype == np.float32
    # the oracle looks at 27 images only: give it the wrapped float32 positions
    frac = np.einsum('ij,taj->tai', np.linalg.inv(box), pos.astype(np.float32).astype(np.float64))
    wrapped = np.einsum('ij,taj->tai', box, frac - np.floor(frac))
    np.testing.assert_allclose(g, rdf_oracle(wrapped, box, c['r_max'], c['n_bins']),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-5)


def typed_traj(seed=13, n=(150, 100), box=np.diag([14.0] * 3), n_t=2):
    pos = positions(seed, box, n_t, sum(n))
    types = np.array([1] * n[0] + [2] * n[1], np.int32)
    return _traj(pos, box, types=types)


@pytest.mark.parametrize("kwargs", [
    {'basis_atom_types': [1]}, {'basis_atom_types': [2]},
    {'basis_atom_types': [1], 'basis_atom_types_b': [2]},
    {'basis_atom_types': [1], 'basis_atom_types_b': [1, 2]},          # overlapping cross
    {'basis_atom_indices': list(range(0, 120)), 'basis_atom_indices_b': list(range(60, 250))},
    {'basis_atom_types': [1, 2], 'basis_atom_types_b': [1, 2]},       # B ≡ A
    {'basis_atom_types': [3]},                                        # no such atoms: all
], ids=str)
@pytest.mark.parametrize("method", ['brute', 'cells'])
def test_groups_match_jax(kwargs, method):
    ref, port = pair(typed_traj())
    kw = dict(r_max=2.5, n_bins=25, method=method, **kwargs)
    _, g = port.calculate_rdf(**kw)
    _, g_ref = ref.calculate_rdf(**kw)
    np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-5)


def test_overlapping_cross_basis_equals_same_group():
    _, port = pair(typed_traj(seed=6, n=(35, 0), box=np.diag([10.0] * 3), n_t=3))
    _, same = port.calculate_rdf(r_max=4.0, n_bins=20)
    _, cross = port.calculate_rdf(r_max=4.0, n_bins=20, basis_atom_types=[1],
                                  basis_atom_types_b=[1])
    np.testing.assert_array_equal(cross, same)


@pytest.mark.parametrize("kwargs", [{'atom_block': 16}, {'atom_block': 7}, {'atom_block': 4096},
                                    {'max_device_bytes': 1000}, {'max_frames': 2},
                                    {'method': 'cells'}, {'method': 'cells', 'cell_block': 3},
                                    {'method': 'cells', 'cell_block': 128},
                                    {'method': 'cells', 'max_device_bytes': 1000}], ids=str)
def test_tiling_invariance(kwargs):
    """Tiles, cell blocks and frame chunks change no count (``max_frames``
    changes the frames sampled, so it is held to the same sampling)."""
    kwargs = dict(kwargs)
    budget = kwargs.pop('max_device_bytes', None)
    traj = typed_traj(seed=2, n=(90, 60), box=CUBE, n_t=5)
    frames = dict(max_frames=kwargs.pop('max_frames', 64))
    _, base = pair(traj)
    _, port = pair(traj, **({} if budget is None else {'max_device_bytes': budget}))
    _, want = base.calculate_rdf(r_max=2.0, n_bins=20, method='brute', **frames)
    _, got = port.calculate_rdf(r_max=2.0, n_bins=20, **frames, **kwargs)
    np.testing.assert_array_equal(got, want)


def test_small_budget_chunks_the_frames():
    """At the floor of the pair budget (2²² pairs) 400 × 400 atoms take 26
    frames a chunk, so 64 sampled frames make three uploads."""
    traj = _traj(positions(8, CUBE, 64, 400), CUBE)
    _, port = pair(traj, max_device_bytes=1000)
    uploads = []
    real = port._to_device
    port._to_device = lambda host, *a: uploads.append(np.shape(host)) or real(host, *a)
    port.calculate_rdf(r_max=2.0, n_bins=10, method='brute')
    assert [s[0] for s in uploads if len(s) == 3] == [26, 26, 12]


@pytest.mark.parametrize("n_a,r_max,want", [(40, 4.0, 'brute'), (3000, 2.0, 'cells')])
def test_auto_chooses_each_way(n_a, r_max, want):
    """Small N with a wide range: the padded cell pairs exceed half the
    brute count; dense with a short range: the cells win, and match."""
    box = np.diag([10.0] * 3) if n_a == 40 else np.diag([24.0] * 3)
    ref, port = pair(_traj(positions(15, box, 1, n_a), box))
    _, g = port.calculate_rdf(r_max=r_max, n_bins=20)
    assert port._last_rdf_method == want
    ref.calculate_rdf(r_max=r_max, n_bins=20)
    assert ref._last_rdf_method == want
    _, brute = port.calculate_rdf(r_max=r_max, n_bins=20, method='brute')
    assert port._last_rdf_method == 'brute'
    np.testing.assert_array_equal(g, brute)


def test_cells_records_its_host_time():
    _, port = pair(_traj(positions(16, CUBE, 2, 300), CUBE))
    port.calculate_rdf(r_max=2.0, n_bins=10, method='cells')
    assert port._last_rdf_host_seconds > 0
    port.calculate_rdf(r_max=2.0, n_bins=10, method='brute')
    assert port._last_rdf_host_seconds == 0


@pytest.mark.parametrize("kwargs,error,match", [
    ({'mesh': object(), 'method': 'cells'}, ValueError, 'single-device'),
    ({'method': 'grid'}, ValueError, "method must be"),
], ids=['cells-with-mesh', 'bad-method'])
def test_unsupported_arguments_raise(kwargs, error, match):
    _, port = pair(_traj(positions(17, CUBE, 1, 20), CUBE))
    with pytest.raises(error, match=match):
        port.calculate_rdf(r_max=2.0, **kwargs)


@pytest.mark.parametrize('shape', [(2, 2, 2), (1, 1, 8)])
def test_mesh_matches_one_device_and_jax_mesh(shape):
    """g(r) over a mesh (A atoms over all eight positions, B whole on each)
    against the port's one-device brute sweep bin for bin and the JAX mesh
    at ``tests/test_rdf.py``'s tolerance, same-group and cross."""
    from psa_tpu.parallel import make_mesh as jax_mesh
    from psa_tpu_torch.parallel import make_mesh
    types = np.array([1] * 20 + [2] * 17, np.int32)
    ref, port = pair(_traj(positions(4, CUBE, 3, 37), CUBE, types=types))
    mesh = make_mesh(shape=shape, devices=['cpu'] * 8)
    for kw in (dict(), dict(basis_atom_types=[1], basis_atom_types_b=[2])):
        _, got = port.calculate_rdf(r_max=5.0, n_bins=25, mesh=mesh, atom_block=8, **kw)
        _, one = port.calculate_rdf(r_max=5.0, n_bins=25, method='brute', **kw)
        _, jax_got = ref.calculate_rdf(r_max=5.0, n_bins=25, mesh=jax_mesh(shape=shape),
                                       atom_block=8, **kw)
        np.testing.assert_array_equal(got, one)
        np.testing.assert_allclose(got, jax_got, rtol=1e-5, atol=1e-6)
        assert port._last_rdf_method == 'brute'


def test_degenerate_inputs():
    traj = _traj(positions(18, CUBE, 1, 20), CUBE)
    _, port = pair(traj)
    r, g = port.calculate_rdf(n_bins=10)                    # default r_max: half the box
    np.testing.assert_allclose(r[-1] + r[0], 6.0, rtol=1e-6)
    flat = _traj(positions(18, CUBE, 1, 20), np.diag([12.0, 12.0, 0.0]))
    with pytest.raises(ValueError, match="3D box"):
        _flat_calc(flat).calculate_rdf(r_max=1.0)


def _flat_calc(traj):
    """A port calculator over a cell with a zero edge (the constructor
    rejects it, as the JAX one does, so it is assembled by hand)."""
    calc = SEDCalculator.__new__(SEDCalculator)
    calc._configure(traj, False, 'parity', int(8e9), False, 'cpu')
    calc.dt_ps = traj.dt_ps
    return calc


# ---------------------------------------------------------------------------
# Physics (the fixtures of tests/test_rdf.py)
# ---------------------------------------------------------------------------

def test_ideal_gas_is_flat_one():
    n_t, n_a, L = 8, 500, 15.0
    pos = np.random.default_rng(3).uniform(0, L, (n_t, n_a, 3))
    port = SEDCalculator(_traj(pos, np.diag([L] * 3)), 1, 1, 1, device='cpu')
    r, g = port.calculate_rdf(n_bins=30)
    np.testing.assert_allclose(g[5:], 1.0, atol=0.12)
    assert abs(g[5:].mean() - 1.0) < 0.02


@pytest.mark.parametrize("method", ['brute', 'cells'])
def test_simple_cubic_shells_and_coordination(method):
    a0, n_c = 2.0, 5
    grid = np.stack(np.meshgrid(*([np.arange(n_c) * a0] * 3), indexing='ij'), -1).reshape(-1, 3)
    port = SEDCalculator(_traj(grid[None], np.diag([n_c * a0] * 3)), n_c, n_c, n_c, device='cpu')
    r, g = port.calculate_rdf(r_max=4.5, n_bins=90, method=method)
    rho = grid.shape[0] / (n_c * a0) ** 3
    coord = 4 * np.pi * rho * np.cumsum(g * r.astype(np.float64) ** 2) * (r[1] - r[0])
    i1 = np.searchsorted(r, (1.0 + np.sqrt(2)) / 2 * a0)
    i2 = np.searchsorted(r, (np.sqrt(2) + np.sqrt(3)) / 2 * a0)
    np.testing.assert_allclose(coord[i1], 6.0, rtol=0.02)
    np.testing.assert_allclose(coord[i2], 18.0, rtol=0.02)
    assert g[r < 0.9 * a0].max() == 0.0


def test_cscl_cross_rdf():
    a0, n_c = 2.0, 4
    grid = np.stack(np.meshgrid(*([np.arange(n_c) * a0] * 3), indexing='ij'), -1).reshape(-1, 3)
    pos = np.concatenate([grid, grid + a0 / 2], axis=0)[None]
    types = np.array([1] * len(grid) + [2] * len(grid), np.int32)
    port = SEDCalculator(_traj(pos, np.diag([n_c * a0] * 3), types=types), n_c, n_c, n_c,
                         device='cpu')
    r, g_ab = port.calculate_rdf(r_max=3.0, n_bins=60, basis_atom_types=[1],
                                 basis_atom_types_b=[2])
    d1 = np.sqrt(3) / 2 * a0
    assert g_ab[r < 0.95 * d1].max() == 0.0
    rho_b = len(grid) / (n_c * a0) ** 3
    coord = 4 * np.pi * rho_b * np.cumsum(g_ab * r.astype(np.float64) ** 2) * (r[1] - r[0])
    np.testing.assert_allclose(coord[np.searchsorted(r, 1.1 * d1)], 8.0, rtol=0.02)
