"""The 'exact' mode stacks: the plain chain on the CPU, the fused kernel on a card.

``ops/instantaneous.accumulate_modes`` runs the fused kernel
(``csrc/instant_modes.cu``, ``fused_modes``) for CUDA tensors under 'exact'
and the plain chain (``accumulate_modes_plain``: float64 angles, float32
cos and sin, a float32 ``bmm`` per time tile) everywhere else.  On the CPU
these tests hold the plain chain to the chain the port ran before the
kernel existed, bit for bit, and check the kernel's plan in Python: the
atom splits, the counts and the calculator's tiles.  The tests marked
``chip`` hold the kernel to the CPU's plain chain and to a float64
reference, and skip without a card.  The file imports neither JAX nor the
JAX package, so on the card it runs without the suite's ``conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_instant_modes.py -q
"""
import numpy as np
import pytest
import torch

from psa_tpu_torch import SEDCalculator, Trajectory
from psa_tpu_torch.core.trajectory import make_box_arrays
from psa_tpu_torch.ops import instantaneous as tinst
from psa_tpu_torch.ops import sed_projection as tproj
from psa_tpu_torch.utils.profiling import count, counted_since, kernel_launches, snapshot

#: The kernel's error against the float64 reference, in units of 2⁻²⁴ times
#: the sum of the magnitudes it adds (:func:`sum_units`), may exceed the plain
#: chain's by at most this factor (both form the same phasors; they sum the
#: atoms in other orders) over a floor of one unit.
FACTOR, FLOOR = 2.0, 1.0
#: Each phasor times its weight within this many units of 2⁻²⁴·|w| of
#: w·(cos θ, sin θ), beyond what the float32 rounding of the folded angle θ
#: moves it (:func:`element_units`): sincosf's documented 2 ulps (the CPU's
#: cos and sin keep 1) and the rounding of the product.  __sincosf, a
#: phasor rounded to TF32 or an angle folded in float32 exceed it.
ELEMENT_UNITS = 3.0
#: The kernel's tiles as built, (frames, k-points) per block and atoms per
#: stage (``psa_instant_modes_tile``), and two others the plan must serve.
TILES, OTHER_TILES = (8, 64, 128), ((16, 32, 64), (8, 128, 256))


def inputs(n_t, n_a, n_k, weighted, sliced, seed=0, device='cpu'):
    """Seeded float32 positions (0-100 Å, so k·r reaches hundreds of
    radians), velocities, k in ±3 Å⁻¹ and weights; with ``sliced`` the
    positions and velocities are atom slices of wider arrays (row stride
    ≠ 3A)."""
    rng = np.random.default_rng(seed)
    width = n_a + 37 if sliced else n_a
    pos = torch.from_numpy(rng.uniform(0, 100, (n_t, width, 3)).astype(np.float32))
    vel = torch.from_numpy(rng.normal(0, 5, (n_t, width, 3)).astype(np.float32))
    kv = torch.from_numpy(rng.uniform(-3, 3, (n_k, 3)).astype(np.float32))
    w = torch.from_numpy(rng.uniform(0.5, 2, n_a).astype(np.float32)) if weighted else None
    a0 = 19 if sliced else 0
    pos, vel = (x.to(device)[:, a0:a0 + n_a] for x in (pos, vel))
    return pos, vel, kv.to(device), None if w is None else w.to(device)


def parent_chain(acc_re, acc_im, pos, vel, kv, t_chunk, weights=None):
    """The 'exact' chain as the port ran it before the fused kernel: per
    time tile the float64 folded angles, cos and sin, and one float32 bmm."""
    n_t, n_a, _ = pos.shape
    n_k, n_ch = kv.shape[0], acc_re.shape[2]
    for t0 in range(0, n_t, t_chunk):
        t1 = min(t0 + t_chunk, n_t)
        ang = pos[t0:t1].reshape(-1, 3).double() @ kv.double().T
        ang = ang.sub_((ang / (2.0 * torch.pi)).round_(), alpha=2.0 * torch.pi).float()
        cs = torch.cat([torch.cos(ang), torch.sin(ang)], dim=1).view(t1 - t0, n_a, 2 * n_k)
        w = torch.zeros((t1 - t0, 4, n_a))
        w[:, 0] = 1.0
        if vel is not None:
            w[:, 1:] = vel[t0:t1].transpose(1, 2)
        if weights is not None:
            w *= weights[None, None, :]
        f = torch.bmm(w, cs)[:, :n_ch]
        acc_re[t0:t1] += f[..., :n_k].transpose(1, 2)
        acc_im[t0:t1] += f[..., n_k:].transpose(1, 2)


# ---------------------------------------------------------------------------
# The CPU: the plain chain, the plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('n_ch, weighted, sliced', [(4, False, False), (4, True, True),
                                                    (1, True, False), (1, False, True)])
def test_the_cpu_takes_the_plain_chain_bit_for_bit(n_ch, weighted, sliced):
    n_t, n_a, n_k = 23, 41, 9
    pos, vel, kv, w = inputs(n_t, n_a, n_k, weighted, sliced, seed=3)
    vel = vel if n_ch == 4 else None
    rng = np.random.default_rng(4)
    start = [torch.from_numpy(rng.normal(size=(n_t, n_k, n_ch)).astype(np.float32))
             for _ in range(2)]
    got, want = [x.clone() for x in start], [x.clone() for x in start]
    before = snapshot()
    tinst.accumulate_modes(*got, pos, vel, kv, 7, weights=w)
    assert counted_since(before) == {'phasor.exact_elems': n_t * n_a * n_k}   # no launch
    parent_chain(*want, pos, vel, kv, 7, w)
    assert all(torch.equal(g, x) for g, x in zip(got, want))


@pytest.mark.parametrize('n_ch, with_vel, atom', [(4, True, 0), (4, True, 40), (1, True, 17),
                                                  (4, False, 33)])
def test_the_plain_chain_meets_the_phasor_bound(n_ch, with_vel, atom):
    """The bound the card tests hold the kernel to, on the CPU's chain:
    one atom's mode stack within ELEMENT_UNITS of w·(cos θ, sin θ)."""
    n_t, n_a, n_k = 23, 41, 9
    pos, vel, kv, _ = inputs(n_t, n_a, n_k, False, True, seed=9)
    vel = vel if with_vel else None
    acc = [torch.zeros((n_t, n_k, n_ch)) for _ in range(2)]
    tinst.accumulate_modes(*acc, pos, vel, kv, 7, weights=one_hot(n_a, atom, 0.75, 'cpu'))
    assert element_units(acc, pos, vel, kv, 0.75, atom) <= ELEMENT_UNITS


def test_the_phasor_bound_refuses_a_float32_fold():
    """The same check fails a chain that folds the angle in float32."""
    n_t, n_a, n_k = 23, 41, 9
    pos, vel, kv, _ = inputs(n_t, n_a, n_k, False, False, seed=9)
    ang = (pos[:, 7] @ kv.T)
    ang = ang - 2 * np.float32(np.pi) * torch.round(ang / (2 * np.float32(np.pi)))
    w = torch.cat([torch.ones((n_t, 1)), vel[:, 7]], dim=1) * 0.75
    acc = [w[:, None, :] * f(ang)[..., None] for f in (torch.cos, torch.sin)]
    assert element_units(acc, pos, vel, kv, 0.75, 7) > 100 * ELEMENT_UNITS


@pytest.mark.parametrize('name', ['launch.parity', 'launch.table', 'launch.product',
                                  'launch.phasor_modes', 'launch.some_later_kernel'])
def test_kernel_launches_counts_every_launch_counter(name):
    before, proj = kernel_launches(), tproj.kernel_launches()
    count(name, 3)
    count('phasor.fused_elems', 5)          # not a launch
    try:
        assert kernel_launches() == before + 3
        assert tproj.kernel_launches() == proj + 3 * (name in (
            'launch.parity', 'launch.table', 'launch.product'))
    finally:
        count(name, -3)
        count('phasor.fused_elems', -5)


def splits_time(n_t, n_a, n_k, slots, tiles, splits, per):
    frames, k_points, atoms = tiles
    n_tiles = -(-n_t // frames) * -(-n_k // k_points)
    return -(-n_tiles * splits // slots) * (per // atoms)


def check_splits(shape, slots, tiles, splits, per):
    """The plan's invariants: whole stages, every atom once, splits of at
    least MODES_SPLIT_STAGES stages, the scratch within its cap, and a time
    within 1% of the best split count the caps allow."""
    n_t, n_a, n_k = shape
    atoms = tiles[2]
    stages = -(-n_a // atoms)
    assert per % atoms == 0 and (splits - 1) * per < n_a <= splits * per
    assert splits == 1 or per // atoms >= tinst.MODES_SPLIT_STAGES
    assert splits * 2 * 4 * 4 * n_t * n_k <= max(tinst.MODES_SCRATCH_BYTES,
                                                  2 * 4 * 4 * n_t * n_k)
    cap = min(tinst.MODES_MAX_SPLITS, max(1, stages // tinst.MODES_SPLIT_STAGES))
    best = min(splits_time(*shape, slots, tiles, s, -(-stages // s) * atoms)
               for s in range(1, cap + 1)
               if s * 32 * n_t * n_k <= max(tinst.MODES_SCRATCH_BYTES, 32 * n_t * n_k))
    assert splits_time(*shape, slots, tiles, splits, per) <= 1.01 * best


@pytest.mark.parametrize('shape, slots, want', [
    ((10_000, 32_000, 128), 528, (4, 63 * 128)),      # the DSF cell's call: 19 waves, not 5 x 4
    ((10_000, 32_000, 128), 264, (2, 125 * 128)),
    ((37, 301, 7), 528, (1, 384)),                    # 3 stages: too few to split
    ((64, 32_000, 128), 528, (32, 8 * 128)),          # 16 tiles fill the card only when split
    ((5, 2_500, 1), 528, (10, 2 * 128)),              # at least two stages a split
    ((20_000, 10**6, 2_500), 528, (1, 10**6 // 128 * 128 + 128))])   # the scratch cap
def test_modes_splits(shape, slots, want):
    splits, per = tinst.modes_splits(*shape, slots, TILES)
    assert (splits, per) == want
    check_splits(shape, slots, TILES, splits, per)


@pytest.mark.parametrize('tiles', OTHER_TILES)
@pytest.mark.parametrize('shape', [(10_000, 32_000, 128), (64, 32_000, 130), (5, 2_500, 1)])
def test_modes_splits_plan_with_the_tiles_they_are_given(shape, tiles):
    """A kernel built with other tiles gets a plan in its own stages."""
    splits, per = tinst.modes_splits(*shape, 528, tiles)
    check_splits(shape, 528, tiles, splits, per)


def test_fused_modes_refuses_what_the_kernel_does_not_take():
    pos, vel, kv, w = inputs(4, 6, 3, True, False)
    acc = [torch.zeros((4, 3, 4)) for _ in range(2)]
    with pytest.raises(ValueError, match="CUDA"):
        tinst.fused_modes(*acc, pos, vel, kv, w)
    with pytest.raises(ValueError, match="channels"):
        tinst.fused_modes(*[torch.zeros((4, 3, 2))] * 2, pos, vel, kv)
    with pytest.raises(ValueError, match="contiguous float32"):
        tinst.fused_modes(torch.zeros((4, 3, 4)), torch.zeros((3, 4, 4)), pos, vel, kv)
    with pytest.raises(ValueError, match="weights"):
        tinst.fused_modes(*acc, pos, vel, kv, w[:5])
    with pytest.raises(TypeError, match="float32"):
        tinst.fused_modes(*acc, pos.double(), vel, kv)
    assert tinst.fuses('cuda', 'exact') and tinst.fuses(torch.device('cuda', 1), 'exact')
    assert not any(tinst.fuses(d, m) for d, m in (('cpu', 'exact'), ('cuda', 'factored'),
                                                  ('cuda', 'incremental')))


def broadcast_calculator(n_t, n_a, budget):
    zeros = np.broadcast_to(np.zeros(3, np.float32), (n_t, n_a, 3))
    box = np.diag([130.0] * 3).astype(np.float32)
    traj = Trajectory(zeros, zeros, np.ones(n_a, np.int32), np.arange(n_t, dtype=np.float32),
                      box, *make_box_arrays(box), dt_ps=0.01)
    return SEDCalculator(traj, nx=24, ny=24, nz=24, max_device_bytes=budget, device='cpu')


@pytest.mark.parametrize('budget', [int(30e9), int(8e9)])
def test_the_fused_plan_takes_every_frame(budget):
    """On a card under 'exact' the plan has no time tiles: the whole group
    (or each staged block) in one launch over every frame; the other
    engines keep their tiles."""
    n_t, n_a = 10_000, 100_000
    calc = broadcast_calculator(n_t, n_a, budget)
    group = np.arange(n_a)
    tiled = {mode: calc._dsf_plan(128, group, True, mode) for mode in tinst.PHASOR_BYTES}
    calc.device = torch.device('cuda')         # the plan allocates nothing
    streams = calc._instant_streams(group, True)
    assert calc._dsf_plan(128, group, True, 'exact') == (
        calc.stream_block_atoms(n_a) if streams else n_a, n_t)
    assert calc._dsf_plan(128, group, False, 'exact')[1] == n_t
    for mode in ('factored', 'incremental'):
        assert calc._dsf_plan(128, group, True, mode) == tiled[mode]
        assert tiled[mode][1] < n_t


# ---------------------------------------------------------------------------
# The card: the kernel against the plain chain and float64
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused mode-stack kernel runs only there")
    return torch.device('cuda')


def reference64(pos, vel, kv, weights, n_ch, atoms=512):
    """Σ_a w_c e^{i k·r_a(t)} in float64 from the float32 operands, with the
    weights rounded as the program rounds them (fl32(weight·v)): (re, im)
    float64 (n_t, K, n_ch), and Σ_a |w_c| (n_t, 1, n_ch), which bounds every
    partial sum of either."""
    n_t, n_a, _ = pos.shape
    out = torch.zeros((n_t, kv.shape[0], n_ch), dtype=torch.complex128, device=pos.device)
    mag = torch.zeros((n_t, 1, n_ch), dtype=torch.float64, device=pos.device)
    k64 = kv.double()
    for a0 in range(0, n_a, atoms):
        p = pos[:, a0:a0 + atoms].double()
        a1 = a0 + p.shape[1]
        w = weights32(n_t, vel, weights, a0, a1, pos.device)[..., :n_ch].double()
        ph = torch.exp(1j * (p @ k64.T))
        out += torch.einsum('tak,tac->tkc', ph, w.to(ph.dtype))
        mag += w.abs().sum(dim=1, keepdim=True)
    return out.real, out.imag, mag


def weights32(n_t, vel, weights, a0, a1, device):
    """[1, v_x, v_y, v_z] · weight of atoms a0 … a1 in float32, (n_t, a1 − a0, 4)."""
    w = torch.ones((n_t, a1 - a0, 4), dtype=torch.float32, device=device)
    w[..., 1:] = 0.0 if vel is None else vel[:, a0:a1]
    if weights is not None:
        w *= weights[None, a0:a1, None]
    return w


def sum_units(x, ref, start=None):
    """max over every element of |x − ref| in units of 2⁻²⁴ times the
    magnitudes the element's sum adds (Σ_a |w|, and |acc| before the call):
    a float32 sum's error in those units does not grow where the sum
    cancels, as an error of the column's largest value does."""
    re, im, mag = ref
    scale = mag if start is None else mag + torch.stack([s.abs() for s in start]).amax(0)
    return max(float(((a.double() - r).abs() / (scale * 2.0 ** -24)).max())
               for a, r in zip(x, (re, im)))


def element_units(acc, pos, vel, kv, weight, atom):
    """Max over (t, k, c) of how far ``acc``, the mode stack of one atom
    (weight ``weight``, every other atom's 0), lies from w·(cos θ, sin θ),
    beyond what the float32 rounding of the folded float64 angle θ moves
    it, in units of 2⁻²⁴·|w|, w = fl32(weight · [1, v]).  The allowance for
    the angle is |θ₃₂ − θ| times the other function's magnitude (plus
    (θ₃₂ − θ)²/2): an angle that lies within 10⁻¹³ of a rounding boundary
    may round either way in another float64 order and still meets it."""
    n_ch = acc[0].shape[2]
    theta = pos[:, atom].double() @ kv.double().T
    theta = theta - 2 * torch.pi * torch.round(theta / (2 * torch.pi))
    delta = (theta.float().double() - theta).abs()
    w = weights32(pos.shape[0], vel, torch.full((pos.shape[1],), weight, device=pos.device),
                  atom, atom + 1, pos.device)[:, 0, :n_ch].double()[:, None, :]
    worst = 0.0
    for got, f, other in ((acc[0], torch.cos, torch.sin), (acc[1], torch.sin, torch.cos)):
        allow = (other(theta).abs() * delta + delta ** 2 / 2)[..., None] * w.abs()
        excess = (got.double() - w * f(theta)[..., None]).abs() - allow
        worst = max(worst, float((excess / (w.abs() * 2.0 ** -24)).max()))
    return worst


def one_hot(n_a, atom, weight, device):
    w = torch.zeros(n_a, device=device)
    w[atom] = weight
    return w


CASES = {   # n_t, A, K, C, weights, atom slice, velocities, acc nonzero, acc a row slice
    'ragged K=7': (37, 301, 7, 4, False, False, True, False, False),
    'K=128 split': (64, 1000, 128, 4, True, True, True, True, True),
    'K=130 density': (33, 257, 130, 1, False, True, True, True, False),
    'K=1 split': (5, 2500, 1, 1, True, False, True, False, True),
    'K=130 long': (150, 2100, 130, 4, True, True, True, True, True),
    'no velocities': (9, 129, 128, 4, False, False, False, True, False),
}


def on_card(card, n_t, n_a, n_k, weighted, sliced, seed, with_vel=True):
    pos, vel, kv, w = inputs(n_t, n_a, n_k, weighted, sliced, seed=seed, device=card)
    assert not sliced or pos.stride(0) != 3 * n_a         # an atom slice on the card too
    return pos, vel if with_vel else None, kv, w


def run_case(card, case, seed=0):
    n_t, n_a, n_k, n_ch, weighted, sliced, with_vel, nonzero, rows = case
    pos, vel, kv, w = inputs(n_t, n_a, n_k, weighted, sliced, seed=seed)
    vel = vel if with_vel else None
    rng = np.random.default_rng(seed + 1)
    lead = 3 if rows else 0
    full = [torch.from_numpy((rng.normal(size=(n_t + 2 * lead, n_k, n_ch)) * nonzero)
                             .astype(np.float32)) for _ in range(2)]
    start = [x[lead:lead + n_t].clone() for x in full]
    plain = [x.clone() for x in start]
    tinst.accumulate_modes_plain(*plain, pos, vel, kv, 16, weights=w)
    dev = [x.to(card) for x in full]
    on = on_card(card, n_t, n_a, n_k, weighted, sliced, seed, with_vel)
    tinst.accumulate_modes(*[x[lead:lead + n_t] for x in dev], on[0], on[1], on[2], 16,
                           weights=on[3])
    torch.cuda.synchronize()
    got = [x.cpu() for x in dev]
    for g, f in zip(got, full):                 # rows outside the slice untouched
        assert torch.equal(g[:lead], f[:lead]) and torch.equal(g[lead + n_t:], f[lead + n_t:])
    re, im, mag = (r.cpu() for r in reference64(*on[:3], on[3], n_ch))
    ref = (start[0].double() + re, start[1].double() + im, mag)
    return [g[lead:lead + n_t] for g in got], plain, ref, start


@pytest.mark.chip
@pytest.mark.parametrize('name', list(CASES))
def test_the_kernel_holds_the_plain_chain_and_float64(card, name):
    got, plain, ref, start = run_case(card, CASES[name])
    e_kernel, e_plain = sum_units(got, ref, start), sum_units(plain, ref, start)
    assert e_kernel <= FACTOR * max(e_plain, FLOOR), (name, e_kernel, e_plain)


@pytest.mark.chip
@pytest.mark.parametrize('name', ['ragged K=7', 'K=130 density', 'K=130 long', 'no velocities'])
def test_each_phasor_is_sincosf_of_the_folded_angle(card, name):
    """One atom at a time (a weight of 0.75 on it, 0 on the others): the
    kernel's output is that atom's phasors times its weights, within
    ELEMENT_UNITS of the float64 functions of the folded angle.  The atoms
    sit in the first and a later stage of the AP-atom groups, the ragged
    tail and, split, the last split."""
    n_t, n_a, n_k, n_ch, _, sliced, with_vel, *_ = CASES[name]
    pos, vel, kv, _ = on_card(card, n_t, n_a, n_k, False, sliced, 8, with_vel)
    for atom in sorted({a for a in (0, 5, 130, n_a - 1) if a < n_a}):
        acc = [torch.zeros((n_t, n_k, n_ch), device=card) for _ in range(2)]
        tinst.fused_modes(*acc, pos, vel, kv, one_hot(n_a, atom, 0.75, card))
        units = element_units(acc, pos, vel, kv, 0.75, atom)
        assert units <= ELEMENT_UNITS, (name, atom, units)


@pytest.mark.chip
@pytest.mark.parametrize('name', ['K=128 split', 'ragged K=7'])
def test_two_launches_give_the_same_bits(card, name):
    n_t, n_a, n_k, n_ch, weighted, sliced, *_ = CASES[name]
    pos, vel, kv, w = on_card(card, n_t, n_a, n_k, weighted, sliced, 5)
    outs = []
    for _ in range(2):
        acc = [torch.zeros((n_t, n_k, n_ch), device=card) for _ in range(2)]
        tinst.fused_modes(*acc, pos, vel, kv, w)
        outs.append([x.cpu() for x in acc])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


@pytest.mark.chip
def test_the_density_channel_is_the_same_bits_at_one_and_four_channels(card):
    pos, vel, kv, w = on_card(card, 40, 3000, 130, True, True, 6)
    four = [torch.zeros((40, 130, 4), device=card) for _ in range(2)]
    one = [torch.zeros((40, 130, 1), device=card) for _ in range(2)]
    tinst.fused_modes(*four, pos, vel, kv, w)
    tinst.fused_modes(*one, pos, None, kv, w)
    assert all(torch.equal(f[..., :1], o) for f, o in zip(four, one))


@pytest.mark.chip
def test_the_counters_read_what_the_launches_did(card):
    pos, vel, kv, _ = on_card(card, 20, 700, 50, False, False, 7)
    acc = [torch.zeros((20, 50, 4), device=card) for _ in range(2)]
    before, launched = snapshot(), kernel_launches()
    tinst.accumulate_modes(*acc, pos, vel, kv, 4)
    tinst.accumulate_modes(*[x[:7] for x in acc], pos[:7], vel[:7], kv, 4)
    acc1 = [torch.zeros((20, 50, 1), device=card) for _ in range(2)]
    tinst.accumulate_modes(*acc1, pos, None, kv, 4, phase_mode='incremental',
                           box=torch.eye(3, device=card) * 100)
    elems = 20 * 700 * 50 + 7 * 700 * 50
    assert counted_since(before) == {'launch.phasor_modes': 2, 'phasor.fused_elems': elems,
                                     'phasor.exact_elems': elems}
    assert kernel_launches() == launched + 2


@pytest.mark.chip
def test_the_calculator_runs_the_kernel_on_the_card(card):
    """``calculate_dsf`` and ``calculate_sk`` on the card against the CPU's
    plain chain: one launch per k-chunk, every exact element fused."""
    from psa_tpu_torch.models import make_random_crystal_trajectory
    traj = make_random_crystal_trajectory(n_cells_xyz=(6, 6, 6), basis=2, n_frames=128, seed=2)
    k = tinst.nearest_commensurate(
        np.outer(np.arange(1, 41) * 2 * np.pi / traj.box_lengths[0], [1, 0, 0]),
        traj.box_lengths)
    cpu = SEDCalculator(traj, nx=6, ny=6, nz=6, device='cpu')
    gpu = SEDCalculator(traj, nx=6, ny=6, nz=6, device=card)
    want = cpu.calculate_dsf(k, k_chunk_size=16), cpu.calculate_sk(k, k_chunk_size=16)
    before = snapshot()
    got = gpu.calculate_dsf(k, k_chunk_size=16), gpu.calculate_sk(k, k_chunk_size=16)
    counted = counted_since(before)
    assert counted['launch.phasor_modes'] == 6                   # 3 k-chunks, 2 surfaces
    elems = 2 * traj.n_frames * traj.n_atoms * len(k)
    assert counted['phasor.fused_elems'] == counted['phasor.exact_elems'] == elems
    (_, s, c_l, c_t), sk = got
    (_, s0, c_l0, c_t0), sk0 = want
    for g, w in ((s, s0), (c_l, c_l0), (c_l + c_t, c_l0 + c_t0), (sk, sk0)):
        assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
