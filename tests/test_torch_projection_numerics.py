"""The number path of the CUDA projection kernel, emulated in NumPy on the CPU.

``psa_tpu_torch/csrc/sed_projection.cu`` multiplies on the tensor cores in
3xTF32 form: each float32 operand x is split into big = tf32(x) and
small = tf32(x - big), rounded as ``cvt.rna.tf32.f32`` rounds (add 0x1000 to
the bits, clear the low 13), and each product d*c becomes
d_small*c_big + d_big*c_small + d_big*c_big, three MMAs of depth 8 per
k-step of 8 atoms.  The tensor cores add to their float32 accumulator with
truncation (round toward zero), so the kernel runs the MMAs of CHAIN_ATOMS
atoms from zero and adds their sum in IEEE float32 to a partial that
restarts every SUM_ATOMS atoms; each partial is then added to the running
total.

The emulation follows that path (each MMA adds its 8 exact products to the
accumulator and truncates once to float32) and is held against the float64
oracle at a small ragged size.  Two other paths must miss the bar, which
shows the test can tell them apart: one TF32 product alone, and three TF32
products chained in the truncating accumulator over a whole partial.

The other two tiers run in ``csrc/sed_projection_tiers.cu`` (a table, then
a wgmma product) with the same two-level sum, its constants read from that
source: 'balanced' splits each operand into hi = rn_bf16(x) and
lo = rn_bf16(x - hi) (round to nearest, ties to even) and takes
lo*hi + hi*lo + hi*hi in MMAs of depth BF16_DEPTH; 'fast' takes the one
product big*big of the TF32 split in MMAs of depth TF32_DEPTH.  Each is
held to its bar against the oracle (5e-5 and 5e-3 of max) and to the
wrapper's plain version of the tier at 1e-6, which rounds the operands the
same way, whole and with the atom axis in blocks (each block's sum added to
the output in float32, as the wrapper adds them past its table cap).
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from psa_tpu_torch.ops import sed_projection as tproj
from psa_tpu_torch.ops.spectral import split_f64

torch.set_num_threads(1)

KERNEL = Path(__file__).resolve().parents[1] / 'psa_tpu_torch' / 'csrc' / 'sed_projection.cu'
TIER_KERNEL = KERNEL.with_name('sed_projection_tiers.cu')   # 'balanced' and 'fast'
SHAPE = (8, 4099, 19)        # (n_t, A, K): ragged on every axis
MMA_DEPTH = 8                # atoms per m16n8k8 product


def kernel_constant(name, source=KERNEL):
    """An ``int`` constant of a kernel source, so the emulation follows it."""
    return int(re.search(rf'constexpr int {name} = (\d+);', source.read_text()).group(1))


def tf32(x):
    """Round float32 to TF32 as cvt.rna.tf32.f32 does."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def truncate(x64):
    """float64 to float32, rounded toward zero (the tensor cores' accumulator)."""
    x32 = x64.astype(np.float32)
    over = np.abs(x32.astype(np.float64)) > np.abs(x64)
    x32[over] = np.nextafter(x32[over], np.float32(0))
    return x32


def bf16(x):
    """Round float32 to bfloat16 (to nearest, ties to even), as float32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    lsb = (bits >> np.uint32(16)) & np.uint32(1)
    return ((bits + np.uint32(0x7FFF) + lsb) & np.uint32(0xFFFF0000)).view(np.float32)


def split(x, rnd=tf32):
    big = rnd(x)
    return big, rnd(x - big)


def emulate(d, c, terms, sum_atoms, chain_atoms, rnd=tf32, depth=MMA_DEPTH):
    """Σ_a d[m, a] c[a, n] along the kernel's path.

    ``terms`` names the MMAs of each k-step, in the kernel's order, as pairs
    of (part of d, part of c) with 'big' or 'small' of the split ``rnd``
    makes.  Each MMA adds its ``depth`` exact products and truncates; the
    MMAs of each ``chain_atoms`` atoms run from zero.
    """
    n_atoms = d.shape[1]
    pad = -n_atoms % sum_atoms
    d = np.pad(d, ((0, 0), (0, pad)))
    c = np.pad(c, ((0, pad), (0, 0)))
    parts = {'big': 0, 'small': 1}
    d_parts, c_parts = split(d, rnd), split(c, rnd)
    steps = d.shape[1] // depth
    # products of each MMA step, exact in float64: (term, step, m, n)
    prods = [np.einsum('msa,san->smn',
                       d_parts[parts[dp]].reshape(d.shape[0], steps, depth).astype(np.float64),
                       c_parts[parts[cp]].reshape(steps, depth, -1).astype(np.float64))
             for dp, cp in terms]
    total = np.zeros((d.shape[0], c.shape[1]), np.float32)
    per_sum, per_chain = sum_atoms // depth, chain_atoms // depth
    for s0 in range(0, steps, per_sum):
        partial = np.zeros_like(total)
        for c0 in range(s0, s0 + per_sum, per_chain):
            mma = np.zeros_like(total)
            for step in range(c0, c0 + per_chain):
                for prod in prods:
                    mma = truncate(mma.astype(np.float64) + prod[step])
            partial = partial + mma
        total = total + partial
    return total


THREE_TF32 = [('small', 'big'), ('big', 'small'), ('big', 'big')]
ONE_TF32 = [('big', 'big')]
#: tier -> (MMA terms, rounding of the split, MMA depth in atoms, bar against the oracle)
TIERS = {'parity': (THREE_TF32, tf32, 8, 1e-6),
         'balanced': (THREE_TF32, bf16, kernel_constant('BF16_DEPTH', TIER_KERNEL), 5e-5),
         'fast': (ONE_TF32, tf32, kernel_constant('TF32_DEPTH', TIER_KERNEL), 5e-3)}


@pytest.fixture(scope='module')
def problem():
    n_t, n_a, n_k = SHAPE
    rng = np.random.default_rng(0)
    data = rng.normal(size=(n_t, n_a, 3)).astype(np.float32)
    mean64 = rng.uniform(0, 50.0, size=(n_a, 3))
    hi, lo = split_f64(mean64)
    kv = rng.uniform(-3, 3, size=(n_k, 3)).astype(np.float32)
    table = tproj.phase_table(*(torch.from_numpy(np.ascontiguousarray(x)) for x in (hi, lo, kv)))
    d = np.ascontiguousarray(data.transpose(0, 2, 1).reshape(n_t * 3, n_a))
    ang = mean64 @ kv.astype(np.float64).T
    oracle = d.astype(np.float64) @ np.concatenate([np.cos(ang), np.sin(ang)], axis=1)
    return data, hi, lo, kv, d, table.numpy(), oracle


def rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def kernel_path(d, c, terms, rnd=tf32, depth=MMA_DEPTH, source=KERNEL):
    return emulate(d, c, terms, kernel_constant('SUM_ATOMS', source),
                   kernel_constant('CHAIN_ATOMS', source), rnd, depth)


def test_kernel_constants_are_read():
    for source in (KERNEL, TIER_KERNEL):
        assert kernel_constant('SUM_ATOMS', source) % kernel_constant('BA', source) == 0
        assert kernel_constant('BA', source) % kernel_constant('CHAIN_ATOMS', source) == 0
    assert kernel_constant('CHAIN_ATOMS') % MMA_DEPTH == 0
    for depth in ('TF32_DEPTH', 'BF16_DEPTH'):   # whole k-steps of each tier per MMA sum
        assert kernel_constant('CHAIN_ATOMS', TIER_KERNEL) % kernel_constant(depth, TIER_KERNEL) == 0


def test_truncate_rounds_toward_zero():
    x = np.array([1.0 + 2.0 ** -24, -(1.0 + 2.0 ** -24), 1.0 - 2.0 ** -26, 3.0])
    np.testing.assert_array_equal(truncate(x), np.float32([1.0, -1.0, 1.0 - 2.0 ** -24, 3.0]))


def test_tf32_rounds_to_nearest_away():
    x = np.array([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                  1.0 + 2.0 ** -12], np.float32)
    want = np.array([1.0, 1.0 + 2.0 ** -10, 1.0 + 2.0 ** -9, -(1.0 + 2.0 ** -10), 1.0], np.float32)
    np.testing.assert_array_equal(tf32(x), want)
    big, small = split(np.float32([np.pi]))
    assert abs(float(big[0]) + float(small[0]) - np.pi) < 2 ** -21


@pytest.mark.parametrize('terms,chained,bound', [(THREE_TF32, False, ('under', 1e-6)),
                                                 (THREE_TF32, True, ('over', 1e-6)),
                                                 (ONE_TF32, False, ('over', 1e-5))],
                         ids=['3xtf32', '3xtf32-chained', '1xtf32'])
def test_emulated_kernel_against_oracle(problem, terms, chained, bound):
    """The kernel's path meets 1e-6 of max|oracle|; chaining the truncating
    accumulator over a whole partial misses it, and one TF32 product misses 1e-5."""
    *_, d, table, oracle = problem
    sum_atoms = kernel_constant('SUM_ATOMS')
    got = (emulate(d, table, terms, sum_atoms, sum_atoms) if chained
           else kernel_path(d, table, terms))
    err = rel(got, oracle)
    side, limit = bound
    assert (err < limit) if side == 'under' else (err > limit), err


def test_emulated_kernel_against_plain(problem):
    """The emulated kernel and the wrapper's plain version agree to 1e-6."""
    data, hi, lo, kv, d, table, _ = problem
    re_, im_ = tproj.sed_projection(*(torch.from_numpy(np.ascontiguousarray(x))
                                      for x in (data, hi, lo, kv)))
    n_t, _, n_k = SHAPE
    plain = torch.cat([re_, im_], dim=2).reshape(n_t * 3, 2 * n_k).numpy()
    assert rel(kernel_path(d, table, THREE_TF32), plain) < 1e-6


def test_bf16_rounds_to_nearest_even():
    """The NumPy model, the plain version's rounding and hand cases agree."""
    x = np.array([1.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, 1.0 + 2.0 ** -8 + 2.0 ** -20,
                  -(1.0 + 3 * 2.0 ** -8), 3.0e-39], np.float32)
    want = np.array([1.0, 1.0, 1.0 + 2.0 ** -6, 1.0 + 2.0 ** -7, -(1.0 + 2.0 ** -6)],
                    np.float32)
    np.testing.assert_array_equal(bf16(x)[:5], want)
    y = np.random.default_rng(5).normal(size=4096).astype(np.float32) * 1e3
    np.testing.assert_array_equal(bf16(y), tproj.round_bf16(torch.from_numpy(y)).numpy())
    np.testing.assert_array_equal(tf32(y), tproj.round_tf32(torch.from_numpy(y)).numpy())
    np.testing.assert_array_equal(bf16(x)[5:], tproj.round_bf16(torch.from_numpy(x[5:])).numpy())
    hi, lo = split(y, bf16)
    assert np.max(np.abs((hi.astype(np.float64) + lo) - y) / np.abs(y)) < 2.0 ** -16


@pytest.mark.parametrize('tier', ['balanced', 'fast'])
def test_emulated_tier_against_oracle_and_plain(problem, tier):
    """Each tier's path meets its bar against the float64 oracle, misses the
    tier above (balanced is not parity, fast is not balanced), and agrees
    with the wrapper's plain version of the tier to 1e-6 of max."""
    data, hi, lo, kv, d, table, oracle = problem
    terms, rnd, depth, bar = TIERS[tier]
    got = kernel_path(d, table, terms, rnd, depth, TIER_KERNEL)
    above = {'balanced': TIERS['parity'][3], 'fast': TIERS['balanced'][3]}[tier]
    assert above < rel(got, oracle) < bar
    re_, im_ = tproj.sed_projection(*(torch.from_numpy(np.ascontiguousarray(x))
                                      for x in (data, hi, lo, kv)), precision=tier)
    n_t, _, n_k = SHAPE
    plain = torch.cat([re_, im_], dim=2).reshape(n_t * 3, 2 * n_k).numpy()
    assert rel(got, plain) < 1e-6


@pytest.mark.parametrize('tier', ['balanced', 'fast'])
def test_emulated_tier_in_atom_blocks(problem, tier):
    """Past its table cap the wrapper runs the atom axis in blocks, each
    block's two-level sum added to the output in float32: that path too
    meets the tier's bar and agrees with the plain version to 1e-6."""
    data, hi, lo, kv, d, table, oracle = problem
    terms, rnd, depth, bar = TIERS[tier]
    n_k = SHAPE[2]
    blocks = tproj.atom_blocks(SHAPE[1], n_k, tproj.table_bytes(40 * tproj.TABLE_ATOMS, n_k))
    assert len(blocks) == 4 and blocks[-1][1] - blocks[-1][0] < blocks[0][1] - blocks[0][0]
    got = np.zeros((d.shape[0], table.shape[1]), np.float32)
    for a0, a1 in blocks:
        got += kernel_path(d[:, a0:a1], table[a0:a1], terms, rnd, depth, TIER_KERNEL)
    assert rel(got, oracle) < bar
    re_, im_ = tproj.sed_projection(*(torch.from_numpy(np.ascontiguousarray(x))
                                      for x in (data, hi, lo, kv)), precision=tier)
    n_t = SHAPE[0]
    plain = torch.cat([re_, im_], dim=2).reshape(n_t * 3, 2 * n_k).numpy()
    assert rel(got, plain) < 1e-6
