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
SHAPE = (8, 4099, 19)        # (n_t, A, K): ragged on every axis
MMA_DEPTH = 8                # atoms per m16n8k8 product


def kernel_constant(name):
    """An ``int`` constant of the kernel source, so the emulation follows it."""
    return int(re.search(rf'constexpr int {name} = (\d+);', KERNEL.read_text()).group(1))


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


def split(x):
    big = tf32(x)
    return big, tf32(x - big)


def emulate(d, c, terms, sum_atoms, chain_atoms):
    """Σ_a d[m, a] c[a, n] along the kernel's path.

    ``terms`` names the MMAs of each k-step, in the kernel's order, as pairs
    of (part of d, part of c) with 'big' or 'small'.  The MMAs of each
    ``chain_atoms`` atoms run from zero in the truncating accumulator.
    """
    n_atoms = d.shape[1]
    pad = -n_atoms % sum_atoms
    d = np.pad(d, ((0, 0), (0, pad)))
    c = np.pad(c, ((0, pad), (0, 0)))
    parts = {'big': 0, 'small': 1}
    d_parts, c_parts = split(d), split(c)
    steps = d.shape[1] // MMA_DEPTH
    # products of each MMA step, exact in float64: (term, step, m, n)
    prods = [np.einsum('msa,san->smn',
                       d_parts[parts[dp]].reshape(d.shape[0], steps, MMA_DEPTH).astype(np.float64),
                       c_parts[parts[cp]].reshape(steps, MMA_DEPTH, -1).astype(np.float64))
             for dp, cp in terms]
    total = np.zeros((d.shape[0], c.shape[1]), np.float32)
    per_sum, per_chain = sum_atoms // MMA_DEPTH, chain_atoms // MMA_DEPTH
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


def kernel_path(d, c, terms):
    return emulate(d, c, terms, kernel_constant('SUM_ATOMS'), kernel_constant('CHAIN_ATOMS'))


def test_kernel_constants_are_read():
    assert kernel_constant('SUM_ATOMS') % kernel_constant('BA') == 0
    assert kernel_constant('BA') % kernel_constant('CHAIN_ATOMS') == 0
    assert kernel_constant('CHAIN_ATOMS') % MMA_DEPTH == 0


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
