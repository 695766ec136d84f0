"""Kernel (``ops/sed_projection.py`` → ``csrc/sed_projection.cu``) on a
mesh of four cards: the projection stage's share of the four cards'
roofline, in percent.

Each card's bound is a quarter of the call's work (12·n_t·A·K operations at
the TF32 rate, or the bytes read and written once at HBM bandwidth,
whichever is longer: :mod:`benchmark.harness.workcount`), summed over the
window's calls; it is divided by the mean over the cards of each card's
device time of every kernel but cuFFT's (``Trace.cards``), copies and
memsets, as ``proj_roofline`` does for one card."""
from benchmark.harness.trace import kernel_class
from benchmark.harness.workcount import bound_seconds

#: Cards of the mesh cells: cards 0 … CARDS − 1.
CARDS = 4


def read(trace, record):
    work = [w for w in record['work'] if w is not None]
    if not work or len(work) != record['n_calls'] or not trace.cards:
        return None
    w0, w1 = trace.window
    per_card = [0.0] * CARDS
    for (kind, name, s, e), card in zip(trace.device, trace.cards):
        s, e = max(s, w0), min(e, w1)
        if (kind == 'kernel' and kernel_class(name) in ('other', 'gemm') and e > s
                and 0 <= card < CARDS):
            per_card[card] += e - s
    ns = sum(per_card) / CARDS
    if ns <= 0:
        return None
    bound = sum(bound_seconds(flops / CARDS, nbytes / CARDS) for flops, nbytes in work)
    return 100.0 * bound / (ns / 1e9)
