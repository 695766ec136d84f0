"""Kernel (``ops/sed_projection.py`` → ``csrc/*.cu``): the projection stage's
share of its roofline, in percent.

The bound is computed from the calls' shapes (:mod:`benchmark.harness.workcount`:
12·n_t·A·K operations at the TF32 rate, or the bytes read and written once
at HBM bandwidth, whichever is longer), summed over the window's calls, and
divided by the device time of every kernel but cuFFT's, copies and memsets:
the same work, whatever kernels carry the stage."""
from benchmark.harness.workcount import bound_seconds


def read(trace, record):
    work = [w for w in record['work'] if w is not None]
    ns = trace.device_ns(classes=('other', 'gemm'))
    if not work or len(work) != record['n_calls'] or ns <= 0:
        return None
    bound = sum(bound_seconds(flops, nbytes) for flops, nbytes in work)
    return 100.0 * bound / (ns / 1e9)
