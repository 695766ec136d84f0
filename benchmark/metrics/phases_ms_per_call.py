"""Instantaneous phases (``ops/instantaneous.py``): device milliseconds per
call of every kernel but cuFFT's (the angle chain, cos/sin and the atom
contraction), copies and memsets apart."""


def read(trace, record):
    if not record['n_calls'] or not trace.count_device(classes=('other', 'gemm')):
        return None
    return trace.device_ns(classes=('other', 'gemm')) / 1e6 / record['n_calls']
