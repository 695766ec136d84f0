"""Gridded engine (``ops/gridded.py``): device milliseconds of cuBLAS's GEMM
kernels (the batched float32 ``bmm`` of each group of cells) per call."""


def read(trace, record):
    if not record['n_calls'] or not trace.count_device(classes=('gemm',)):
        return None
    return trace.device_ns(classes=('gemm',)) / 1e6 / record['n_calls']
