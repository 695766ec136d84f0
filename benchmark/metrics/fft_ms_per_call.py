"""Spectrum (``ops/spectral.py``, the FFTs of ``ops/instantaneous.py`` and
``ops/gridded.py``): device milliseconds of cuFFT's kernels per call."""


def read(trace, record):
    if not record['n_calls'] or not trace.count_device(classes=('fft',)):
        return None
    return trace.device_ns(classes=('fft',)) / 1e6 / record['n_calls']
