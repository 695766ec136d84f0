"""Device (H100): the share of the traced window in which no kernel, copy or
memset ran, in percent (1 − union of the device's intervals / window)."""


def read(trace, record):
    if not trace.device or trace.window_ns() <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_ns() / trace.window_ns())
