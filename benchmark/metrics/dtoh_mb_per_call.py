"""Readback (``utils/transfer.py::DeviceToHost``, the calculator's
``_to_host``): megabytes read back from the device per call, from what the
program's ``dtoh_bytes`` counter gained over the window.  A program without
the counter reads nothing."""


def read(trace, record):
    n_bytes = record['counters'].get('dtoh_bytes')
    if not record['n_calls'] or not n_bytes:
        return None
    return n_bytes / 1e6 / record['n_calls']
