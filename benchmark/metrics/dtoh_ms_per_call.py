"""Readback (``utils/transfer.py::DeviceToHost``): device milliseconds of
device-to-host copies per call."""


def read(trace, record):
    if not record['n_calls'] or not trace.count_device(kinds=('copy',), name_has='DtoH'):
        return None
    return trace.device_ns(kinds=('copy',), name_has='DtoH') / 1e6 / record['n_calls']
