"""Host driver (``core/calculator.py``): CUDA runtime calls that block the host
until the device catches up (stream, device and event synchronizes and the
synchronous ``cudaMemcpy``), per call of the window."""
from benchmark.harness.trace import BLOCKING_CALLS


def read(trace, record):
    if not record['n_calls'] or not trace.runtime_calls():
        return None
    return trace.host_count(BLOCKING_CALLS) / record['n_calls']
