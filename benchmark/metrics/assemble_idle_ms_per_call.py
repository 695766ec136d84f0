"""Host driver (``psa.host.assemble``: a surface's host result arrays, their
allocation and the readback sinks that fill them): milliseconds per call in
which the device sat idle while the host assembled the answer.  A program
without the span reads nothing."""
from benchmark.harness.spans import idle_in_span_ns, span_intervals

SPAN = 'psa.host.assemble'


def read(trace, record):
    if not record['n_calls'] or not span_intervals(trace, SPAN):
        return None
    return idle_in_span_ns(trace, SPAN) / 1e6 / record['n_calls']
