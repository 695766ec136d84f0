"""Mesh (``parallel/sharded._exchange``): megabytes of partials exchanged
into the stripes' buffers per call, from what the program's
``mesh.exchange_bytes`` counter gained over the window.  A program without
the counter reads nothing."""


def read(trace, record):
    n_bytes = record['counters'].get('mesh.exchange_bytes')
    if not record['n_calls'] or not n_bytes:
        return None
    return n_bytes / 1e6 / record['n_calls']
