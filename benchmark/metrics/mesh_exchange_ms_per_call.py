"""Mesh (``parallel/sharded._exchange``): device milliseconds per call of
the peer copies that move the atom shards' partials between cards (copy
events whose name holds ``PtoP``, whichever card records them)."""


def read(trace, record):
    ns = trace.device_ns(kinds=('copy',), name_has='PtoP')
    if not record['n_calls'] or ns <= 0:
        return None
    return ns / 1e6 / record['n_calls']
