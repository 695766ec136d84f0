"""Device cache (``core/calculator.py``: the resident install, the group
cache, ``_Projections``): the share of the group data the projections asked
for that was served from the device, without crossing from the host, from
what the program's ``groups.resident_bytes`` and ``groups.requested_bytes``
counters gained over the window.  1 when every group of every k-chunk was
on the card already.  A program without the counters reads nothing."""


def read(trace, record):
    requested = record['counters'].get('groups.requested_bytes')
    if not record['n_calls'] or not requested:
        return None
    return record['counters'].get('groups.resident_bytes', 0) / requested
