"""Kernel (``ops/sed_projection.py`` → ``csrc/sed_projection.cu``, 'parity'):
output tiles whose products ran per angle tile made, from what the program's
``parity.time_tiles`` and ``parity.angle_tiles`` counters gained over the
window.  A kernel that makes the angle tile in every time tile reads 1; one
whose clusters of CL time tiles share it reads about CL.  A program without
the counters reads nothing."""


def read(trace, record):
    time_tiles = record['counters'].get('parity.time_tiles')
    angle_tiles = record['counters'].get('parity.angle_tiles')
    if not record['n_calls'] or not time_tiles or not angle_tiles:
        return None
    return time_tiles / angle_tiles
