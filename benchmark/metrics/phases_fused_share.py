"""Instantaneous phases (``ops/instantaneous.py``): the share of the 'exact'
mode-stack elements that the fused kernel made (``csrc/instant_modes.cu``),
from what the program's ``phasor.fused_elems`` and ``phasor.exact_elems``
counters gained over the window: 1 when every 'exact' contraction ran in the
kernel, 0 when the plain chain made them all.  A program without the
counters reads nothing."""


def read(trace, record):
    exact = record['counters'].get('phasor.exact_elems')
    if not record['n_calls'] or not exact:
        return None
    return record['counters'].get('phasor.fused_elems', 0) / exact
