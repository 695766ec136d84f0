"""The program's own spans in a traced window.

The port opens ``record_function`` ranges named ``psa.*`` where each stage's
work happens (the vocabulary is in ``psa_tpu_torch/utils/profiling.py``).
In a :class:`~benchmark.harness.trace.Trace` they are host events, on the
profiler's clock beside the device's events.  :func:`idle_in_span_ns` is the
device's idle time while the host was inside the spans of one stage: the
host time that stage costs the device.  A trace of a program without such
spans reads none.  Nothing of the program is imported.
"""
from __future__ import annotations

from typing import List, Tuple

from benchmark.harness.trace import merged


def span_intervals(trace, prefix: str) -> List[Tuple[float, float]]:
    """The union, inside the window, of the host spans named ``prefix`` or
    ``prefix.<anything>``."""
    return merged((s, e) for (name, _, _), s, e in trace._clipped(trace.host)
                  if name == prefix or name.startswith(prefix + '.'))


def idle_intervals(trace) -> List[Tuple[float, float]]:
    """The window's intervals in which the device ran no kernel, copy or
    memset (the gaps :meth:`~benchmark.harness.trace.Trace.idle_gaps` names)."""
    gaps, cur = [], trace.window[0]
    for s, e in merged((s, e) for _, s, e in trace._clipped(trace.device)):
        if s > cur:
            gaps.append((cur, s))
        cur = max(cur, e)
    if trace.window[1] > cur:
        gaps.append((cur, trace.window[1]))
    return gaps


def overlap_ns(a: List[Tuple[float, float]], b: List[Tuple[float, float]]) -> float:
    """Length of the intersection of two sorted lists of disjoint intervals."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_span_ns(trace, prefix: str) -> float:
    """Nanoseconds of the window in which the device sat idle while the host
    was inside a span named ``prefix`` or ``prefix.*``."""
    return overlap_ns(idle_intervals(trace), span_intervals(trace, prefix))
