"""The traced window of a ``--trace 1`` run, reduced from ``torch.profiler``'s events.

The harness marks the window and each call with ``record_function`` spans
(``bench.window``, ``bench.call``).  :func:`from_profiler` keeps, in the
profiler's nanosecond clock, the device's kernels, copies and memsets, the
host's events (torch ops, CUDA runtime calls, the spans), and the window;
the per-layer readers in ``benchmark/metrics/`` take their numbers from the
:class:`Trace` alone.  The categories and the union of device intervals are
those of ``chip_profile.py``.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

WINDOW_SPAN, CALL_SPAN = 'bench.window', 'bench.call'
#: CUDA runtime calls that block the host until the device has caught up
#: (``cudaMemcpy`` is the synchronous copy, not ``cudaMemcpyAsync``).
BLOCKING_CALLS = frozenset({'cudaStreamSynchronize', 'cudaDeviceSynchronize',
                            'cudaEventSynchronize', 'cudaMemcpy'})


def device_kind(name: str) -> str:
    """'copy', 'memset' or 'kernel' for a device event's name."""
    if name.startswith('Memcpy'):
        return 'copy'
    if name.startswith('Memset'):
        return 'memset'
    return 'kernel'


def kernel_class(name: str) -> str:
    """'fft' (cuFFT), 'gemm' (cuBLAS GEMM/GEMV) or 'other' for a kernel's name."""
    low = name.lower()
    if 'fft' in low:
        return 'fft'
    if 'gemm' in low or 'gemv' in low:
        return 'gemm'
    return 'other'


def merged(intervals) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class Trace:
    """Events of one traced window, times in nanoseconds.

    ``device``: (kind, name, start, end) of each kernel, copy and memset;
    ``host``: (name, start, end) of each host event; ``window``: (start, end)
    of the ``bench.window`` span; ``calls``: (start, end) of each call;
    ``cards``: the CUDA device index of each ``device`` event, in its order
    (empty for a trace made by hand: one card).
    """
    window: Tuple[float, float]
    device: List[Tuple[str, str, float, float]] = field(default_factory=list)
    host: List[Tuple[str, float, float]] = field(default_factory=list)
    calls: List[Tuple[float, float]] = field(default_factory=list)
    cards: List[int] = field(default_factory=list)

    def window_ns(self) -> float:
        return self.window[1] - self.window[0]

    def _clipped(self, events):
        w0, w1 = self.window
        for ev in events:
            s, e = max(ev[-2], w0), min(ev[-1], w1)
            if e > s:
                yield ev, s, e

    def busy_ns(self, card: Optional[int] = None) -> float:
        """Length of the union of the device's intervals inside the window;
        with ``card``, of that card's intervals alone."""
        events = self.device if card is None else [
            ev for ev, c in zip(self.device, self.cards) if c == card]
        return sum(e - s for s, e in merged((s, e) for _, s, e in self._clipped(events)))

    def _matching(self, kinds, classes, name_has):
        for (kind, name, _, _), s, e in self._clipped(self.device):
            if kind not in kinds:
                continue
            if kind == 'kernel' and classes is not None and kernel_class(name) not in classes:
                continue
            if name_has is not None and name_has not in name:
                continue
            yield e - s

    def device_ns(self, kinds=('kernel',), classes=None, name_has: Optional[str] = None) -> float:
        """Summed device time inside the window of the events of ``kinds``,
        kernels restricted to :func:`kernel_class` in ``classes``, names
        restricted to those containing ``name_has``."""
        return sum(self._matching(kinds, classes, name_has))

    def count_device(self, kinds=('kernel',), classes=None, name_has: Optional[str] = None) -> int:
        """How many events :meth:`device_ns` sums."""
        return sum(1 for _ in self._matching(kinds, classes, name_has))

    def host_count(self, names) -> int:
        """Host events inside the window whose name is in ``names``."""
        w0, w1 = self.window
        return sum(1 for name, s, _ in self.host if name in names and w0 <= s <= w1)

    def runtime_calls(self) -> int:
        """Host events inside the window that are CUDA runtime calls."""
        w0, w1 = self.window
        return sum(1 for name, s, _ in self.host if name.startswith('cuda') and w0 <= s <= w1)

    def top_device_ops(self, n: int = 10) -> List[List]:
        """[[name, seconds], ...]: the ``n`` device operations with the most time."""
        by_name = {}
        for (_, name, _, _), s, e in self._clipped(self.device):
            by_name[name[:160]] = by_name.get(name[:160], 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10, scan: int = 4000) -> List[List]:
        """[[what the host was doing, seconds], ...]: the device's idle time
        in the window, each gap named by the innermost host event that spans
        its middle (the latest-starting one), summed by name, the ``n``
        largest."""
        w0, w1 = self.window
        busy = merged((s, e) for _, s, e in self._clipped(self.device))
        gaps, cur = [], w0
        for s, e in busy:
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if w1 > cur:
            gaps.append((cur, w1))
        host = sorted((s, e, name) for name, s, e in self.host if name != WINDOW_SPAN)
        starts = [h[0] for h in host]
        by_name = {}
        for g0, g1 in gaps:
            mid = 0.5 * (g0 + g1)
            label = 'no host event'
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - scan), -1):
                if host[j][1] >= mid:
                    label = host[j][2]
                    break
            if label == CALL_SPAN:
                label = 'bench.call (host code outside torch ops)'
            by_name[label[:160]] = by_name.get(label[:160], 0.0) + (g1 - g0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, ns / 1e9] for name, ns in top]


def _ns(event, what: str) -> float:
    """An event's start or duration in nanoseconds, across torch versions."""
    fn = getattr(event, f'{what}_ns', None)
    if fn is not None:
        return float(fn())
    return 1e3 * float(getattr(event, f'{what}_us')())


def _annotation(event) -> bool:
    """True for a ``record_function`` span (torch versions that can tell)."""
    fn = getattr(event, 'is_user_annotation', None)
    return bool(fn()) if fn is not None else False


def from_profiler(prof) -> Trace:
    """The :class:`Trace` of a finished ``torch.profiler.profile`` whose
    recording held one ``bench.window`` span."""
    from torch.autograd import DeviceType
    device, cards, host, calls, window = [], [], [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start = _ns(ev, 'start')
        end = start + _ns(ev, 'duration')
        if ev.device_type() == DeviceType.CUDA:
            # a span's copy on the device's timeline is no device work
            if name not in (WINDOW_SPAN, CALL_SPAN) and not _annotation(ev):
                device.append((device_kind(name), name, start, end))
                cards.append(int(ev.device_index()))
            continue
        host.append((name, start, end))
        if name == WINDOW_SPAN:
            window = (start, end)
        elif name == CALL_SPAN:
            calls.append((start, end))
    if window is None:
        raise RuntimeError(f"the profile holds no {WINDOW_SPAN!r} span")
    return Trace(window=window, device=device, host=host, calls=sorted(calls), cards=cards)
