"""Profiling and observability utilities.

Carried over from :mod:`psa_tpu.utils.profiling` with the same names and
arguments:

  * :func:`progress_iter` — progress reporting for slow host-side loops;
  * :class:`Timer` / :func:`timed` — wall-clock blocks, fenced on the device
    by :func:`sync` (``torch.cuda.synchronize`` on each CUDA device that
    holds a tensor of the tree; CPU tensors and NumPy arrays need nothing);
  * :func:`trace` — context manager around ``torch.profiler`` writing a
    chrome trace, ``trace.json``, into a directory (``chrome://tracing`` or
    Perfetto open it; the command line's ``--profile`` goes through it),
    and beside it ``counters.json``, the change in :data:`counters` over
    the block;
  * :func:`throughput_report` — normalizes a run into k-points/sec,
    spectra/sec and effective TFLOP/s (the same FLOP model: arithmetic).

The port's own tracing is :func:`span` and :data:`counters`.  A span is a
``torch.profiler.record_function`` range, opened only while a profiler
records; it lies on the profiler's clock beside the device's events, so a
trace puts each kernel and each idle gap of the device down to a stage of
the program.  The spans, each named where the work of its layer happens:

  ====================== ==================================================
  ``psa.project``        each call of ``ops/sed_projection.sed_projection``:
                         the projection kernels' launches (or plain version)
  ``psa.spectrum``       FFT, power and gather of a projection or mode stack:
                         each group's ``spectral.Reduction.reduce`` (one
                         device or a mesh's stripe) and its peaks,
                         ``instantaneous.dsf_reduce``, the gridded
                         ``_Sweep.reduce``
  ``psa.spectrum.peaks`` each ``spectral.peak_reduce``, inside ``psa.spectrum``
  ``psa.phases``         the atom-block loop of the DSF family's mode
                         accumulation (angles, cos/sin, contraction: the
                         fused kernel's launches, or the plain chain)
  ``psa.gridded.spread`` the gridded engine's spread of one ky block
                         (weights, copies, GEMM, ``index_add``), resident or
                         streamed
  ``psa.gridded.budget`` the gridded grid budget (``cudaMemGetInfo``)
  ``psa.groups.gather``  a group made on the device from the calculator's
                         resident install (``SEDCalculator._group_made``):
                         the index upload and the gather
  ``psa.readback.wait``  the host waiting for a result: ``DeviceToHost``'s
                         drain and the calculator's ``_to_host``
  ``psa.host.assemble``  a surface's host result arrays: their allocation,
                         and every readback sink that fills them
  ``psa.stage``          ``HostToDevice.put``: the pinned slot's wait, the
                         host fill and the copy's enqueue
  ``psa.rdf.host``       the cells pair histogram's host passes (occupancy
                         caps, bucketing)
  ``psa.mesh.ingest``    ``parallel/sharded._read_windows``: a mesh's (t, a)
                         windows read from their source and uploaded, or
                         with resident shards the windows' look-up alone
  ``psa.mesh.exchange``  ``parallel/sharded._exchange``: one position's
                         partial made away from its stripe's device, moved
                         there and added (a partial on that device is added
                         in place by the kernel, outside the span)
  ====================== ==================================================

:data:`counters` is a process-wide :class:`collections.Counter`, raised by
:func:`count` (an integer add under a lock, on without a profiler) and read
whole by :func:`snapshot`:

  * ``dtoh_bytes``: bytes read back from the device (``DeviceToHost.push``,
    the calculator's ``_to_host``);
  * ``readback.direct_bytes``: of those, the bytes read back straight into
    a caller's pinned result (``DeviceToHost.push`` with ``into``: a
    ``calculate`` chunk that spans the k axis), not into a staging block;
  * ``htod_bytes``: bytes sent to the device (``HostToDevice.put``, the
    calculator's ``_to_device``);
  * ``groups.requested_bytes``: bytes of group data the one-device
    projections asked for, each group once per k-chunk
    (``core/calculator._Projections``), on any device;
    ``groups.resident_bytes``: of those, the bytes served from the device
    cache or the resident install, which crossed no host link;
  * ``launch.parity``, ``launch.table``, ``launch.product``: launches of the
    projection's kernels (``ops/sed_projection.kernel_launches`` sums
    them); ``launch.phasor_modes``: launches of the fused mode-stack
    kernel (``ops/instantaneous.fused_modes``); :func:`kernel_launches`
    sums every ``launch.`` counter;
  * ``phasor.exact_elems``: n_t·A·K of every 'exact' mode-stack contraction
    (``ops/instantaneous.accumulate_modes``), fused or plain;
    ``phasor.fused_elems``: of those, the ones the fused kernel made;
  * ``parity.time_tiles``, ``parity.angle_tiles``: at each launch of the
    'parity' kernel, the output tiles whose products run and the angle
    tiles made, one per cluster of time tiles
    (``ops/sed_projection.parity_tiles``);
  * ``mesh.ingest_bytes``: bytes copied from the host to a mesh's positions
    for their sweeps (the windows, and the SED's mean positions, weights
    and k-vectors), on any device;
  * ``mesh.exchange_bytes``: bytes of the partials a mesh's SED moved
    between devices into its stripes' buffers (``parallel/sharded._exchange``):
    each partial made away from its buffer's device; none on a mesh of one
    device.

``torch`` is imported inside the functions that need it, so a loader or a
view that only wants :func:`progress_iter` imports nothing heavy.
"""
from __future__ import annotations

import collections
import contextlib
import json
import logging
import math
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)

#: Process-wide counts of what the program moved and launched (module docstring).
counters: collections.Counter = collections.Counter()
_counters_lock = threading.Lock()
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records in
    this thread, else one shared no-op context (a check of well under a
    microsecond).  Use as ``with span('psa.project'): ...``; never keep one
    open across a ``yield``."""
    import torch
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``; threads that count at once lose nothing."""
    with _counters_lock:
        counters[name] += n


def snapshot() -> Dict[str, int]:
    """A copy of :data:`counters` as they stand."""
    with _counters_lock:
        return dict(counters)


def counted_since(before: Dict[str, int]) -> Dict[str, int]:
    """What each counter gained since the :func:`snapshot` ``before``."""
    return {k: v - before.get(k, 0) for k, v in sorted(snapshot().items())
            if v != before.get(k, 0)}


def kernel_launches() -> int:
    """Launches of every hand-written kernel of the port in this process:
    the sum of the counters named ``launch.*``."""
    with _counters_lock:
        return sum(n for name, n in counters.items() if name.startswith('launch.'))


def progress_iter(iterable, total: Optional[int] = None, desc: str = "",
                  callback=None):
    """Progress-reporting wrapper for slow host-side loops.

    ``callback(done, total)`` when given (GUI/status-bar integration);
    otherwise a tqdm bar when tqdm is importable (the reference's behavior
    on OVITO frame loads, reference loader.py:313); otherwise the iterable
    unchanged.  Multi-minute ingest loops (per-frame OVITO compute,
    streaming mean-position passes) should always run through this.
    """
    if callback is not None:
        def gen():
            for i, item in enumerate(iterable):
                yield item
                callback(i + 1, total)
        return gen()
    try:
        from tqdm import tqdm
    except ImportError:
        return iterable
    return tqdm(iterable, total=total, desc=desc, leave=False)


def _cuda_devices(tree: Any, found: set) -> set:
    """CUDA devices of the tensors in a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple, set)):
        for leaf in tree:
            _cuda_devices(leaf, found)
    elif getattr(getattr(tree, 'device', None), 'type', None) == 'cuda':
        found.add(tree.device)
    return found


def sync(tree: Any) -> None:
    """Hard device synchronization on a tree of tensors.

    ``tree`` is a tensor or any nesting of dicts, lists and tuples of them;
    every CUDA device that holds one is drained with
    ``torch.cuda.synchronize``.  A CPU tensor, a NumPy array or ``None``
    needs nothing: the host already has it.
    """
    devices = _cuda_devices(tree, set())
    if devices:
        import torch
        for device in devices:
            torch.cuda.synchronize(device)


@dataclass
class Timer:
    """Accumulating named wall-clock timer.

    Usage:
        t = Timer()
        with t.section('projection'):
            out = kernel(...)
            sync(out)
        print(t.report())
    """
    sections: Dict[str, float] = field(default_factory=dict)
    counts: Dict[str, int] = field(default_factory=dict)

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.sections[name] = self.sections.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        total = sum(self.sections.values())
        lines = [f"{'section':<24}{'time (s)':>10}{'calls':>8}{'share':>8}"]
        for name, t in sorted(self.sections.items(), key=lambda kv: -kv[1]):
            share = 100.0 * t / total if total else 0.0
            lines.append(f"{name:<24}{t:>10.3f}{self.counts[name]:>8}{share:>7.1f}%")
        lines.append(f"{'TOTAL':<24}{total:>10.3f}")
        return "\n".join(lines)


@contextlib.contextmanager
def timed(name: str, sync_tree: Any = None):
    """Log the wall time of a block, optionally fencing on a device tree."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if sync_tree is not None:
            sync(sync_tree)
        logger.info("%s: %.3f s", name, time.perf_counter() - t0)


@contextlib.contextmanager
def trace(log_dir: str):
    """Write a ``torch.profiler`` chrome trace of the enclosed block to
    ``<log_dir>/trace.json`` (host activity with the program's spans, and
    the device's when CUDA is present), and what each of :data:`counters`
    gained over the block to ``<log_dir>/counters.json``."""
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    before = snapshot()
    profiler.start()
    try:
        yield
    finally:
        profiler.stop()
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(str(log_dir / 'trace.json'))
        (log_dir / 'counters.json').write_text(json.dumps(counted_since(before), indent=1))
        logger.info("Profiler trace and counters written to %s", log_dir)


def throughput_report(n_k: int, seconds: float, n_atoms: int, n_t: int,
                      n_pol: int = 3) -> Dict[str, float]:
    """Normalize a SED run into throughput metrics.

    FLOP model (SURVEY.md §3.5): the projection is 2 real matmuls fused into
    one — 2·(n_t·n_pol)·N·(2K) MACs = 8·n_t·n_pol·N·K flops — plus
    n_pol·K FFTs of length n_t (5·n_t·log2(n_t) each).
    """
    proj_flops = 8.0 * n_t * n_pol * n_atoms * n_k
    fft_flops = n_pol * n_k * 5.0 * n_t * math.log2(max(n_t, 2))
    return {
        'k_points_per_sec': n_k / seconds if seconds > 0 else float('inf'),
        'spectra_per_sec': (n_k * n_pol) / seconds if seconds > 0 else float('inf'),
        'effective_tflops': (proj_flops + fft_flops) / seconds / 1e12 if seconds > 0 else 0.0,
        'seconds': seconds,
    }
