"""Host↔device transfers that overlap the device's work.

:class:`HostToDevice` streams host blocks (atom blocks of a group larger
than ``max_device_bytes``, frame blocks of a dump) to the device through two
pinned staging buffers: block b+1 is filled on the host and copied on a side
stream while the kernels of block b run.  :class:`DeviceToHost` reads
per-chunk results back the other way: chunk i's copy into pinned memory (staging
blocks, or the caller's own pinned result) runs on a side stream, and the
host assembles chunk i while the device computes chunk i+1.

Both are the identity on the CPU (a CPU-only torch cannot pin memory): a
block is handed over as it is, a result is read where it lies.
"""
from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import debug
from .profiling import count, span

_pool: Optional[ThreadPoolExecutor] = None


def _threads() -> int:
    return max(1, min(8, os.cpu_count() or 1))


def copy_rows(dst: np.ndarray, src: np.ndarray) -> None:
    """``dst[...] = src`` (casting), split over threads along the first axis
    when it is 16 MB or more.

    NumPy releases the GIL while it copies, so a strided multi-GB gather
    (one atom block of an (n_t, N, 3) trajectory) runs on several cores.
    """
    n, n_threads = dst.shape[0], _threads()
    if n_threads == 1 or n < 2 * n_threads or dst.nbytes < (1 << 24):
        np.copyto(dst, src, casting='unsafe')
        return
    _pool_map(lambda a, b: np.copyto(dst[a:b], src[a:b], casting='unsafe'), n)


def _pool_map(fn, n: int) -> None:
    """``fn(a, b)`` over ``_threads()`` spans [a, b) of range(n), on the pool."""
    global _pool
    if _pool is None:
        _pool = ThreadPoolExecutor(max_workers=_threads(), thread_name_prefix='psa-copy')
    bounds = np.linspace(0, n, _threads() + 1).astype(int)
    jobs = [_pool.submit(fn, a, b) for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
    for job in jobs:
        job.result()


def gather_atoms(dst: np.ndarray, src: np.ndarray, cols: np.ndarray) -> None:
    """``dst[...] = src[:, cols]`` for (n_t, N, 3) ``src`` and (n_t, len(cols), 3)
    ``dst``, split over threads along the time axis when it is 16 MB or more
    (NumPy releases the GIL while it gathers)."""
    def take(a, b):
        if src.dtype == dst.dtype:
            np.take(src[a:b], cols, axis=1, out=dst[a:b], mode='clip')
        else:
            dst[a:b] = src[a:b][:, cols]
    n = dst.shape[0]
    if _threads() == 1 or n < 2 * _threads() or dst.nbytes < (1 << 24):
        take(0, n)
    else:
        _pool_map(take, n)


class HostToDevice:
    """Double-buffered, pinned host→device staging of float32 blocks.

    ``put(fill, shape)`` hands ``fill`` a host array of ``shape`` to write
    the block into and returns the block on the device, ordered after its
    copy on the current stream.  On CUDA, the host array is one of two
    pinned buffers, the copy runs ``non_blocking`` on a side stream, and
    events order it after the kernels that read the same slot two blocks
    earlier; the device tensor stays valid until the next-but-one ``put``.
    ``bytes_moved`` counts the bytes put; on CUDA they also raise the
    ``htod_bytes`` counter (:mod:`~psa_tpu_torch.utils.profiling`), and each
    put is a ``psa.stage`` span.
    """

    def __init__(self, device: torch.device, max_elems: int):
        self.device = torch.device(device)
        self.max_elems = int(max_elems)
        self.bytes_moved = 0
        self._n = 0
        if self.device.type == 'cuda':
            self._stream = torch.cuda.Stream(device=self.device)
            self._host = [torch.empty(self.max_elems, dtype=torch.float32, pin_memory=True)
                          for _ in range(2)]
            self._dev = [torch.empty(self.max_elems, dtype=torch.float32, device=self.device)
                         for _ in range(2)]
            self._copied = [torch.cuda.Event() for _ in range(2)]
            self._used = [torch.cuda.Event() for _ in range(2)]

    def put(self, fill: Callable[[np.ndarray], None], shape: Tuple[int, ...]) -> torch.Tensor:
        numel = int(np.prod(shape))
        if numel > self.max_elems:
            raise ValueError(f"block of {numel} floats exceeds the staging size {self.max_elems}")
        self.bytes_moved += 4 * numel
        with span('psa.stage'):
            if self.device.type != 'cuda':
                host = np.empty(shape, dtype=np.float32)
                fill(host)
                return torch.from_numpy(host)
            count('htod_bytes', 4 * numel)
            slot, current = self._n % 2, torch.cuda.current_stream(self.device)
            # everything enqueued so far, the kernels on the previous block
            # included, comes before the copy that reuses that block's slot
            self._used[(self._n + 1) % 2].record(current)
            self._copied[slot].synchronize()          # the pinned slot's last copy has left it
            host = self._host[slot][:numel].view(shape)
            fill(host.numpy())
            dev = self._dev[slot][:numel].view(shape)
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(self._used[slot])
                dev.copy_(host, non_blocking=True)
                self._copied[slot].record(self._stream)
            current.wait_event(self._copied[slot])
            self._n += 1
            return dev


class DeviceToHost:
    """One-deep device→host pipeline of per-chunk results.

    ``push(tensors, sink, into=None)`` enqueues the copy of ``tensors``
    (results of the current stream) into pinned host memory on a side
    stream, then hands the previous push's host arrays to its ``sink``, so
    the host assembles chunk i while the device works on chunk i+1.
    ``finish()`` drains the last.  Without ``into`` the copy lands in fresh
    staging blocks of PyTorch's pinned cache, which are reused once the sink
    returns: a sink must copy what it keeps of them.  ``into`` names the
    caller's own host tensors (contiguous, pinned on CUDA, each of its
    tensor's shape and dtype) for the copy to land in; the sink then gets
    their arrays, which stay the caller's.  On the CPU, ``push`` calls
    ``sink`` at once with the tensors' arrays, or with ``into``'s once the
    tensors are copied there.  On CUDA the bytes pushed raise the
    ``dtoh_bytes`` counter, those that land in ``into`` also
    ``readback.direct_bytes`` (:mod:`~psa_tpu_torch.utils.profiling`); the
    wait for a copy is a ``psa.readback.wait`` span, each sink a
    ``psa.host.assemble`` span.
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._pending = None
        if self.device.type == 'cuda':
            self._stream = torch.cuda.Stream(device=self.device)

    def push(self, tensors: Sequence[torch.Tensor],
             sink: Callable[[List[np.ndarray]], None],
             into: Optional[Sequence[torch.Tensor]] = None) -> None:
        where = debug.caller() if debug.active else None
        if self.device.type != 'cuda':
            if into is not None:
                for h, t in zip(into, tensors):
                    h.copy_(t)
                tensors = into
            self._hand_over([t.numpy() for t in tensors], sink, where)
            return
        n_bytes = sum(t.nbytes for t in tensors)
        count('dtoh_bytes', n_bytes)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        if into is None:
            hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        else:
            count('readback.direct_bytes', n_bytes)
            hosts = list(into)
        done = torch.cuda.Event()
        with torch.cuda.stream(self._stream):
            self._stream.wait_event(ready)
            for h, t in zip(hosts, tensors):
                h.copy_(t, non_blocking=True)
            done.record(self._stream)
        previous, self._pending = self._pending, (done, hosts, list(tensors), sink, where)
        self._drain(previous)

    def finish(self) -> None:
        previous, self._pending = self._pending, None
        self._drain(previous)

    @staticmethod
    def _hand_over(arrays: List[np.ndarray], sink, where: Optional[str]) -> None:
        """Give ``sink`` the host arrays; under :mod:`debug`'s mode (``where``
        names the sweep that pushed them), checked first."""
        if where is not None:
            debug.check_arrays(where, arrays)
        with span('psa.host.assemble'):
            sink(arrays)

    @classmethod
    def _drain(cls, entry) -> None:
        if entry is None:
            return
        done, hosts, _sources, sink, where = entry    # the sources stay alive until copied
        with span('psa.readback.wait'):
            done.synchronize()
        cls._hand_over([h.numpy() for h in hosts], sink, where)
