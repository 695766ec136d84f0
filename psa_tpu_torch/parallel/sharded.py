"""Multi-device sweeps over a (t, a, k) mesh on PyTorch (counterpart of
:mod:`psa_tpu.parallel.sharded`).

The JAX package maps the SED onto a ``jax.sharding.Mesh`` with three axes:

  * ``k``: k-points, independent of each other: no collective;
  * ``a``: atoms, the contraction axis: each position projects its atom
    shard and the partials are summed;
  * ``t``: frames: each position projects its time slice and the projected
    signal (small next to the trajectory) is gathered before the time FFT.

PyTorch has no mesh of that kind (``DeviceMesh`` takes one rank per device),
so :class:`Mesh` is explicit: a (t, a, k) array of ``torch.device`` and the
rank that owns each position.  Devices may repeat: eight positions on
``cuda:0`` are the virtual mesh of one card, as the JAX tests' eight
virtual CPU devices are.  Each position's work is a plain call on its
device: the projection of every shard is the kernel's wrapper
(:func:`psa_tpu_torch.ops.sed_projection.sed_projection`), which launches
the CUDA kernel on a card and runs its plain version on the CPU.

Collectives:

  * atoms: inside a process the partials of a (t, k) cell are added in
    ascending atom-shard order on the device of the stripe (the kernel's
    ``accumulate=``; a partial made on another card is copied there first);
    across processes ``dist.all_reduce`` sums the stripe buffers.  Each
    process writes only the rows of its own time positions, the rest are
    zero, so the same sum also assembles the time axis;
  * time: inside a process the slices are rows of one buffer;
  * k: none in the sweep; the reduced outputs of each stripe are made by its
    owner and gathered with ``dist.all_gather_into_tensor``, the JAX
    package's ``process_allgather`` of a k-sharded result.

With a process group the collectives run even for a world of one rank.  A
gloo group takes host tensors: a card's tensor is staged through the host,
and only then.

Data ingestion reads each (t, a) window a process's positions need once,
through a :class:`BlockSource`, and copies it to each device of the
positions that take it; a process reads only the windows of the positions it
owns.  Time superchunks stream through the mesh, the next one read (and
copied) by a prefetch thread while the current one is projected.
"""
from __future__ import annotations

import logging
import math
import threading
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..ops import spectral
from ..ops.sed_projection import sed_projection
from ..utils.transfer import copy_rows

logger = logging.getLogger(__name__)

AXIS_T, AXIS_A, AXIS_K = 't', 'a', 'k'
#: Elements of one position's phasor tile in the mesh's mode stacks (the
#: JAX package's ``_dsf_t_chunk`` budget).
MODE_TILE_ELEMS = 1 << 26
#: Bytes of one position's transient per atom chunk of the per-atom-FFT
#: sweeps (self parts, MSD/VACF), as in the JAX package.
SELF_CHUNK_BYTES = 1 << 30


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

class Mesh:
    """A (t, a, k) array of devices, the rank owning each position, and the
    optional process group joining the ranks.

    ``devices[t, a, k]`` is a ``torch.device`` on its owner; ``owners`` the
    owner's rank in ``group`` (all 0 without a group).  ``shape`` maps the
    axis names to their extents, as ``jax.sharding.Mesh.shape`` does.
    """

    axis_names = (AXIS_T, AXIS_A, AXIS_K)

    def __init__(self, devices: np.ndarray, owners: Optional[np.ndarray] = None,
                 group=None):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != 3:
            raise ValueError(f"a mesh is a (t, a, k) array of devices, got {devices.shape}")
        self.devices = devices
        self.owners = (np.zeros(devices.shape, dtype=np.int64) if owners is None
                       else np.asarray(owners, dtype=np.int64).reshape(devices.shape))
        self.group = group
        self.rank = dist.get_rank(group) if group is not None else 0
        self.world = dist.get_world_size(group) if group is not None else 1
        if self.owners.min() < 0 or self.owners.max() >= self.world:
            raise ValueError(f"owners must be ranks below {self.world}")
        self._local = [(t, a, k, devices[t, a, k]) for t, a, k in np.ndindex(devices.shape)
                       if self.owners[t, a, k] == self.rank]
        if not self._local:
            raise ValueError(f"rank {self.rank} owns no position of the mesh")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local_positions(self) -> List[Tuple[int, int, int, torch.device]]:
        """(t, a, k, device) of the positions this process owns, in C order."""
        return list(self._local)

    @property
    def home(self) -> torch.device:
        """The device of this process's first position."""
        return self.local_positions()[0][3]

    def stripe_home(self, ki: int) -> torch.device:
        """Device of this process's first position in k stripe ``ki``, else
        :attr:`home`: where the stripe's sums and reductions live."""
        for t, a, k, dev in self.local_positions():
            if k == ki:
                return dev
        return self.home

    def stripe_owner(self, ki: int) -> int:
        """Rank that reduces stripe ``ki``: the owner of position (0, 0, ki)."""
        return int(self.owners[0, 0, ki])


def _backend(mesh: Mesh) -> Optional[str]:
    return None if mesh.group is None else dist.get_backend(mesh.group)


def _all_reduce(mesh: Mesh, tensor: torch.Tensor) -> None:
    """In-place sum over the mesh's process group (nothing without one)."""
    if mesh.group is None:
        return
    if _backend(mesh) == 'gloo' and tensor.device.type != 'cpu':
        host = tensor.cpu()
        dist.all_reduce(host, group=mesh.group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, group=mesh.group)


def _all_gather(mesh: Mesh, tensor: torch.Tensor) -> torch.Tensor:
    """(world, *tensor.shape) of every rank's ``tensor``, rank order."""
    src = (tensor.cpu() if _backend(mesh) == 'gloo' else tensor).contiguous()
    out = torch.empty((mesh.world * src.shape[0],) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    dist.all_gather_into_tensor(out, src, group=mesh.group)
    return out.view((mesh.world,) + tuple(src.shape))


def _auto_hbm_bytes(device) -> int:
    """Half the card's memory: the 'auto' budget of :func:`mesh_shape_for`."""
    dev = torch.device(device)
    if dev.type != 'cuda':
        raise ValueError("hbm_bytes='auto' reads the card's memory; on the CPU pass a "
                         "budget in bytes")
    return int(torch.cuda.get_device_properties(dev).total_memory) // 2


def mesh_shape_for(n_devices: int, n_t: Optional[int] = None,
                   n_atoms: Optional[int] = None,
                   hbm_bytes: Optional[Union[int, str]] = None,
                   dtype_bytes: int = 4, device='cuda') -> Tuple[int, int, int]:
    """Factor ``n_devices`` into a (t, a, k) mesh shape.

    Among the factorizations whose per-position trajectory shard (twice, for
    the superchunk in flight) fits the budget, favour the k axis (no
    collective), then atoms, then time.  Without a budget (``n_atoms`` or
    ``hbm_bytes`` omitted) only the preference order counts.  The t factor
    must divide ``n_t`` (the FFT length cannot be padded).

    ``hbm_bytes`` is a per-position budget in bytes, or 'auto': half the
    memory of ``device``'s card (``torch.cuda.get_device_properties``); on
    the CPU 'auto' raises.  If no factorization fits, the one with the
    smallest shard is returned (stream time superchunks through it).
    """
    if hbm_bytes == 'auto':
        hbm_bytes = _auto_hbm_bytes(device)
    budget_active = (hbm_bytes is not None and n_t is not None and n_atoms is not None)

    def shard_bytes(t: int, a: int) -> int:
        return 2 * dtype_bytes * 3 * int(n_t) * int(n_atoms) // (t * a)

    candidates = []
    for t in range(1, n_devices + 1):
        if n_devices % t or (n_t is not None and t > 1 and n_t % t):
            continue
        rest = n_devices // t
        for a in range(1, rest + 1):
            if rest % a:
                continue
            k = rest // a
            fits = (not budget_active) or shard_bytes(t, a) <= hbm_bytes
            candidates.append(((fits, k, a, -t), (t, a, k)))
    candidates.sort()
    best_score, best = candidates[-1]
    if budget_active and not best_score[0]:
        best = min((shape for _, shape in candidates),
                   key=lambda s: (shard_bytes(s[0], s[1]), -s[2]))
        logger.warning("mesh_shape_for: no (t,a,k) factorization of %d devices fits %.1f "
                       "GB/device for %d atoms x %d frames; choosing %s (%.1f GB/device): "
                       "stream time superchunks through it", n_devices, hbm_bytes / 2 ** 30,
                       n_atoms, n_t, best, shard_bytes(best[0], best[1]) / 2 ** 30)
    return best


def make_mesh(n_devices: Optional[int] = None,
              shape: Optional[Tuple[int, int, int]] = None,
              devices: Optional[Sequence] = None,
              n_t: Optional[int] = None,
              n_atoms: Optional[int] = None,
              hbm_bytes: Optional[Union[int, str]] = None,
              k_outer: bool = False, group=None) -> Mesh:
    """Build a (t, a, k) mesh.

    ``devices`` lists every position's device as its owner names it
    ('cuda:0', 'cpu', torch devices; a bare 'cuda' is this thread's current
    card, :func:`psa_tpu_torch.core.calculator.resolve_device`).  Devices may
    repeat: ``devices=['cuda:0'] * 8`` is a virtual 8-position mesh on one
    card.  Default: this process's cards, once per rank of ``group``.  With
    a process group of W ranks the list is split into W equal consecutive
    blocks, rank r owning block r (the order of ``jax.devices()``, process by
    process).  ``n_devices`` keeps the first n entries; ``shape`` defaults
    to :func:`mesh_shape_for`.

    ``k_outer``: the k axis varies slowest over the list, so consecutive
    blocks (processes) each own whole k stripes: the atom and time sums then
    stay inside a process and only the outputs cross.  The cost is ingest:
    every process reads the whole (t, a) window set of its stripes.
    """
    from ..core.calculator import resolve_device
    world = dist.get_world_size(group) if group is not None else 1
    if devices is None:
        n_local = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_local == 0:
            raise RuntimeError("make_mesh: no CUDA card; pass devices=['cpu', ...] "
                               "to build a mesh on the host")
        devices = [f'cuda:{i}' for i in range(n_local)] * world
    devs = [resolve_device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    if len(devs) % world:
        raise ValueError(f"{len(devs)} devices do not split over {world} ranks")
    owners = np.arange(len(devs)) // (len(devs) // world)
    if shape is None:
        shape = mesh_shape_for(len(devs), n_t=n_t, n_atoms=n_atoms, hbm_bytes=hbm_bytes,
                               device=devs[0])
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != len(devs):
        raise ValueError(f"mesh shape {shape} does not cover {len(devs)} devices")
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    if k_outer:
        t_sh, a_sh, k_sh = shape
        arr = arr.reshape(k_sh, t_sh, a_sh).transpose(1, 2, 0)
        owners = owners.reshape(k_sh, t_sh, a_sh).transpose(1, 2, 0)
    return Mesh(arr.reshape(shape), owners.reshape(shape), group)


# ---------------------------------------------------------------------------
# Block sources: random-access (time, atom) windows of the trajectory data
# ---------------------------------------------------------------------------

class BlockSource:
    """Random-access provider of (time, atom) blocks of (n_t, n_atoms, 3) data.

    Implementations expose ``n_frames``/``n_atoms`` and
    ``read_block(t0, t1, a0, a1) -> float32 (t1-t0, a1-a0, 3)``.  The mesh
    sweeps read one block per (t, a) window a process needs, so a source
    backed by ``np.memmap`` (or any lazy store) keeps host memory at the size
    of a superchunk's windows whatever the trajectory's size.
    """

    n_frames: int
    n_atoms: int

    def read_block(self, t0: int, t1: int, a0: int, a1: int) -> np.ndarray:
        raise NotImplementedError


class ArrayBlockSource(BlockSource):
    """Blocks sliced from an array-like: ndarray, np.memmap, or anything
    supporting NumPy basic slicing.  Slicing a memmap reads only the pages
    that cover the window."""

    def __init__(self, data):
        if data.ndim != 3 or data.shape[-1] != 3:
            raise ValueError(f"expected (n_t, n_atoms, 3) data, got {data.shape}")
        self._data = data
        self.n_frames, self.n_atoms = int(data.shape[0]), int(data.shape[1])

    def read_block(self, t0, t1, a0, a1):
        return np.asarray(self._data[t0:t1, a0:a1, :], dtype=np.float32)


class TiledBlockSource(BlockSource):
    """A virtual ``n_frames``-long trajectory tiled from a small in-RAM pool
    along time: frame t is ``pool[t % len(pool)]``.

    A synthetic out-of-core workload: the device pipeline moves the same
    bytes and runs the same work as over a memmap of that shape, without the
    disk.  A window inside one tile is a zero-copy view of the pool.
    """

    def __init__(self, pool, n_frames: int):
        pool = np.asarray(pool)
        if pool.ndim != 3 or pool.shape[-1] != 3:
            raise ValueError(f"expected (pool_frames, n_atoms, 3) pool, got {pool.shape}")
        if pool.dtype != np.float32:
            pool = pool.astype(np.float32)
        if n_frames < 1:
            raise ValueError(f"n_frames must be >= 1, got {n_frames}")
        self._pool = pool
        self.n_frames = int(n_frames)
        self.n_atoms = pool.shape[1]

    def read_block(self, t0, t1, a0, a1):
        if not (0 <= t0 <= t1 <= self.n_frames):
            raise ValueError(f"time window [{t0}, {t1}) outside [0, {self.n_frames})")
        p = self._pool.shape[0]
        lo = t0 % p
        if lo + (t1 - t0) <= p:
            return self._pool[lo:lo + (t1 - t0), a0:a1, :]
        return self._pool[np.arange(t0, t1) % p, a0:a1, :]


class DumpBlockSource(BlockSource):
    """Blocks parsed on demand from a LAMMPS text dump: text straight into
    the mesh, no ``.npy`` conversion.

    Backed by :class:`psa_tpu_torch.io.lammps.MmapDumpFrames` (native scan
    and parallel parse over a copy-on-write mmap).  Atom shards of one time
    window share one parse through a single-window memo, so a mesh costs one
    parse per time window, not one per position.

    Args:
        filepath: dump path (with velocities unless ``field='positions'``).
        field: 'velocities' (default) or 'positions'.
    """

    def __init__(self, filepath, field: str = 'velocities', _share=None):
        from ..io.lammps import MmapDumpFrames
        if field not in ('velocities', 'positions'):
            raise ValueError("field must be 'velocities' or 'positions'")
        if _share is not None:
            self._src, self._state = _share
        else:
            self._src = MmapDumpFrames(filepath)
            # [window, positions, velocities, lock, both]: ``both`` turns on
            # when a sibling exists; a lone source keeps only its own field
            self._state = [None, None, None, threading.Lock(), False]
        if field == 'velocities' and not self._src.has_velocities:
            raise ValueError(f"{self._src.filepath} has no velocity columns; "
                             "use field='positions' with displacement-mode SED")
        self._field = field
        self.n_frames = self._src.n_frames
        self.n_atoms = self._src.n_atoms

    def sibling(self, field: str) -> 'DumpBlockSource':
        """A source over the other field sharing this one's parse memo: each
        text window is parsed once for both the positions and the
        velocities of a DSF sweep."""
        self._state[4] = True
        return DumpBlockSource(None, field=field, _share=(self._src, self._state))

    @property
    def types(self):
        return self._src.types

    @property
    def box_matrix(self):
        return self._src.box_matrix

    def frames(self, i: int, j: int):
        """(positions, velocities) of frames [i, j) (see MmapDumpFrames)."""
        return self._src.frames(i, j)

    def mean_positions64(self, frame_chunk: int = 256, progress=None) -> np.ndarray:
        """float64 mean of the positions, one streaming pass over the dump;
        ``progress`` is an optional ``(done_frames, total_frames)`` callback."""
        from ..utils.profiling import progress_iter
        acc = np.zeros((self.n_atoms, 3), dtype=np.float64)
        starts = list(range(0, self.n_frames, frame_chunk))
        cb = ((lambda done, total: progress(min(done * frame_chunk, self.n_frames),
                                            self.n_frames))
              if progress is not None else None)
        for i in progress_iter(starts, total=len(starts), desc="mean positions", callback=cb):
            pos, _ = self._src.frames(i, min(i + frame_chunk, self.n_frames))
            acc += pos.astype(np.float64).sum(axis=0)
        return acc / self.n_frames

    def read_block(self, t0, t1, a0, a1):
        st = self._state
        with st[3]:
            if st[0] != (t0, t1):
                pos, vel = self._src.frames(t0, t1)
                if st[4]:
                    st[1], st[2] = pos, vel
                elif self._field == 'positions':
                    st[1], st[2] = pos, None
                else:
                    st[1], st[2] = None, vel
                st[0] = (t0, t1)
            memo = st[1] if self._field == 'positions' else st[2]
            if memo is None:                    # the window was parsed before the sibling
                pos, vel = self._src.frames(t0, t1)
                st[1], st[2] = pos, vel
                memo = pos if self._field == 'positions' else vel
            return np.ascontiguousarray(memo[:, a0:a1, :], dtype=np.float32)

    def close(self):
        self._src.close()


def _as_source(data) -> BlockSource:
    return data if hasattr(data, 'read_block') else ArrayBlockSource(data)


# ---------------------------------------------------------------------------
# Shared machinery: shard bounds, window ingestion, stripe buffers
# ---------------------------------------------------------------------------

def _shards(n: int, parts: int) -> List[Tuple[int, int]]:
    """[lo, hi) of ``parts`` consecutive shards of range(n), ⌈n/parts⌉ each
    (the JAX package's padded layout): the last short, trailing ones empty."""
    size = -(-n // parts) if n else 0
    return [(min(i * size, n), min((i + 1) * size, n)) for i in range(parts)]


def _round_t_superchunk(n_t: int, t_sh: int, t_superchunk: Optional[int]) -> int:
    """A requested superchunk rounded to a multiple of the t extent that
    divides n_t (else the whole axis)."""
    if t_superchunk is None or t_superchunk >= n_t:
        return n_t
    t_superchunk = max(t_sh, -(-t_superchunk // t_sh) * t_sh)
    while n_t % t_superchunk and t_superchunk > t_sh:
        t_superchunk -= t_sh
    return n_t if n_t % t_superchunk else t_superchunk


def _check_time_axis(n_t: int, t_sh: int) -> None:
    if n_t % t_sh:
        raise ValueError(f"time axis ({n_t}) must divide evenly over the t mesh axis "
                         f"({t_sh}); the FFT length cannot be padded")


def _to_device(host: np.ndarray, device, dtype=np.float32) -> torch.Tensor:
    """``host`` as a tensor on ``device``; a strided window is gathered into
    a contiguous array first, on several threads (a window of a memmap or of
    a large host array is gigabytes)."""
    host = np.asarray(host)
    if host.flags.c_contiguous and host.flags.writeable and host.dtype == dtype:
        arr = host
    else:
        arr = np.empty(host.shape, dtype=dtype)
        copy_rows(arr, host)
    return torch.from_numpy(arr).to(device)


def _weights(atom_weights, n_atoms: int) -> np.ndarray:
    if atom_weights is None:
        return np.ones(n_atoms, dtype=np.float32)
    w = np.asarray(atom_weights, dtype=np.float32)
    if w.shape != (n_atoms,):
        raise ValueError(f"atom_weights must be ({n_atoms},), got {w.shape}")
    return w


class _Cache:
    """Host arrays sliced and sent to a device once per (key, device)."""

    def __init__(self):
        self._memo = {}

    def get(self, key, device, make):
        full = (key, str(device))
        if full not in self._memo:
            self._memo[full] = make()
        return self._memo[full]


def _read_windows(mesh: Mesh, sources, t_rows: List[Tuple[int, int]],
                  a_bounds: List[Tuple[int, int]], ti_of=None, ai_of=None):
    """{(ti, ai): {device: (tensor per source)}}: each (t, a) window of this
    process's positions read once from each source and copied to every
    device of a position that takes it.  ``ti_of``/``ai_of`` map a
    position to its window indices (default: its t and a)."""
    need: Dict[Tuple[int, int], List[torch.device]] = {}
    for t, a, k, dev in mesh.local_positions():
        key = (ti_of(t, a, k) if ti_of else t, ai_of(t, a, k) if ai_of else a)
        devs = need.setdefault(key, [])
        if dev not in devs:
            devs.append(dev)
    out = {}
    for (ti, ai), devs in need.items():
        (r0, r1), (a0, a1) = t_rows[ti], a_bounds[ai]
        if a1 <= a0 or r1 <= r0:
            continue
        blocks = [np.asarray(src.read_block(r0, r1, a0, a1), dtype=np.float32)
                  for src in sources]
        out[(ti, ai)] = {dev: tuple(_to_device(b, dev) for b in blocks) for dev in devs}
    return out


def _stream(mesh: Mesh, sources, n_t: int, t_superchunk: int, a_bounds, prefetch: bool,
            work) -> None:
    """Time superchunks through the mesh: ``work(rows, windows)`` per
    superchunk, ``rows[ti]`` the global frame rows of time position ti and
    ``windows`` as :func:`_read_windows` gives them.  With ``prefetch`` a
    thread reads and copies the next superchunk while ``work`` runs; a
    failure there raises here."""
    t_sh = mesh.shape[AXIS_T]
    sc_l = t_superchunk // t_sh

    def rows_of(t0):
        return [(t0 + i * sc_l, t0 + (i + 1) * sc_l) for i in range(t_sh)]

    def load(t0):
        return _read_windows(mesh, sources, rows_of(t0), a_bounds)

    starts = list(range(0, n_t, t_superchunk))
    pending = [None, None]

    def load_async(t0):
        def run():
            try:
                pending[:] = [None, load(t0)]
            except BaseException as e:          # noqa: BLE001 — re-raised below
                pending[:] = [e, None]
        th = threading.Thread(target=run, daemon=True)
        th.start()
        return th

    chunk = load(starts[0])
    for i, t0 in enumerate(starts):
        loader = load_async(starts[i + 1]) if prefetch and i + 1 < len(starts) else None
        work(rows_of(t0), chunk)
        chunk = None
        if loader is not None:
            loader.join()
            if pending[0] is not None:
                raise RuntimeError(f"prefetch of superchunk t0={starts[i + 1]} failed"
                                   ) from pending[0]
            chunk = pending[1]
        elif i + 1 < len(starts):
            chunk = load(starts[i + 1])


def _add_into(dst: torch.Tensor, part: torch.Tensor, first: bool) -> None:
    """dst = part (first) or dst += part, ``part`` copied to dst's device."""
    part = part.to(dst.device)
    if first:
        dst.copy_(part)
    else:
        dst.add_(part)


def _stripe_buffers(mesh: Mesh, k_bounds, shape_of, dtype=torch.float32):
    """{ki: zeros(shape_of(kk))} on each stripe's home device: every stripe
    with a process group (the all-reduce takes them all), else the stripes
    this process has positions in; empty stripes are left out."""
    local_k = {k for _, _, k, _ in mesh.local_positions()}
    return {ki: torch.zeros(shape_of(k1 - k0), dtype=dtype, device=mesh.stripe_home(ki))
            for ki, (k0, k1) in enumerate(k_bounds)
            if k1 > k0 and (mesh.group is not None or ki in local_k)}


def _reduce_buffers(mesh: Mesh, bufs: Dict[int, Sequence[torch.Tensor]]) -> None:
    """Sum the stripe buffers over the process group, stripe by stripe."""
    for ki in sorted(bufs):
        for b in bufs[ki]:
            _all_reduce(mesh, b)


def _gather_outputs(mesh: Mesh, k_bounds, reduce, lead_shapes, dtype=torch.float32):
    """Host NumPy outputs, each (*lead, n_k): ``reduce(ki)`` gives the list
    of stripe ki's output tensors (k on the last axis) for the stripes this
    process reduces, the owner's (:meth:`Mesh.stripe_owner`) with a process
    group, every stripe without; the others arrive through
    ``dist.all_gather_into_tensor``.  Empty stripes give no columns."""
    n_k = k_bounds[-1][1]
    outs = [np.zeros(tuple(lead) + (n_k,), dtype=np.float32) for lead in lead_shapes]
    stripes = [ki for ki, (k0, k1) in enumerate(k_bounds) if k1 > k0]
    if mesh.group is None:
        for ki in stripes:
            k0, k1 = k_bounds[ki]
            for o, r in zip(outs, reduce(ki)):
                o[..., k0:k1] = r.cpu().numpy()
        return outs
    mine = {r: [ki for ki in stripes if mesh.stripe_owner(ki) == r] for r in range(mesh.world)}
    slots = max(len(v) for v in mine.values())
    k_max = max(k1 - k0 for k0, k1 in k_bounds)
    sizes = [int(np.prod(lead)) * k_max for lead in lead_shapes]
    packed = torch.zeros((slots, sum(sizes)), dtype=dtype, device=mesh.home)
    for s, ki in enumerate(mine[mesh.rank]):
        k0, k1 = k_bounds[ki]
        col = 0
        for size, lead, r in zip(sizes, lead_shapes, reduce(ki)):
            view = packed[s, col:col + size].view(tuple(lead) + (k_max,))
            view[..., :k1 - k0] = r.to(packed.device)
            col += size
    gathered = _all_gather(mesh, packed).cpu().numpy()        # (world, slots, sum(sizes))
    for r in range(mesh.world):
        for s, ki in enumerate(mine[r]):
            k0, k1 = k_bounds[ki]
            col = 0
            for o, size, lead in zip(outs, sizes, lead_shapes):
                o[..., k0:k1] = gathered[r, s, col:col + size].reshape(
                    tuple(lead) + (k_max,))[..., :k1 - k0]
                col += size
    return outs


# ---------------------------------------------------------------------------
# The SED over the mesh
# ---------------------------------------------------------------------------

def sharded_sed_spectrum(mesh: Mesh, data, mean_pos64: np.ndarray,
                         k_vectors: np.ndarray, precision: str = 'parity',
                         want_intensity: bool = False,
                         t_superchunk: Optional[int] = None,
                         prefetch: bool = True,
                         freq_indices: Optional[np.ndarray] = None,
                         n_peaks: Optional[int] = None,
                         peak_freqs_thz: Optional[np.ndarray] = None,
                         exclusion_bins: int = 4,
                         atom_weights: Optional[Sequence[np.ndarray]] = None,
                         subtract_mean: bool = False,
                         comp_pair: Optional[Tuple[int, int]] = None,
                         angle_range_opt: str = 'C',
                         width_method: str = 'rms',
                         lt: bool = False,
                         welch_segments: int = 1, welch_window: str = 'rect'):
    """SED spectrum over a device mesh, streamed in time superchunks.

    Every position projects its (time slice, atom shard) window onto its k
    stripe through :func:`~psa_tpu_torch.ops.sed_projection.sed_projection`
    (the CUDA kernel on a card), writing into the rows of its time slice of
    the stripe's (n_t, 3, K_stripe) buffer (``out=``) and adding the other
    atom shards to them (``accumulate=``); see the module docstring for the
    collectives.  The FFT and the reductions then run per stripe.

    Args:
        mesh: from :func:`make_mesh`; its t extent must divide n_frames.
        data: (n_t, n_atoms, 3) array-like (ndarray, np.memmap) or a
            :class:`BlockSource`; never read whole.
        mean_pos64: (n_atoms, 3) float64 mean positions.
        k_vectors: (n_k, 3) float32.
        precision: the kernel's tier, 'parity' | 'balanced' | 'fast'.
        want_intensity: return Σ_α|Φ|² instead of the (re, im) pair.
        t_superchunk: frames per superchunk (rounded to a multiple of the t
            extent that divides n_frames); default all frames at once.
        prefetch: read and copy the next superchunk while this one runs.
        freq_indices: kept frequency rows (filtered on the device).
        n_peaks: reduce to the top peaks per k on the device; needs
            ``freq_indices`` and ``peak_freqs_thz`` (THz of the kept rows).
        atom_weights: list of (n_atoms,) per-atom weights (membership, ×√m):
            one scales a coherent spectrum, several are incoherent groups
            whose intensities are summed in the mesh while the data streams
            once (needs ``want_intensity``, ``n_peaks`` or ``lt``).  Each
            group multiplies the data once more before the kernel.
        subtract_mean: ``data`` holds positions; the split float64 mean is
            subtracted on the device (displacement-mode SED).
        comp_pair: polarization pair for the chiral phase (coherent only):
            browse planes (with ``freq_indices`` + ``want_intensity``) or the
            phase at each peak (with ``n_peaks``).
        lt: the longitudinal/transverse split (needs ``freq_indices``;
            exclusive with ``comp_pair``/``n_peaks``).
        welch_segments, welch_window: the segment-averaged estimator
            (intensity outputs; ``freq_indices`` index the segment spectrum).

    Returns:
        Host NumPy, as the JAX function: intensity (n_f, n_k) float32, or
        the (re, im) pair of (n_f, n_k, 3); with ``n_peaks`` the three (four
        with ``comp_pair``) (n_peaks, n_k) arrays; with ``comp_pair`` and
        filtered intensity the (intensity, phase) pair; with ``lt`` (I_L, I_T).
    """
    if n_peaks is not None and (freq_indices is None or peak_freqs_thz is None):
        raise ValueError("n_peaks requires freq_indices and peak_freqs_thz")
    if lt:
        if freq_indices is None:
            raise ValueError("lt=True requires freq_indices")
        if comp_pair is not None or n_peaks is not None:
            raise ValueError("lt=True is exclusive with comp_pair/n_peaks")
    n_groups = len(atom_weights) if atom_weights is not None else 1
    incoherent = n_groups > 1
    if incoherent and not (want_intensity or n_peaks is not None or lt):
        raise ValueError("multiple atom_weights mean incoherent summation: "
                         "set want_intensity=True, n_peaks, or lt")
    if incoherent and comp_pair is not None:
        raise ValueError("chiral phase needs a single (coherent) spectrum")
    if comp_pair is not None and n_peaks is None and not (
            want_intensity and freq_indices is not None):
        raise ValueError("comp_pair requires freq_indices + want_intensity "
                         "(browse planes) or n_peaks (phase at peak)")
    segments = int(welch_segments)
    if segments > 1:
        if lt:
            raise ValueError("welch_segments does not support lt=True")
        if freq_indices is None or not (want_intensity or n_peaks):
            raise ValueError("welch_segments requires freq_indices plus "
                             "want_intensity or n_peaks")
    source = _as_source(data)
    n_t, n_atoms = source.n_frames, source.n_atoms
    k_vectors = np.asarray(k_vectors, dtype=np.float32)
    n_k = k_vectors.shape[0]
    t_sh, a_sh, k_sh = mesh.devices.shape
    _check_time_axis(n_t, t_sh)
    t_superchunk = _round_t_superchunk(n_t, t_sh, t_superchunk)
    weights = None
    if atom_weights is not None:
        weights = []
        for w in atom_weights:
            w = np.asarray(w, dtype=np.float32)
            if w.shape != (n_atoms,):
                raise ValueError(f"atom_weights entries must be ({n_atoms},), got {w.shape}")
            weights.append(w)
    a_bounds, k_bounds = _shards(n_atoms, a_sh), _shards(n_k, k_sh)
    mp_hi, mp_lo = spectral.split_f64(np.asarray(mean_pos64, dtype=np.float64))
    cache = _Cache()

    # [group][re, im]: (n_t, 3, K_stripe) float32 per stripe
    bufs = {ki: [z] + [torch.zeros_like(z) for _ in range(2 * n_groups - 1)]
            for ki, z in _stripe_buffers(mesh, k_bounds, lambda kk: (n_t, 3, kk)).items()}

    def work(rows, windows):
        done = set()
        for ti, ai, ki, dev in mesh.local_positions():
            (a0, a1), (k0, k1) = a_bounds[ai], k_bounds[ki]
            if (ti, ai) not in windows or k1 <= k0:
                continue
            (block,) = windows[(ti, ai)][dev]
            hi = cache.get(('hi', ai), dev, lambda: _to_device(mp_hi[a0:a1], dev))
            lo = cache.get(('lo', ai), dev, lambda: _to_device(mp_lo[a0:a1], dev))
            kv = cache.get(('k', ki), dev, lambda: _to_device(k_vectors[k0:k1], dev))
            if subtract_mean:
                block = spectral.displacement_data(block, hi, lo)
            r0, r1 = rows[ti][0], rows[ti][1]
            first = (ti, ki) not in done
            done.add((ti, ki))
            for g in range(n_groups):
                d = block
                if weights is not None:
                    w = cache.get(('w', g, ai), dev, lambda: _to_device(weights[g][a0:a1], dev))
                    d = block * w[None, :, None]
                dst = (bufs[ki][2 * g][r0:r1], bufs[ki][2 * g + 1][r0:r1])
                if dst[0].device == dev:
                    sed_projection(d, hi, lo, kv, out=dst, accumulate=not first,
                                   precision=precision)
                else:
                    for b, part in zip(dst, sed_projection(d, hi, lo, kv, precision=precision)):
                        _add_into(b, part, first)

    _stream(mesh, (source,), n_t, t_superchunk, a_bounds, prefetch, work)
    _reduce_buffers(mesh, bufs)

    n_f = n_t // segments if freq_indices is None else len(freq_indices)
    stripe_cache = _Cache()

    def on(ki, name, make):
        return stripe_cache.get((name, ki), mesh.stripe_home(ki), make)

    def planes(ki, g):
        """(intensity, phase or None) of group g on stripe ki's kept rows."""
        re, im = bufs[ki][2 * g], bufs[ki][2 * g + 1]
        dev = re.device
        if segments > 1:
            idx = on(ki, 'idx', lambda: _to_device(freq_indices, dev, np.int64))
            return spectral.welch_browse_reduce(re, im, idx, segments, welch_window,
                                                comp_pair=comp_pair,
                                                angle_range_opt=angle_range_opt)
        spec = spectral.finalize_spectrum(re, im)
        if freq_indices is None:
            return spectral._power(spec), None
        idx = on(ki, 'idx', lambda: _to_device(freq_indices, dev, np.int64))
        return spectral.browse_reduce(spec, idx, comp_pair=comp_pair,
                                      angle_range_opt=angle_range_opt)

    def reduce(ki):
        dev = mesh.stripe_home(ki)
        if lt:
            k0, k1 = k_bounds[ki]
            ku = _to_device(spectral.unit_k_vectors(k_vectors[k0:k1]), dev)
            idx = on(ki, 'idx', lambda: _to_device(freq_indices, dev, np.int64))
            i_l = i_t = None
            for g in range(n_groups):
                l_g, t_g = spectral.lt_reduce(
                    spectral.finalize_spectrum(bufs[ki][2 * g], bufs[ki][2 * g + 1]), ku, idx)
                i_l, i_t = (l_g, t_g) if i_l is None else (i_l + l_g, i_t + t_g)
            return [i_l, i_t]
        if n_peaks is not None or want_intensity or incoherent:
            inten = phase = None
            for g in range(n_groups):
                iv, phase = planes(ki, g)
                inten = iv if inten is None else inten + iv
            if n_peaks is None:
                return [inten] + ([phase] if phase is not None else [])
            freqs = _to_device(peak_freqs_thz, dev)
            return list(spectral.peak_reduce(inten, freqs, n_peaks=n_peaks,
                                             exclusion_bins=exclusion_bins, phase=phase,
                                             width_method=width_method))
        spec = spectral.finalize_spectrum(bufs[ki][0], bufs[ki][1])      # (n_t, K, 3)
        if freq_indices is not None:
            spec = spec.index_select(0, on(ki, 'idx', lambda: _to_device(
                freq_indices, dev, np.int64)))
        spec = spec.transpose(1, 2)                                       # k last
        return [spec.real, spec.imag]

    if lt:
        leads = [(n_f,)] * 2
    elif n_peaks is not None:
        leads = [(n_peaks,)] * (4 if comp_pair is not None else 3)
    elif want_intensity or incoherent:
        leads = [(n_f,)] * (2 if comp_pair is not None else 1)
    else:
        leads = [(n_f, 3)] * 2
    outs = _gather_outputs(mesh, k_bounds, reduce, leads)
    if lt or n_peaks is not None or (want_intensity and comp_pair is not None):
        return tuple(outs)
    if want_intensity or incoherent:
        return outs[0]
    return outs[0].transpose(0, 2, 1), outs[1].transpose(0, 2, 1)


# ---------------------------------------------------------------------------
# Instantaneous-phase observables over the mesh (DSF, S(k), ISF, self parts)
# ---------------------------------------------------------------------------

def _phase_args(box, phase_mode: str):
    if phase_mode not in ('exact', 'incremental'):
        raise ValueError(f"the mesh sweeps take phase_mode 'exact' or 'incremental', "
                         f"got {phase_mode!r}")
    if phase_mode == 'incremental' and box is None:
        raise ValueError("phase_mode='incremental' needs the cell matrix (box=)")
    return None if phase_mode == 'exact' else np.asarray(box, dtype=np.float32)


def _mode_stacks(mesh: Mesh, sources, k_vectors: np.ndarray, n_ch: int, t_superchunk,
                 prefetch: bool, weights: np.ndarray, box, phase_mode: str):
    """The (n_t, K_stripe, n_ch) (re, im) mode stacks of every stripe,
    summed over the atom shards and the processes: per position
    :func:`psa_tpu_torch.ops.instantaneous.accumulate_modes` on its window,
    into the rows of its time slice (velocities from ``sources[1]`` when
    n_ch is 4).  Returns (bufs, k_bounds, n_t)."""
    from ..ops import instantaneous
    box_host = _phase_args(box, phase_mode)
    n_t, n_atoms = sources[0].n_frames, sources[0].n_atoms
    t_sh, a_sh, k_sh = mesh.devices.shape
    _check_time_axis(n_t, t_sh)
    t_superchunk = _round_t_superchunk(n_t, t_sh, t_superchunk)
    n_k = len(k_vectors)
    a_bounds, k_bounds = _shards(n_atoms, a_sh), _shards(n_k, k_sh)
    cache = _Cache()
    bufs = {ki: [torch.zeros_like(z), z] for ki, z in _stripe_buffers(
        mesh, k_bounds, lambda kk: (n_t, kk, n_ch)).items()}
    a_loc, k_loc = -(-n_atoms // a_sh), -(-n_k // k_sh)
    t_chunk = max(1, MODE_TILE_ELEMS // max(1, a_loc * k_loc))

    def work(rows, windows):
        done = set()
        for ti, ai, ki, dev in mesh.local_positions():
            (a0, a1), (k0, k1) = a_bounds[ai], k_bounds[ki]
            if (ti, ai) not in windows or k1 <= k0:
                continue
            blocks = windows[(ti, ai)][dev]
            pos, vel = blocks[0], (blocks[1] if n_ch == 4 else None)
            kv = cache.get(('k', ki), dev, lambda: _to_device(k_vectors[k0:k1], dev))
            w = cache.get(('w', ai), dev, lambda: _to_device(weights[a0:a1], dev))
            bx = (None if box_host is None
                  else cache.get('box', dev, lambda: _to_device(box_host, dev)))
            r0, r1 = rows[ti]
            first = (ti, ki) not in done
            done.add((ti, ki))
            dst = [b[r0:r1] for b in bufs[ki]]
            if dst[0].device != dev:
                acc = [torch.zeros(d.shape, dtype=torch.float32, device=dev) for d in dst]
            else:
                acc = dst
            instantaneous.accumulate_modes(*acc, pos, vel, kv, t_chunk, bx, phase_mode,
                                           weights=w)
            if acc is not dst:
                for d, part in zip(dst, acc):
                    _add_into(d, part, first)

    _stream(mesh, sources, n_t, t_superchunk, a_bounds, prefetch, work)
    _reduce_buffers(mesh, bufs)
    return bufs, k_bounds, n_t


def _instant_sources(*data):
    srcs = tuple(_as_source(d) for d in data)
    if len({(s.n_frames, s.n_atoms) for s in srcs}) != 1:
        raise ValueError("positions and velocities extents differ")
    return srcs


def sharded_dsf(mesh: Mesh, positions, velocities, k_vectors: np.ndarray,
                freq_indices: np.ndarray, precision: str = 'parity',
                t_superchunk: Optional[int] = None, prefetch: bool = True,
                atom_weights: Optional[np.ndarray] = None,
                box=None, phase_mode: str = 'exact',
                welch_segments: int = 1, welch_window: str = 'rect'):
    """Dynamic structure factor and current spectra over a device mesh (the
    mesh form of :meth:`SEDCalculator.calculate_dsf`).

    Positions and velocities stream in lockstep superchunks; each position
    accumulates the [ρ, j_x, j_y, j_z] mode stack of its window on its k
    stripe, the atom shards and processes are summed, and each stripe's
    owner reduces it (FFT, (S, C_L, C_T)).

    Args:
        positions, velocities: (n_t, n_atoms, 3) array-likes or
            :class:`BlockSource`\\ s of one extent.
        k_vectors: (n_k, 3) float32, box-commensurate.
        freq_indices: kept frequency rows.
        precision: accepted for the calculator's tiers; the contraction is
            IEEE float32 (as on one device).
        atom_weights: (n_atoms,) per-atom weights (0/1 membership);
            normalization divides by Σw.
        box, phase_mode: 'exact', or 'incremental' with the (3, 3) cell.

    Returns:
        (S, C_L, C_T): (n_keep, n_k) float32 host arrays, divided by Σw.
    """
    from ..ops import instantaneous
    pos_src, vel_src = _instant_sources(positions, velocities)
    k_vectors = np.asarray(k_vectors, dtype=np.float32)
    w = _weights(atom_weights, pos_src.n_atoms)
    bufs, k_bounds, n_t = _mode_stacks(mesh, (pos_src, vel_src), k_vectors, 4, t_superchunk,
                                       prefetch, w, box, phase_mode)
    segments = int(welch_segments)

    def reduce(ki):
        k0, k1 = k_bounds[ki]
        dev = mesh.stripe_home(ki)
        ku = _to_device(spectral.unit_k_vectors(k_vectors[k0:k1]), dev)
        idx = _to_device(freq_indices, dev, np.int64)
        return list(instantaneous.dsf_reduce(*bufs[ki], ku, idx, segments, welch_window))

    n_f = len(freq_indices)
    outs = _gather_outputs(mesh, k_bounds, reduce, [(n_f,)] * 3)
    inv = 1.0 / max(float(w.sum()), 1.0)
    return tuple(o * inv for o in outs)


def _density_stacks(mesh, positions, k_vectors, t_superchunk, prefetch, atom_weights, box,
                    phase_mode):
    (pos_src,) = _instant_sources(positions)
    w = _weights(atom_weights, pos_src.n_atoms)
    bufs, k_bounds, n_t = _mode_stacks(mesh, (pos_src,), np.asarray(k_vectors, np.float32), 1,
                                       t_superchunk, prefetch, w, box, phase_mode)
    return bufs, k_bounds, n_t, float(w.sum())


def sharded_sk(mesh: Mesh, positions, k_vectors: np.ndarray,
               precision: str = 'parity',
               t_superchunk: Optional[int] = None, prefetch: bool = True,
               atom_weights: Optional[np.ndarray] = None,
               box=None, phase_mode: str = 'exact') -> np.ndarray:
    """Static structure factor S(k) = ⟨|ρ_k(t)|²⟩_t / Σw over a device mesh:
    only positions stream and only the density channel accumulates.
    Arguments as in :func:`sharded_dsf`.  Returns (n_k,) float32."""
    from ..ops import instantaneous
    bufs, k_bounds, _, norm = _density_stacks(mesh, positions, k_vectors, t_superchunk,
                                              prefetch, atom_weights, box, phase_mode)
    (out,) = _gather_outputs(mesh, k_bounds, lambda ki: [instantaneous.sk_reduce(*bufs[ki])],
                             [()])
    return out / max(norm, 1.0)


def sharded_isf(mesh: Mesh, positions, k_vectors: np.ndarray, n_lags: int,
                precision: str = 'parity',
                t_superchunk: Optional[int] = None, prefetch: bool = True,
                atom_weights: Optional[np.ndarray] = None,
                box=None, phase_mode: str = 'exact') -> np.ndarray:
    """Coherent intermediate scattering function F(k,τ) over a device mesh:
    the density stacks of :func:`sharded_sk`, each stripe's linear FFT
    autocorrelation as the reduction.  Returns (n_lags, n_k) float32, /Σw."""
    from ..ops import instantaneous
    bufs, k_bounds, _, norm = _density_stacks(mesh, positions, k_vectors, t_superchunk,
                                              prefetch, atom_weights, box, phase_mode)
    (out,) = _gather_outputs(
        mesh, k_bounds, lambda ki: [instantaneous.isf_reduce(*bufs[ki], n_lags)], [(n_lags,)])
    return out / max(norm, 1.0)


def _atom_chunk(atom_chunk: Optional[int], per_atom_bytes: int, n_shards: int) -> int:
    """Atoms per streamed chunk, a multiple of the shard count: by default
    each shard's transient within :data:`SELF_CHUNK_BYTES`."""
    if atom_chunk is None:
        atom_chunk = max(1, SELF_CHUNK_BYTES // max(1, per_atom_bytes)) * n_shards
    return max(n_shards, -(-atom_chunk // n_shards) * n_shards)


def _atom_sweep(mesh: Mesh, source, atom_chunk: int, n_shards: int, shard_of, work) -> None:
    """Full-time atom chunks over the mesh: chunk [c0, c1) splits into
    ``n_shards`` shards, position (t, a, k) takes shard ``shard_of(t, a, k)``;
    ``work(c0, windows)`` with windows keyed (0, shard) as
    :func:`_read_windows` gives them."""
    n_t, n_atoms = source.n_frames, source.n_atoms
    per = atom_chunk // n_shards
    for c0 in range(0, n_atoms, atom_chunk):
        bounds = [(min(c0 + s * per, n_atoms), min(c0 + (s + 1) * per, n_atoms))
                  for s in range(n_shards)]
        work(bounds, _read_windows(mesh, (source,), [(0, n_t)], bounds,
                                   ti_of=lambda t, a, k: 0, ai_of=shard_of))


def _sharded_self_sweep(mesh: Mesh, positions, k_vectors: np.ndarray, kernel,
                        out_rows: int, atom_weights, atom_chunk: Optional[int],
                        per_atom_k_bytes: int) -> np.ndarray:
    """The per-atom-FFT ("self") observables: full time per position, atoms
    over the combined (t, a) axes (shard t·a_sh + a), k stripes apart;
    ``kernel(pos, k, weights)`` gives a shard's (out_rows, K_stripe)
    partial, added on the stripe's device in shard order, chunk after
    chunk.  Returns (out_rows, n_k) / Σw."""
    src = _as_source(positions)
    k_vectors = np.asarray(k_vectors, dtype=np.float32)
    t_sh, a_sh, k_sh = mesh.devices.shape
    k_bounds = _shards(len(k_vectors), k_sh)
    w = _weights(atom_weights, src.n_atoms)
    k_loc = max(1, -(-len(k_vectors) // k_sh))
    atom_chunk = _atom_chunk(atom_chunk, per_atom_k_bytes * k_loc, t_sh * a_sh)
    cache = _Cache()
    bufs = {ki: [z] for ki, z in _stripe_buffers(mesh, k_bounds,
                                                 lambda kk: (out_rows, kk)).items()}

    def work(bounds, windows):
        for t, a, ki, dev in mesh.local_positions():
            s = t * a_sh + a
            (a0, a1), (k0, k1) = bounds[s], k_bounds[ki]
            if (0, s) not in windows or k1 <= k0:
                continue
            (pos,) = windows[(0, s)][dev]
            kv = cache.get(('k', ki), dev, lambda: _to_device(k_vectors[k0:k1], dev))
            _add_into(bufs[ki][0], kernel(pos, kv, _to_device(w[a0:a1], dev)), False)

    _atom_sweep(mesh, src, atom_chunk, t_sh * a_sh, lambda t, a, k: t * a_sh + a, work)
    _reduce_buffers(mesh, bufs)
    (out,) = _gather_outputs(mesh, k_bounds, lambda ki: bufs[ki], [(out_rows,)])
    return out / max(float(w.sum()), 1.0)


def sharded_dsf_self(mesh: Mesh, positions, k_vectors: np.ndarray,
                     freq_indices: np.ndarray,
                     atom_weights: Optional[np.ndarray] = None,
                     atom_chunk: Optional[int] = None,
                     box=None, phase_mode: str = 'exact'):
    """Self (incoherent) dynamic structure factor over a device mesh:
    S_s(k,ω) = Σ_a w_a |FFT_t e^{i k·r_a(t)}|² / (n_t²·Σw).  Each atom's FFT
    needs the whole time axis, so atoms shard over the combined (t, a) axes
    and stream in chunks; k stripes are apart, and the partial planes are
    summed.  Returns (n_keep, n_k) float32."""
    from ..ops import instantaneous
    box_host = _phase_args(box, phase_mode)
    n_t = _as_source(positions).n_frames

    def kernel(pos, kv, w):
        idx = _to_device(freq_indices, pos.device, np.int64)
        bx = None if box_host is None else _to_device(box_host, pos.device)
        return instantaneous.dsf_self_block(pos, kv, idx, bx, phase_mode, weights=w)

    return _sharded_self_sweep(mesh, positions, k_vectors, kernel, len(freq_indices),
                               atom_weights, atom_chunk, 16 * n_t)


def sharded_isf_self(mesh: Mesh, positions, k_vectors: np.ndarray, n_lags: int,
                     atom_weights: Optional[np.ndarray] = None,
                     atom_chunk: Optional[int] = None,
                     box=None, phase_mode: str = 'exact'):
    """Self intermediate scattering function F_s(k,τ) over a device mesh:
    the sharding of :func:`sharded_dsf_self` with the linear FFT
    autocorrelation.  Returns (n_lags, n_k) float32, /Σw."""
    from ..ops import instantaneous
    box_host = _phase_args(box, phase_mode)
    n_t = _as_source(positions).n_frames

    def kernel(pos, kv, w):
        bx = None if box_host is None else _to_device(box_host, pos.device)
        return instantaneous.isf_self_block(pos, kv, n_lags, bx, phase_mode, weights=w)

    return _sharded_self_sweep(mesh, positions, k_vectors, kernel, n_lags, atom_weights,
                               atom_chunk, 16 * instantaneous._autocorr_fft_len(n_t))


# ---------------------------------------------------------------------------
# k-independent observables: MSD/VACF and the g(r) pair sweep
# ---------------------------------------------------------------------------

def sharded_timecorr(mesh: Mesh, data, kind: str, n_lags: int,
                     atom_weights: Optional[np.ndarray] = None,
                     atom_chunk: Optional[int] = None) -> np.ndarray:
    """MSD ('msd', positions) or VACF ('vacf', velocities) over a device
    mesh for one atom group.  The per-atom FFT needs the whole time axis,
    so atoms shard over all the mesh's positions (the observable has no k)
    and stream in chunks; each position's float32 partial sum is added in
    float64 in position order, and the only collective is the sum over the
    processes.  ``atom_weights`` multiply the data (0/1 membership);
    normalization divides by Σw.  Returns (n_lags,) float32."""
    from ..ops import timecorr
    from ..ops.instantaneous import _autocorr_fft_len
    if kind not in ('msd', 'vacf'):
        raise ValueError(f"kind must be 'msd' or 'vacf', got {kind!r}")
    src = _as_source(data)
    w = _weights(atom_weights, src.n_atoms)
    n_pos = mesh.size
    atom_chunk = _atom_chunk(atom_chunk, 48 * _autocorr_fft_len(src.n_frames), n_pos)
    fn = timecorr.msd_block if kind == 'msd' else timecorr.vacf_block
    acc = torch.zeros(n_lags, dtype=torch.float64, device=mesh.home)
    t_sh, a_sh, k_sh = mesh.devices.shape

    def flat(t, a, k):
        return (t * a_sh + a) * k_sh + k

    def work(bounds, windows):
        for t, a, k, dev in mesh.local_positions():
            s = flat(t, a, k)
            if (0, s) not in windows:
                continue
            (block,) = windows[(0, s)][dev]
            a0, a1 = bounds[s]
            part = fn(block * _to_device(w[a0:a1], dev)[None, :, None], n_lags)
            acc.add_(part.double().to(acc.device))

    _atom_sweep(mesh, src, atom_chunk, n_pos, flat, work)
    _all_reduce(mesh, acc)
    return (acc.cpu().numpy() / max(float(w.sum()), 1.0)).astype(np.float32)


def rdf_sweep_step(mesh: Mesh, n_bins: int, block: int, b_block: Optional[int] = None):
    """The g(r) pair sweep of one frame chunk over a device mesh: the A
    atoms shard over all the mesh's positions, the B atoms go whole to each
    device, and each position sweeps its A rows against all of B in
    (``block``, ``b_block``) tiles (:func:`psa_tpu_torch.ops.structure.rdf_sweep`);
    the integer counts are summed exactly over the positions and the
    processes.

    Returns ``step(pos_a, ids_a, pos_b, ids_b, h, h_inv, r_max) -> (n_bins,)
    int64`` taking host arrays: positions (t, N, 3) float32, global ids
    (N,) int, ``h``/``h_inv`` the host (3, 3) cell and its inverse."""
    from ..ops import structure
    t_sh, a_sh, k_sh = mesh.devices.shape

    def step(pos_a, ids_a, pos_b, ids_b, h, h_inv, r_max):
        shards = _shards(pos_a.shape[1], mesh.size)
        cache = _Cache()
        counts = torch.zeros(n_bins, dtype=torch.int64, device=mesh.home)
        for t, a, k, dev in mesh.local_positions():
            a0, a1 = shards[(t * a_sh + a) * k_sh + k]
            if a1 <= a0:
                continue
            pa = _to_device(pos_a[:, a0:a1], dev)
            ia = _to_device(ids_a[a0:a1], dev, np.int64)
            pb = cache.get('pb', dev, lambda: _to_device(pos_b, dev))
            ib = cache.get('ib', dev, lambda: _to_device(ids_b, dev, np.int64))
            part = structure.rdf_sweep(pa, ia, pb, ib, h, h_inv, r_max, n_bins, block, b_block)
            counts.add_(part.to(counts.device))
        _all_reduce(mesh, counts)
        return counts.cpu().numpy()

    return step
