"""Per-k-chunk SED checkpointing for resumable sweeps.

Carried over from :mod:`psa_tpu.io.shard_cache` (NumPy only) with the same
key and layout, so a cache written by either package resumes in the other.

The reference caches whole SED results keyed by filename convention
(reference: sed.py:26-69, cli.py:115-124) — an interrupted 200×200-grid run
restarts from zero.  Here a sweep checkpoints per k-chunk under a
content-derived key, so a pod-scale run resumes by recomputing only missing
chunks (SURVEY.md §5.4's rebuild plan).

Key = SHA-256 over (trajectory fingerprint, k-vector bytes, basis, mode,
dtype, precision, engine params) — not filename conventions.
"""
from __future__ import annotations

import hashlib
import json
import logging
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)

_FORMAT_VERSION = 1


def trajectory_fingerprint(traj) -> str:
    """Cheap-but-robust content hash: shapes, dtype, box, and strided samples
    of the data arrays (hashing 1.2 TB in full is not an option)."""
    h = hashlib.sha256()
    for arr in (traj.positions, traj.velocities):
        h.update(str(arr.shape).encode())
        h.update(str(arr.dtype).encode())
        step = max(1, arr.size // 4096)
        # the samples of arr.reshape(-1)[::step], gathered without flattening
        # a non-contiguous (mmap slice, broadcast) array into a full copy
        sample = arr[np.unravel_index(np.arange(0, arr.size, step), arr.shape)]
        h.update(np.ascontiguousarray(sample).tobytes())
    h.update(np.ascontiguousarray(traj.types).tobytes())
    h.update(np.ascontiguousarray(traj.box_matrix).tobytes())
    h.update(np.float64(traj.dt_ps).tobytes())
    if getattr(traj, 'masses', None) is not None:
        h.update(np.ascontiguousarray(traj.masses).tobytes())
    return h.hexdigest()[:16]


def file_fingerprint(path) -> str:
    """Content hash of a file the caller streams rather than loads: size,
    mtime, and sampled stripes (head / middle / tail, 1 MB each) — so an
    in-place overwrite with same-sized different content changes the key."""
    from pathlib import Path as _Path
    p = _Path(path)
    st = p.stat()
    h = hashlib.sha256()
    h.update(f"{st.st_size}:{st.st_mtime_ns}".encode())
    stripe = 1 << 20
    with open(p, 'rb') as f:
        for off in (0, max(0, st.st_size // 2 - stripe // 2),
                    max(0, st.st_size - stripe)):
            f.seek(off)
            h.update(f.read(stripe))
    return h.hexdigest()[:16]


class ShardedSEDCache:
    """Directory of per-chunk .npy files plus a manifest.

    Layout:
        <root>/<key>/manifest.json
        <root>/<key>/chunk_00042.npy
    """

    def __init__(self, root: Path, workload: Dict[str, Any]):
        """``workload`` must uniquely identify the computation; it is hashed
        into the cache key and stored (JSON-serializably) in the manifest."""
        self.root = Path(root)
        self.workload = workload
        self.key = self._make_key(workload)
        self.dir = self.root / self.key
        self.dir.mkdir(parents=True, exist_ok=True)
        self._write_manifest()

    @staticmethod
    def _make_key(workload: Dict[str, Any]) -> str:
        h = hashlib.sha256()
        for k in sorted(workload):
            v = workload[k]
            h.update(k.encode())
            if isinstance(v, np.ndarray):
                h.update(str(v.shape).encode())
                h.update(np.ascontiguousarray(v).tobytes())
            else:
                h.update(json.dumps(v, sort_keys=True, default=str).encode())
        return h.hexdigest()[:16]

    def _write_manifest(self) -> None:
        manifest = self.dir / "manifest.json"
        if manifest.exists():
            return
        meta = {'format_version': _FORMAT_VERSION}
        for k, v in self.workload.items():
            if isinstance(v, np.ndarray):
                meta[k] = {'shape': list(v.shape), 'dtype': str(v.dtype)}
            else:
                meta[k] = v
        with open(manifest, 'w') as f:
            json.dump(meta, f, indent=2, default=str)

    def _chunk_path(self, idx: int) -> Path:
        return self.dir / f"chunk_{idx:05d}.npy"

    def has(self, idx: int) -> bool:
        return self._chunk_path(idx).exists()

    def load(self, idx: int) -> Optional[np.ndarray]:
        path = self._chunk_path(idx)
        if not path.exists():
            return None
        try:
            return np.load(path)
        except Exception as e:  # truncated write from a crashed run
            logger.warning("Corrupt cache chunk %s (%s); recomputing.", path.name, e)
            path.unlink(missing_ok=True)
            return None

    def store(self, idx: int, array: np.ndarray) -> None:
        path = self._chunk_path(idx)
        tmp = path.parent / (path.stem + '.tmp.npy')  # np.save appends .npy otherwise
        np.save(tmp, array)
        tmp.replace(path)  # atomic on POSIX: a crash never leaves half chunks

    def completed_chunks(self) -> int:
        return len(list(self.dir.glob("chunk_[0-9][0-9][0-9][0-9][0-9].npy")))
