"""Native (C) fast parsing for trajectory I/O, bound via ctypes.

Carried over from :mod:`psa_tpu.io.native`.  At first use ``cc`` compiles
``fastparse.c`` into ``psa_tpu_torch/_build/libpsa_fastparse.so`` (listed in
``.gitignore``; never next to the source).  A stamp beside the library holds
the sha256 of the source and the compiler flags; any change rebuilds, as
:mod:`psa_tpu_torch._build` does for the CUDA kernels.  Without a compiler
the readers fall back to NumPy's text parsing, which is host parsing only,
several times slower, and logged at warning level when taken.
"""
from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

SOURCE = Path(__file__).resolve().parent / "fastparse.c"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
LIB_PATH = BUILD_DIR / "libpsa_fastparse.so"
CC_FLAGS = ('-O3', '-shared', '-fPIC', '-pthread')

_lock = threading.Lock()
_lib = None
_tried = False
#: Frame bodies parsed by the parallel whole-file parser in this process.
bulk_parses = 0


def fingerprint() -> str:
    """sha256 of the compiler flags and ``fastparse.c``."""
    h = hashlib.sha256('\0'.join(CC_FLAGS).encode())
    h.update(b'\0' + SOURCE.read_bytes())
    return h.hexdigest()


def _stamp_path() -> Path:
    return LIB_PATH.with_suffix('.stamp')


def _stale() -> bool:
    stamp = _stamp_path()
    return not (LIB_PATH.is_file() and stamp.is_file() and stamp.read_text() == fingerprint())


def build() -> None:
    """Compile ``fastparse.c`` into :data:`LIB_PATH` (atomic rename), then stamp it."""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    stamp = fingerprint()
    tmp = LIB_PATH.with_name(f'{LIB_PATH.name}.{os.getpid()}.tmp')
    errors = []
    for cc in ('cc', 'gcc', 'clang'):
        try:
            subprocess.run([cc, *CC_FLAGS, str(SOURCE), '-o', str(tmp)],
                           check=True, capture_output=True, timeout=120)
        except (FileNotFoundError, subprocess.CalledProcessError,
                subprocess.TimeoutExpired) as e:
            errors.append(f"{cc}: {e}")
            continue
        os.replace(tmp, LIB_PATH)
        _stamp_path().write_text(stamp)
        logger.info("Compiled the native parser with %s -> %s", cc, LIB_PATH)
        return
    tmp.unlink(missing_ok=True)
    raise RuntimeError("cannot build the native parser: " + "; ".join(errors))


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, built first if missing or stale; None if
    it cannot be built or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
        except (RuntimeError, OSError) as e:
            logger.warning("Native parser unavailable (%s); trajectory text is parsed "
                           "by NumPy on the host, several times slower.", e)
            return None
        lib.psa_parse_doubles.restype = ctypes.c_long
        lib.psa_parse_doubles.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_double), ctypes.c_long]
        c_longp = ctypes.POINTER(ctypes.c_long)
        lib.psa_scan_dump.restype = ctypes.c_long
        lib.psa_scan_dump.argtypes = [
            ctypes.c_char_p, ctypes.c_long,
            c_longp, c_longp, c_longp, c_longp, ctypes.c_long]
        lib.psa_parse_blocks.restype = ctypes.c_long
        lib.psa_parse_blocks.argtypes = [
            ctypes.c_char_p, c_longp, c_longp, ctypes.c_long,
            ctypes.c_long, ctypes.POINTER(ctypes.c_double),
            ctypes.c_long]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def parse_doubles(text: bytes, n_vals: int) -> np.ndarray:
    """Parse exactly ``n_vals`` whitespace-separated numbers from ``text``.

    Raises ValueError on malformed input or a count mismatch.
    """
    lib = get_lib()
    if lib is None:
        out = np.fromstring(text.decode('ascii'), dtype=np.float64, sep=' ')
        if out.size != n_vals:
            raise ValueError(f"Expected {n_vals} values, parsed {out.size}")
        return out
    out = np.empty(n_vals, dtype=np.float64)
    got = lib.psa_parse_doubles(
        text, len(text),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n_vals)
    if got < 0:
        offset = -(got + 1)
        snippet = text[max(0, offset - 10):offset + 10]
        raise ValueError(f"Malformed number at byte {offset}: {snippet!r}")
    if got != n_vals:
        raise ValueError(f"Expected {n_vals} values, parsed {got}")
    return out


def _as_c_buffer(buf):
    """bytes pass through; writable buffers (mmap ACCESS_COPY, bytearray) are
    wrapped zero-copy; read-only buffers fall back to one copy."""
    if isinstance(buf, bytes):
        return buf
    try:
        return (ctypes.c_char * len(buf)).from_buffer(buf)
    except TypeError:
        return bytes(buf)


def bulk_dump_available() -> bool:
    """True when the parallel whole-file dump parser is loadable."""
    return get_lib() is not None


def scan_dump(buf) -> Optional[tuple]:
    """Locate every frame's ATOMS body in a dump held in ``buf`` (bytes or
    a writable/readonly buffer, e.g. ``mmap``).

    Returns (body_start, body_end, hdr_start, hdr_end) int64 arrays — one
    entry per frame — or None when the native library is unavailable.
    """
    lib = get_lib()
    if lib is None:
        return None
    length = len(buf)
    base = _as_c_buffer(buf)
    # first call with a generous bound; rescan only if it overflows
    cap = 1 << 16
    while True:
        bs = np.empty(cap, dtype=np.int64)
        be = np.empty(cap, dtype=np.int64)
        hs = np.empty(cap, dtype=np.int64)
        he = np.empty(cap, dtype=np.int64)
        lp = ctypes.POINTER(ctypes.c_long)
        n = lib.psa_scan_dump(base, length,
                              bs.ctypes.data_as(lp), be.ctypes.data_as(lp),
                              hs.ctypes.data_as(lp), he.ctypes.data_as(lp),
                              cap)
        if n <= cap:
            return bs[:n], be[:n], hs[:n], he[:n]
        cap = int(n)


def parse_blocks(buf, body_start: np.ndarray, body_end: np.ndarray,
                 vals_per_frame: int, n_threads: int = 0) -> np.ndarray:
    """Parse every frame body in parallel into one
    (n_frames, vals_per_frame) float64 array.

    Raises ValueError naming the first malformed frame.
    """
    global bulk_parses
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native parallel parser unavailable")
    if n_threads <= 0:
        n_threads = min(32, os.cpu_count() or 1)
    n_frames = len(body_start)
    base = _as_c_buffer(buf)
    out = np.empty((n_frames, vals_per_frame), dtype=np.float64)
    bs = np.ascontiguousarray(body_start, dtype=np.int64)
    be = np.ascontiguousarray(body_end, dtype=np.int64)
    lp = ctypes.POINTER(ctypes.c_long)
    rc = lib.psa_parse_blocks(base, bs.ctypes.data_as(lp),
                              be.ctypes.data_as(lp), n_frames, vals_per_frame,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                              n_threads)
    if rc != 0:
        frame = -(rc + 1)
        raise ValueError(f"Frame {frame}: atom block did not contain exactly "
                         f"{vals_per_frame} numbers")
    bulk_parses += n_frames
    return out
