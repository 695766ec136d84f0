"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into one shared library
with a plain C interface under ``_build/`` (listed in ``.gitignore``), and
:func:`load` opens it with :mod:`ctypes`.  Importing this module needs
neither ``nvcc`` nor a GPU, so the CPU tests can import every module.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG_DIR = Path(__file__).resolve().parent
SOURCE_DIR = _PKG_DIR / 'csrc'
BUILD_DIR = _PKG_DIR / '_build'
LIB_PATH = BUILD_DIR / 'libpsa_kernels.so'

NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: Seconds the last build took in this process (None: loaded without building).
build_seconds: Optional[float] = None
#: nvcc's output of the last build (``-Xptxas -v``: registers, shared memory, spills).
build_log: str = ''


def sources():
    return sorted(SOURCE_DIR.glob('*.cu'))


def find_nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under $CUDA_HOME, else the CUDA default prefix."""
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and (Path(root) / 'bin' / 'nvcc').is_file():
            return str(Path(root) / 'bin' / 'nvcc')
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def _stale() -> bool:
    if not LIB_PATH.is_file():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources())


def build() -> None:
    """Compile ``csrc/*.cu`` into :data:`LIB_PATH` (atomic rename)."""
    global build_seconds, build_log
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f'{LIB_PATH.name}.{os.getpid()}.tmp')
    cmd = [find_nvcc(), *NVCC_FLAGS, '-o', str(tmp), *map(str, sources())]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{build_log}")
    os.replace(tmp, LIB_PATH)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or older than a source."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            lib = ctypes.CDLL(str(LIB_PATH))
            fn = lib.psa_sed_projection
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_longlong] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
