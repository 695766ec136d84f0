"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` into an object, one
process per source, all started together, and links them into one shared
library with a plain C interface under ``_build/`` (listed in
``.gitignore``); :func:`load` opens it with :mod:`ctypes`.  A stamp file beside the library
holds the hash of the sources, the headers and the nvcc flags it was built
from; the library is rebuilt when that hash changes.  Importing this module
needs neither ``nvcc`` nor a GPU, so the CPU tests can import every module.
"""
from __future__ import annotations

import ctypes
import hashlib
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

_PTR, _LL, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
#: Entry point -> (argument types, result type) of the library's C interface.
SIGNATURES = {
    # data, mp_hi, mp_lo, kv, out_re, out_im, n_t, n_atoms, n_k, accumulate, stream
    'psa_sed_projection': ([_PTR] * 6 + [_LL] * 3 + [_I32, _PTR], _I32),
    'psa_sed_projection_smem_bytes': ([], _I32),
    'psa_sed_projection_active_clusters': ([], _I32),
    # mp_hi, mp_lo, kv, table, table_bytes, atom0, n_atoms, n_k, tier, stream
    'psa_sed_tier_table': ([_PTR] * 4 + [_LL] * 4 + [_I32, _PTR], _I32),
    # data, table, table_bytes, out_re, out_im, n_t, row_atoms, atom0, n_atoms, n_k,
    # accumulate, tier, stream
    'psa_sed_tier_product': ([_PTR, _PTR, _LL, _PTR, _PTR] + [_LL] * 5 + [_I32, _I32, _PTR], _I32),
    'psa_sed_tier_product_smem_bytes': ([], _I32),
    # pos, pos_st, pos_sa, vel, vel_st, vel_sa, weights, kv, acc_re, acc_im, part,
    # n_t, n_atoms, n_k, n_ch, splits, split_atoms, stream
    'psa_instant_modes': ([_PTR, _LL, _LL, _PTR, _LL, _LL] + [_PTR] * 5 + [_LL] * 3
                          + [_I32, _LL, _LL, _PTR], _I32),
    'psa_instant_modes_active_blocks': ([], _I32),
    'psa_instant_modes_tile': ([_I32], _I32),
}

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


def fingerprint() -> str:
    """Hash of the nvcc flags and of every ``csrc/*.cu`` and ``csrc/*.cuh``."""
    h = hashlib.sha256('\0'.join(NVCC_FLAGS).encode())
    for path in sorted([*SOURCE_DIR.glob('*.cu'), *SOURCE_DIR.glob('*.cuh')]):
        h.update(b'\0' + path.name.encode() + b'\0' + path.read_bytes())
    return h.hexdigest()


def _stamp_path() -> Path:
    return LIB_PATH.with_suffix('.stamp')


def _stale() -> bool:
    stamp = _stamp_path()
    if not (LIB_PATH.is_file() and stamp.is_file()):
        return True
    return stamp.read_text() != fingerprint()


def build() -> None:
    """Compile each ``csrc/*.cu`` into an object (all nvcc runs at once),
    link them into :data:`LIB_PATH` (atomic rename), then stamp it."""
    global build_seconds, build_log
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    stamp = fingerprint()
    nvcc, tag = find_nvcc(), f'{os.getpid()}.tmp'
    tmp = LIB_PATH.with_name(f'{LIB_PATH.name}.{tag}')
    compile_flags = [f for f in NVCC_FLAGS if f != '-shared']
    objects = [LIB_PATH.with_name(f'{src.stem}.{tag}.o') for src in sources()]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([nvcc, *compile_flags, '-c', '-o', str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources(), objects)]
    logs = [f'== {src.name}\n{proc.communicate()[0]}' for src, proc in zip(sources(), procs)]
    failed = [proc.returncode for proc in procs if proc.returncode != 0]
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS, '-o', str(tmp), *map(str, objects)],
                              capture_output=True, text=True)
        logs.append(f'== link\n{link.stdout}{link.stderr}')
        failed = [link.returncode] if link.returncode != 0 else []
    build_log = ''.join(logs)
    for obj in objects:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({failed[0]}):\n{build_log}")
    os.replace(tmp, LIB_PATH)
    _stamp_path().write_text(stamp)
    build_seconds = time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built first if missing or built from other sources or flags."""
    global _lib
    with _lock:
        if _lib is None:
            if _stale():
                build()
            _lib = bind(ctypes.CDLL(str(LIB_PATH)))
        return _lib


def bind(lib: ctypes.CDLL, names=None) -> ctypes.CDLL:
    """Set the argument and result types of ``names`` (default: every entry
    point of :data:`SIGNATURES`) on ``lib``; returns it."""
    for name in SIGNATURES if names is None else names:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name]
    return lib
