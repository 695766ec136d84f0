"""When the kernel library is rebuilt: ``psa_tpu_torch._build`` without nvcc.

A fake ``nvcc`` (a Python script that writes the ``-o`` file and logs its
arguments) stands in for the compiler, and the source and build directories
point into ``tmp_path``, so the whole of :func:`_build.build` runs on the CPU.
"""
import os
import stat
import sys

import pytest

from psa_tpu_torch import _build


@pytest.fixture
def tree(tmp_path, monkeypatch):
    src = tmp_path / 'csrc'
    src.mkdir()
    (src / 'kernel.cu').write_text('#include "tile.cuh"\n__global__ void k() {}\n')
    (src / 'tile.cuh').write_text('constexpr int BT = 64;\n')
    (src / 'tiers.cu').write_text('__global__ void t() {}\n')
    nvcc = tmp_path / 'nvcc'
    nvcc.write_text(f'#!{sys.executable}\n'
                    'import sys\n'
                    'args = sys.argv[1:]\n'
                    f'open({str(tmp_path / "calls")!r}, "a").write(" ".join(args) + "\\n")\n'
                    'open(args[args.index("-o") + 1], "wb").write(b"lib")\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    build_dir = tmp_path / '_build'
    monkeypatch.setattr(_build, 'SOURCE_DIR', src)
    monkeypatch.setattr(_build, 'BUILD_DIR', build_dir)
    monkeypatch.setattr(_build, 'LIB_PATH', build_dir / 'libpsa_kernels.so')
    monkeypatch.setattr(_build, 'find_nvcc', lambda: str(nvcc))
    return src


def test_fresh_after_build(tree):
    assert _build._stale()
    _build.build()
    assert _build.LIB_PATH.read_bytes() == b'lib'
    assert not _build._stale()
    # a touch that changes no byte leaves the library fresh
    lib_time = _build.LIB_PATH.stat().st_mtime
    os.utime(tree / 'kernel.cu', (lib_time + 10, lib_time + 10))
    assert not _build._stale()


def test_each_source_compiles_then_links(tree):
    """One compile per source, then one link of their objects; the objects
    are removed after the link."""
    _build.build()
    calls = (tree.parent / 'calls').read_text().splitlines()
    compiles = [c for c in calls if ' -c ' in c]
    assert sorted(c.split()[-1].rsplit('/', 1)[-1] for c in compiles) == ['kernel.cu', 'tiers.cu']
    assert all('-shared' not in c.split() for c in compiles)
    link = calls[-1].split()
    assert '-shared' in link and sum(a.endswith('.o') for a in link) == 2
    assert not list(_build.BUILD_DIR.glob('*.o'))
    assert '== kernel.cu' in _build.build_log and '== tiers.cu' in _build.build_log


@pytest.mark.parametrize('change', ['header_edited', 'header_added', 'source_edited',
                                    'second_source_edited', 'flags_changed', 'stamp_missing'])
def test_stale_after_change(tree, monkeypatch, change):
    _build.build()
    assert not _build._stale()
    if change == 'header_edited':
        (tree / 'tile.cuh').write_text('constexpr int BT = 128;\n')
    elif change == 'header_added':
        (tree / 'ring.cuh').write_text('constexpr int STAGES = 3;\n')
    elif change == 'source_edited':
        (tree / 'kernel.cu').write_text('__global__ void k2() {}\n')
    elif change == 'second_source_edited':
        (tree / 'tiers.cu').write_text('__global__ void t2() {}\n')
    elif change == 'flags_changed':
        monkeypatch.setattr(_build, 'NVCC_FLAGS', _build.NVCC_FLAGS + ('-lineinfo',))
    else:
        _build.LIB_PATH.with_suffix('.stamp').unlink()
    # the library itself is older than nothing: only its recorded inputs differ
    lib_time = _build.LIB_PATH.stat().st_mtime
    for path in tree.iterdir():
        os.utime(path, (lib_time - 10, lib_time - 10))
    assert _build._stale()
