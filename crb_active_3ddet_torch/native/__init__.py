"""Host C++ helpers of the port, built with g++ at first use and loaded with
``ctypes``.

Copy of ``crb_active_3ddet_tpu/native/__init__.py``'s loader, with one
change: ``lib<name>.so`` is built into the package's git-ignored
``_build/`` directory (beside the CUDA kernels' libraries), never next to
its source.  A library is rebuilt when its source is newer; the compiler
writes a temporary file that is renamed into place, so that processes
building at once do not load a half-written library.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from pathlib import Path

NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / '_build'
_LIBS: dict = {}


def load_library(name: str) -> ctypes.CDLL:
    """Compile (if needed) and load ``_build/lib<name>.so`` from
    ``native/<name>.cpp``."""
    if name in _LIBS:
        return _LIBS[name]
    src = NATIVE_DIR / f'{name}.cpp'
    lib_path = BUILD_DIR / f'lib{name}.so'
    if not lib_path.exists() or lib_path.stat().st_mtime < src.stat().st_mtime:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(['g++', '-O3', '-march=native', '-shared', '-fPIC', '-std=c++17',
                            str(src), '-o', tmp], check=True, capture_output=True)
            os.replace(tmp, lib_path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    lib = ctypes.CDLL(str(lib_path))
    _LIBS[name] = lib
    return lib
