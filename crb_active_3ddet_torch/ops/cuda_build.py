"""Build and load the hand-written CUDA kernels of ``crb_active_3ddet_torch/csrc``.

Each ``csrc/<name>.cu`` exports plain C entry points.  At first use it is
compiled by ``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>.so``
inside the package (listed in ``.gitignore``) and loaded with ``ctypes``.
A library is rebuilt when its source is newer.  ``build_all`` starts one
``nvcc`` per source, all at once, and waits for them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v']
# the FPS keeps every product and sum separately rounded, like its plain
# version, so the two agree to the last bit on the same inputs (the overlap
# writes its arithmetic as round-to-nearest intrinsics instead, so that its
# cosf and sinf compile as PyTorch's own cos and sin do)
EXTRA_FLAGS = {'fps': ['-fmad=false']}

_LIBS: dict = {}
BUILD_LOG: dict = {}     # name → (seconds, ptxas report) of this process's builds


def _nvcc():
    path = shutil.which('nvcc') or '/usr/local/cuda/bin/nvcc'
    if not os.path.exists(path):
        raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')
    return path


def _lib_path(name):
    return BUILD_DIR / f'lib{name}.so'


def _stale(name):
    lib = _lib_path(name)
    src = CSRC / f'{name}.cu'
    return not lib.exists() or lib.stat().st_mtime < src.stat().st_mtime


def _start(name, flags=()):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, []), *flags, '-o', tmp,
           str(CSRC / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, time.perf_counter()


def _finish(name, proc, tmp, t0, tag=''):
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed for csrc/{name}.cu:\n{out}')
    os.replace(tmp, _lib_path(name + tag))      # atomic: concurrent builds agree
    BUILD_LOG[name + tag] = (time.perf_counter() - t0, out)


def build_all(names):
    """Build every stale library in ``names`` concurrently; returns
    {name: seconds} for the ones built."""
    started = {n: _start(n) for n in names if _stale(n)}
    for n, job in started.items():
        _finish(n, *job)
    return {n: BUILD_LOG[n][0] for n in started}


def build_variants(name, variants, signatures):
    """Measurement builds of ``csrc/<name>.cu``: one library per entry of
    ``variants`` ({tag: extra nvcc flags, e.g. a -D that compiles part of the
    kernel's work out}), built concurrently; returns {tag: ctypes handle}.
    The port itself never loads them."""
    jobs = {tag: _start(name, flags) for tag, flags in variants.items()}
    libs = {}
    for tag, job in jobs.items():
        _finish(name, *job, tag=f'_{tag}')
        libs[tag] = _bind(ctypes.CDLL(str(_lib_path(f'{name}_{tag}'))), name, signatures)
    return libs


def _bind(lib, name, signatures):
    for fn, argtypes in signatures.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    err_string = getattr(lib, f'{name}_error_string')
    err_string.argtypes = [ctypes.c_int]
    err_string.restype = ctypes.c_char_p
    return lib


def load_library(name, signatures):
    """ctypes handle of ``lib<name>.so`` (built if stale), with each
    function's ``argtypes`` set from ``signatures`` and ``restype`` int
    (every entry point returns its ``cudaGetLastError()``); each library
    also exports ``<name>_error_string``."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = _bind(ctypes.CDLL(str(_lib_path(name))), name, signatures)
        _LIBS[name] = lib
    return lib


def check(lib, name, err):
    """Raise if a C entry point of ``lib<name>.so`` returned a CUDA error."""
    if err != 0:
        msg = getattr(lib, f'{name}_error_string')(err).decode()
        raise RuntimeError(f'{name} kernel launch failed: CUDA error {err} ({msg})')
