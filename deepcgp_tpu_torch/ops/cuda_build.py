"""Build and load the port's CUDA kernels.

Each source in ``deepcgp_tpu_torch/csrc/`` compiles with ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface, which
the wrapper modules load with :mod:`ctypes`.  A library is built at first
use into ``build/cuda/`` at the root of the checkout (listed in
``.gitignore``); its file name carries a hash of the source, so an edited
source builds anew.  :func:`build` starts one ``nvcc`` per missing library,
all at once, and waits for all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SOURCES = ('chol_inv', 'tri_inv', 'conv_rbf_cross', 'conv_rbf_cross_bwd',
           'patches', 'adam')
CSRC = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'cuda'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')

_loaded: dict = {}
_functions: dict = {}


def _nvcc() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    default = Path('/usr/local/cuda/bin/nvcc')
    if default.exists():
        return str(default)
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f'{name}.cu').read_bytes())
    digest.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'{name}-{digest.hexdigest()[:12]}.so'


def build(names=SOURCES) -> dict:
    """Compile every library in ``names`` that is not built yet, in
    parallel.  Returns {name: {'seconds': s, 'ptxas': [lines]}} for the
    libraries compiled by this call; raises if any compilation fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    running = {}
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f'.tmp{os.getpid()}')
        cmd = [nvcc, *NVCC_FLAGS, '-o', str(tmp), str(CSRC / f'{name}.cu')]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, time.perf_counter())
    report = {}
    failed = []
    for name, (proc, tmp, out, t0) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f'{name}:\n{log}')
            continue
        os.replace(tmp, out)
        report[name] = {'seconds': seconds,
                        'ptxas': [ln.strip() for ln in log.splitlines()
                                  if 'ptxas' in ln or 'spill' in ln]}
    if failed:
        raise RuntimeError('nvcc failed for ' + '\n'.join(failed))
    return report


def library(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib


def function(name: str, symbol: str, argtypes: list):
    """The C entry ``symbol`` of library ``name``, its argument types set
    once; every entry returns a ``cudaError_t`` as an int."""
    fn = _functions.get((name, symbol))
    if fn is None:
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[(name, symbol)] = fn
    return fn


def check(status: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if status != 0:
        raise RuntimeError(f'{what}: CUDA error {status} at launch')
