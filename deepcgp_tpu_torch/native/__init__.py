"""The port's native host data path: ctypes bindings of ``dataio.cpp``.

The C++ core (the port's own copy of the JAX package's
``deepcgp_tpu/native/dataio.cpp``) standardises datasets and gathers rows
and image patches on the host.  :func:`lib` compiles it at first use with
``g++ -O3 -march=native -shared -fPIC`` into ``build/native/`` at the root
of the checkout (listed in ``.gitignore``), under a file name that carries
a hash of the source, the flags and the host; the library is written to a
temporary file and moved into place, so processes that build at the same
moment each load a whole library.  A failed build raises with g++'s output:
there is no numpy fallback.

Each binding has a plain numpy version beside it (``*_numpy``) that
computes the same bits; the tests and ``chip_smoke.py`` hold one against
the other.  The bindings take float32 arrays (float64 for the scaler's
fit) and check shapes, dtypes and indices before passing pointers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / 'dataio.cpp'
BUILD_DIR = Path(__file__).resolve().parents[2] / 'build' / 'native'
GXX_FLAGS = ('-O3', '-march=native', '-shared', '-fPIC')

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I = ctypes.c_int64
_SIGNATURES = {
    'dcgp_fit_scaler_f64': [_P, _I, _I, _P, _P],
    'dcgp_standardize_f32': [_P, _P, _P, _P, _I, _I],
    'dcgp_gather_rows_f32': [_P, _P, _P, _I, _I],
    'dcgp_extract_patches_f32': [_P] + [_I] * 6 + [_P],
    'dcgp_sample_patches_f32': [_P] + [_I] * 5 + [_P] * 4 + [_I],
}


def library_path() -> Path:
    """The library's file: a hash of the source, the flags and the host's
    name in it, since ``-march=native`` compiles for this host's CPU."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(' '.join(GXX_FLAGS).encode())
    digest.update(platform.node().encode())
    return BUILD_DIR / f'dataio-{digest.hexdigest()[:12]}.so'


def build() -> float | None:
    """Compile the library unless it is built; returns the seconds g++
    took, or None when it was already there.  Raises on a failed build."""
    out = library_path()
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f'.tmp{os.getpid()}.{threading.get_ident()}')
    t0 = time.perf_counter()
    proc = subprocess.run(['g++', *GXX_FLAGS, str(SOURCE), '-o', str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed to build {SOURCE}:\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, out)
    return time.perf_counter() - t0


def lib() -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            handle = ctypes.CDLL(str(library_path()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = None
            _lib = handle
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _float32(name: str, a) -> np.ndarray:
    a = np.asarray(a)
    if a.dtype != np.float32:
        raise TypeError(f'{name}: needs float32, got {a.dtype}')
    return np.ascontiguousarray(a)


def _patch_grid(shape, f: int, stride: int):
    if len(shape) != 4:
        raise ValueError(f'need [N, H, W, C] images, got {shape}')
    _, h, w, _ = shape
    if not (1 <= f <= min(h, w) and stride >= 1):
        raise ValueError(f'filter {f}, stride {stride} on {h}x{w} images')
    return (h - f) // stride + 1, (w - f) // stride + 1


def _check_offsets(shape, img, ys, xs, f: int) -> None:
    n, h, w, _ = shape
    if not (img.shape == ys.shape == xs.shape and img.ndim == 1):
        raise ValueError('img, ys and xs must be 1-D of one length')
    if len(img) and not ((0 <= img.min() and img.max() < n)
                         and (0 <= ys.min() and ys.max() <= h - f)
                         and (0 <= xs.min() and xs.max() <= w - f)):
        raise IndexError('sample_patches offsets out of range')


# ------------------------------------------------------------ the scaler


def fit_scaler(X: np.ndarray):
    """Per-column (mean, population std) of X [n, d] in float64, a
    zero std replaced by 1.0."""
    X64 = np.ascontiguousarray(X, dtype=np.float64)
    n, d = X64.shape
    mean, std = np.empty(d), np.empty(d)
    lib().dcgp_fit_scaler_f64(_ptr(X64), n, d, _ptr(mean), _ptr(std))
    return mean, std


def _two_sum(a, b):
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_square(a):
    """(p, e) with p = fl(a * a) and p + e = a * a exactly (Dekker)."""
    t = 134217729.0 * a                       # 2^27 + 1: Veltkamp's split
    hi = t - (t - a)
    lo = a - hi
    p = a * a
    return p, lo * lo - (((p - hi * hi) - lo * hi) - hi * lo)


def fma_square_add(c: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """c * c + acc rounded once, as ``std::fma(c, c, acc)`` computes it:
    the exact product and sum, the low parts added with rounding to odd,
    then one rounding to nearest (Boldo and Melquiond, "Emulation of FMA
    and correctly rounded sums: proved algorithms using rounding to odd",
    IEEE Trans. Computers 57(4), 2008, algorithm 5.4)."""
    uh, ul = _two_square(c)
    th, tl = _two_sum(acc, uh)
    v, err = _two_sum(tl, ul)
    even = (v.view(np.int64) & 1) == 0
    v = np.where((err != 0) & even,
                 np.nextafter(v, np.where(err > 0, np.inf, -np.inf)), v)
    return th + v


def fit_scaler_numpy(X: np.ndarray):
    """:func:`fit_scaler` in numpy, in the C++ loop's order: the column
    sums row by row, the squared deviations accumulated by fused
    multiply-adds."""
    X64 = np.ascontiguousarray(X, dtype=np.float64)
    n, d = X64.shape
    mean = np.zeros(d)
    for row in X64:
        mean += row
    mean /= n
    acc = np.zeros(d)
    for row in X64:
        acc = fma_square_add(row - mean, acc)
    std = np.sqrt(acc / n)
    return mean, np.where(std == 0.0, 1.0, std)


def standardize(X: np.ndarray, mean: np.ndarray,
                std: np.ndarray) -> np.ndarray:
    """(X - mean) / std per column, float32 [n, d]."""
    Xf = _float32('standardize', X)
    n, d = Xf.shape
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    if mean.shape != (d,) or std.shape != (d,):
        raise ValueError(f'mean {mean.shape} and std {std.shape} for {d} '
                         'columns')
    out = np.empty((n, d), np.float32)
    lib().dcgp_standardize_f32(_ptr(Xf), _ptr(mean), _ptr(std), _ptr(out),
                               n, d)
    return out


def standardize_numpy(X, mean, std) -> np.ndarray:
    return ((np.asarray(X, np.float32) - np.asarray(mean, np.float32))
            / np.asarray(std, np.float32))


# ------------------------------------------------------------ gathers


def gather_rows(X: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """X[idx] for float32 X [n, ...] and integer indices in [0, n)."""
    Xc = _float32('gather_rows', X)
    idx64 = np.ascontiguousarray(idx, np.int64)
    if idx64.ndim != 1:
        raise ValueError('gather_rows: 1-D indices')
    if idx64.size and (idx64.min() < 0 or idx64.max() >= Xc.shape[0]):
        raise IndexError(f'gather_rows indices out of range [0, {Xc.shape[0]})')
    flat = Xc.reshape(Xc.shape[0], -1)
    out = np.empty((len(idx64), flat.shape[1]), np.float32)
    lib().dcgp_gather_rows_f32(_ptr(flat), _ptr(idx64), _ptr(out),
                               len(idx64), flat.shape[1])
    return out.reshape((len(idx64),) + Xc.shape[1:])


def gather_rows_numpy(X, idx) -> np.ndarray:
    return np.asarray(X)[np.asarray(idx)]


def extract_patches(NHWC: np.ndarray, f: int, stride: int = 1) -> np.ndarray:
    """Host im2col of float32 [N, H, W, C] images: [N, P, f*f*C], the
    positions row-major, each patch in (fy, fx, c) order."""
    Xc = _float32('extract_patches', NHWC)
    ph, pw = _patch_grid(Xc.shape, f, stride)
    n, h, w, c = Xc.shape
    out = np.empty((n, ph * pw, f * f * c), np.float32)
    lib().dcgp_extract_patches_f32(_ptr(Xc), n, h, w, c, f, stride, _ptr(out))
    return out


def extract_patches_numpy(NHWC, f: int, stride: int = 1) -> np.ndarray:
    NHWC = np.asarray(NHWC)
    ph, pw = _patch_grid(NHWC.shape, f, stride)
    n, _, _, c = NHWC.shape
    win = np.lib.stride_tricks.sliding_window_view(NHWC, (f, f), axis=(1, 2))
    win = win[:, ::stride, ::stride]              # [N, ph, pw, C, f, f]
    return np.moveaxis(win, 3, -1).reshape(n, ph * pw, f * f * c)


def sample_patches(NHWC: np.ndarray, img, ys, xs, f: int) -> np.ndarray:
    """The f x f patches of float32 images [N, H, W, C] at the offsets
    (img[k], ys[k], xs[k]): [count, f*f*C] in (fy, fx, c) order."""
    Xc = _float32('sample_patches', NHWC)
    _patch_grid(Xc.shape, f, 1)
    img, ys, xs = (np.ascontiguousarray(a, np.int32) for a in (img, ys, xs))
    _check_offsets(Xc.shape, img, ys, xs, f)
    n, h, w, c = Xc.shape
    out = np.empty((len(img), f * f * c), np.float32)
    lib().dcgp_sample_patches_f32(_ptr(Xc), n, h, w, c, f, _ptr(img),
                                  _ptr(ys), _ptr(xs), _ptr(out), len(img))
    return out


def sample_patches_numpy(NHWC, img, ys, xs, f: int) -> np.ndarray:
    NHWC = np.asarray(NHWC)
    _patch_grid(NHWC.shape, f, 1)
    img, ys, xs = (np.asarray(a) for a in (img, ys, xs))
    _check_offsets(NHWC.shape, img, ys, xs, f)
    win = np.lib.stride_tricks.sliding_window_view(NHWC, (f, f), axis=(1, 2))
    patches = win[img, ys, xs]                    # [count, C, f, f]
    return np.moveaxis(patches, 1, -1).reshape(len(img), -1)
