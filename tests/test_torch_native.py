"""The port's native host data path (deepcgp_tpu_torch/native) on the CPU:
each binding bit-equal to the JAX package's ``deepcgp_tpu.native`` (g++
builds both here) and to its own numpy version, the scaler's statistics
bit-equal to the JAX StandardScaler's, the fused multiply-add of the numpy
fit against exact rationals, out-of-range offsets and wrong dtypes
refused, a failed build raising with g++'s output, two processes building
at once, and the inducing-patch gather going through the library."""

import os
import pathlib
import subprocess
import sys
import time
from fractions import Fraction

import numpy as np
import pytest

from deepcgp_tpu import native as jnative
from deepcgp_tpu.training import data as jdata

from deepcgp_tpu_torch import native
from deepcgp_tpu_torch.models import inducing
from deepcgp_tpu_torch.training import data

ROOT = pathlib.Path(__file__).resolve().parent.parent


def jax_native_loaded() -> None:
    """Load the JAX package's native library.  Its ``lib()`` builds next
    to its source and caches a failed load for the process (as when
    another test process is writing the same file at that moment), and
    then falls back to numpy, whose fit is not bit-equal; so clear the
    cached failure and retry until the build in flight has finished."""
    for _ in range(100):
        if jnative.lib() is not None:
            return
        jnative._tried = False
        time.sleep(0.2)
    raise AssertionError("the JAX package's native library does not load")


@pytest.fixture(autouse=True, scope='module')
def _jax_native():
    jax_native_loaded()


def _images(seed, shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


@pytest.mark.parametrize('shape,scale', [((500, 33), 3.0), ((2000, 784), 90.0),
                                         ((64, 5), 1e-4)])
def test_fit_scaler_bit_equal(shape, scale):
    rng = np.random.RandomState(shape[1])
    X = rng.randn(*shape) * scale + 1.5
    X[:, 3] = 2.0                                   # zero std -> 1.0
    mean, std = native.fit_scaler(X)
    jmean, jstd = jnative.fit_scaler(X)
    nmean, nstd = native.fit_scaler_numpy(X)
    for ours in (jmean, nmean):
        np.testing.assert_array_equal(mean, ours)
    for ours in (jstd, nstd):
        np.testing.assert_array_equal(std, ours)
    assert std[3] == 1.0
    np.testing.assert_allclose(std, np.where(X.std(0) == 0, 1.0, X.std(0)),
                               rtol=1e-12)


def test_fit_scaler_on_pixel_counts():
    """uint8-scale MNIST-like columns, some constant: float32 in, float64
    statistics, the same bits three ways."""
    X = np.random.RandomState(2).randint(0, 256, size=(3000, 784))
    X[:, :30] = 0
    X = X.astype(np.float32)
    mean, std = native.fit_scaler(X)
    assert mean.dtype == std.dtype == np.float64
    for m, s in (jnative.fit_scaler(X), native.fit_scaler_numpy(X)):
        np.testing.assert_array_equal(mean, m)
        np.testing.assert_array_equal(std, s)


def test_fma_square_add_is_rounded_once():
    """c * c + acc rounded once, against exact rationals, on values whose
    plain product-then-sum rounds twice differently."""
    rng = np.random.RandomState(3)
    c = rng.randn(4000) * rng.choice([1e-3, 1.0, 1e3], 4000)
    acc = np.abs(rng.randn(4000)) * rng.choice([1e-3, 1.0, 1e5], 4000)
    got = native.fma_square_add(c, acc)
    exact = np.array([float(Fraction(a) * Fraction(a) + Fraction(b))
                      for a, b in zip(c, acc)])
    np.testing.assert_array_equal(got, exact)
    assert (got != c * c + acc).any()


def test_standard_scaler_statistics_equal_jax():
    X = np.random.RandomState(4).rand(700, 64) * 16
    X[:, 0] = 0.0
    ours, ref = data.StandardScaler(), jdata.StandardScaler()
    a, b = ours.fit_transform(X), ref.fit_transform(X)
    np.testing.assert_array_equal(ours.mean_, ref.mean_)
    np.testing.assert_array_equal(ours.scale_, ref.scale_)
    np.testing.assert_array_equal(a, b)
    assert a.dtype == np.float64


def test_standardize_bit_equal():
    X = _images(5, (300, 17)).reshape(300, 17)
    mean, std = native.fit_scaler(X)
    out = native.standardize(X, mean, std)
    np.testing.assert_array_equal(out, jnative.standardize(X, mean, std))
    np.testing.assert_array_equal(out, native.standardize_numpy(X, mean, std))
    assert out.dtype == np.float32


def test_gather_rows_bit_equal():
    X = _images(6, (50, 4, 3))
    idx = np.random.RandomState(6).randint(0, 50, size=70)
    out = native.gather_rows(X, idx)
    np.testing.assert_array_equal(out, jnative.gather_rows(X, idx))
    np.testing.assert_array_equal(out, native.gather_rows_numpy(X, idx))
    assert out.shape == (70, 4, 3)


@pytest.mark.parametrize('shape,f,stride', [((3, 9, 8, 2), 3, 1),
                                            ((3, 9, 8, 2), 3, 2),
                                            ((4, 32, 32, 3), 5, 3),
                                            ((2, 28, 28, 1), 5, 1)])
def test_extract_patches_bit_equal(shape, f, stride):
    X = _images(7, shape)
    out = native.extract_patches(X, f, stride)
    np.testing.assert_array_equal(out, jnative.extract_patches(X, f, stride))
    np.testing.assert_array_equal(out, native.extract_patches_numpy(X, f, stride))


@pytest.mark.parametrize('shape,f', [((10, 12, 12, 3), 5), ((6, 8, 8, 1), 3)])
def test_sample_patches_bit_equal(shape, f):
    X = _images(8, shape)
    rng = np.random.RandomState(8)
    n, h, w, _ = shape
    img = rng.randint(0, n, size=300)
    ys = rng.randint(0, h - f + 1, size=300)
    xs = rng.randint(0, w - f + 1, size=300)
    out = native.sample_patches(X, img, ys, xs, f)
    np.testing.assert_array_equal(out, jnative.sample_patches(X, img, ys, xs, f))
    np.testing.assert_array_equal(out, native.sample_patches_numpy(X, img, ys, xs, f))
    assert out.shape == (300, f * f * shape[3])


def test_out_of_range_and_wrong_dtype_raise():
    X = _images(9, (5, 8, 8, 2))
    with pytest.raises(IndexError):
        native.gather_rows(X, np.array([0, 5]))
    with pytest.raises(IndexError):
        native.gather_rows(X, np.array([-1]))
    for img, ys, xs in (([5], [0], [0]), ([0], [5], [0]), ([0], [0], [-1])):
        with pytest.raises(IndexError):
            native.sample_patches(X, img, ys, xs, 4)
        with pytest.raises(IndexError):
            native.sample_patches_numpy(X, img, ys, xs, 4)
    with pytest.raises(ValueError):
        native.extract_patches(X, 9, 1)
    with pytest.raises(ValueError):
        native.standardize(X.reshape(5, -1), np.zeros(3), np.ones(3))
    for call in (lambda: native.gather_rows(X.astype(np.float64), [0]),
                 lambda: native.extract_patches(X.astype(np.float64), 3),
                 lambda: native.sample_patches(X.astype(np.float64), [0], [0],
                                               [0], 3)):
        with pytest.raises(TypeError):
            call()


def test_failed_build_raises_with_gxx_output(tmp_path, monkeypatch):
    broken = tmp_path / 'dataio.cpp'
    broken.write_text('extern "C" { void f( }\n')
    monkeypatch.setattr(native, 'SOURCE', broken)
    monkeypatch.setattr(native, 'BUILD_DIR', tmp_path / 'out')
    with pytest.raises(RuntimeError, match='g\\+\\+ failed') as err:
        native.build()
    assert 'error' in str(err.value)
    assert not list((tmp_path / 'out').glob('*'))


_BUILD_AND_USE = '''
import pathlib, sys
import numpy as np
from deepcgp_tpu_torch import native
native.BUILD_DIR = pathlib.Path(sys.argv[1])
X = np.random.RandomState(0).randn(200, 9)
mean, std = native.fit_scaler(X)
nmean, nstd = native.fit_scaler_numpy(X)
assert (mean == nmean).all() and (std == nstd).all()
print(native.library_path().name)
'''


def test_two_processes_build_at_once(tmp_path):
    """Both processes, started together on an empty build dir, load a whole
    library; one library file is left, no temporary."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, '-c', _BUILD_AND_USE,
                               str(tmp_path)], env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    names = {out.strip() for out, _ in outs}
    assert len(names) == 1
    assert [p.name for p in tmp_path.iterdir()] == [names.pop()]


def test_library_lives_in_the_build_dir():
    path = native.library_path()
    native.lib()
    assert path.exists() and path.parent == ROOT / 'build' / 'native'
    assert not list(native.SOURCE.parent.glob('*.so'))


def test_inducing_gather_goes_through_the_library(monkeypatch):
    X = _images(10, (6, 9, 9, 2))
    rng = np.random.RandomState(10)
    img, ys, xs = (rng.randint(0, hi, size=40) for hi in (6, 5, 5))
    calls = []
    real = native.sample_patches
    monkeypatch.setattr(native, 'sample_patches',
                        lambda *a: calls.append(1) or real(*a))
    out = inducing.gather_patches(X, img, ys, xs, 4)
    assert calls == [1]
    np.testing.assert_array_equal(out, jnative.sample_patches(X, img, ys, xs, 4))
    out64 = inducing.gather_patches(X.astype(np.float64), img, ys, xs, 4)
    assert calls == [1] and out64.dtype == np.float64
    np.testing.assert_array_equal(out64, out)
