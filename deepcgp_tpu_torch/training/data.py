"""Datasets + preprocessing (counterpart of ``deepcgp_tpu/training/data.py``;
numpy only).

Rebuild of the data paths in `conv_gp/mnist.py:14-45` and
`conv_gp/cifar.py:12-40`.  The reference pulls MNIST/fashion-MNIST/CIFAR-10
over the network; here loaders resolve in order:

1. ``$DEEPCGP_DATA_DIR`` (or ``~/.cache/deepcgp``) containing ``mnist.npz`` /
   ``fashion_mnist.npz`` / ``cifar10.npz`` with keys
   ``x_train, y_train, x_test, y_test``;
2. a deterministic synthetic fallback with the same shapes/dtypes (class-
   conditional blob images), so every config stays runnable end-to-end.

UCI digits come from scikit-learn's bundled copy (or a ``digits.npz``) and
never fall back to synthetic data.

Preprocessing parity:
* MNIST: per-pixel StandardScaler fit on train, reshape to 28x28x1
  (`conv_gp/mnist.py:40-45`);
* CIFAR-10: NCHW->NHWC, train tail moved into the test set, per-channel
  mean/std normalisation (`conv_gp/cifar.py:13-40`).
Each loader attaches the fitted statistics, in the flat [D] layout, to
``flags.preprocessing`` for serving raw inputs.
"""

from __future__ import annotations

import os
import warnings

import numpy as np

_SHAPES = {
    'mnist': ((28, 28), 1, 10),
    'fashion_mnist': ((28, 28), 1, 10),
    'cifar10': ((32, 32), 3, 10),
    'digits': ((8, 8), 1, 10),
}


def data_dir() -> str:
    return os.environ.get('DEEPCGP_DATA_DIR',
                          os.path.expanduser('~/.cache/deepcgp'))


def _load_npz(name: str):
    path = os.path.join(data_dir(), name + '.npz')
    if not os.path.exists(path):
        return None
    with np.load(path) as d:
        return (d['x_train'], d['y_train'], d['x_test'], d['y_test'])


def _synthetic(name: str, seed: int = 0):
    """Class-conditional blob images; deterministic.  Shapes match the real
    dataset so every pipeline/config runs without network access."""
    (H, W), C, K = _SHAPES[name]
    rng = np.random.RandomState(seed)
    n_train, n_test = 6000, 1000
    protos = rng.rand(K, H, W, C) * 255.0

    def make(n, seed2):
        r = np.random.RandomState(seed2)
        y = r.randint(0, K, size=n)
        x = protos[y] + r.randn(n, H, W, C) * 64.0
        x = np.clip(x, 0, 255)
        if name != 'cifar10':
            x = x.reshape(n, H * W * C)  # observations-style flat uint8
        else:
            x = x.transpose(0, 3, 1, 2)  # observations returns NCHW
        return x.astype(np.float64), y.astype(np.int64)

    x_tr, y_tr = make(n_train, seed + 1)
    x_te, y_te = make(n_test, seed + 2)
    return x_tr, y_tr, x_te, y_te


def learnable_blobs(n, shape, classes, seed):
    """Gaussian class blobs in image space: class k = template_k + noise;
    linearly separable but image-shaped.  Unlike the pure-noise synthetic
    fallback, training on this must visibly reduce the ELBO and reach high
    held-out accuracy, so it checks the numerics end to end."""
    rng = np.random.RandomState(seed)
    templates = rng.randn(classes, *shape).astype(np.float32)
    y = rng.randint(0, classes, size=(n, 1))
    X = templates[y[:, 0]] + 0.3 * rng.randn(n, *shape).astype(np.float32)
    return X.astype(np.float32), y


_DIGITS_SPLIT_SEED = 42  # fixed: the split IS the dataset definition
_DIGITS_TEST_FRACTION = 0.2


def _load_digits_raw():
    """UCI handwritten digits (1,797 real 8x8 grayscale scans, 10 classes)
    bundled inside scikit-learn's wheel, in the observations-style flat
    layout ([N, 64] f64, pixel range 0..16) with a FIXED seeded 80/20
    split.  Returns None when sklearn is unavailable so the loader falls
    through to an npz."""
    try:
        from sklearn.datasets import load_digits
    except ImportError:
        return None
    d = load_digits()
    X = d.data.astype(np.float64)           # [1797, 64], values 0..16
    y = d.target.astype(np.int64)
    perm = np.random.RandomState(_DIGITS_SPLIT_SEED).permutation(len(X))
    X, y = X[perm], y[perm]
    n_test = int(round(len(X) * _DIGITS_TEST_FRACTION))
    return X[n_test:], y[n_test:], X[:n_test], y[:n_test]


def load_dataset(name: str):
    """Returns (x_train, y_train, x_test, y_test) in the reference's raw
    layout (MNIST flat [N, 784]; CIFAR NCHW uint8-scale floats).

    'digits' never falls through to the synthetic generator: it is the
    repo's real-data accuracy set, and a blob substitute would report
    synthetic accuracy under a real-data label.  Without sklearn an
    explicit npz may stand in; otherwise this raises."""
    if name == 'digits':
        loaded = _load_digits_raw() or _load_npz(name)
        if loaded is None:
            raise RuntimeError(
                "real UCI digits unavailable (sklearn.datasets.load_digits "
                f"failed and no digits.npz under {data_dir()}); refusing "
                "the synthetic fallback for a real-data artifact")
        return loaded
    loaded = _load_npz(name)
    if loaded is None:
        warnings.warn(
            f"dataset '{name}' not found under {data_dir()} - "
            "using the deterministic synthetic fallback")
        loaded = _synthetic(name)
    return loaded


class StandardScaler:
    """Per-feature standardisation (sklearn-compatible subset): per-column
    mean and population std, zero-std columns scaled by 1.0; the transform
    in float64 for parity with the reference's f64 preprocessing."""

    def fit_transform(self, X):
        X = np.asarray(X, dtype=np.float64)
        self.mean_ = X.mean(axis=0)
        std = X.std(axis=0)
        self.scale_ = np.where(std == 0, 1.0, std)
        return self.transform(X)

    def transform(self, X):
        return ((np.asarray(X) - self.mean_) / self.scale_).astype(np.float64)


def _attach_preprocessing(flags, mean, scale) -> None:
    """Expose the fitted statistics (flat [D] layout) so the experiment can
    persist them for serving raw inputs."""
    try:
        flags.preprocessing = {'mean': mean, 'scale': scale}
    except AttributeError:
        pass


def _subsample(flags, x, y):
    """A uniform ``test_size`` subset, drawn with ``flags.seed``."""
    rng = np.random.RandomState(getattr(flags, 'seed', 0))
    chosen = rng.choice(len(x), min(flags.test_size, len(x)), replace=False)
    return x[chosen], y[chosen]


def mnist_data(flags, dtype=np.float32, fashion: bool = False):
    """`conv_gp/mnist.py:14-45` + subset selection."""
    x_train, y_train, x_test, y_test = load_dataset(
        'fashion_mnist' if fashion else 'mnist')
    y_train = y_train.reshape(-1, 1)
    y_test = y_test.reshape(-1, 1)
    x_train, y_train = x_train[:flags.N], y_train[:flags.N]
    x_test, y_test = _subsample(flags, x_test, y_test)
    scaler = StandardScaler()
    x_train = scaler.fit_transform(x_train.astype(np.float64)).astype(dtype)
    x_test = scaler.transform(x_test.astype(np.float64)).astype(dtype)
    _attach_preprocessing(flags, scaler.mean_, scaler.scale_)
    return (x_train.reshape(-1, 28, 28, 1), y_train,
            x_test.reshape(-1, 28, 28, 1), y_test)


def digits_data(flags, dtype=np.float32):
    """The UCI digits set through `mnist_data`'s preprocessing (per-pixel
    StandardScaler fit on train), reshaped to 8x8x1 images: 1,438 train /
    359 test under the fixed split."""
    x_train, y_train, x_test, y_test = load_dataset('digits')
    y_train = y_train.reshape(-1, 1)
    y_test = y_test.reshape(-1, 1)
    x_train, y_train = x_train[:flags.N], y_train[:flags.N]
    if getattr(flags, 'test_size', None):
        x_test, y_test = _subsample(flags, x_test, y_test)
    scaler = StandardScaler()
    x_train = scaler.fit_transform(x_train.astype(np.float64)).astype(dtype)
    x_test = scaler.transform(x_test.astype(np.float64)).astype(dtype)
    _attach_preprocessing(flags, scaler.mean_, scaler.scale_)
    return (x_train.reshape(-1, 8, 8, 1), y_train,
            x_test.reshape(-1, 8, 8, 1), y_test)


def cifar_data(flags, dtype=np.float32):
    """`conv_gp/cifar.py:12-40`."""
    x_train, y_train, x_test, y_test = load_dataset('cifar10')
    x_train = np.transpose(x_train, (0, 2, 3, 1)).astype(np.float64)
    x_test = np.transpose(x_test, (0, 2, 3, 1)).astype(np.float64)
    y_train = y_train.reshape(-1, 1)
    y_test = y_test.reshape(-1, 1)

    N = min(flags.N, x_train.shape[0])
    x_test = np.concatenate([x_train[N:], x_test], axis=0)
    y_test = np.concatenate([y_train[N:], y_test], axis=0)
    x_train, y_train = x_train[:N], y_train[:N]

    mean = x_train.mean(axis=(0, 1, 2))
    x_train -= mean
    x_test -= mean
    std = x_train.std(axis=(0, 1, 2))
    x_train /= std
    x_test /= std
    H, W, C = x_train.shape[1:]
    _attach_preprocessing(flags,
                          np.broadcast_to(mean, (H, W, C)).reshape(-1),
                          np.broadcast_to(std, (H, W, C)).reshape(-1))
    # The reference evaluates on the whole test set (moved train tail + the
    # real test set, `conv_gp/cifar.py:19-22`); an explicit --test-size
    # subsamples it uniformly, since its first rows are all held-out
    # training images.
    if getattr(flags, 'test_size', None):
        x_test, y_test = _subsample(flags, x_test, y_test)
    return (x_train.astype(dtype), y_train, x_test.astype(dtype), y_test)
