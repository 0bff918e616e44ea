"""The port's bundled copy of the UCI digits (deepcgp_tpu_torch/training/
digits.npz): the arrays equal scikit-learn's ``load_digits()`` exactly,
``digits_data`` gives the same split with and without scikit-learn, and
no module of the port but the digits loader imports scikit-learn."""

import ast
import pathlib
import sys
import types

import numpy as np
import pytest
from sklearn.datasets import load_digits

from deepcgp_tpu_torch.training import data

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _flags(**kw):
    return types.SimpleNamespace(**{'N': 1438, 'test_size': 359, 'seed': 0,
                                    **kw})


def test_bundled_arrays_equal_load_digits():
    d = load_digits()
    with np.load(data.BUNDLED_DIGITS) as b:
        x, y = b['x'], b['y']
    assert x.dtype == y.dtype == np.uint8
    assert x.shape == (1797, 64) and y.shape == (1797,)
    np.testing.assert_array_equal(x.astype(np.float64), d.data)
    np.testing.assert_array_equal(y.astype(np.int64), d.target)


def test_same_split_without_sklearn(monkeypatch, tmp_path):
    """The loader with scikit-learn, then with its import made to fail:
    the same rows, labels, preprocessing and dtypes, and no npz under the
    data dir read."""
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path))
    for kw in (dict(), dict(N=256, test_size=64)):
        f1 = _flags(**kw)
        with_sk = data.digits_data(f1)
        with monkeypatch.context() as m:
            m.setitem(sys.modules, 'sklearn.datasets', None)
            f2 = _flags(**kw)
            without = data.digits_data(f2)
            raw = data.load_dataset('digits')
        for a, b in zip(with_sk, without):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for k in ('mean', 'scale'):
            np.testing.assert_array_equal(f1.preprocessing[k],
                                          f2.preprocessing[k])
    assert raw[0].shape == (1438, 64) and raw[2].shape == (359, 64)
    assert raw[0].dtype == np.float64 and raw[1].dtype == np.int64
    # Without scikit-learn the rows come from the bundled copy alone.
    monkeypatch.setitem(sys.modules, 'sklearn.datasets', None)
    monkeypatch.setattr(data, 'BUNDLED_DIGITS', str(tmp_path / 'none.npz'))
    with pytest.raises(RuntimeError, match='refusing the synthetic'):
        data.load_dataset('digits')


def test_only_the_digits_loader_imports_sklearn():
    for path in sorted((ROOT / 'deepcgp_tpu_torch').rglob('*.py')):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.FunctionDef):
                inner = [n for n in ast.walk(node)
                         if isinstance(n, ast.ImportFrom)
                         and (n.module or '').startswith('sklearn')]
                assert not inner or (path.name == 'data.py'
                                     and node.name == '_load_digits_raw'), \
                    (path, node.name)
        top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
        for node in top:
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ''])
            assert not any(n.startswith('sklearn') for n in names), path
