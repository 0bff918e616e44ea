"""The PyTorch port's CLI flags, data loaders and log files against the JAX
package's on the CPU: ``training/arguments.py`` (the same dests, types and
defaults, and ``train_steps``), ``training/data.py`` (the same arrays and
preprocessing statistics from the synthetic fallback, an ``.npz`` and the
UCI digits, and the digits loader's refusal of the synthetic fallback) and
``utils/log.py`` (byte-equal ``log.csv`` and ``options.toml``)."""

import argparse
import math
import types

import numpy as np
import pytest

from deepcgp_tpu import cifar as jcifar
from deepcgp_tpu import digits as jdigits
from deepcgp_tpu import mnist as jmnist
from deepcgp_tpu.training import arguments as jarguments
from deepcgp_tpu.training import data as jdata
from deepcgp_tpu.utils import log as jlog
from deepcgp_tpu.utils import profiling as jprofiling

from deepcgp_tpu_torch import cifar, digits, mnist, native
from deepcgp_tpu_torch.training import arguments, data
from deepcgp_tpu_torch.utils import log, profiling

from test_torch_native import jax_native_loaded

# ------------------------------------------------------------ arguments


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.type, a.default, a.required,
                     a.nargs, a.const, type(a).__name__)
            for a in parser._actions if not isinstance(a, argparse._HelpAction)}


def test_default_parser_matches_jax():
    ours, ref = _actions(arguments.default_parser()), \
        _actions(jarguments.default_parser())
    assert list(ours) == list(ref)
    for dest in ref:
        assert ours[dest] == ref[dest], dest


@pytest.mark.parametrize('entry,ref', [(cifar, jcifar), (mnist, jmnist),
                                       (digits, jdigits)],
                         ids=['cifar', 'mnist', 'digits'])
def test_read_args_matches_jax(entry, ref):
    """Each entry point's flags after parsing: the same dests, values and
    value types, at the defaults and on a full argv."""
    for argv in (['--name', 'x'],
                 ['--name', 'y', '-M', '1024', '--feature-maps', '',
                  '--optimizer', 'NatGrad', '--natgrad-warm-steps', '20',
                  '--test-size', '512', '--no-tensorboard',
                  '--full-state-ckpt', '--lr', '0.003', '-N', '2048']):
        ours, want = vars(entry.read_args(argv)), vars(ref.read_args(argv))
        assert list(ours) == list(want)
        for k, v in want.items():
            assert ours[k] == v and type(ours[k]) is type(v), k
    with pytest.raises(SystemExit):
        entry.read_args([])           # --name is required, as in JAX


@pytest.mark.parametrize('lr,decay,every', [
    (0.01, 100000, 50000), (0.01, 4, 2), (0.003, 7000, 1000),
    (0.01, 40, 20), (0.01, 20, 10), (0.05, 100000, 100), (1e-3, 13, 7)])
def test_train_steps_matches_jax(lr, decay, every):
    flags = types.SimpleNamespace(lr=lr, lr_decay_steps=decay,
                                  test_every=every)
    assert arguments.train_steps(flags) == jarguments.train_steps(flags)
    assert arguments.train_steps(flags) == math.ceil(
        decay * math.log(5e-5 / lr, 0.1) / every)

# ------------------------------------------------------------ data


def _flags(**kw):
    f = types.SimpleNamespace(N=100, test_size=40, seed=0)
    f.__dict__.update(kw)
    return f


def _assert_same_data(ours, want, flags_ours, flags_want):
    """Labels exactly, float32 images to 1 ulp, the float64 statistics to
    1e-12 relative (the JAX scaler may fit them in its C++ pipeline)."""
    for a, b in zip(ours, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if a.dtype == np.float32:
            np.testing.assert_array_max_ulp(a, b, maxulp=1)
        else:
            np.testing.assert_array_equal(a, b)
    for k in ('mean', 'scale'):
        a, b = flags_ours.preprocessing[k], flags_want.preprocessing[k]
        assert a.dtype == b.dtype == np.float64 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)


@pytest.mark.parametrize('loader,kw', [
    ('mnist_data', {}), ('mnist_data', {'fashion': True}), ('cifar_data', {}),
    ('cifar_data', {'N': 5990, 'test_size': None})],
    ids=['mnist', 'fashion', 'cifar', 'cifar-whole-test-set'])
def test_synthetic_fallback_matches_jax(loader, kw, monkeypatch, tmp_path):
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path))     # empty
    fkw = {k: v for k, v in kw.items() if k != 'fashion'}
    akw = {k: v for k, v in kw.items() if k == 'fashion'}
    fo, fw = _flags(**fkw), _flags(**fkw)
    with pytest.warns(UserWarning, match='synthetic fallback'):
        ours = getattr(data, loader)(fo, **akw)
    with pytest.warns(UserWarning, match='synthetic fallback'):
        want = getattr(jdata, loader)(fw, **akw)
    _assert_same_data(ours, want, fo, fw)


def _write_npz(path, n_train, n_test, shape, seed):
    rng = np.random.RandomState(seed)
    np.savez(path, x_train=rng.randint(0, 256, (n_train,) + shape).astype(np.uint8),
             y_train=rng.randint(0, 10, n_train),
             x_test=rng.randint(0, 256, (n_test,) + shape).astype(np.uint8),
             y_test=rng.randint(0, 10, n_test))


def test_npz_loaders_match_jax(tmp_path, monkeypatch):
    """Real-layout files under $DEEPCGP_DATA_DIR: flat uint8 MNIST (one
    pixel column constant, so its scale is 1.0) and NCHW CIFAR."""
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path))
    _write_npz(tmp_path / 'mnist.npz', 120, 50, (784,), 1)
    with np.load(tmp_path / 'mnist.npz') as d:
        arrays = dict(d)
    arrays['x_train'][:, 0] = 7
    np.savez(tmp_path / 'mnist.npz', **arrays)
    _write_npz(tmp_path / 'cifar10.npz', 90, 30, (3, 32, 32), 2)
    for loader, kw in (('mnist_data', dict(N=100, test_size=40)),
                       ('cifar_data', dict(N=64, test_size=50))):
        fo, fw = _flags(**kw), _flags(**kw)
        _assert_same_data(getattr(data, loader)(fo),
                          getattr(jdata, loader)(fw), fo, fw)
        if loader == 'mnist_data':
            assert fo.preprocessing['scale'][0] == 1.0


def test_digits_matches_jax():
    for kw in (dict(N=1438, test_size=359), dict(N=256, test_size=64),
               dict(N=300, test_size=None)):
        fo, fw = _flags(**kw), _flags(**kw)
        ours, want = data.digits_data(fo), jdata.digits_data(fw)
        _assert_same_data(ours, want, fo, fw)
    assert ours[0].shape == (300, 8, 8, 1) and ours[2].shape == (359, 8, 8, 1)


def test_digits_refuses_synthetic_fallback(monkeypatch, tmp_path):
    monkeypatch.setattr(data, '_load_digits_raw', lambda: None)
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path))
    with pytest.raises(RuntimeError, match='refusing the synthetic'):
        data.load_dataset('digits')
    with pytest.raises(RuntimeError, match='refusing the synthetic'):
        data.digits_data(_flags(N=1438, test_size=359))
    _write_npz(tmp_path / 'digits.npz', 10, 3, (64,), 3)     # stands in
    assert data.load_dataset('digits')[0].shape == (10, 64)


def test_standard_scaler_matches_jax_formula():
    jax_native_loaded()
    rng = np.random.RandomState(4)
    X = rng.rand(50, 7) * 16
    X[:, 3] = 2.0                                      # zero-std column
    ours, ref = data.StandardScaler(), jdata.StandardScaler()
    a, b = ours.fit_transform(X), ref.fit_transform(X)
    assert a.dtype == np.float64
    np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12)
    # Both fit through their native data paths: the same bits, and the
    # bits of the port's numpy version of its loop.
    np.testing.assert_array_equal(ours.mean_, ref.mean_)
    np.testing.assert_array_equal(ours.scale_, ref.scale_)
    mean, scale = native.fit_scaler_numpy(X)
    np.testing.assert_array_equal(ours.mean_, mean)
    np.testing.assert_array_equal(ours.scale_, scale)
    assert ours.scale_[3] == 1.0 and (a[:, 3] == 0).all()
    np.testing.assert_allclose(ours.transform(X[:5]), ref.transform(X[:5]),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('n,shape,seed', [(2560, (32, 32, 3), 0),
                                          (100, (8, 8, 1), 3)])
def test_learnable_blobs_match_jax(n, shape, seed):
    X, y = data.learnable_blobs(n, shape, 10, seed)
    Xj, yj = jdata.learnable_blobs(n, shape, 10, seed)
    assert X.dtype == np.float32 and X.shape == (n, *shape)
    np.testing.assert_array_equal(X, Xj)
    np.testing.assert_array_equal(y, yj)

# ------------------------------------------------------------ log files


class _FakeExperiment:
    def __init__(self):
        self.global_step, self.learning_rate = 0, 0.01
        self.last_mean_elbo = float('nan')
        self._acc = iter([0.125, 0.5, 1.0])

    def test_accuracy(self):
        return next(self._acc)


def _write_log(mod, root):
    exp = _FakeExperiment()
    loggers = [mod.GlobalStepLogger(), mod.LearningRateLogger(),
               mod.AccuracyLogger(), mod.TrainELBOLogger()]
    lines = []
    for opening in range(2):        # append mode: a header on every open
        lg = mod.Log(str(root), 'run', loggers)
        for step in (20, 40) if opening == 0 else (60,):
            exp.global_step = step
            exp.learning_rate *= 0.1
            exp.last_mean_elbo = -898.9 / step
            lines.append(lg.write_entry(exp))
        lg.write_flags(types.SimpleNamespace(
            name='flag"ship', log_dir='C:\\runs', M='384,384', lr=0.01,
            test_size=None, white=False, full_state_ckpt=True, N=2048,
            preprocessing={'mean': np.zeros(3)}, shape=(1, 2)))
        lg.close()
    return ((root / 'run' / 'log.csv').read_bytes(),
            (root / 'run' / 'options.toml').read_bytes(), lines)


def test_log_files_byte_equal_to_jax(tmp_path):
    ours = _write_log(log, tmp_path / 'port')
    want = _write_log(jlog, tmp_path / 'jax')
    assert ours == want
    assert ours[0].decode().count('Entry,global_step') == 2
    assert b'preprocessing' not in ours[1] and b'shape' not in ours[1]
    mapping = {'a': 1, 'b': 2.5, 'c': 'x\\y"z', 'd': None, 'e': True}
    log.write_toml(str(tmp_path / 'o.toml'), mapping)
    jlog.write_toml(str(tmp_path / 'j.toml'), mapping)
    assert (tmp_path / 'o.toml').read_bytes() == (tmp_path / 'j.toml').read_bytes()
    for v in mapping.values():
        assert log._toml_escape(v) == jlog._toml_escape(v)


def test_log_without_write_touches_no_file(tmp_path):
    lg = log.Log(str(tmp_path), 'quiet', [log.GlobalStepLogger()], write=False)
    exp = _FakeExperiment()
    assert lg.write_entry(exp) == 'Entry: 0; global_step: 0'
    lg.write_flags(types.SimpleNamespace(name='q'))
    lg.close()
    assert not (tmp_path / 'quiet').exists()


def test_steps_per_sec_logger_matches_jax(monkeypatch):
    """The steps_per_sec column on one fake clock: NaN first, steps over
    seconds since the previous entry after, unchanged while the step does
    not move -- the JAX logger's values."""
    def column(mod):
        clock = iter([100.0, 102.0, 103.0, 104.0])
        monkeypatch.setattr(mod.time, 'time', lambda: next(clock))
        logger = mod.StepsPerSecLogger()
        exp = types.SimpleNamespace(global_step=0)
        out = []
        for step in (10, 30, 30, 40):
            exp.global_step = step
            out.append(logger(exp))
        return out
    ours, want = column(profiling), column(jprofiling)
    assert math.isnan(ours[0]) and math.isnan(want[0])
    assert ours[1:] == want[1:] == [10.0, 10.0, 10.0]
    assert profiling.StepsPerSecLogger.title == jprofiling.StepsPerSecLogger.title
