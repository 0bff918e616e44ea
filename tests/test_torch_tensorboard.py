"""The port's TensorBoard log on the CPU: its event writer and reader
(tensorboard's own ``EventAccumulator`` reads what the writer writes; the
reader checks every CRC and reads tensorboardX's files); the port's
``TensorBoardLog`` against the JAX package's (tensorboardX) on the same
converted model, float64, the default loggers and the patch-covariance
one -- the same tags and steps, equal parameter scalars, histograms equal
in num, min, max, sum, sum_squares, limits and counts, image pixels
within 1 of 255, and ``train_log_likelihood`` on
JAX's own draws (stored as float32 by both, so to rtol 1e-6); and the CPU
CLI, which writes the JAX CLI's tags by default."""

import glob
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.utils import tensorboard as jtb

from deepcgp_tpu_torch import cifar
from deepcgp_tpu_torch.utils import events, tensorboard

from test_torch_full_cov import _models
from test_torch_training import jax_draws

STEPS = (10, 20)


def _only_file(directory):
    (path,) = glob.glob(os.path.join(directory, 'events.out.tfevents.*'))
    return path


def _by_tag(path):
    """{(tag, step): summary value} of an event file."""
    evs = events.read_events(path)
    assert evs[0]['file_version'] == 'brain.Event:2'
    out = {}
    for ev in evs[1:]:
        for v in ev['summary']:
            assert (v['tag'], ev['step']) not in out
            out[(v['tag'], ev['step'])] = v
    return out


def test_event_writer_round_trips_through_tensorboard(tmp_path):
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator
    rng = np.random.RandomState(0)
    w = events.EventWriter(str(tmp_path))
    vals = rng.randn(5000) * 3.0
    img = rng.rand(1, 6, 9)
    w.add_scalar('loss/train', -1.25, 7)
    w.add_histogram('model.layers[0].Z', vals, 7)
    w.add_image('conv_mean', img, 8)
    w.close()
    acc = EventAccumulator(str(tmp_path), size_guidance={
        'scalars': 0, 'histograms': 0, 'images': 0})
    acc.Reload()
    (s,) = acc.Scalars('loss/train')
    assert (s.step, s.value) == (7, -1.25)
    (h,) = acc.Histograms('model.layers_0_.Z')      # the cleaned tag
    hv = h.histogram_value
    ours = events.histogram(vals)
    assert h.step == 7 and hv.num == 5000
    assert (hv.min, hv.max, hv.sum, hv.sum_squares) == (
        ours['min'], ours['max'], ours['sum'], ours['sum_squares'])
    assert list(hv.bucket) == ours['bucket'] and \
        list(hv.bucket_limit) == ours['bucket_limit']
    (im,) = acc.Images('conv_mean')
    assert (im.step, im.width, im.height) == (8, 9, 6)
    back = _by_tag(w.path)[('conv_mean', 8)]['image']
    assert back['png'] == im.encoded_image_string
    np.testing.assert_array_equal(events.decode_png(back['png']),
                                  events.image_pixels(img))
    # A flipped byte fails its CRC.
    data = bytearray(open(w.path, 'rb').read())
    data[-10] ^= 0x40
    open(w.path, 'wb').write(bytes(data))
    with pytest.raises(ValueError, match='CRC'):
        events.read_records(w.path)


def test_histogram_matches_tensorboardx(tmp_path):
    """The default bucket limits are tensorboardX's ``bins='tensorflow'``,
    and each histogram its ``make_histogram``, field for field."""
    from tensorboardX import SummaryWriter
    from tensorboardX.summary import histogram as tbx_histogram
    writer = SummaryWriter(str(tmp_path))
    assert events.DEFAULT_BINS == writer.default_bins
    writer.close()
    rng = np.random.RandomState(1)
    for vals in (rng.randn(1000), np.abs(rng.randn(77)) + 3, np.zeros(5),
                 np.array([2.5])):
        ref = tbx_histogram('x', vals, events.DEFAULT_BINS).value[0].histo
        ours = events.histogram(vals)
        assert list(ref.bucket) == ours['bucket']
        np.testing.assert_array_equal(ref.bucket_limit, ours['bucket_limit'])
        assert (ref.min, ref.max, ref.num, ref.sum, ref.sum_squares) == (
            ours['min'], ours['max'], ours['num'], ours['sum'],
            ours['sum_squares'])


def _tag_sizes(jmodel) -> dict:
    """{tag: leaf size} of the JAX ModelParameterLogger's leaves."""
    return {events.clean_tag('model' + ''.join(str(k) for k in p)):
            np.size(v) for p, v in
            jax.tree_util.tree_flatten_with_path(jmodel)[0]}


class _ReplayedLogLikelihood(tensorboard.LogLikelihoodLogger):
    """The port's logger fed the JAX logger's draws: the step's key folded
    into PRNGKey(0), split once per batch, then split per layer."""

    def __init__(self, jmodel):
        super().__init__()
        self.jmodel = jmodel

    def draw(self, generator, step, batch, model, rows):
        if batch == 0:
            self.key = jax.random.fold_in(jax.random.PRNGKey(0), step)
        self.key, sub = jax.random.split(self.key)
        return {'noise': jax_draws(self.jmodel, sub, rows)}


class _ReplayedLayerOutput(tensorboard.LayerOutputLogger):
    def noise(self, step, shape, like):
        return torch.as_tensor(np.asarray(jax.random.normal(
            jax.random.PRNGKey(step), shape, jnp.float64)))


def test_log_matches_jax_tensorboard_log(tmp_path):
    jmodel, port, X = _models('conv')
    N = X.shape[0]
    X = np.concatenate([X, 0.5 * X, X[:6]])        # 70 rows: 2 ELBO batches
    Y = np.random.RandomState(1).randint(0, 10, size=(len(X), 1))
    Xtest = np.random.RandomState(2).randn(9, X.shape[1])
    assert N < 64 < len(X)
    jexp = types.SimpleNamespace(
        state=types.SimpleNamespace(model=jmodel),
        X_train=X.reshape(-1, 12, 12, 1), Y_train=Y,
        X_test=Xtest.reshape(-1, 12, 12, 1))
    pexp = types.SimpleNamespace(
        model=port, X_train_dev=torch.as_tensor(X),
        Y_train_dev=torch.as_tensor(Y), X_test_dev=torch.as_tensor(Xtest))
    jlog = jtb.TensorBoardLog([jtb.LogLikelihoodLogger(),
                               jtb.ModelParameterLogger(),
                               jtb.LayerOutputLogger(),
                               jtb.PatchCovarianceLogger()],
                              str(tmp_path / 'jax'), 'run')
    plog = tensorboard.TensorBoardLog([_ReplayedLogLikelihood(jmodel),
                                       tensorboard.ModelParameterLogger(),
                                       _ReplayedLayerOutput(),
                                       tensorboard.PatchCovarianceLogger()],
                                      str(tmp_path / 'port'), 'run')
    for step in STEPS:
        jexp.global_step = pexp.global_step = step
        jlog.write_entry(jexp)
        plog.write_entry(pexp)
    jlog.close()
    plog.close()
    ref = _by_tag(_only_file(str(tmp_path / 'jax' / 'run')))
    ours = _by_tag(_only_file(str(tmp_path / 'port' / 'run')))
    assert sorted(ours) == sorted(ref)
    # tensorboardX's cleaned tags: 'model.layers[0].Z' -> 'model.layers_0_.Z'.
    sizes = _tag_sizes(jmodel)
    assert {t for t, _ in ours} == set(sizes) | {
        'train_log_likelihood', 'conv_sample', 'conv_mean', 'conv_var',
        'Kuf_covariance'}
    assert 'model.layers_0_.base_kernel.raw_variance' in sizes
    for (tag, step), v in ours.items():
        r = ref[(tag, step)]
        if tag == 'train_log_likelihood':
            np.testing.assert_allclose(v['simple_value'], r['simple_value'],
                                       rtol=1e-6)
        elif 'simple_value' in r:
            assert v['simple_value'] == r['simple_value'], tag
        elif 'histo' in r:
            assert v['histo'] == r['histo'], tag
            assert v['histo']['num'] == sizes[tag]
        else:
            a = events.decode_png(v['image']['png']).astype(int)
            b = events.decode_png(r['image']['png']).astype(int)
            assert a.shape == b.shape and np.abs(a - b).max() <= 1, tag
            assert {k: v['image'][k] for k in ('height', 'width',
                                               'colorspace')} == \
                {k: r['image'][k] for k in ('height', 'width', 'colorspace')}


@pytest.fixture
def _no_dataset(monkeypatch, tmp_path_factory):
    monkeypatch.setenv('DEEPCGP_DATA_DIR', str(tmp_path_factory.mktemp('none')))


def test_cpu_cli_writes_the_jax_cli_tags(tmp_path, _no_dataset):
    """``cifar.main`` without ``--no-tensorboard``: one events file under
    ``<tensorboard_dir>/<name>`` with an entry per log step, each carrying
    the JAX CLI's tags for the same flags (its builder's leaves)."""
    argv = ['--name', 'tb', '-N', '64', '-M', '4,4', '--feature-maps', '2',
            '--filter-sizes', '5,5', '--strides', '2,2', '--test-every', '2',
            '--lr-decay-steps', '4', '--test-size', '32', '--num-samples',
            '2', '--batch-size', '8', '--log-dir', str(tmp_path / 'logs'),
            '--tensorboard-dir', str(tmp_path / 'tb')]
    exp = cifar.main(argv, device='cpu')
    tags = _by_tag(_only_file(str(tmp_path / 'tb' / 'tb')))
    steps = sorted({s for _, s in tags})
    assert steps == [2 * (i + 1) for i in range(len(steps))] and \
        steps[-1] == exp.global_step
    jmodel = jbuild(BuilderFlags(M='4,4', feature_maps='2',
                                 filter_sizes='5,5', strides='2,2'),
                    np.random.RandomState(0).randn(16, 32, 32, 3),
                    np.zeros((16, 1), int), jax.random.PRNGKey(0))
    sizes = _tag_sizes(jmodel)
    for step in steps:
        at = {t: v for (t, s), v in tags.items() if s == step}
        assert set(at) == set(sizes) | {'train_log_likelihood', 'conv_sample',
                                         'conv_mean', 'conv_var'}
        assert np.isfinite(at['train_log_likelihood']['simple_value'])
        for tag, size in sizes.items():
            assert (at[tag]['histo']['num'] == size if size > 1
                    else 'simple_value' in at[tag]), tag
        img = events.decode_png(at['conv_mean']['image']['png'])
        assert img.shape == (14, 14 * 2, 3)
