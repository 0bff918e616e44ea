"""The PyTorch port's serving layer (deepcgp_tpu_torch/serving.py) on the
CPU: a snapshot written by the JAX package loads through the port's
``Predictor.from_run_dir`` and predicts what the JAX model predicts; the
Predictor's padded, batched answers equal per-batch ``predict_y``; and the
entry points refuse to run on the CPU unless asked."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch import convert
from deepcgp_tpu_torch.models import builder
from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.utils import checkpoint

IMAGE = (12, 12, 1)
FLAGS = BuilderFlags(M='16,16', feature_maps='2', filter_sizes='5,3',
                     strides='2,1', last_kernel='add')
S = 2


def _jax_model():
    rng = np.random.RandomState(0)
    X = rng.randn(32, *IMAGE)
    Y = rng.randint(0, 10, size=(32, 1))
    model = jbuild(FLAGS, X, Y, jax.random.PRNGKey(0), dtype=jnp.float64)
    layers = []
    for layer in model.layers:
        M, R = layer.q_mu.shape
        layers.append(layer.replace(q_mu=jnp.asarray(0.5 * rng.randn(M, R))))
    return model.replace(layers=tuple(layers)), X.reshape(32, -1), Y


def _write_run(root, model):
    """<root>/serve.npy beside <root>/serve/options.toml, as a training run
    leaves them."""
    jckpt.save_model(os.path.join(root, 'serve.npy'), model, 3)
    run = os.path.join(root, 'serve')
    os.makedirs(run)
    with open(os.path.join(run, 'options.toml'), 'w') as f:
        f.write('name = "serve"\n')
        for k in ('M', 'feature_maps', 'filter_sizes', 'strides',
                  'base_kernel', 'last_kernel'):
            f.write(f'{k} = "{getattr(FLAGS, k)}"\n')
        f.write('white = false\nidentity_mean = false\nnum_samples = 2\n')
    return run


def jax_draws(model, key, N, S):
    """The standard normals the JAX ``propagate`` draws for N rows."""
    from deepcgp_tpu.models.dgp import mc_normal
    out = []
    for layer in model.layers:
        key, sub = jax.random.split(key)
        out.append(np.array(mc_normal(sub, (S, N, layer.num_outputs),
                                      jnp.float64)))
    return out


def test_jax_snapshot_serves_through_port(tmp_path):
    model, X, Y = _jax_model()
    run = _write_run(str(tmp_path), model)
    pred = Predictor.from_run_dir(run, IMAGE, batch_size=8, num_samples=S,
                                  dtype=torch.float64, device='cpu')
    key = jax.random.PRNGKey(3)
    noise = jax_draws(model, key, 10, S)
    pj, _ = model.predict_y(jnp.asarray(X[:10]), key, S)
    p, _ = pred.model.predict_y(torch.as_tensor(X[:10]), S, noise=noise)
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), rtol=1e-9, atol=1e-12)
    assert float(p.std()) > 1e-3
    # The snapshot round-trips through the port's own writer.
    again = checkpoint.model_parameters(pred.model, 3)
    for k, v in jckpt.model_parameters(model, 3).items():
        np.testing.assert_allclose(again[k], v, rtol=1e-12, err_msg=k)


def test_predictor_equals_per_batch_predict_y():
    model, X, Y = _jax_model()
    port = convert.from_jax_parameters(FLAGS, IMAGE,
                                       jckpt.model_parameters(model, 0),
                                       device='cpu')
    pred = Predictor(port, batch_size=8, num_samples=S, seed=5, device='cpu')
    probs = pred.predict_proba(X[:13])                  # 13 = 8 + 5 padded
    dens = pred.log_density(X[:13], Y[:13])

    ref = Predictor(port, batch_size=8, num_samples=S, seed=5, device='cpu')
    Xp = torch.as_tensor(np.concatenate([X[:13], np.zeros((3, X.shape[1]))]))
    Yp = torch.as_tensor(np.concatenate([Y[:13], np.zeros((3, 1), int)]))
    want_p, want_d = [], []
    for b in (slice(0, 8), slice(8, 16)):
        want_p.append(port.predict_y(Xp[b], S, generator=ref._generator())[0].mean(0))
    for b in (slice(0, 8), slice(8, 16)):
        want_d.append(port.predict_density(Xp[b], Yp[b], S,
                                           generator=ref._generator())[:, 0])
    np.testing.assert_allclose(probs, torch.cat(want_p)[:13].numpy(), rtol=1e-6)
    np.testing.assert_allclose(dens, torch.cat(want_d)[:13].numpy(), rtol=1e-6)
    assert probs.shape == (13, 10) and dens.shape == (13,)
    assert pred.predict(X[:13]).shape == (13,)

    raw = X[:5] * 3.0 + 1.0
    pre = {'mean': np.ones(X.shape[1]), 'scale': np.full(X.shape[1], 3.0)}
    a = Predictor(port, batch_size=8, num_samples=S, seed=1, device='cpu',
                  preprocessing=pre).predict_proba(raw, raw=True)
    b = Predictor(port, batch_size=8, num_samples=S, seed=1,
                  device='cpu').predict_proba(X[:5].astype(np.float32))
    np.testing.assert_allclose(a, b, rtol=1e-5)
    with pytest.raises(ValueError, match='preprocessing'):
        pred.predict_proba(raw, raw=True)


def test_entry_points_need_a_device(monkeypatch):
    """Without device=, an entry point runs on the card, and raises where
    there is none."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    model, _, _ = _jax_model()
    params = jckpt.model_parameters(model, 0)
    with pytest.raises(RuntimeError, match='CUDA'):
        convert.from_jax_parameters(FLAGS, IMAGE, params)
    _, layer_params = checkpoint.parse_layer_parameters(params, 2)
    with pytest.raises(RuntimeError, match='CUDA'):
        builder.build_model(FLAGS, IMAGE, layer_params)
    port = builder.build_model(FLAGS, IMAGE, layer_params, device='cpu')
    with pytest.raises(RuntimeError, match='CUDA'):
        Predictor(port)


def test_fresh_init_is_refused():
    """Without training images there is nothing to initialise a layer's
    inducing points from: a build that lacks a saved Z and the images is
    refused."""
    with pytest.raises(ValueError, match='Z'):
        builder.build_model(FLAGS, IMAGE, {}, device='cpu')
