"""The port's diagnostics, inspection and tracing utilities on the CPU,
against the JAX package's where it has them: ``param_health`` and
``cholesky_health`` (the same keys and answers), ``elbo_drift`` on JAX's
own draws (the float64 ELBO to rtol 1e-9, the float32 one within 1e-5 of
it), ``cast_model``, ``layer_features`` (1e-9),
``inducing_patches``, ``inducing_patch_grid`` and the embedding's PCA
(equal), ``patch_embedding``'s shapes, ``noise_robustness``, and a
``trace`` that names its ``annotate`` region."""

import copy
import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepcgp_tpu.utils import diagnostics as jdiag
from deepcgp_tpu.utils import inspect as jinspect

from deepcgp_tpu_torch.training import trainer
from deepcgp_tpu_torch.utils import diagnostics, inspect, profiling

from test_torch_full_cov import _models
from test_torch_serving import jax_draws as jax_draws_S
from test_torch_training import jax_draws


def test_param_and_cholesky_health_match_jax():
    jmodel, port, _ = _models('conv')
    assert diagnostics.param_health(port) == jdiag.param_health(jmodel) == {}
    assert diagnostics.cholesky_health(port) == jdiag.cholesky_health(jmodel)
    bad_q = np.array(jmodel.layers[1].q_sqrt)
    bad_q[0, :2, 0] = np.nan
    bad_z = np.array(jmodel.layers[0].Z)
    bad_z[1, 3] = np.inf
    jbad = jmodel.replace(layers=(jmodel.layers[0].replace(Z=jnp.asarray(bad_z)),
                                  jmodel.layers[1].replace(
                                      q_sqrt=jnp.asarray(bad_q))))
    pbad = copy.deepcopy(port)
    with torch.no_grad():
        pbad.layers[1].q_sqrt.copy_(torch.as_tensor(bad_q))
        pbad.layers[0].Z.copy_(torch.as_tensor(bad_z))
    assert diagnostics.param_health(pbad) == jdiag.param_health(jbad) == {
        '.layers[0].Z': 1, '.layers[1].q_sqrt': 2}
    assert diagnostics.cholesky_health(pbad) == jdiag.cholesky_health(jbad)
    assert [c['cholesky_ok'] for c in diagnostics.cholesky_health(pbad)] == \
        [False, True]


def test_elbo_drift_matches_jax():
    """The float64 ELBO against the JAX model's on the same draws (the
    JAX package's ``elbo_drift`` evaluates it eagerly, op by op, which
    takes half a minute here; its float64 half is the jitted ELBO below).
    The float32 ELBO takes the same draws rounded to float32, so it is
    held to its own float64 value: JAX's float32 half draws its normals in
    float32, another stream."""
    jmodel, port, X = _models('conv')
    Y = np.random.RandomState(3).randint(0, 10, size=(8, 1))
    key = jax.random.PRNGKey(4)
    ref64 = float(jax.jit(lambda m, x, y: m.elbo(x, y, key))(
        jmodel, jnp.asarray(X[:8]), jnp.asarray(Y)))
    out = diagnostics.elbo_drift(port, X[:8], Y,
                                 noise=jax_draws(jmodel, key, 8))
    np.testing.assert_allclose(out['elbo_f64'], ref64, rtol=1e-9)
    assert out['rel_drift'] == abs(out['elbo_f32'] - out['elbo_f64']) / abs(
        out['elbo_f64']) and out['rel_drift'] < 1e-5
    assert port.layers[0].Z.dtype == torch.float64        # left as it was
    m32 = diagnostics.cast_model(port, torch.float32)
    assert {p.dtype for p in m32.parameters()} == {torch.float32}
    assert m32.layers[1].kernel.patch_perm.dtype == torch.int64
    # Without noise the draw is the port's own, from the seed.
    again = diagnostics.elbo_drift(port, X[:8], Y, seed=1, num_samples=3)
    assert np.isfinite(again['elbo_f64']) and port.num_samples == 2


def test_layer_features_match_jax():
    jmodel, port, X = _models('conv')
    key = jax.random.PRNGKey(6)
    ref = jinspect.layer_features(jmodel, X[:5], key, num_samples=3)
    out = inspect.layer_features(port, X[:5], 3,
                                 noise=jax_draws_S(jmodel, key, 5, 3))
    for ours, theirs in zip(out, ref):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9,
                                       atol=1e-9 * np.abs(b).max())


def test_inducing_patches_and_embedding_match_jax():
    jmodel, port, X = _models('conv')
    for i in (0, 1):
        np.testing.assert_array_equal(
            inspect.inducing_patches(port.layers[i]),
            jinspect.inducing_patches(jmodel.layers[i]))
        np.testing.assert_array_equal(
            inspect.inducing_patch_grid(port.layers[i], cols=4),
            jinspect.inducing_patch_grid(jmodel.layers[i], cols=4))
    joint = np.random.RandomState(0).randn(40, 25)
    np.testing.assert_array_equal(inspect._pca_2d(joint),
                                  jinspect._pca_2d(joint))
    images = X.reshape(-1, 12, 12, 1)
    emb_z, emb_d = inspect.patch_embedding(port.layers[0], images,
                                           max_data_patches=50)
    assert emb_z.shape == (6, 2) and emb_d.shape == (50, 2)
    assert np.isfinite(emb_z).all() and np.isfinite(emb_d).all()


def test_noise_robustness():
    jmodel, port, X = _models('conv')
    Y = np.random.RandomState(8).randint(0, 10, size=(len(X), 1))
    out = inspect.noise_robustness(port, X, Y, noise_levels=(0.0, 0.5),
                                   batch_size=8, num_samples=2, max_points=16,
                                   seed=3)
    assert list(out) == [0.0, 0.5]
    assert out[0.0] == trainer.accuracy(port, X[:16], Y[:16], seed=4,
                                        batch_size=8, num_samples=2)
    assert all(0.0 <= v <= 1.0 for v in out.values())


def test_trace_names_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate('port_region'):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (path,) = glob.glob(os.path.join(str(tmp_path), 'trace_*.json'))
    names = {e.get('name') for e in json.load(open(path))['traceEvents']}
    assert 'port_region' in names
    assert any(e.key == 'port_region' for e in prof.key_averages())
