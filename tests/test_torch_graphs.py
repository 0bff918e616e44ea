"""The graphed chunk's contract on the CPU, where it runs eagerly: the
TrainState keeps its storage through ``run_chunk`` and
``restore_train_state`` (a replayed CUDA graph reads every tensor where
its capture found it), the chunk's steps equal the JAX package's
``train_step`` across a chunk boundary on the port's own draws, who runs
graphed (``graphs.use_graphs``), the launch counters' bookkeeping of a
capture and its replays, and ``cuda_cross._cached`` rebuilding inside a
capture."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models import dgp as jdgp
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.models.layers import ConvLayer as JConvLayer
from deepcgp_tpu.training import trainer as jtrainer
from deepcgp_tpu.utils import checkpoint as jckpt

from deepcgp_tpu_torch.convert import from_jax_parameters
from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.ops import cuda_cross
from deepcgp_tpu_torch.parallel import sharding
from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.training import graphs, trainer
from deepcgp_tpu_torch.utils import checkpoint

IMAGE = (12, 12, 1)
OPTIMIZERS = ['Adam', 'SGD', 'NatGrad']


def flags():
    return BuilderFlags(M='6,8', feature_maps='2', filter_sizes='5,3',
                        strides='2,1', num_samples=3, batch_size=8)


def small_port(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(64, *IMAGE)
    Y = rng.randint(0, 10, size=(64, 1))
    model = build_model(flags(), IMAGE, images=X,
                        generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float64, device='cpu')
    return model, torch.as_tensor(X.reshape(64, -1)), torch.as_tensor(Y)


def storage(state) -> dict:
    """data_ptr of every tensor of the state, by name."""
    out = {f'param {k}': p.data_ptr() for k, p in state.params.items()}
    out['step'] = state.step.data_ptr()
    if state.opt_state:
        out['count'] = state.opt_state['count'].data_ptr()
        for m in ('mu', 'nu'):
            out.update({f'{m} {k}': t.data_ptr()
                        for k, t in state.opt_state[m].items()})
    if state.steps_back is not None:
        out['steps_back'] = state.steps_back.data_ptr()
        out.update({f'prev {k}': t.data_ptr() for k, t in state.prev.items()})
    return out


def values(state) -> dict:
    out = {f'param {k}': p.detach().clone() for k, p in state.params.items()}
    out['step'] = state.step.clone()
    if state.opt_state:
        out['count'] = state.opt_state['count'].clone()
        for m in ('mu', 'nu'):
            out.update({f'{m} {k}': t.clone()
                        for k, t in state.opt_state[m].items()})
    if state.steps_back is not None:
        out['steps_back'] = state.steps_back.clone()
        out.update({f'prev {k}': t.clone() for k, t in state.prev.items()})
    return out


@pytest.mark.parametrize('optimizer', OPTIMIZERS)
def test_run_chunk_and_restore_keep_storage(optimizer, tmp_path):
    """Every parameter, moment, count, step, steps_back and prev keeps its
    storage through two chunks and a restore, and the restore brings the
    saved values back bit for bit."""
    model, X, Y = small_port()
    config = trainer.TrainConfig(optimizer=optimizer, batch_size=8,
                                 lr=1e-4 if optimizer == 'SGD' else 0.01)
    state = trainer.init_state(model, config, seed=3)
    ptrs = storage(state)
    trainer.run_chunk(state, config, X, Y, 3)
    assert storage(state) == ptrs
    checkpoint.save_train_state(str(tmp_path), state)
    saved = values(state)
    generator = state.generator.get_state()
    trainer.run_chunk(state, config, X, Y, 2)
    assert storage(state) == ptrs
    assert int(state.step) == 5
    checkpoint.restore_train_state(str(tmp_path), state)
    assert storage(state) == ptrs
    restored = values(state)
    assert restored.keys() == saved.keys()
    for k in saved:
        assert torch.equal(restored[k], saved[k]), k
    assert torch.equal(state.generator.get_state(), generator)


def _jax_model(seed):
    rng = np.random.RandomState(seed)
    X = rng.randn(96, *IMAGE)
    Y = rng.randint(0, 10, size=(96, 1))
    model = jbuild(flags(), X, Y, jax.random.PRNGKey(0), dtype=jnp.float64)
    # Away from the symmetric q_mu = 0 start, whose gradients cancel to
    # float64 noise that Adam's normalisation would amplify.
    prng = np.random.RandomState(100)
    model = model.replace(layers=tuple(
        layer.replace(q_mu=layer.q_mu + 0.05 * jnp.asarray(
            prng.randn(*layer.q_mu.shape))) for layer in model.layers))
    return model, X.reshape(96, -1), Y


def _jax_leaf(model, name):
    _, i, *path = name.split('.')
    node = model.layers[int(i)]
    for part in path:
        node = getattr(node, part)
    return node


def _assert_close(params, jmodel, what):
    """rtol 1e-6 with an absolute floor of 1e-7 of the array's largest
    magnitude: the rule of the trajectory tests of test_torch_training.py
    and test_torch_natgrad.py."""
    for name, p in params.items():
        ref = np.asarray(_jax_leaf(jmodel, name))
        p = p.detach()
        if name.endswith('q_sqrt'):
            ref, p = np.tril(ref), torch.tril(p)
        np.testing.assert_allclose(p.numpy(), ref, rtol=1e-6,
                                   atol=1e-7 * np.abs(ref).max() + 1e-12,
                                   err_msg=f'{what} {name}')


@pytest.mark.parametrize('optimizer', OPTIMIZERS)
def test_run_chunk_trajectory_matches_jax_across_chunks(optimizer,
                                                        monkeypatch):
    """Two ``run_chunk`` calls (3 and 2 steps) against the JAX package's
    ``train_step`` in float64, fed the port's own minibatches and
    Monte-Carlo draws (replayed from a copy of the state's generator in
    the order a step draws them: the indices, then each layer's normals;
    under NatGrad the final check's batch and normals after each chunk).
    The ELBO trace at rtol 1e-6, and every parameter (NatGrad: also prev
    and steps_back) after each chunk, as the trajectory tests hold them.
    Plain SGD takes lr 1e-4, as there (see
    test_torch_training.test_adam_trajectory_matches_jax)."""
    lr = 1e-4 if optimizer == 'SGD' else 0.01
    jmodel, Xd, Y = _jax_model(0)
    jconfig = jtrainer.TrainConfig(optimizer=optimizer, lr=lr, batch_size=8,
                                   gamma=0.01)
    state_j = jtrainer.init_state(jmodel, jconfig, jax.random.PRNGKey(1))
    draws: list = []
    monkeypatch.setattr(jdgp, 'mc_normal', lambda key, shape, dtype:
                        draws.pop(0))

    def jax_step(s, x, y, noise):
        draws[:] = list(noise)
        return jtrainer.train_step(s, jconfig, x, y)

    step_j = jax.jit(jax_step)
    params = jckpt.model_parameters(jmodel, 0)
    Z0 = [np.asarray(l.Z0) for l in jmodel.layers
          if isinstance(l, JConvLayer)]
    port = from_jax_parameters(flags(), IMAGE, params, Z0,
                               num_data=jmodel.num_data, device='cpu')
    config = trainer.TrainConfig(optimizer=optimizer, lr=lr, batch_size=8,
                                 gamma=0.01)
    state = trainer.init_state(port, config, seed=7)
    X, Yt = torch.as_tensor(Xd), torch.as_tensor(Y)
    S = port.num_samples

    def draw(g):
        idx = torch.randint(0, 96, (8,), generator=g)
        noise = [torch.randn((S, 8, layer.num_outputs), generator=g,
                             dtype=torch.float64) for layer in port.layers]
        return idx.numpy(), [z.numpy() for z in noise]

    for chunk in (3, 2):
        g = torch.Generator()
        g.set_state(state.generator.get_state())
        trace = trainer.run_chunk(state, config, X, Yt, chunk).numpy()
        for t in range(chunk):
            idx, noise = draw(g)
            state_j, elbo_j = step_j(state_j, jnp.asarray(Xd[idx]),
                                     jnp.asarray(Y[idx]), noise)
            np.testing.assert_allclose(trace[t], float(elbo_j), rtol=1e-6,
                                       err_msg=f'chunk {chunk} step {t}')
        if optimizer == 'NatGrad':
            draw(g)             # the final check's batch and draws
            _assert_close(state.prev, state_j.prev_model,
                          f'chunk {chunk} prev')
            assert float(state.steps_back) == float(state_j.steps_back)
        _assert_close(state.params, state_j.model, f'chunk {chunk}')
        assert torch.equal(state.generator.get_state(), g.get_state())
    assert int(state.step) == int(state_j.step) == 5


def test_graphed_true_on_the_cpu_raises():
    model, X, Y = small_port()
    config = trainer.TrainConfig(batch_size=8)
    state = trainer.init_state(model, config)
    with pytest.raises(ValueError, match='graphed=True needs a CUDA device'):
        trainer.run_chunk(state, config, X, Y, 1, graphed=True)
    with pytest.raises(ValueError, match='graphed=True needs a CUDA device'):
        trainer.accuracy(model, X[:8], Y[:8], graphed=True)
    with pytest.raises(ValueError, match='graphed=True needs a CUDA device'):
        Predictor(model, device='cpu', graphed=True).predict_proba(
            X[:4].numpy())
    assert state.graphs is None and int(state.step) == 0


def test_default_runs_eager_on_the_cpu():
    """graphed=None and graphed=False give the same chunk, eval and
    Predictor answers on the CPU (both eager), and no graph cache."""
    out = {}
    for graphed in (None, False):
        model, X, Y = small_port()
        config = trainer.TrainConfig(batch_size=8)
        state = trainer.init_state(model, config, seed=1)
        trace = trainer.run_chunk(state, config, X, Y, 2, graphed=graphed)
        acc = trainer.predict_probs(model, X[:20], seed=2, batch_size=8,
                                    graphed=graphed)
        pred = Predictor(model, batch_size=8, device='cpu',
                         graphed=graphed).predict_proba(X[:12].numpy())
        assert state.graphs is None
        out[graphed] = (trace, acc, torch.as_tensor(pred))
    for a, b in zip(out[None], out[False]):
        assert torch.equal(a, b)


def test_use_graphs_decides_by_device_and_mesh(monkeypatch):
    """None: graphed on a CUDA device without a mesh, eager on the CPU and
    under a gloo mesh (an NCCL mesh: tests/test_torch_graphs_mesh.py);
    True raises where None would run eager; False is eager everywhere."""
    cuda, cpu = torch.device('cuda'), torch.device('cpu')
    assert graphs.use_graphs(None, cuda, 'x') is True
    assert graphs.use_graphs(None, cpu, 'x') is False
    assert graphs.use_graphs(False, cuda, 'x') is False
    assert graphs.use_graphs(True, 'cuda', 'x') is True
    monkeypatch.setattr(torch.distributed, 'get_backend',
                        lambda group=None: 'gloo')
    with sharding.mesh_context(types.SimpleNamespace(
            data=2, model=1, distributed=True, data_group='data group',
            model_group='model group')):
        assert graphs.use_graphs(None, cuda, 'x') is False
        assert graphs.use_graphs(False, cuda, 'x') is False
        with pytest.raises(ValueError, match='under a gloo mesh'):
            graphs.use_graphs(True, cuda, 'x')
    with pytest.raises(ValueError, match='CUDA device'):
        graphs.use_graphs(True, cpu, 'x')


def test_capture_counts_are_taken_back_and_added_per_replay():
    """A stand-in wrapper that bumps its counter: the counts a capture
    makes are taken back (also when the capture raises), and every replay
    adds them once."""
    def stand_in():
        stand_in.launches += 1

    def other():
        other.launches += 3

    stand_in.launches, other.launches = 5, 7
    fns = (stand_in, other)
    with graphs.counts_taken_back(fns) as added:
        stand_in()
        stand_in()
        other()
    assert (stand_in.launches, other.launches) == (5, 7)
    assert added == [2, 3]
    with pytest.raises(KeyError):
        with graphs.counts_taken_back(fns) as failed:
            stand_in()
            raise KeyError('capture failed')
    assert (stand_in.launches, other.launches, failed) == (5, 7, [1, 0])

    class FakeGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    fake = FakeGraph()
    graph = graphs.Graph(fake, [], 'outputs', added, fns)
    for _ in range(4):
        cuda_cross._pad_cache['zp'] = 'a copy of Z'
        assert graph.replay() == 'outputs'
        # A replay writes Z behind its version counter: no padded copy of
        # the old Z may be read after it.
        assert cuda_cross._pad_cache == {}
    assert fake.replays == 4
    assert (stand_in.launches, other.launches) == (5 + 4 * 2, 7 + 4 * 3)


def test_counted_are_the_kernel_wrappers():
    """Every wrapper whose counter a replay adds to counts in an int
    ``.launches``, each one once."""
    fns = graphs.counted()
    assert len({id(fn) for fn in fns}) == len(fns) == 8
    assert {fn.__name__ for fn in fns} == {
        'chol_inv_base', 'chol_inv_base_upper', 'tri_inv_base',
        'conv_rbf_cross', 'conv_rbf_cross_bwd', 'extract_patches_transposed',
        'col2im_transposed', 'adam_step'}
    assert all(isinstance(fn.launches, int) for fn in fns)


@pytest.mark.parametrize('kind', ['zt', 'zp', 'zn'])
def test_cached_rebuilds_every_call_while_capturing(kind, monkeypatch):
    """Outside a capture a padded copy of Z is built once and rebuilt after
    Z is written in place; while the stream captures, every call builds
    it anew and the cache keeps the copy it had."""
    build = {'zt': cuda_cross._padded_zt, 'zp': cuda_cross._padded_z,
             'zn': cuda_cross._padded_zn}[kind]
    capturing = [False]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'is_current_stream_capturing',
                        lambda: capturing[0])
    monkeypatch.setattr(cuda_cross, '_pad_cache', {})
    Z = torch.randn(5, 7)
    first = build(Z)
    assert build(Z) is first
    capturing[0] = True
    inside = [build(Z), build(Z)]
    assert inside[0] is not inside[1] and inside[0] is not first
    assert torch.equal(inside[0], first) and torch.equal(inside[1], first)
    assert cuda_cross._pad_cache[kind][2] is first
    capturing[0] = False
    assert build(Z) is first
    with torch.no_grad():
        Z.mul_(2.0)
    rebuilt = build(Z)
    assert rebuilt is not first and not torch.equal(rebuilt, first)


@pytest.mark.parametrize('kind', ['zt', 'zp', 'zn'])
def test_cached_builds_every_call_in_a_graphs_eager_run(kind, monkeypatch):
    """Inside ``built_every_call`` (a graph's eager run, which precedes its
    capture) every call builds the padded copy anew, as a capture does, so
    the eager run launches what the replays launch; the cache keeps what
    it had, and outside the block the copy is cached as before."""
    build = {'zt': cuda_cross._padded_zt, 'zp': cuda_cross._padded_z,
             'zn': cuda_cross._padded_zn}[kind]
    monkeypatch.setattr(cuda_cross, '_pad_cache', {})
    Z = torch.randn(5, 7)
    first = build(Z)
    with cuda_cross.built_every_call():
        inside = [build(Z), build(Z)]
    assert inside[0] is not inside[1] and inside[0] is not first
    assert torch.equal(inside[0], first) and torch.equal(inside[1], first)
    assert cuda_cross._pad_cache[kind][2] is first
    assert build(Z) is first and not cuda_cross._EVERY_CALL


def test_robust_max_gradient_equals_autograd_prod():
    """The robust-max quadrature's product of CDFs takes autograd's
    zero-free ``prod`` backward without its host-side zero count: value
    and gradients bit-equal to ``prod``'s own (float32 and float64)."""
    from deepcgp_tpu_torch.models import likelihoods
    like = likelihoods.MultiClass(10)
    rng = np.random.RandomState(3)
    for dtype in (torch.float32, torch.float64):
        mu0 = torch.as_tensor(rng.randn(4, 6, 10), dtype=dtype)
        var0 = torch.as_tensor(rng.rand(4, 6, 10) + 0.1, dtype=dtype)
        Y = torch.as_tensor(rng.randint(0, 10, size=(4, 6, 1)))
        out = {}
        for prod in ('custom', 'autograd'):
            mu = mu0.clone().requires_grad_(True)
            var = var0.clone().requires_grad_(True)
            if prod == 'autograd':
                orig = likelihoods._ProdOfNonzero.apply
                likelihoods._ProdOfNonzero.apply = lambda x, d: x.prod(d)
            try:
                v = like.variational_expectations(mu, var, Y)
            finally:
                if prod == 'autograd':
                    likelihoods._ProdOfNonzero.apply = orig
            g = torch.autograd.grad(v.sum(), [mu, var])
            out[prod] = (v.detach(), *g)
        for a, b in zip(out['custom'], out['autograd']):
            assert torch.equal(a, b)
