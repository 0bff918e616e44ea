"""The port's multi-process layer (``deepcgp_tpu_torch/parallel``) against
the JAX package's ``deepcgp_tpu/parallel`` and against the port's own
single-process step, on the CPU with gloo.

One group of 4 processes (mesh data=2 x model=2, float64) runs two Adam
and two NatGrad steps of three geometries -- the small 2-layer conv
model, the M=1024 geometry at M = 8 (an ARD-RBF SVGP layer, its GPs over
'model') and a single-layer ConvKernel at M = 8 -- on the global batches
and the JAX package's own Monte-Carlo draws;
then the first case again with the data axis' gradient sum, and with the
model axis' sum in ``replicate_in``'s backward, patched out; then a
request served through ``Predictor(mesh=...)`` and the sharded
evaluation.  Every rank's ELBO and parameters are held to the port's
single-process step at rtol 1e-8 and to the JAX ``train_step`` at rtol
1e-6; each patched-out collective must break that agreement.  The mesh
helpers are held against the JAX functions' outputs, and
``dryrun_multichip`` runs in a group of its own."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcgp_tpu.models import dgp as jdgp
from deepcgp_tpu.models.builder import BuilderFlags, build_model as jbuild
from deepcgp_tpu.models.layers import ConvLayer as JConvLayer
from deepcgp_tpu.parallel import mesh as jmesh
from deepcgp_tpu.parallel import multihost as jmultihost
from deepcgp_tpu.training import trainer as jtrainer
from deepcgp_tpu.utils import checkpoint as jckpt

import torch_parallel_worker as worker
from deepcgp_tpu_torch.parallel import mesh as mesh_lib
from deepcgp_tpu_torch.parallel import multihost, sharding
from deepcgp_tpu_torch.parallel.train import (dryrun_multichip, free_port,
                                              run_processes)

WORLD, SPEC = 4, 'data=2,model=2'
IMAGE = (12, 12, 1)
GEOMETRIES = {
    'conv2': BuilderFlags(M='6,8', feature_maps='2', filter_sizes='5,3',
                          strides='2,1', num_samples=3, batch_size=8),
    'rbf': BuilderFlags(M='8', feature_maps='', filter_sizes='5',
                        strides='1', last_kernel='rbf', num_samples=3,
                        batch_size=8),
    'convkernel': BuilderFlags(M='8', feature_maps='', filter_sizes='5',
                               strides='1', num_samples=3, batch_size=8)}
CASES = [(g, o) for o in ('Adam', 'NatGrad') for g in GEOMETRIES]
STEPS = 2


def jax_draws(model, key, N):
    """The standard normals ``dgp.propagate`` draws for N rows."""
    out = []
    for layer in model.layers:
        key, sub = jax.random.split(key)
        out.append(np.array(jdgp.mc_normal(
            sub, (model.num_samples, N, layer.num_outputs), layer.q_mu.dtype)))
    return out


def jax_leaf(model, name):
    _, i, *path = name.split('.')
    node = model.layers[int(i)]
    for part in path:
        node = getattr(node, part)
    return np.asarray(node)


def _case(geometry, optimizer):
    """The JAX trajectory of ``STEPS`` steps (float64, q_mu moved off its
    symmetric zero start as the single-process trajectory tests do), and
    what a rank needs to replay it: the model's parameters, the global
    batches and the draws."""
    flags = GEOMETRIES[geometry]
    rng = np.random.RandomState(0)
    X = rng.randn(96, *IMAGE)
    Y = rng.randint(0, 10, size=(96, 1))
    model = jbuild(flags, X, Y, jax.random.PRNGKey(0), dtype=jnp.float64)
    prng = np.random.RandomState(100)
    model = model.replace(layers=tuple(
        layer.replace(q_mu=layer.q_mu + 0.05 * jnp.asarray(
            prng.randn(*layer.q_mu.shape))) for layer in model.layers))
    kw = dict(optimizer=optimizer, lr=0.01, batch_size=8, gamma=0.01)
    config = jtrainer.TrainConfig(**kw)
    state_j = jtrainer.init_state(model, config, jax.random.PRNGKey(1))
    step_j = jax.jit(lambda s, x, y: jtrainer.train_step(s, config, x, y))
    case = {'flags': dataclasses.asdict(flags), 'image': IMAGE,
            'params': jckpt.model_parameters(model, 0),
            'Z0': [np.asarray(l.Z0) for l in model.layers
                   if isinstance(l, JConvLayer)],
            'num_data': model.num_data, 'config': kw, 'steps': []}
    Xd = X.reshape(96, -1)
    key, brng, jax_out = state_j.key, np.random.RandomState(2), []
    for _ in range(STEPS):
        idx = brng.randint(0, 96, size=8)
        key, k_mc = jax.random.split(key)
        case['steps'].append((Xd[idx], Y[idx],
                              jax_draws(state_j.model, k_mc, 8)))
        state_j, elbo_j = step_j(state_j, jnp.asarray(Xd[idx]),
                                 jnp.asarray(Y[idx]))
        jax_out.append((float(elbo_j), state_j.model))
    return case, jax_out


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The JAX trajectories, the port's single-process ones and the 4
    ranks' sharded ones (one spawned group for the whole file)."""
    cases, jax_outs = {}, {}
    for geometry, optimizer in CASES:
        name = f'{geometry}-{optimizer}'
        cases[name], jax_outs[name] = _case(geometry, optimizer)
    rng = np.random.RandomState(9)
    request = {'X': rng.randn(13, int(np.prod(IMAGE))),
               'Y': rng.randint(0, 10, size=(13, 1))}
    single = {name: worker.run_case(None, case)
              for name, case in cases.items()}
    single['serve'] = worker.serve(None, next(iter(cases.values())), request)
    out_dir = tmp_path_factory.mktemp('ranks')
    run_processes(worker.step_worker, WORLD,
                  (WORLD, free_port(), SPEC, cases, request, str(out_dir)),
                  timeout=300)
    ranks = [torch.load(out_dir / f'rank{r}.pt', weights_only=False)
             for r in range(WORLD)]
    return cases, jax_outs, single, ranks


def _agree(got, want, rtol, floor=0.0):
    """Each step's ELBO and every parameter (the lower triangle of q_sqrt)
    at ``rtol``, with an absolute floor of ``floor`` times the array's
    largest magnitude."""
    assert len(got) == len(want)
    for t, ((elbo, params), (elbo_w, params_w)) in enumerate(zip(got, want)):
        np.testing.assert_allclose(elbo, elbo_w, rtol=rtol,
                                   err_msg=f'step {t} ELBO')
        for name, p in params.items():
            ref = params_w[name]
            if name.endswith('q_sqrt'):
                p, ref = np.tril(p), np.tril(ref)
            np.testing.assert_allclose(
                p, ref, rtol=rtol, atol=floor * np.abs(ref).max() + 1e-300,
                err_msg=f'step {t} {name}')


@pytest.mark.parametrize('name', [f'{g}-{o}' for g, o in CASES])
def test_sharded_step_equals_single_process(runs, name):
    """Every rank of data=2 x model=2 takes the single-process step's
    ELBO and parameters, float64, rtol 1e-8."""
    _, _, single, ranks = runs
    assert sorted(r['mesh'] for r in ranks) == [(0, 0), (0, 1), (1, 0),
                                                (1, 1)]
    for r, out in enumerate(ranks):
        _agree(out[name], single[name], 1e-8)


@pytest.mark.parametrize('name', [f'{g}-{o}' for g, o in CASES])
def test_sharded_step_equals_jax(runs, name):
    """Rank 0's sharded trajectory against the JAX package's
    ``train_step`` with its draws replayed, float64: rtol 1e-6 with an
    absolute floor of 1e-7 of the array's largest magnitude (the
    single-process trajectory tests' rule)."""
    _, jax_outs, _, ranks = runs
    want = [(elbo, {k: jax_leaf(model, k) for k in ranks[0][name][0][1]})
            for elbo, model in jax_outs[name]]
    _agree(ranks[0][name], want, 1e-6, floor=1e-7)


@pytest.mark.parametrize('kind', ['data', 'replicate'])
def test_a_patched_out_collective_fails_the_check(runs, kind):
    """The sharded step without the data axis' gradient sum, or without
    the model axis' sum in replicate_in's backward, is finite but wrong:
    the equality with the single-process step must fail."""
    cases, _, single, ranks = runs
    first = next(iter(cases))
    for out in ranks:
        assert all(np.isfinite(e) for e, _ in out[f'fault-{kind}'])
        with pytest.raises(AssertionError):
            _agree(out[f'fault-{kind}'], single[first], 1e-8)


def test_predictor_mesh_equals_single_process(runs):
    """``Predictor(mesh='data=2,model=2')``: a 13-row request in batches
    of 8 (the last one padded), probabilities and log-densities on every
    rank equal the single-process Predictor's (rtol 1e-10); the sharded
    evaluation's probabilities and correct count equal
    ``trainer.predict_probs`` / ``correct_count``."""
    _, _, single, ranks = runs
    want = single['serve']
    for out in ranks:
        got = out['serve']
        assert got['probs'].shape == (13, 10)
        for key in ('probs', 'log_density', 'eval'):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-10,
                                       atol=1e-14, err_msg=key)
        assert got['count'] == want['count']


def test_dryrun_multichip():
    """``dryrun_multichip(4)`` in float64: two sharded steps of Adam and
    NatGrad and the R-sharded M=1024-geometry step, each against the
    replicated step, in 4 gloo processes; the JAX package's summary
    line."""
    line = dryrun_multichip(4, dtype=torch.float64)
    assert line.startswith('MULTICHIP DRYRUN OK: mesh data=2 x model=2')
    assert 'rtol 1e-06' in line


# -- the helpers, against the JAX package's ------------------------------------

def test_parse_mesh_spec_equals_jax():
    for spec in ('data=4,model=2', 'model=2', 'data=8', ''):
        assert mesh_lib.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)


def test_mesh_layout_equals_jax():
    """Rank r sits where device r sits in the JAX package's (data, model)
    mesh of 8 devices: row-major."""
    devices = jax.devices()[:8]
    jm = jmesh.make_mesh({'data': 4, 'model': 2}, devices=devices)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        m = mesh_lib.Mesh(data=4, model=2, rank=r, world_size=8)
        assert ids[m.data_rank, m.model_rank] == devices[r].id
    assert jm.axis_names == m.axis_names


def test_make_mesh_one_process():
    """Without a process group: the one-rank mesh, no collectives; a spec
    larger than the world or with an unknown axis raises, as the JAX
    package asserts."""
    m = mesh_lib.make_mesh('')
    assert (m.data, m.model, m.rank, m.distributed) == (1, 1, 0, False)
    assert mesh_lib.make_mesh('data=1,model=1').shape == {'data': 1,
                                                          'model': 1}
    with pytest.raises(ValueError, match='needs 2 ranks'):
        mesh_lib.make_mesh('data=2')
    with pytest.raises(ValueError, match='unknown mesh axes'):
        mesh_lib.make_mesh('pipe=1')
    with pytest.raises(AssertionError):
        jmesh.make_mesh({'data': 16})


@pytest.mark.parametrize('n_proc', [2, 3, 4])
def test_process_shard_and_pad_rows_equal_jax(n_proc, monkeypatch):
    """process_shard's even split (the remainder dropped) and pad_rows'
    zero rows and -1 labels, rank by rank, as the JAX functions give
    them."""
    X = np.arange(11 * 3).reshape(11, 3)
    Y = np.arange(11)[:, None]
    for idx in range(n_proc):
        monkeypatch.setattr(multihost, 'world', lambda i=idx: (n_proc, i))
        monkeypatch.setattr(jax, 'process_count', lambda: n_proc)
        monkeypatch.setattr(jax, 'process_index', lambda i=idx: i)
        np.testing.assert_array_equal(multihost.process_shard(X),
                                      jmultihost.process_shard(X))
        for a, b in zip(multihost.pad_rows(X, Y, n_proc),
                        jmultihost.pad_rows(X, Y, n_proc)):
            np.testing.assert_array_equal(a, b)


def test_fetch_rows_and_split_rows_one_process():
    """One process: fetch_rows is indexing, split_rows the identity, and
    every helper leaves its input as it is."""
    X = torch.arange(24.).reshape(8, 3)
    Y = torch.arange(8)[:, None]
    idx = torch.tensor([5, 0, 7, 5])
    xb, yb = multihost.fetch_rows(X, Y, idx)
    assert torch.equal(xb, X[idx]) and torch.equal(yb, Y[idx])
    assert sharding.split_rows(X, Y)[0] is X
    with sharding.mesh_context(mesh_lib.make_mesh('')):
        assert sharding.replicate_in(X) is X
        assert sharding.gather_out(X, 0) is X
        assert sharding.model_block(4, 'P', (4,)) is None
        assert sharding.sum_over_data([X])[0] is X


@pytest.mark.parametrize('rank', [0, 1])
def test_padded_batch_takes_the_true_rows_draws(rank):
    """split_rows pads a tensor batch as pad_rows pads arrays, and inside
    true_rows each data rank's draw is its rows of the unpadded batch's
    one-process draw, zeros on the padding rows."""
    X = torch.arange(15.).reshape(5, 3)
    Y = torch.arange(5)[:, None]
    want = [torch.as_tensor(a) for a in multihost.pad_rows(X.numpy(),
                                                           Y.numpy(), 2)]
    mesh = mesh_lib.Mesh(data=2, model=1, rank=rank, world_size=2)
    g = torch.Generator().manual_seed(3)
    one = torch.randn((2, 5, 4), generator=g, dtype=torch.float64)
    one = torch.cat([one, one.new_zeros((2, 1, 4))], dim=1)
    with sharding.mesh_context(mesh), sharding.true_rows(5):
        xb, yb = sharding.split_rows(X, Y)
        z = sharding.normal((2, 3, 4), g.manual_seed(3),
                            dtype=torch.float64, device='cpu', dim=1)
    rows = slice(3 * rank, 3 * rank + 3)
    assert torch.equal(xb, want[0][rows]) and torch.equal(yb, want[1][rows])
    assert torch.equal(z, one[:, rows])


def test_model_block_warns_once_on_a_non_dividing_axis():
    """A sharded axis that does not divide the model group runs whole on
    every rank, with one warning naming the shape (the JAX package's
    ``constrain`` rule)."""
    mesh = mesh_lib.Mesh(data=1, model=2, rank=1, world_size=2)
    with sharding.mesh_context(mesh):
        assert sharding.model_block(10, 'R', (10, 4, 4)) == slice(5, 10)
        with pytest.warns(UserWarning, match=r'\(5, 4, 4\)'):
            assert sharding.model_block(5, 'R', (5, 4, 4)) is None
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter('error')
            assert sharding.model_block(5, 'R', (5, 4, 4)) is None
