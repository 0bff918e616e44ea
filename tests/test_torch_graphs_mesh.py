"""The mesh's collectives inside the captured graphs, on the CPU: who runs
graphed under a mesh (``graphs.use_graphs`` over the device, the mesh's
backend and ``graphed``), the mesh in every graph key of the chunk, the
eval and the Predictor, a capture that fails raising and the collective
counter's bookkeeping, and -- in two gloo processes under data=2 and
model=2 -- the functions the graphed paths would capture running with no
host read and giving the eager sharded answers bit for bit (the eager
sharded step is held to the JAX package's in test_torch_parallel.py)."""

import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_parallel_worker as worker
from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.parallel import mesh as mesh_lib
from deepcgp_tpu_torch.parallel import sharding
from deepcgp_tpu_torch.parallel.train import free_port, run_processes
from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.training import graphs, trainer
from deepcgp_tpu_torch.utils import profiling

IMAGE = (12, 12, 1)


def group_mesh(groups=('data group', 'model group')):
    """A one-rank mesh whose groups are the given stand-ins."""
    return mesh_lib.Mesh(1, 1, 0, 1, *groups)


# (device, mesh backend) -> what graphed None, False and True give: a bool,
# or the ValueError's message.
DECISIONS = {
    ('cpu', None): (False, False, 'needs a CUDA device'),
    ('cpu', 'nccl'): (False, False, 'needs a CUDA device'),
    ('cpu', 'gloo'): (False, False, 'needs a CUDA device'),
    ('cuda', None): (True, False, True),
    ('cuda', 'one rank'): (True, False, True),
    ('cuda', 'nccl'): (True, False, True),
    ('cuda', 'gloo'): (False, False, 'under a gloo mesh'),
}


@pytest.mark.parametrize('graphed', [None, False, True])
@pytest.mark.parametrize('device,backend', list(DECISIONS))
def test_use_graphs_decision_table(device, backend, graphed, monkeypatch):
    """None is graphed on a CUDA device without a mesh, under a one-rank
    mesh without a process group and under an NCCL mesh, eager on the CPU
    and under gloo; False is eager everywhere; True raises where None is
    eager.  The backend is read from every group of the mesh."""
    seen = []

    def get_backend(group=None):
        seen.append(group)
        return backend
    monkeypatch.setattr(dist, 'get_backend', get_backend)
    mesh = {None: None, 'one rank': group_mesh((None, None))}.get(
        backend, group_mesh())
    want = DECISIONS[device, backend][[None, False, True].index(graphed)]
    with sharding.mesh_context(mesh):
        if isinstance(want, str):
            with pytest.raises(ValueError, match=want):
                graphs.use_graphs(graphed, torch.device(device), 'x')
        else:
            assert graphs.use_graphs(graphed, device, 'x') is want
    if backend in ('nccl', 'gloo') and (device, graphed) != ('cpu', True):
        assert set(seen) >= {None, 'data group', 'model group'}


def _model(seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(24, *IMAGE)
    Y = rng.randint(0, 10, size=(24, 1))
    flags = types.SimpleNamespace(
        M='6,8', feature_maps='2', filter_sizes='5,3', strides='2,1',
        num_samples=2, base_kernel='rbf', last_kernel='conv', white=False,
        identity_mean=False)
    model = build_model(flags, IMAGE, images=X,
                        generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float64, device='cpu')
    return model, torch.as_tensor(X.reshape(24, -1)), torch.as_tensor(Y)


def _one_rank_collective(fn, *args, **kwargs):
    """A collective over one rank, on the host: the identity, or the input
    copied into the output of an all-gather."""
    if fn is dist.all_gather_into_tensor:
        args[0].copy_(args[1])


def test_graph_keys_hold_the_mesh(monkeypatch):
    """The keys of run_chunk's step and NatGrad's final check, of the eval
    (probabilities, the count and its sum) and of the Predictor's batch
    hold the active mesh: without a mesh and under two one-rank NCCL
    meshes (other groups) every path's keys differ, and the answers are
    the same."""
    monkeypatch.setattr(dist, 'get_backend', lambda group=None: 'nccl')
    monkeypatch.setattr(sharding, 'collective', _one_rank_collective)
    keys, answers = {}, {}
    for label, mesh in (('none', None), ('a', group_mesh(('a', 'b'))),
                        ('b', group_mesh(('c', 'd')))):
        model, X, Y = _model()
        with worker.graphed_on_the_cpu() as caches, \
                sharding.mesh_context(mesh):
            out = []
            for optimizer in ('Adam', 'NatGrad'):
                config = trainer.TrainConfig(optimizer=optimizer,
                                             batch_size=4, gamma=0.01)
                state = trainer.init_state(model, config, seed=1)
                out.append(trainer.run_chunk(state, config, X, Y, 2))
            out.append(trainer.predict_probs(model, X[:12], 3, 8, 2))
            out.append(trainer.correct_count(model, X[:12], Y[:12], 3, 8, 2))
            out.append(torch.as_tensor(Predictor(
                model, batch_size=4, num_samples=2, device='cpu',
                mesh=mesh).predict_proba(X[:6].numpy())))
        keys[label] = [k for c in caches for k in c.keys]
        answers[label] = out
        assert not [r for c in caches for r in c.reads]
    kinds = [k[0] for k in keys['none']]
    assert kinds.count('step') == 4 and kinds.count('final check') == 1
    assert {'eval', 'eval count', 'predict_proba'} <= set(kinds)
    assert 'eval sum' not in kinds    # a one-process eval sums nothing
    for label in ('a', 'b'):
        meshed = [k[0] for k in keys[label]]
        assert meshed.count('eval sum') == 1
        assert [k for k in meshed if k != 'eval sum'] == kinds
    idents = {label: (1, 1, 0, 1) + groups
              for label, groups in (('a', ('a', 'b')), ('b', ('c', 'd')))}
    for label, got in keys.items():
        for other, ident in idents.items():
            assert all(worker.contains(k, ident) == (label == other)
                       for k in got), (label, other)
    for got in (answers['a'], answers['b']):
        assert all(torch.equal(x, y) for x, y in zip(got, answers['none']))


class _FakeCUDAGraph:
    def register_generator_state(self, g):
        pass

    def capture_begin(self, pool=None):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


def _cache():
    cache = object.__new__(graphs.GraphCache)
    cache.pool, cache.captures, cache.capture_seconds = None, 0, 0.0
    return cache


def test_capture_under_an_nccl_mesh_raises(monkeypatch):
    """A function that fails while it is captured under an NCCL mesh
    raises, with the capture's note; nothing runs it eagerly instead, and
    the collectives it counted are taken back."""
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _FakeCUDAGraph)
    monkeypatch.setattr(dist, 'get_backend', lambda group=None: 'nccl')
    calls = []

    def step():
        calls.append(1)
        sharding.collective(lambda: None)
        raise RuntimeError('operation not permitted when stream is capturing')
    before = sharding.collective.launches
    with sharding.mesh_context(group_mesh()):
        assert graphs.use_graphs(None, 'cuda', 'x') is True
        with pytest.raises(RuntimeError, match='capturing') as info:
            _cache()._capture(step, [], (), 'graph replay step')
    assert 'raised while capturing a CUDA graph' in str(info.value.__notes__)
    assert calls == [1] and sharding.collective.launches == before


def test_collectives_are_taken_back_and_added_per_replay(monkeypatch):
    """The collectives a capture counts are taken back and each replay
    adds them, beside the kernel counters."""
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _FakeCUDAGraph)
    before = sharding.collective.launches

    def step():
        for _ in range(3):
            sharding.collective(lambda: None)
    graph = _cache()._capture(step, [], (), 'graph replay step')
    assert sharding.collective.launches == before
    assert graph.fns[-1] is sharding.collective and graph.launches[-1] == 3
    for _ in range(2):
        graph.replay()
    assert sharding.collective.launches == before + 6


def test_graph_captures_count_one_per_capture(monkeypatch):
    """profiling.COUNTERS['graph captures'] counts each capture beside the
    cache's own count, and a replay, a span carrying its request, counts
    none."""
    monkeypatch.setattr(torch.cuda, 'CUDAGraph', _FakeCUDAGraph)
    before = profiling.COUNTERS['graph captures']
    cache = _cache()
    graph = cache._capture(lambda: None, [], (), 'graph replay step')
    cache._capture(lambda: None, [], (), 'graph replay predict_proba')
    assert profiling.COUNTERS['graph captures'] == before + 2
    assert cache.captures == 2
    with profiling.recording() as rec:
        for step in range(3):
            graph.replay(request=step)
    assert profiling.COUNTERS['graph captures'] == before + 2
    assert [(s.name, s.request) for s in rec.spans] == [
        ('graph replay step', 0), ('graph replay step', 1),
        ('graph replay step', 2)]


def test_gather_rows_is_one_flat_all_gather(monkeypatch):
    """gather_rows and the model axis' gather make one
    all_gather_into_tensor each, into a flat buffer, joined in rank order
    along their axis (the other rank's block stands in for a second
    rank)."""
    calls = []

    def all_gather(out, x, group=None):
        calls.append(group)
        out.copy_(torch.cat([x, x + 100]))
    monkeypatch.setattr(dist, 'all_gather_into_tensor', all_gather)
    mesh = mesh_lib.Mesh(2, 2, 0, 4, 'data group', 'model group')
    x = torch.arange(12.).reshape(2, 3, 2)
    with sharding.mesh_context(mesh):
        rows = sharding.gather_rows(x)
        cols = sharding.gather_out(x, 1)
    assert torch.equal(rows, torch.cat([x, x + 100]))
    assert torch.equal(cols, torch.cat([x, x + 100], 1))
    assert calls == ['data group', 'model group']


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp('graph_ranks')
    run_processes(worker.graph_worker, 2, (2, free_port(), str(out_dir)),
                  timeout=120)
    return [torch.load(out_dir / f'rank{r}.pt', weights_only=False)
            for r in range(2)]


@pytest.mark.parametrize('spec', ['data=2', 'model=2'])
def test_captured_functions_read_nothing_on_the_host(ranks, spec):
    """Under each mesh, on both ranks: every function the graphed chunk
    (Adam, NatGrad with its final check), eval, count and Predictor would
    capture runs its collectives with no host read, each key holds the
    mesh, and the answers and states equal the eager sharded ones bit
    for bit."""
    shape = {'data=2': (2, 1), 'model=2': (1, 2)}[spec]
    for rank, out in enumerate(ranks):
        res = out[spec]
        assert res['graphed reads'] == [], res['graphed reads']
        assert res['keys'] >= 8 and res['keys_hold_mesh']
        assert res['mesh'] == shape + (rank, 2)
        assert res['eager keys'] == []
        assert all(res['equal'].values()), res['equal']
