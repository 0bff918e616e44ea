"""Ranks of the port's multi-process tests: gloo processes on the CPU,
started by ``torch.multiprocessing`` from test_torch_parallel.py and
test_torch_parallel_cli.py.  This module imports no JAX: the tests hand
their children numpy arrays and read back what each rank wrote."""

import contextlib
import datetime
import os
import types
from unittest import mock

import numpy as np
import torch

TIMEOUT = datetime.timedelta(seconds=180)


def join_group(rank: int, world: int, port: int) -> None:
    """One thread, this rank's environment, the gloo group (a collective
    that waits longer than TIMEOUT fails instead of hanging the test)."""
    from deepcgp_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    multihost.initialize_distributed(device='cpu', timeout=TIMEOUT)


def port_model(case: dict):
    from deepcgp_tpu_torch.convert import from_jax_parameters
    return from_jax_parameters(types.SimpleNamespace(**case['flags']),
                               case['image'], case['params'], case['Z0'],
                               num_data=case['num_data'], device='cpu')


def run_case(mesh, case: dict) -> list:
    """[(ELBO, {name: parameter})] after each step of ``case``: the port's
    single-process ``train_step`` when ``mesh`` is None, else the sharded
    step on the same global batches and noise."""
    from deepcgp_tpu_torch.parallel.train import make_sharded_train_fns
    from deepcgp_tpu_torch.training import trainer
    config = trainer.TrainConfig(**case['config'])
    state = trainer.init_state(port_model(case), config)
    if mesh is None:
        def step(xb, yb, noise):
            return trainer.train_step(state, config, xb, yb, noise=noise)
    else:
        train_step_fn, _ = make_sharded_train_fns(mesh, config)

        def step(xb, yb, noise):
            return train_step_fn(state, xb, yb, noise=noise)
    out = []
    for xb, yb, noise in case['steps']:
        elbo = step(torch.as_tensor(xb), torch.as_tensor(yb),
                    [torch.as_tensor(z) for z in noise])
        out.append((float(elbo), {k: p.detach().numpy().copy()
                                  for k, p in state.params.items()}))
    return out


@contextlib.contextmanager
def fault(kind: str):
    """A collective patched out: 'data' drops the gradients' sum over the
    data group, 'replicate' the model group's sum in replicate_in's
    backward."""
    from deepcgp_tpu_torch.parallel import sharding
    if kind == 'data':
        with mock.patch.object(sharding, 'sum_over_data', list):
            yield
    else:
        with mock.patch.object(sharding._ReplicateIn, 'backward',
                               staticmethod(lambda ctx, *g: (None, *g))):
            yield


def serve(mesh, case: dict, request: dict) -> dict:
    """The served probabilities and log-densities, and the sharded
    evaluation's probabilities and correct count, of the case's model."""
    from deepcgp_tpu_torch.parallel.train import (make_sharded_accuracy_fn,
                                                  make_sharded_eval_fn)
    from deepcgp_tpu_torch.serving import Predictor
    from deepcgp_tpu_torch.training import trainer
    model = port_model(case)
    pred = Predictor(model, batch_size=8, num_samples=3, seed=5,
                     device='cpu', mesh=mesh)
    X, Y = torch.as_tensor(request['X']), torch.as_tensor(request['Y'])
    out = {'probs': pred.predict_proba(request['X']),
           'log_density': pred.log_density(request['X'], request['Y'])}
    if pred.mesh is None:
        out['eval'] = trainer.predict_probs(model, X, 3, 8, 3).numpy()
        out['count'] = int(trainer.correct_count(model, X, Y, 3, 8, 3))
    else:
        out['eval'] = make_sharded_eval_fn(pred.mesh, 8, 3)(model, X,
                                                            3).numpy()
        out['count'] = int(make_sharded_accuracy_fn(pred.mesh, 8, 3)(
            model, X, Y, 3))
    return out


def step_worker(rank, world, port, spec, cases, request, out_dir):
    """Every case's sharded trajectory on the mesh ``spec``, the two
    faults on the first case, and the served request; written to
    ``out_dir/rank<r>.pt``."""
    from deepcgp_tpu_torch.parallel import mesh as mesh_lib
    join_group(rank, world, port)
    try:
        mesh = mesh_lib.make_mesh(spec)
        out = {'mesh': (mesh.data_rank, mesh.model_rank)}
        for name, case in cases.items():
            out[name] = run_case(mesh, case)
        first = next(iter(cases))
        for kind in ('data', 'replicate'):
            with fault(kind):
                out[f'fault-{kind}'] = run_case(mesh, cases[first])
        out['serve'] = serve(spec, cases[first], request)
        torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        torch.distributed.destroy_process_group()


def _f64_loaders():
    """The CLI in float64: the builder's dtype and the loaders' arrays."""
    import functools
    from deepcgp_tpu_torch import config
    from deepcgp_tpu_torch.training import data
    config.FLOAT_TYPE = torch.float64
    for name in ('mnist_data', 'cifar_data'):
        setattr(data, name, functools.partial(getattr(data, name),
                                              dtype=np.float64))


def cli_worker(rank, world, port, runs, out_dir):
    """Each run of ``runs`` ({name: (entry, argv, chunks, resume_after)}):
    the entry point's Experiment under ``--mesh data=<world>
    --distributed`` in float64 for ``chunks`` chunks, or stopped after
    ``resume_after`` chunks and resumed by a new Experiment.  Writes each
    rank's view (its resident rows, whether it writes) to
    ``out_dir/rank<r>.pt``."""
    import importlib
    join_group(rank, world, port)
    try:
        _f64_loaders()
        out = {}
        for name, (entry, argv, chunks, resume_after) in runs.items():
            module = importlib.import_module(f'deepcgp_tpu_torch.{entry}')
            argv = argv + ['--mesh', f'data={world}', '--distributed']
            cls = module.MNIST if entry == 'mnist' else module.Cifar
            exp = cls(module.read_args(argv), device='cpu')
            view = {'rows': int(exp.X_train_dev.shape[0]),
                    'N': int(exp.X_train.shape[0]),
                    'writer': exp.log.write}
            try:
                for _ in range(resume_after or chunks):
                    exp.train_step()
            finally:
                exp.conclude()
            if resume_after:
                exp = cls(module.read_args(argv), device='cpu')
                view['resumed_at'] = exp.global_step
                try:
                    for _ in range(chunks - resume_after):
                        exp.train_step()
                finally:
                    exp.conclude()
            out[name] = view
        torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        torch.distributed.destroy_process_group()


# Host reads: a result read on the host (item(), a data-dependent shape, a
# comparison answered in Python) or a copy of a device tensor to the host.
HOST_READ_OPS = ('_local_scalar_dense', 'nonzero', 'equal', 'is_nonzero',
                 'allclose')


def host_read_mode(record: list):
    """A dispatch mode that appends to ``record`` every host read of the
    operators it sees: the HOST_READ_OPS, and every copy whose result
    lies on the CPU and one of whose tensors does not."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    reads = {getattr(torch.ops.aten, n) for n in HOST_READ_OPS}

    class HostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if func.overloadpacket in reads:
                record.append(str(func))
            elif 'copy' in func.overloadpacket.__name__:
                devices = {t.device.type for t in tree_leaves((args, kwargs))
                           if isinstance(t, torch.Tensor)}
                outs = [t for t in tree_leaves(out)
                        if isinstance(t, torch.Tensor)]
                if devices - {'cpu'} and any(t.device.type == 'cpu'
                                              for t in outs):
                    record.append(str(func))
            return out
    return HostReads()


class RecordingCache:
    """A stand-in for ``training.graphs.GraphCache`` on the CPU: ``run``
    records each key and runs the function it would capture on copies of
    the inputs, as the graph's static inputs, under ``host_read_mode``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.keys, self.reads = [], []
        self.generators, self.buffers = {}, {}
        self.captures = 0

    def generator(self, name):
        if name not in self.generators:
            self.generators[name] = torch.Generator(device=self.device)
        return self.generators[name]

    def buffer(self, name, make):
        if name not in self.buffers:
            self.buffers[name] = make()
        return self.buffers[name]

    def run(self, key, fn, inputs=(), generators=(), request=None):
        self.keys.append(key)
        with host_read_mode(self.reads):
            return fn(*[x.clone() for x in inputs])


@contextlib.contextmanager
def graphed_on_the_cpu():
    """Every cache a RecordingCache and ``graphs.use_graphs`` True unless
    asked for eager: the port's graphed paths run on the CPU, each function
    they would capture run by the stand-in.  Yields the caches made."""
    import weakref
    from deepcgp_tpu_torch.training import graphs
    made = []

    def cache(device):
        made.append(RecordingCache(device))
        return made[-1]
    with mock.patch.object(graphs, 'GraphCache', cache), \
            mock.patch.object(graphs, '_MODEL_CACHES',
                              weakref.WeakKeyDictionary()), \
            mock.patch.object(graphs, 'use_graphs',
                              lambda graphed, device, what: graphed
                              is not False):
        yield made


def graph_paths(mesh, seed: int = 0) -> dict:
    """One Adam and one NatGrad step as a chunk, the eval (probabilities
    and the correct count) of a batch and a half, and one Predictor batch
    of a small flagship-shaped model (a conv hidden layer, a ConvKernel
    last layer), run under ``mesh`` eagerly and through the graphed
    paths: their answers, state and the stand-in caches' keys and host
    reads."""
    from deepcgp_tpu_torch.models.builder import build_model
    from deepcgp_tpu_torch.parallel.train import (make_sharded_accuracy_fn,
                                                  make_sharded_eval_fn,
                                                  make_sharded_train_fns)
    from deepcgp_tpu_torch.serving import Predictor
    from deepcgp_tpu_torch.training import trainer
    rng = np.random.RandomState(seed)
    image = (12, 12, 1)
    X = rng.randn(32, *image)
    Y = rng.randint(0, 10, size=(32, 1))
    flags = types.SimpleNamespace(
        M='6,8', feature_maps='2', filter_sizes='5,3', strides='2,1',
        num_samples=2, base_kernel='rbf', last_kernel='conv', white=False,
        identity_mean=False)
    from deepcgp_tpu_torch.parallel import multihost
    Xf = torch.as_tensor(X.reshape(32, -1))
    Yt = torch.as_tensor(Y)
    Xs = torch.as_tensor(multihost.process_shard(X.reshape(32, -1)))
    Ys = torch.as_tensor(multihost.process_shard(Y))
    out = {}
    for mode in ('eager', 'graphed'):
        model = build_model(flags, image, images=X,
                            generator=torch.Generator().manual_seed(seed),
                            dtype=torch.float64, device='cpu')
        got, caches = {}, []
        with contextlib.ExitStack() as stack:
            if mode == 'graphed':
                caches = stack.enter_context(graphed_on_the_cpu())
            graphed = None if mode == 'graphed' else False
            for optimizer in ('Adam', 'NatGrad'):
                config = trainer.TrainConfig(optimizer=optimizer,
                                             batch_size=4, gamma=0.01)
                state = trainer.init_state(model, config, seed=1)
                _, chunk = make_sharded_train_fns(mesh, config)
                got[f'{optimizer} trace'] = chunk(state, Xs, Ys, 1,
                                                  graphed).clone()
                got.update({f'{optimizer} {k}': p.detach().clone()
                            for k, p in state.params.items()})
            got['probs'] = make_sharded_eval_fn(mesh, 8, 2)(
                model, Xf[:12], 3, graphed)
            got['count'] = make_sharded_accuracy_fn(mesh, 8, 2)(
                model, Xf[:12], Yt[:12], 3, graphed)
            pred = Predictor(model, batch_size=4, num_samples=2, seed=5,
                             device='cpu', mesh=mesh, graphed=graphed)
            got['served'] = torch.as_tensor(pred.predict_proba(X[:4]))
        out[mode] = got
        out[f'{mode} keys'] = [k for c in caches for k in c.keys]
        out[f'{mode} reads'] = [r for c in caches for r in c.reads]
    return out


def contains(key, part) -> bool:
    """Whether ``part`` is an element of the (nested) tuple ``key``."""
    return isinstance(key, tuple) and any(
        k is part or (type(k) is type(part) and k == part) or contains(k, part)
        for k in key)


def graph_worker(rank, world, port, out_dir):
    """``graph_paths`` under mesh data=2 and, with the group kept, model=2;
    each mesh's answers, whether every key of the graphed paths holds the
    mesh (shape, rank, groups), and the host reads, written to
    ``out_dir/rank<r>.pt``."""
    from deepcgp_tpu_torch.parallel import mesh as mesh_lib
    join_group(rank, world, port)
    try:
        out = {}
        for spec in ('data=2', 'model=2'):
            mesh = mesh_lib.make_mesh(spec)
            res = graph_paths(mesh)
            ident = (mesh.data, mesh.model, mesh.rank, mesh.world_size,
                     mesh.data_group, mesh.model_group)
            out[spec] = {
                'equal': {k: bool(torch.equal(v, res['graphed'][k]))
                          for k, v in res['eager'].items()},
                'keys': len(res['graphed keys']),
                'keys_hold_mesh': all(contains(k, ident)
                                      for k in res['graphed keys']),
                'mesh': ident[:4],
                'graphed reads': res['graphed reads'],
                'eager keys': res['eager keys']}
        torch.save(out, os.path.join(out_dir, f'rank{rank}.pt'))
    finally:
        torch.distributed.destroy_process_group()
