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
