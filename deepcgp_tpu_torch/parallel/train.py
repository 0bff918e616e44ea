"""Multi-process training and evaluation functions (counterpart of
``deepcgp_tpu/parallel/train.py``).

Each function runs the single-process code under the mesh
(``parallel.sharding.mesh_context``): the batch's rows over the data
ranks, a conv layer's patches and the last layer's GPs over the model
ranks, the update replicated.  Every rank calls it with the same
arguments.  On the card under a mesh of NCCL groups the chunk, the eval
and the count run as replayed CUDA graphs with their collectives
captured inside (``training.graphs``), as the JAX package jits its
sharded programs; under gloo, whose collectives run on the host, they
run eagerly.  ``graphed`` (None, False, True) chooses as
``graphs.use_graphs`` does.
"""

from __future__ import annotations

import copy
import os
import socket
import tempfile
import time

import numpy as np
import torch

from deepcgp_tpu_torch.parallel import mesh as mesh_lib
from deepcgp_tpu_torch.parallel.sharding import broadcast_module, mesh_context
from deepcgp_tpu_torch.training import trainer


def make_sharded_train_fns(mesh, config):
    """(train_step_fn, run_chunk_fn) under ``mesh``.

    ``train_step_fn(state, xb, yb, noise=None)``: one optimizer step on
    the global batch (xb [B, D], yb [B, 1], the same on every rank; each
    rank steps on its rows); ``noise`` is the global batch's draws.
    Returns the ELBO of the global batch.
    ``run_chunk_fn(state, X, Y, num_steps, graphed=None)``:
    ``trainer.run_chunk`` under the mesh, X and Y this process's
    ``multihost.process_shard`` of the resident set."""

    def train_step_fn(state, xb, yb, noise=None):
        with mesh_context(mesh):
            xl, yl = mesh_lib.shard_batch(mesh, xb, yb)
            return trainer.train_step(state, config, xl, yl, noise=noise)

    def run_chunk_fn(state, X, Y, num_steps, graphed=None):
        with mesh_context(mesh):
            return trainer.run_chunk(state, config, X, Y, num_steps,
                                     graphed)

    return train_step_fn, run_chunk_fn


def make_sharded_eval_fn(mesh, batch_size: int = 32, num_samples: int = 5):
    """``eval_fn(model, X, seed, graphed=None) -> probs [N, K]`` on every
    rank: whole-set class probabilities with each batch's rows over the
    data ranks and the patches over the model ranks
    (``trainer.predict_probs`` under the mesh)."""

    def eval_fn(model, X, seed, graphed=None):
        with mesh_context(mesh):
            return trainer.predict_probs(model, X, seed, batch_size,
                                         num_samples, graphed)

    return eval_fn


def make_sharded_accuracy_fn(mesh, batch_size: int = 32,
                             num_samples: int = 5):
    """``acc_fn(model, X, Y, seed, graphed=None) -> count``: the whole-set
    count of correct predictions (a device int64, summed over the data
    group, so only the scalar crosses ranks); divide by the true row
    count."""

    def acc_fn(model, X, Y, seed, graphed=None):
        with mesh_context(mesh):
            return trainer.correct_count(model, X, Y, seed, batch_size,
                                         num_samples, graphed)

    return acc_fn


def run_processes(fn, nprocs: int, args: tuple, timeout: float) -> None:
    """``fn(rank, *args)`` in ``nprocs`` spawned processes.  Raises when one
    fails (with its traceback) or when they are not all done within
    ``timeout`` seconds; every process is stopped before this returns."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method='spawn')
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                raise TimeoutError(f'{nprocs} processes not done in '
                                   f'{timeout} s')
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
            p.join()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _dryrun_worker(rank, n, port, model_axis, dtype_name, optimizers, out):
    from deepcgp_tpu_torch.models.builder import build_model
    from deepcgp_tpu_torch.parallel import multihost
    from deepcgp_tpu_torch.training.trainer import TrainConfig
    import types

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR='127.0.0.1', MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank))
    multihost.initialize_distributed(device='cpu')
    try:
        dtype = getattr(torch, dtype_name)
        n_data = n // model_axis
        mesh = mesh_lib.make_mesh({'data': n_data, 'model': model_axis})
        rng = np.random.RandomState(0)
        # Tiny 2-layer conv GP: 12x12 images, a 16-patch hidden layer.
        flags = types.SimpleNamespace(
            M='8,8', feature_maps='2', filter_sizes='5,3', strides='2,1',
            num_samples=2, base_kernel='rbf', last_kernel='conv',
            white=False, identity_mean=False)
        B = 2 * n_data
        X = rng.randn(64, 12, 12, 1)
        Y = rng.randint(0, 10, size=(64, 1))
        xb = torch.as_tensor(X[:B].reshape(B, -1), dtype=dtype)
        yb = torch.as_tensor(Y[:B])
        rtol = 1e-6 if dtype == torch.float64 else 1e-4

        def build(f, seed):
            model = build_model(f, (12, 12, 1), images=X,
                                generator=torch.Generator().manual_seed(seed),
                                dtype=dtype, device='cpu')
            broadcast_module(model)
            return model

        def agree(tag, got, want):
            assert abs(got - want) <= rtol * max(abs(want), 1.0), (
                f'multichip dryrun ({tag}) ELBO diverges from the '
                f'replicated reference: sharded {got!r} vs {want!r}')

        model = build(flags, 0)
        elbos = {}
        for opt in optimizers:
            config = TrainConfig(optimizer=opt, lr=0.01, lr_decay_steps=1000,
                                 gamma=0.001, batch_size=B)
            ref = trainer.init_state(copy.deepcopy(model), config, seed=1)
            state = trainer.init_state(copy.deepcopy(model), config, seed=1)
            step_fn, _ = make_sharded_train_fns(mesh, config)
            for t in (1, 2):
                got = float(step_fn(state, xb, yb))
                want = float(trainer.train_step(ref, config, xb, yb))
                assert np.isfinite(got), f'{opt} step {t}: ELBO {got}'
                agree(f'{opt} step{t}', got, want)
            elbos[opt] = got
        probs = make_sharded_eval_fn(mesh, batch_size=B, num_samples=2)(
            state.model, X[:16].reshape(16, -1), 2)
        assert probs.shape == (16, 10) and torch.isfinite(probs).all()
        # The M=1024 geometry at M = 8: one SVGP layer with an ARD RBF
        # over the whole image, its R = 10 GPs over the model ranks.
        mflags = types.SimpleNamespace(**{**vars(flags), 'M': '8',
                                          'feature_maps': '',
                                          'filter_sizes': '5', 'strides': '1',
                                          'last_kernel': 'rbf'})
        mmodel = build(mflags, 3)
        mconfig = TrainConfig(optimizer='Adam', lr=0.01, lr_decay_steps=1000,
                              gamma=0.001, batch_size=B)
        ref = trainer.init_state(copy.deepcopy(mmodel), mconfig, seed=4)
        mstate = trainer.init_state(mmodel, mconfig, seed=4)
        step_fn, _ = make_sharded_train_fns(mesh, mconfig)
        melbo = float(step_fn(mstate, xb, yb))
        agree('m1024-geometry R-sharded',
              melbo, float(trainer.train_step(ref, mconfig, xb, yb)))
        if rank == 0:
            text = ', '.join(f'{k} elbo={v:.2f}' for k, v in elbos.items())
            with open(out, 'w') as f:
                f.write(f'MULTICHIP DRYRUN OK: mesh data={n_data} x '
                        f'model={model_axis}, 2 steps each of [{text}] each '
                        'matching the replicated single-process step to '
                        f'rtol {rtol:g}, sharded eval finite, m1024-geometry '
                        f'R-sharded step elbo={melbo:.2f} (also '
                        'replicated-checked)')
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, *, model_axis: int | None = None,
                     dtype=torch.float32,
                     optimizers: tuple = ('Adam', 'NatGrad')) -> str:
    """``n_devices`` gloo processes on the CPU run two sharded steps of
    each optimizer on a tiny 2-layer conv GP over a (data, model) mesh,
    and one Adam step of the M=1024 geometry with its GPs over 'model',
    each asserted against the same step replicated in one process (rtol
    1e-6 in float64, 1e-4 in float32), then a sharded eval.  A child's
    failure raises here.  Prints and returns the summary line."""
    if model_axis is None:
        model_axis = 2 if n_devices % 2 == 0 and n_devices >= 4 else 1
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, 'summary')
        run_processes(_dryrun_worker, n_devices,
                      (n_devices, free_port(), model_axis,
                       str(dtype).split('.')[-1], tuple(optimizers), out),
                      timeout=300)
        with open(out) as f:
            line = f.read()
    print(line, flush=True)
    return line
