"""Experiment lifecycle (counterpart of ``deepcgp_tpu/training/experiment.py``).

Template-method lifecycle: load data -> build model -> optimizer -> loggers
(`conv_gp/experiment.py:14-20`); ``train_step()`` runs one ``test_every``-
iteration chunk (``trainer.run_chunk``, no host sync inside), then logs and
snapshots parameters (`conv_gp/experiment.py:28-31,56-64`).

The training set moves to the device once; each chunk syncs once, for
its mean ELBO, and each evaluation once, for its count.  On the card,
without a mesh or under ``--mesh`` / ``--distributed`` over NCCL, the
chunk and the eval run as replayed CUDA graphs
(``trainer.run_chunk``'s and ``trainer.accuracy``'s default): the chunk's
graphs live on the TrainState, so the NatGrad warm start's new state and
a resumed run capture afresh, and the eval's on the model.  The run writes
its files (the TensorBoard events too, under ``<tensorboard_dir>/<name>``,
unless ``--no-tensorboard``).

Across processes (``parallel``): ``--distributed`` joins the process
group from the environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``, ``LOCAL_RANK``, as ``torchrun`` sets them) and
``--mesh data=4,model=2`` lays the ranks out (without ``--mesh``, every
rank goes to 'data'; ``--mesh`` alone in one process is the one-rank
mesh).  Every rank builds the model from the whole data set, and rank 0's
parameters are broadcast; each rank keeps only its
``multihost.process_shard`` of the training set resident, the chunk and
the evaluation run under the mesh -- on the card over NCCL as replayed
graphs with their collectives captured (the default, as without a mesh),
over gloo eagerly -- and rank 0 alone writes the run's
files (every rank waits at a barrier after a write, and every rank reads
on resume).  The TensorBoard log, on rank 0, evaluates its tasks outside
the mesh, on rank 0's shard of the training set.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from deepcgp_tpu_torch import config as port_config
from deepcgp_tpu_torch.models.builder import build_model, parse_ints
from deepcgp_tpu_torch.parallel import mesh as mesh_lib
from deepcgp_tpu_torch.parallel import multihost, sharding
from deepcgp_tpu_torch.training import trainer
from deepcgp_tpu_torch.training.arguments import train_steps
from deepcgp_tpu_torch.training.optim import learning_rate_schedule
from deepcgp_tpu_torch.training.trainer import TrainConfig
from deepcgp_tpu_torch.utils import checkpoint as ckpt
from deepcgp_tpu_torch.utils.log import (AccuracyLogger, GlobalStepLogger,
                                         LearningRateLogger, Log,
                                         TrainELBOLogger)
from deepcgp_tpu_torch.utils.profiling import StepsPerSecLogger
from deepcgp_tpu_torch.utils.tensorboard import make_default_log


def eval_seed(seed: int, global_step: int) -> int:
    """Generator seed for a test-set evaluation at ``global_step``:
    deterministic given (seed, step), different across steps (the
    counterpart of the JAX package's ``eval_key``)."""
    return ((seed + 2) << 32) + global_step


class Experiment:
    def __init__(self, flags, device=None):
        self.flags = flags
        self.last_mean_elbo = float('nan')
        self.mesh = None
        distributed = getattr(flags, 'distributed', False)
        if distributed:
            self.device = multihost.initialize_distributed(device=device)
        else:
            self.device = port_config.default_device(device)
        if getattr(flags, 'mesh', '') or distributed:
            self.mesh = mesh_lib.make_mesh(getattr(flags, 'mesh', ''))
        self._load_data()
        self._setup_model()
        self._setup_optimizer()
        self._setup_logger()

    # -- subclass hooks -------------------------------------------------------
    def _load_data(self):
        raise NotImplementedError

    # -- lifecycle ------------------------------------------------------------
    def conclude(self):
        self.log.close()
        if self.tensorboard_log is not None:
            self.tensorboard_log.close()

    def train_step(self):
        self._optimize()
        self._log_step()
        self._save_model_parameters()

    def run(self):
        # A resumed run (--full-state-ckpt or --load-model) executes only
        # the remainder of the flags' schedule, not the full count again.
        done = self.global_step // self.flags.test_every
        try:
            for _ in range(max(0, train_steps(self.flags) - done)):
                self.train_step()
        finally:
            self.conclude()

    # -- internals -------------------------------------------------------------
    @property
    def _is_writer(self) -> bool:
        """Rank 0 alone writes the run's files."""
        return self.mesh is None or self.mesh.rank == 0

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.distributed:
            torch.distributed.barrier()

    def _run_chunk(self, state, config, num_steps):
        with sharding.mesh_context(self.mesh):
            return trainer.run_chunk(state, config, self.X_train_dev,
                                     self.Y_train_dev, num_steps)

    def _optimize(self):
        elbos = self._run_chunk(self.state, self.config, self.flags.test_every)
        self.last_mean_elbo = float(elbos.mean()) / self.flags.batch_size

    def _log_step(self):
        entry = self.log.write_entry(self)
        if self.tensorboard_log is not None:
            self.tensorboard_log.write_entry(self)
        print(entry, flush=True)

    def _model_path(self, model_name=None):
        if model_name is None:
            model_name = self.flags.name
        return os.path.join(self.flags.log_dir, model_name + '.npy')

    def _save_model_parameters(self):
        if self._is_writer:
            ckpt.save_model(self._model_path(), self.model, self.global_step)
            if getattr(self.flags, 'full_state_ckpt', False):
                ckpt.save_train_state(self._state_dir(), self.state)
        self._barrier()

    def _state_dir(self) -> str:
        return os.path.join(self.flags.log_dir, self.flags.name + '_state')

    def _setup_model(self):
        loaded, initial_step = None, 0
        if self.flags.load_model is not None:
            initial_step, loaded = ckpt.load_layer_parameters(
                self._model_path(self.flags.load_model),
                len(parse_ints(str(self.flags.M))))
        generator = torch.Generator(device=self.device)
        generator.manual_seed(self.flags.seed)
        self.model = build_model(self.flags, self.X_train.shape[1:], loaded,
                                 images=self.X_train, generator=generator,
                                 num_data=self.X_train.shape[0],
                                 device=self.device)
        if self.mesh is not None:
            sharding.broadcast_module(self.model)
        self.initial_step = initial_step

    def _train_config(self, optimizer: str) -> TrainConfig:
        return TrainConfig(
            optimizer=optimizer, lr=self.flags.lr,
            lr_decay_steps=self.flags.lr_decay_steps,
            gamma=self.flags.gamma, batch_size=self.flags.batch_size,
            lr_staircase=not getattr(self.flags, 'lr_decay_continuous',
                                     False))

    def _setup_optimizer(self):
        if self.flags.optimizer not in ('Adam', 'NatGrad', 'SGD'):
            raise ValueError("Not a supported optimizer. Try Adam or NatGrad.")
        self.config = self._train_config(self.flags.optimizer)
        self.state = trainer.init_state(self.model, self.config,
                                        seed=self.flags.seed + 1,
                                        global_step=self.initial_step)
        # Preemption resume: restore the full state (incl. optimizer
        # moments and the generator, unlike the reference's .npy path).
        if getattr(self.flags, 'full_state_ckpt', False) and \
                ckpt.latest_train_state_step(self._state_dir()) is not None:
            ckpt.restore_train_state(self._state_dir(), self.state)
            print(f"resumed full train state at step {self.global_step}",
                  flush=True)
        # The training set, flattened, and the test set resident on the
        # device for the whole run; under a mesh, this process's row shard
        # of the training set (the model above was built from all of it).
        N = self.X_train.shape[0]
        X_flat, Y_train = self.X_train.reshape(N, -1), self.Y_train
        if self.mesh is not None:
            X_flat = multihost.process_shard(X_flat)
            Y_train = multihost.process_shard(np.asarray(Y_train))
        self.X_train_dev = torch.as_tensor(X_flat, device=self.device)
        self.Y_train_dev = torch.as_tensor(Y_train, device=self.device)
        self.X_test_dev = torch.as_tensor(
            self.X_test.reshape(self.X_test.shape[0], -1), device=self.device)
        self.Y_test_dev = torch.as_tensor(
            np.asarray(self.Y_test).reshape(-1, 1), device=self.device)
        # --natgrad-warm-steps: a fresh NatGrad run (step 0 -- resumes and
        # --load-model restarts skip this) first trains the model with Adam
        # for a short phase, then restarts the NatGrad state from it.
        warm = int(getattr(self.flags, 'natgrad_warm_steps', 0) or 0)
        if (self.flags.optimizer == 'NatGrad' and warm > 0
                and self.global_step == 0):
            self._natgrad_warm_start(warm)

    def _natgrad_warm_start(self, warm_steps: int):
        """Adam warm start for NatGrad (`--natgrad-warm-steps`).

        From a fresh model's 1e-5-scaled q_sqrt init, NatGrad sits at
        chance-level accuracy under a small gamma0 and overshoots into
        Cholesky-failure backoff under a large one; a short Adam phase on
        a state of its own places the variational state in the basin, and
        NatGrad's state is then built afresh on the same (trained) model,
        so every parameter is in it."""
        cfg = self._train_config('Adam')
        st = trainer.init_state(self.model, cfg, seed=self.flags.seed + 1)
        self._run_chunk(st, cfg, warm_steps)
        self.state = trainer.init_state(self.model, self.config,
                                        seed=self.flags.seed + 1,
                                        global_step=self.initial_step)
        print(f"natgrad warm start: {warm_steps} Adam steps", flush=True)

    def _setup_logger(self):
        loggers = [GlobalStepLogger(), LearningRateLogger(),
                   AccuracyLogger(), TrainELBOLogger(), StepsPerSecLogger()]
        self.log = Log(self.flags.log_dir, self.flags.name, loggers,
                       write=self._is_writer)
        self.log.write_flags(self.flags)
        # Preprocessing statistics for serving (Predictor applies them to
        # raw inputs).
        prep = getattr(self.flags, 'preprocessing', None)
        if prep is not None and self._is_writer:
            np.savez(os.path.join(self.log.log_dir, 'preprocessing.npz'),
                     **prep)
        self.tensorboard_log = None
        if self._is_writer and not getattr(self.flags, 'no_tensorboard',
                                           False):
            self.tensorboard_log = make_default_log(self)
        self._barrier()

    # -- logger accessors -------------------------------------------------------
    @property
    def global_step(self) -> int:
        return int(self.state.step)

    @property
    def learning_rate(self) -> float:
        schedule = learning_rate_schedule(self.flags.lr,
                                          self.flags.lr_decay_steps,
                                          staircase=self.config.lr_staircase)
        # In float32, as the JAX package evaluates it.
        return float(schedule(torch.tensor(self.global_step), torch.float32))

    def test_accuracy(self) -> float:
        # Fresh-but-reproducible MC noise per evaluation, from a generator
        # of its own: the training generator is not drawn from.  Under a
        # mesh each batch's rows split over the data ranks and the count
        # is summed.
        with sharding.mesh_context(self.mesh):
            return trainer.accuracy(
                self.model, self.X_test_dev, self.Y_test_dev,
                seed=eval_seed(self.flags.seed, self.global_step),
                batch_size=32, num_samples=5)
