"""Process-group setup and the multi-process input path (counterpart of
``deepcgp_tpu/parallel/multihost.py``).

Each process loads the whole data set (model construction, with its
k-means inducing points, must be the same on every rank) but keeps only
its contiguous row shard resident on its device (:func:`process_shard`).
A step's global batch is drawn by index from the replicated generator;
:func:`fetch_rows` assembles it on every rank from the rows each rank
owns (the counterpart of ``host_local_to_global``).  Evaluation sets are
padded with :func:`pad_rows` so that every row counts.

In one process (no process group) all of it degenerates to the identity.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from deepcgp_tpu_torch import config


def initialised() -> bool:
    return dist.is_available() and dist.is_initialized()


def collective(fn, *args, **kwargs):
    """``fn`` (a ``torch.distributed`` collective) on its arguments,
    synchronous on the current stream, counted in ``collective.launches``
    (``parallel.sharding.collective``)."""
    collective.launches += 1
    return fn(*args, **kwargs)


collective.launches = 0


def world() -> tuple:
    """(world size, rank): (1, 0) without a process group."""
    if initialised():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def initialize_distributed(*, backend: str | None = None, device=None,
                           **kw) -> torch.device:
    """``init_process_group`` from the environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, as ``torchrun`` sets
    them, and ``LOCAL_RANK``); returns this rank's device.

    The device is ``cuda:{LOCAL_RANK % device_count}`` unless ``device``
    asks for another (the CPU, as the tests do).  The backend is NCCL for
    a CUDA device and gloo for the CPU; ``backend`` overrides it (gloo
    also takes CUDA tensors, which lets several processes share one card).
    ``kw`` goes to ``init_process_group``.  A process group that is
    already initialised is kept; any other failure propagates, since a
    rank that went on alone would train a model of its own on its shard."""
    if device is None:
        default = config.default_device()
        local = int(os.environ.get('LOCAL_RANK', os.environ.get('RANK', 0)))
        device = torch.device(default.type,
                              local % torch.cuda.device_count())
    device = torch.device(device)
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    try:
        dist.init_process_group(backend=backend, init_method='env://', **kw)
    except ValueError as e:
        if 'twice' not in str(e):
            raise
    return device


def process_shard(array: np.ndarray, *, axis: int = 0) -> np.ndarray:
    """This process's contiguous slice of a host-loaded array, as an EVEN
    split over the world: every rank holds the same number of rows, and
    the remainder (at most world - 1 trailing rows) is dropped -- standard
    data-parallel practice for the training set.  Pad evaluation sets
    first with :func:`pad_rows`."""
    n_proc, idx = world()
    per = array.shape[axis] // n_proc
    start = idx * per
    return array.take(np.arange(start, start + per), axis=axis)


def pad_rows(X, Y, multiple: int):
    """Pad (X, Y) along axis 0 to the next multiple of ``multiple`` with
    zero rows and sentinel labels (-1).  Class predictions (argmax over
    [0, K)) never equal -1, so padded rows add nothing to a count of
    correct predictions; callers divide by the TRUE row count.  Numpy
    arrays, or tensors padded where they lie."""
    n = X.shape[0]
    pad = (-n) % multiple
    if isinstance(X, torch.Tensor):
        if pad:
            X = torch.cat([X, X.new_zeros((pad,) + X.shape[1:])])
            Y = torch.cat([Y, Y.new_full((pad,) + Y.shape[1:], -1)])
        return X, Y
    if pad == 0:
        return np.asarray(X), np.asarray(Y)
    Xp = np.concatenate([X, np.zeros((pad,) + X.shape[1:], X.dtype)])
    Yp = np.concatenate([Y, np.full((pad,) + Y.shape[1:], -1, Y.dtype)])
    return Xp, Yp


def fetch_rows(X_local: torch.Tensor, Y_local: torch.Tensor,
               idx: torch.Tensor):
    """Rows ``idx`` [B] of the resident set of which this rank holds the
    :func:`process_shard` (X_local [n, D], Y_local [n, 1]): each rank fills
    the rows it owns and zeros elsewhere, and one all-reduce over the world
    hands every rank the whole [B, D] batch and its labels (integer labels
    ride in X's dtype, exact below 2**24).  Nothing is read on the host:
    ``trainer.run_chunk`` captures it in its step, ``idx`` drawn on the
    device from the step graph's registered generator."""
    _, rank = world()
    n = X_local.shape[0]
    lo = rank * n
    own = ((idx >= lo) & (idx < lo + n))[:, None]
    local = (idx - lo).clamp(0, n - 1)
    Y2 = Y_local.reshape(n, -1)
    buf = torch.cat([X_local[local], Y2[local].to(X_local.dtype)], dim=1)
    buf = torch.where(own, buf, torch.zeros((), dtype=buf.dtype,
                                            device=buf.device))
    if initialised():
        collective(dist.all_reduce, buf)
    D = X_local.shape[1]
    yb = buf[:, D:].round().to(Y_local.dtype)
    return buf[:, :D], yb.reshape(idx.shape[0], *Y_local.shape[1:])
