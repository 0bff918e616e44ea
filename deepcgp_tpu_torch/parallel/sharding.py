"""The partition of a step over the mesh, made explicit (counterpart of
``deepcgp_tpu/parallel/sharding.py``).

The JAX package pins its intermediates with sharding constraints and lets
GSPMD insert the collectives.  Here the layers call the helpers below
under an active mesh (:func:`mesh_context`); without one every helper is
the identity and issues no collective, so single-process code is
untouched.

* Data axis: :func:`normal` draws the whole global batch's noise from the
  replicated generator and keeps this rank's rows, :func:`own_rows` takes
  them from a global tensor, :func:`split_rows` pads an evaluation batch
  to the data size (and :func:`true_rows` draws only for its true rows),
  and :func:`sum_over_data` sums the loss and the gradients over the data
  group after backward.
* Model axis, Megatron-style: a replicated tensor enters a model-sharded
  region through :func:`replicate_in` (the identity forward, an
  all-reduce over the model group backward), and the region's output
  leaves through :func:`gather_out` (an all-gather along the sharded axis
  forward, this rank's slice of the gradient backward) or
  :func:`reduce_out` (a sum over the model group forward, the identity
  backward).  Everything after the exit runs identically on every model
  rank, so each parameter's gradient is whole on every rank and needs
  only the data-axis sum.  :func:`model_block` gives this rank's block of
  the sharded axis, or None when the axis does not divide the model group
  -- then the region runs whole on every rank, with a one-time warning
  naming the shape (the counterpart of leaving GSPMD to infer).

Every collective goes through :func:`collective`, which counts it in
``collective.launches`` as the kernel wrappers count their launches (a
captured graph's count is taken back and added per replay,
``training.graphs``).  None of them reads a result on the host, and each
writes into a buffer made on the current stream, so that a step with its
collectives can be captured into a CUDA graph under NCCL.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
import warnings

import torch
import torch.distributed as dist

from deepcgp_tpu_torch.parallel import multihost

_ACTIVE_MESH = contextvars.ContextVar('deepcgp_torch_active_mesh',
                                      default=None)
_TRUE_ROWS = contextvars.ContextVar('deepcgp_torch_true_rows', default=None)
_WARNED: set = set()   # one warning per (what, shape, model size)


@contextlib.contextmanager
def mesh_context(mesh):
    """``mesh`` active inside the block (None: no mesh, every helper the
    identity)."""
    token = _ACTIVE_MESH.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE_MESH.reset(token)


def active_mesh():
    return _ACTIVE_MESH.get()


def data_size() -> int:
    """The data axis' size under the active mesh, else 1."""
    mesh = active_mesh()
    return 1 if mesh is None else mesh.data


collective = multihost.collective


def _all_reduce_many(tensors, group, op=dist.ReduceOp.SUM) -> list:
    """All-reduce a list of tensors as one flat buffer per dtype (one
    collective each); returns new tensors of the same shapes."""
    out = list(tensors)
    by_dtype: dict = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idxs in by_dtype.values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idxs])
        collective(dist.all_reduce, flat, op=op, group=group)
        pos = 0
        for i in idxs:
            n = tensors[i].numel()
            out[i] = flat[pos:pos + n].view_as(tensors[i])
            pos += n
    return out


# -- the data axis --------------------------------------------------------------

def own_rows(t: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """This data rank's rows (along ``dim``) of a global-batch tensor."""
    mesh = active_mesh()
    if mesh is None or mesh.data == 1:
        return t
    return t[(slice(None),) * dim + (mesh.rows(t.shape[dim]),)]


def normal(shape, generator, *, dtype, device, dim: int = 0):
    """Standard normals of the local ``shape`` whose ``dim`` holds this
    rank's rows: the whole global batch's draw (``shape[dim]`` times the
    data size) from the replicated generator, then this rank's rows, so
    the sharded step sees the single-process noise.  Inside
    :func:`true_rows` only the batch's true rows are drawn and the padding
    rows get zeros."""
    shape = list(shape)
    padded = shape[dim] * data_size()
    shape[dim] = _TRUE_ROWS.get() or padded
    z = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    if shape[dim] < padded:
        shape[dim] = padded - shape[dim]
        z = torch.cat([z, z.new_zeros(shape)], dim)
    return own_rows(z, dim)


@contextlib.contextmanager
def true_rows(rows: int):
    """Draws inside the block are made for a padded batch's ``rows`` true
    rows (see :func:`split_rows`), so that they are the draws of the
    unpadded batch in one process."""
    token = _TRUE_ROWS.set(rows)
    try:
        yield
    finally:
        _TRUE_ROWS.reset(token)


def split_rows(X: torch.Tensor, Y: torch.Tensor):
    """An evaluation batch's rows for this data rank, after padding the
    batch to a multiple of the data size (``multihost.pad_rows``)."""
    X, Y = multihost.pad_rows(X, Y, data_size())
    return own_rows(X), own_rows(Y)


def sum_over_data(tensors: list) -> list:
    """The sum of each tensor over the data group (the loss and the
    gradients after backward): one all-reduce per dtype, run whenever the
    mesh spans processes."""
    mesh = active_mesh()
    if mesh is None or not mesh.distributed:
        return list(tensors)
    return _all_reduce_many(tensors, mesh.data_group)


def _all_gather(x: torch.Tensor, dim: int, group, size: int) -> torch.Tensor:
    """The blocks ``x`` of the ``size`` ranks of ``group`` joined along
    ``dim`` in rank order: one ``all_gather_into_tensor`` into a flat
    buffer."""
    x = x.contiguous()
    out = x.new_empty((size * x.shape[0],) + x.shape[1:])
    collective(dist.all_gather_into_tensor, out, x, group=group)
    if dim == 0:
        return out
    return out.reshape(size, *x.shape).movedim(0, dim).reshape(
        *x.shape[:dim], size * x.shape[dim], *x.shape[dim + 1:])


def gather_rows(t: torch.Tensor) -> torch.Tensor:
    """The global batch's rows of a per-rank result (``t`` [n, ...], this
    data rank's rows), on every rank; no gradient."""
    mesh = active_mesh()
    if mesh is None or mesh.data == 1:
        return t
    return _all_gather(t, 0, mesh.data_group, mesh.data)


def all_ok(ok: torch.Tensor) -> torch.Tensor:
    """``ok`` (a device bool) true on every rank of the world: an
    all-reduce with MIN, so that no rank commits a step alone."""
    mesh = active_mesh()
    if mesh is None or not mesh.distributed:
        return ok
    flag = ok.to(torch.int32).reshape(1)
    collective(dist.all_reduce, flag, op=dist.ReduceOp.MIN)
    return flag[0].bool()


@torch.no_grad()
def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers into every rank's copy of
    ``module``, in place (a no-op without a process group)."""
    if not multihost.initialised():
        return
    by_dtype: dict = {}
    for t in list(module.parameters()) + list(module.buffers()):
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        collective(dist.broadcast, flat, src=src)
        pos = 0
        for t in ts:
            t.copy_(flat[pos:pos + t.numel()].view_as(t))
            pos += t.numel()


# -- the model axis -------------------------------------------------------------

def model_block(size: int, what: str, shape) -> slice | None:
    """This model rank's block of an axis of ``size`` (``what``, of an
    array of ``shape``), or None: no active model axis, or ``size`` does
    not divide it (then the region runs whole on every rank; warned once
    per shape)."""
    mesh = active_mesh()
    if mesh is None or mesh.model == 1:
        return None
    if size % mesh.model:
        sig = (what, tuple(shape), mesh.model)
        if sig not in _WARNED:
            _WARNED.add(sig)
            warnings.warn(
                f'deepcgp_tpu_torch sharding of {what} dropped for an array '
                f'of shape {tuple(shape)}: its size {size} does not divide '
                f"mesh axis 'model' (size {mesh.model}); the region runs "
                'whole on every model rank', stacklevel=2)
        return None
    per = size // mesh.model
    return slice(mesh.model_rank * per, (mesh.model_rank + 1) * per)


class _ReplicateIn(torch.autograd.Function):
    """Identity forward; backward, the gradients of the inputs that need
    one, summed over the model group in one collective."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.shapes = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        need = [i for i in range(len(grads)) if ctx.needs_input_grad[i + 1]]
        full = [grads[i] if grads[i] is not None else
                torch.zeros(ctx.shapes[i][0], dtype=ctx.shapes[i][1],
                            device=ctx.shapes[i][2]) for i in need]
        out = [None] * len(grads)
        for i, g in zip(need, _all_reduce_many(full, ctx.group)):
            out[i] = g
        return (None, *out)


def replicate_in(*tensors):
    """The replicated ``tensors`` (None entries pass) as a model-sharded
    region reads them: see the module docstring.  The identity without an
    active model axis.  Returns a tuple, or the one tensor."""
    mesh = active_mesh()
    if mesh is None or mesh.model == 1:
        out = tensors
    else:
        idx = [i for i, t in enumerate(tensors) if t is not None]
        got = _ReplicateIn.apply(mesh.model_group, *(tensors[i] for i in idx))
        out = list(tensors)
        for i, t in zip(idx, got):
            out[i] = t
    return tuple(out) if len(out) > 1 else out[0]


def replicate_module(module: torch.nn.Module) -> torch.nn.Module:
    """A shallow copy of ``module`` (a base kernel) whose parameters read
    through :func:`replicate_in`, so that a region may evaluate it."""
    mesh = active_mesh()
    if mesh is None or mesh.model == 1:
        return module
    names = list(module._parameters)
    values = replicate_in(*(module._parameters[n] for n in names))
    values = values if isinstance(values, tuple) else (values,)
    clone = copy.copy(module)
    clone.__dict__['_parameters'] = dict(zip(names, values))
    return clone


class _GatherOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.rank, ctx.n = dim, rank, x.shape[dim]
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n).contiguous(),
                None, None, None, None)


def gather_out(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A region's per-rank block ``x`` joined along ``dim`` over the model
    group (see the module docstring)."""
    mesh = active_mesh()
    if mesh is None or mesh.model == 1:
        return x
    return _GatherOut.apply(x, dim, mesh.model_group, mesh.model,
                            mesh.model_rank)


class _ReduceOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        y = x.clone()
        collective(dist.all_reduce, y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_out(x: torch.Tensor) -> torch.Tensor:
    """A region's per-rank partial sum ``x`` summed over the model group
    (see the module docstring)."""
    mesh = active_mesh()
    if mesh is None or mesh.model == 1:
        return x
    return _ReduceOut.apply(x, mesh.model_group)
