"""Training loop (counterpart of ``deepcgp_tpu/training/trainer.py``).

``run_chunk`` runs a number of optimizer steps with no host sync: each
step draws its minibatch on the device (uniform, with replacement, from
the state's generator) and its Monte-Carlo noise from the same generator,
and the commit guard is a ``torch.where`` on a device boolean.  A step
whose loss, any gradient or the NatGrad proposal is non-finite leaves
parameters and Adam moments as they were (the reference's
Cholesky-failure retry); the failure stays visible as a NaN in the
returned ELBO trace.

On a CUDA device, with no mesh or under a mesh of NCCL groups, the chunk
and the eval run as replayed CUDA graphs (``training.graphs``), the
counterpart of the JAX package's jitted ``lax.scan`` programs (sharded
ones under a mesh): one step (index draw, gather, ``train_step``, its
collectives included) is captured once per state and replayed
``num_steps`` times, each replay writing its ELBO into a device trace at
a device-held index, so the host does one replay a step and nothing
else.  A replay reads the state's
tensors where they lie, so ``train_step`` writes every field of the state
in place and no field of a ``TrainState`` is ever reassigned.

Optimizers, as the reference wires them:

* Adam -- Adam on everything trainable; on the card with every leaf
  float32, the finiteness check, the update and its guarded commit are
  two kernel launches over all leaves (``ops/cuda_adam.py``), bit for bit
  the ``torch.where`` route the CPU keeps;
* SGD -- plain gradient descent;
* NatGrad -- a natural-gradient step on every layer's (q_mu, q_sqrt) and
  an Adam step on the rest, both from one backward pass.  A finite NatGrad
  proposal can still make the next ELBO non-finite, so each step's loss
  verifies the previous commit: ``TrainState.prev`` holds the last
  parameters whose ELBO was seen finite, a non-finite loss rolls the model
  back to them, and ``steps_back`` grows so the gamma schedule retries
  smaller.  ``run_chunk`` ends with one more ELBO that verifies the last
  commit.  The natural-gradient half and its commit are the span
  ``natgrad update`` (``utils.profiling.annotate``).

The trainable set is ``model.parameters()``: the layers' raw kernel
parameters, Z, q_mu, q_sqrt and the patch weights.  The KL anchors Z0 are
buffers, outside it by construction, as the JAX package's
``trainable_mask`` leaves them out.
"""

from __future__ import annotations

import dataclasses

import torch

from deepcgp_tpu_torch.ops import cuda_adam
from deepcgp_tpu_torch.parallel import multihost, sharding
from deepcgp_tpu_torch.training import graphs, optim
from deepcgp_tpu_torch.utils import profiling

_VARIATIONAL = ('q_mu', 'q_sqrt')


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: str = 'Adam'
    lr: float = 0.01
    lr_decay_steps: int = 100000
    gamma: float = 0.001     # NatGrad's initial step size
    batch_size: int = 32
    # True = the reference's current source; False = the continuous decay
    # its committed result artifacts were trained with.
    lr_staircase: bool = True


@dataclasses.dataclass
class TrainState:
    model: torch.nn.Module
    params: dict             # {name: parameter}, the trainable set
    opt_state: dict          # Adam (also NatGrad's): count, mu, nu; SGD: {}
    step: torch.Tensor       # global optimizer step, int64 on the device
    generator: torch.Generator
    # NatGrad only: the gamma backoff counter (in the model's dtype) and
    # the last parameters whose ELBO was seen finite, {name: tensor}.
    steps_back: torch.Tensor | None = None
    prev: dict | None = None
    # The graphs of the chunk (``graphs.GraphCache``), made at the first
    # graphed ``run_chunk``; a new state captures afresh.
    graphs: graphs.GraphCache | None = dataclasses.field(default=None,
                                                         repr=False)
    # The run_chunk calls so far, the request of each call's span.
    chunks: int = dataclasses.field(default=0, repr=False, compare=False)


def _natgrad_names(model) -> list:
    """[(q_mu name, q_sqrt name)] per layer."""
    return [(f'layers.{i}.q_mu', f'layers.{i}.q_sqrt')
            for i in range(len(model.layers))]


def init_state(model, config: TrainConfig, seed: int = 0,
               global_step: int = 0) -> TrainState:
    """Switch gradients on for the trainable set and start the optimizer.
    Minibatches and Monte-Carlo noise come from a generator on the model's
    device seeded with ``seed``.  Under NatGrad the Adam set leaves out
    every q_mu and q_sqrt (the JAX package keeps zero moments for them
    under a mask, which moves nothing)."""
    if config.optimizer not in ('Adam', 'SGD', 'NatGrad'):
        raise ValueError('Not a supported optimizer. Try Adam, SGD or NatGrad.')
    params = dict(model.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    device = next(iter(params.values())).device
    natgrad = config.optimizer == 'NatGrad'
    if config.optimizer == 'SGD':
        opt_state = {}
    else:
        adam_set = {k: p for k, p in params.items()
                    if not (natgrad and k.rsplit('.', 1)[-1] in _VARIATIONAL)}
        opt_state = optim.adam_init(adam_set, optim.bf16_leaf_order(model))
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    dtype = model.layers[0].q_mu.dtype
    return TrainState(
        model=model, params=params, opt_state=opt_state,
        step=torch.full((), global_step, dtype=torch.int64, device=device),
        generator=generator,
        steps_back=(torch.zeros((), dtype=dtype, device=device)
                    if natgrad else None),
        prev=({k: p.detach().clone() for k, p in params.items()}
              if natgrad else None))


def loss_and_grads(state: TrainState, xb, yb, noise=None):
    """(-ELBO, {name: gradient}) at the current parameters; the MC noise
    is ``noise`` (one [S, B, O_l] tensor per layer) or drawn from the
    state's generator."""
    draw = {'noise': noise} if noise is not None else {'generator': state.generator}
    with torch.enable_grad():
        loss = -state.model.elbo(xb, yb, **draw)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[k] for k in names],
                                    allow_unused=True)
    return loss.detach(), {
        k: (torch.zeros_like(state.params[k]) if g is None else g)
        for k, g in zip(names, grads)}


def train_step(state: TrainState, config: TrainConfig, xb, yb, noise=None):
    """One optimizer iteration on the batch (xb [B, D], yb [B, 1]); updates
    ``state`` in place and returns the ELBO (a device scalar).

    Under a mesh (``parallel.sharding.mesh_context``) xb and yb are this
    rank's rows of the global batch and ``noise`` the global batch's
    draws: the loss and the gradients are summed over the data group, the
    update (NatGrad's solve included) runs replicated on every rank, and
    the commit guard holds only if it holds on every rank."""
    loss, grads = loss_and_grads(state, xb, yb, noise)
    # Under a mesh: this rank's share of the loss and of the gradients,
    # summed over the data group (the identity without one).
    names = list(grads)
    loss, *summed = sharding.sum_over_data([loss] + [grads[k] for k in names])
    grads = dict(zip(names, summed))
    loss_ok = torch.isfinite(loss)
    natgrad = config.optimizer == 'NatGrad'
    pairs = _natgrad_names(state.model) if natgrad else []
    variational = {k for pair in pairs for k in pair}
    adam_grads = {k: g for k, g in grads.items() if k not in variational}
    # Adam on the card in float32: the finiteness pass and the update with
    # its commit are two launches over every leaf (ops/cuda_adam.py).
    fused = cuda_adam.route(config.optimizer, state.params.values())
    ok = loss_ok
    if fused:
        leaves = cuda_adam.leaves(state.params, adam_grads, state.opt_state)
        ok = ok & cuda_adam.all_finite(leaves)
    else:
        for g in adam_grads.values():
            ok = ok & torch.isfinite(g).all()
    if not natgrad:
        ok = sharding.all_ok(ok)
    else:
        # Both halves from the one gradient evaluation above: the natural
        # gradient's proposals, the step's guard and their commit.
        with profiling.annotate('natgrad update'), torch.no_grad():
            gamma = optim.gamma_schedule(state.step, state.steps_back,
                                         config.gamma).to(xb.dtype)
            proposals, _, ng_ok = optim.natgrad_step_with_backoff(
                [(state.params[a], state.params[b]) for a, b in pairs],
                [(grads[a], grads[b]) for a, b in pairs], gamma,
                state.steps_back)
            ok = sharding.all_ok(ok & ng_ok)
            for (a, b), proposal in zip(pairs, proposals):
                for k, new in zip((a, b), proposal):
                    optim.commit_verified(state.params[k], state.prev[k],
                                          new, ok, loss_ok)
            state.steps_back.copy_(torch.where(ok, state.steps_back,
                                               state.steps_back + 1.0))
        profiling.COUNTERS['natgrad updates'] += 1
    lr = optim.learning_rate_schedule(config.lr, config.lr_decay_steps,
                                      config.lr_staircase)(state.step,
                                                           loss.dtype)
    with torch.no_grad():
        if fused:
            count, salt0 = optim.adam_count(state.opt_state['count'])
            cuda_adam.adam_step(leaves, *optim.adam_bias(count, lr.dtype),
                                lr, salt0, ok)
            state.opt_state['count'].copy_(
                torch.where(ok, count, state.opt_state['count']))
            state.step.add_(1)
            profiling.COUNTERS['fused adam steps'] += 1
            return -loss
        if config.optimizer == 'SGD':
            updates = adam_grads
        else:
            updates, mu, nu, count = optim.adam_updates(adam_grads,
                                                        state.opt_state)
            for k in adam_grads:
                state.opt_state['mu'][k].copy_(
                    torch.where(ok, mu[k], state.opt_state['mu'][k]))
                state.opt_state['nu'][k].copy_(
                    torch.where(ok, nu[k], state.opt_state['nu'][k]))
            state.opt_state['count'].copy_(
                torch.where(ok, count, state.opt_state['count']))
        for k, u in updates.items():
            p = state.params[k]
            new = p - lr.to(p.dtype) * u
            if natgrad:
                optim.commit_verified(p, state.prev[k], new, ok, loss_ok)
            else:
                p.copy_(torch.where(ok, new, p))
        state.step.add_(1)
    return -loss


def _state_tensors(state: TrainState) -> list:
    """Every tensor of the state a step reads or writes."""
    out = graphs.module_tensors(state.model)
    if state.opt_state:
        out += [state.opt_state['count'], *state.opt_state['mu'].values(),
                *state.opt_state['nu'].values()]
    out.append(state.step)
    if state.steps_back is not None:
        out += [state.steps_back, *state.prev.values()]
    return out


# The ELBOs a step graph writes before the host copies them out.
TRACE_BLOCK = 256


def run_chunk(state: TrainState, config: TrainConfig, X_train: torch.Tensor,
              Y_train: torch.Tensor, num_steps: int,
              graphed: bool | None = None) -> torch.Tensor:
    """``num_steps`` optimizer iterations on minibatches drawn uniformly,
    with replacement, from X_train [N, D] and Y_train [N, 1] (both on the
    model's device).  Returns the ELBO trace [num_steps] on the device.
    Under NatGrad one more ELBO, on a fresh minibatch, verifies the last
    commit and rolls back to ``state.prev`` when it is non-finite.

    ``graphed`` (``graphs.use_graphs``): None runs the chunk as replayed
    CUDA graphs on a CUDA device with no active mesh or under an NCCL
    mesh, and eagerly on the CPU or under a gloo mesh (whose collectives
    are not captured); False runs it eagerly anywhere; True runs it
    graphed and raises on the CPU or under a gloo mesh.  Graphed, one step
    is captured per state (in ``state.graphs``), keyed by the config, the
    model's sample count, the active mesh (``graphs.mesh_key``) and the
    identity of X_train, Y_train and every tensor of the state; the
    first step of the first chunk runs eagerly (a real step of the chunk)
    before the capture, and every later step is a replay, which reads the
    state where it lies and draws from ``state.generator`` as the eager
    step would.  Under NatGrad the final check is a second graph.  The
    trajectory is the eager one, step for step.  A capture that fails
    raises: a shape whose library route cannot be captured runs only with
    ``graphed=False``.

    Under a mesh X_train and Y_train are this process's
    ``multihost.process_shard`` of the resident set: every rank draws the
    same global indices from the replicated generator, the batch is
    assembled from the rows each rank owns (``multihost.fetch_rows``) and
    each rank steps on its rows of it; graphed, each rank's step graph
    holds its collectives (the batch's all-reduce, the gradients' sum,
    the commit guard's MIN)."""
    sharded = sharding.active_mesh() is not None
    N = X_train.shape[0] * (multihost.world()[0] if sharded else 1)

    def batch():
        idx = torch.randint(0, N, (config.batch_size,),
                            generator=state.generator, device=X_train.device)
        if sharded:
            xb, yb = multihost.fetch_rows(X_train, Y_train, idx)
        else:
            xb, yb = X_train[idx], Y_train[idx]
        return sharding.own_rows(xb), sharding.own_rows(yb)

    @torch.no_grad()
    def final_check():
        xb, yb = batch()
        ok = sharding.all_ok(torch.isfinite(
            state.model.elbo(xb, yb, generator=state.generator)))
        for k, p in state.params.items():
            p.copy_(torch.where(ok, p, state.prev[k]))

    state.chunks += 1
    with profiling.annotate('run_chunk', request=state.chunks):
        natgrad = config.optimizer == 'NatGrad'
        if not graphs.use_graphs(graphed, X_train.device, 'run_chunk'):
            elbos = [train_step(state, config, *batch())
                     for _ in range(num_steps)]
            if natgrad:
                final_check()
            return torch.stack(elbos)

        if state.graphs is None:
            state.graphs = graphs.GraphCache(X_train.device)
        cache = state.graphs
        device = X_train.device
        trace = cache.buffer('trace', lambda: torch.empty(
            TRACE_BLOCK, dtype=state.model.layers[0].q_mu.dtype,
            device=device))
        pos = cache.buffer('pos', lambda: torch.zeros(1, dtype=torch.int64,
                                                      device=device))

        def step():
            elbo = train_step(state, config, *batch())
            trace.index_copy_(0, pos, elbo.reshape(1).to(trace.dtype))
            pos.add_(1)

        key = (config, state.model.num_samples, id(state.generator),
               graphs.mesh_key(),
               graphs.tensor_key([X_train, Y_train, trace, pos,
                                  *_state_tensors(state)]))
        gens = (state.generator,)
        out = []
        for start in range(0, num_steps, TRACE_BLOCK):
            n = min(TRACE_BLOCK, num_steps - start)
            pos.zero_()
            for i in range(n):
                cache.run(('step', key), step, generators=gens,
                          request=start + i)
            out.append(trace[:n].clone())
        if natgrad:
            cache.run(('final check', key), final_check, generators=gens)
        return torch.cat(out)


def _eval_batches(model, X_test, Y_test, seed, batch_size, num_samples,
                  graphed, kind, finish):
    """``finish(probs, yb)`` and the batch's true row count, per batch of
    ``batch_size`` test rows: ``probs`` [n, K] are the mean class
    probabilities of this rank's rows, ``yb`` [n, 1] their labels, the MC
    draws from one generator seeded with ``seed`` and drawn across the
    batches.  Under a data axis each batch is padded to a multiple of the
    data size (sentinel labels -1) and each rank evaluates its rows of it,
    with the draws of the batch's true rows (``sharding.true_rows``), so
    that they are the single-process ones.

    Graphed (``graphs.use_graphs``: by default on a CUDA device with no
    active mesh or under an NCCL mesh), each batch shape -- the full
    batch, and the last partial one if there is one -- is one graph of
    ``predict_y``, its mean over the draws and ``finish`` (its collectives
    included) in the model's graph cache (``graphs.model_cache``), keyed
    by ``kind``, the shape, the true rows and the active mesh: a batch is
    copied into the graph's static inputs and the graph replayed, the
    first batch of a shape run eagerly before its capture.  Both graphs
    draw from one generator of the cache, seeded with ``seed`` before the
    first batch, so the draws are the eager ones.  What ``finish``
    returned is then the graph's static output, valid until the next
    batch."""
    device = model.layers[0].Z.device
    dtype = model.layers[0].Z.dtype
    X = torch.as_tensor(X_test, device=device)
    X = X.reshape(X.shape[0], -1).to(dtype)
    Y = torch.as_tensor(Y_test, device=device).reshape(-1, 1)
    if graphs.use_graphs(graphed, device, 'the eval'):
        cache = graphs.model_cache(model)
        g = cache.generator('eval')
        ident = graphs.tensor_key(graphs.module_tensors(model))
    else:
        cache, g = None, torch.Generator(device=device)
    g.manual_seed(seed)

    def batch(xb, yb, rows):
        with sharding.true_rows(rows):
            probs, _ = model.predict_y(xb, num_samples, generator=g)
        return finish(probs.mean(0), yb)

    for start in range(0, X.shape[0], batch_size):
        rows = min(batch_size, X.shape[0] - start)
        xb, yb = sharding.split_rows(X[start:start + batch_size],
                                     Y[start:start + batch_size])
        if cache is None:
            yield batch(xb, yb, rows), rows
            continue
        key = (kind, tuple(xb.shape), rows, num_samples, graphs.mesh_key(),
               ident)
        yield cache.run(key, lambda x, y: batch(x, y, rows), (xb, yb),
                        (g,)), rows


def _sum_counts(model, count, graphed):
    """``count`` summed over the data group: one graph of the all-reduce
    where the eval runs graphed under a mesh that spans processes, else
    ``sharding.sum_over_data``."""
    mesh = sharding.active_mesh()
    if (mesh is None or not mesh.distributed
            or not graphs.use_graphs(graphed, count.device, 'the eval')):
        return sharding.sum_over_data([count])[0]
    return graphs.model_cache(model).run(
        ('eval sum', graphs.mesh_key()),
        lambda c: sharding.sum_over_data([c])[0], (count,)).clone()


@torch.no_grad()
def correct_count(model, X_test, Y_test, seed: int = 0, batch_size: int = 32,
                  num_samples: int = 5, graphed: bool | None = None
                  ) -> torch.Tensor:
    """The number of test rows whose argmax class is their label, a device
    int64 (see :func:`accuracy`); under a data axis each rank counts its
    rows and the count is summed over the data group."""
    correct = torch.zeros((), dtype=torch.int64,
                          device=model.layers[0].Z.device)
    for count, _ in _eval_batches(
            model, X_test, Y_test, seed, batch_size, num_samples, graphed,
            'eval count', lambda probs, yb: (probs.argmax(1)[:, None]
                                             == yb).sum()):
        correct += count
    return _sum_counts(model, correct, graphed)


@torch.no_grad()
def predict_probs(model, X_test, seed: int = 0, batch_size: int = 32,
                  num_samples: int = 5, graphed: bool | None = None
                  ) -> torch.Tensor:
    """[N, K] mean class probabilities of every test row, batched and
    drawn as :func:`accuracy` does; under a data axis the rows are
    gathered, so every rank returns all of them."""
    labels = torch.zeros((X_test.shape[0], 1), dtype=torch.int64)
    return torch.cat([probs[:rows].clone() for probs, rows in _eval_batches(
        model, X_test, labels, seed, batch_size, num_samples, graphed,
        'eval', lambda probs, _: sharding.gather_rows(probs))])


@torch.no_grad()
def accuracy(model, X_test, Y_test, seed: int = 0, batch_size: int = 32,
             num_samples: int = 5, graphed: bool | None = None) -> float:
    """Test accuracy: per batch of ``batch_size``, the mean class
    probability over ``num_samples`` MC draws, argmax, fraction correct.
    ``X_test`` [N, ...] and ``Y_test`` [N(, 1)] are arrays or tensors; a
    tensor already on the model's device is used where it lies.  One host
    sync, for the count.  ``graphed`` as in :func:`_eval_batches`: by
    default replayed graphs on a CUDA device with no active mesh or under
    an NCCL mesh, eager on the CPU or under a gloo mesh."""
    correct = correct_count(model, X_test, Y_test, seed, batch_size,
                            num_samples, graphed)
    return float(correct) / torch.as_tensor(Y_test).numel()
