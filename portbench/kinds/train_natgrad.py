"""A NatGrad training cell: one client running the graphed ``run_chunk``
under ``optimizer='NatGrad'`` in a closed loop, whole chunks of the
traffic's ``chunk_steps`` steps, each ending in ``synchronize()``; a
natural-gradient step on every (q_mu, q_sqrt) and Adam on the rest.

Set-up makes the weights from the seed and hands them to the port's
builder as a reference-format snapshot (the un-prefixed names of a bare
RBF, ``kern/variance`` and ``kern/lengthscales`` [D], which the builder's
``rbf`` last layer reads back), builds one training state, drives it
through its first three steps by the window's own call (three 1-step
``run_chunk`` calls: eager and captured, then replayed, each chunk with
its final check) and keeps what the comparison reads, warms up one whole
chunk, and hands the same state to the window.

The comparison that decides ``correct``: the three steps against the
plain float64 reference (``portbench/reference/svgp.py``) from the same
weights, batches and noise:

* ``loss_rel``: the largest |loss - reference| / |reference| of the three;
* ``grad_gap``: over the Adam leaves, by the worst leaf, |norm(g) -
  norm(g_ref)| of the first gradient (each side's own gradient of the
  loss at the start on the first step's batch and noise, read whether or
  not the step commits) over the larger of norm(g_ref) and the median
  leaf's;
* ``natgrad_gap``: over (q_mu, q_sqrt), by the worst leaf, norm(d - d_ref)
  of the change from the start to the end of the first step the
  reference commits (a step whose proposal leaves the PD cone backs off
  and commits nothing, as the source's start does on most seeds) over
  the larger of norm(d_ref) and the median leaf's; a program that backs
  off another step than the reference reads about 1; infinite where the
  reference commits none of the steps;
* ``change_gap``: over every leaf, by the worst leaf, |norm(d) -
  norm(d_ref)| of the change after three steps, scaled alike.

Both sides' ``steps_back`` after each step is logged with the numbers.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench import compare, inputs, program, tracing, tracing_natgrad
from portbench.reference import svgp
from portbench.reference.convgp import Arith

CHECKED_STEPS = 3
CHECKS = ('loss_rel', 'grad_gap', 'natgrad_gap', 'change_gap')


def _host(d: dict) -> dict:
    return {k: v.detach().double().cpu() for k, v in d.items()}


def weights(config: dict, seed: int, device) -> dict:
    """{'Z' [M, D], 'q_mu' [M, R], 'q_sqrt' [R, M, M] float32 tensors,
    'variance' (a float), 'lengthscales' [D]}: standard normal Z,
    q_mu scaled standard normal, every lengthscale the configuration's,
    q_sqrt the prior's factor chol(Kuu + jitter I) (computed in float64)
    times ``q_sqrt_scale``, for every GP."""
    w = config['weights']
    g = inputs.generator(seed, 'weights', device)
    H, W, C = config['image_shape']
    M, R, D = config['M'][-1], config['num_classes'], H * W * C
    Z = torch.randn((M, D), generator=g, device=device)
    q_mu = w['q_mu_scale'] * torch.randn((M, R), generator=g, device=device)
    ls = torch.full((D,), float(w['lengthscale']), device=device)
    K = svgp.kuu(Arith('float64'), Z.double(),
                 torch.tensor(float(w['variance']), dtype=torch.float64,
                              device=device), ls.double())
    q_sqrt = (w['q_sqrt_scale'] * svgp.cholesky(K)).float().expand(
        R, M, M).clone()
    return {'Z': Z, 'q_mu': q_mu, 'q_sqrt': q_sqrt,
            'variance': float(w['variance']), 'lengthscales': ls}


def snapshot(w: dict) -> dict:
    """The weights as the reference-format snapshot holds a bare RBF last
    layer's: gpflow's un-prefixed kernel names."""
    def host(t):
        return t.detach().cpu().numpy()
    pre = 'DGP/layers/0/'
    return {'global_step': 0, pre + 'feature/Z': host(w['Z']),
            pre + 'q_mu': host(w['q_mu']), pre + 'q_sqrt': host(w['q_sqrt']),
            pre + 'kern/variance': np.float64(w['variance']),
            pre + 'kern/lengthscales': host(w['lengthscales']).astype(
                np.float64)}


def training_model(config: dict, w: dict, samples: int, device):
    """The model of the configuration with the weights, through the port's
    builder from the snapshot, for a training set of ``num_data`` rows."""
    from deepcgp_tpu_torch.models.builder import build_model
    from deepcgp_tpu_torch.utils.checkpoint import parse_layer_parameters
    _, loaded = parse_layer_parameters(snapshot(w), len(config['M']))
    return build_model(program.flags(config, samples),
                       tuple(config['image_shape']), loaded,
                       num_data=config['num_data'], device=device)


def training_state(model, config: dict, traffic: dict, seed: int):
    """(TrainState, TrainConfig) under NatGrad, the stream seeded with
    ``seed``."""
    from deepcgp_tpu_torch.training import trainer
    tc = trainer.TrainConfig(optimizer=traffic['optimizer'], lr=config['lr'],
                             lr_decay_steps=config['lr_decay_steps'],
                             gamma=config['gamma'],
                             lr_staircase=not config['lr_decay_continuous'],
                             batch_size=traffic['batch'])
    return trainer.init_state(model, tc, seed=seed), tc


def first_gradient(state, X, Y, batch: int) -> dict:
    """The Adam leaves' gradient of the loss at the state's parameters, by
    the program's ``trainer.loss_and_grads`` on the batch and noise that
    its next step draws; the stream is left where it was."""
    from deepcgp_tpu_torch.training import trainer
    saved = state.generator.get_state()
    idx = torch.randint(0, X.shape[0], (batch,), generator=state.generator,
                        device=X.device)
    _, grads = trainer.loss_and_grads(state, X[idx], Y[idx])
    state.generator.set_state(saved)
    return _host({k: grads[k] for k in svgp.ADAM_LEAVES})


def checked_start(cfg: dict, tr: dict, seed: int, device) -> dict:
    """One training state from the seed, driven through its first
    ``CHECKED_STEPS`` steps by the window's own call, and what the
    comparison reads of them: (the losses, the Adam leaves' first
    gradient, the natural-gradient leaves after each step, every leaf
    after the steps, ``steps_back`` after each step)."""
    X, Y = inputs.training_set(cfg, seed, device)
    w = weights(cfg, seed, device)
    model = training_model(cfg, w, tr['samples'], device)
    train_seed = inputs.subseed(seed, 'training stream')
    state, tc = training_state(model, cfg, tr, train_seed)
    p0 = _host(state.params)
    g1 = first_gradient(state, X, Y, tr['batch'])
    elbos, qs, backs = [], [], []
    for _ in range(CHECKED_STEPS):
        elbos.append(program.run_chunk(state, tc, X, Y, 1))
        qs.append(_host({k: state.params[k] for k in svgp.NATGRAD_LEAVES}))
        backs.append(float(state.steps_back))
    readings = ([-float(e[0]) for e in elbos], g1, qs, _host(state.params),
                backs)
    return dict(X=X, Y=Y, weights=w, train_seed=train_seed, state=state,
                tc=tc, p0=p0, readings=readings)


def reference(start: dict, cfg: dict, tr: dict, arith: str = 'float64',
              **faults):
    """The reference's (or, in 'tf32', the control's) first steps from the
    same weights, batches and noise, as three 1-step chunks: readings as
    :func:`checked_start` takes them, the first gradient the one the
    first step computes.  ``faults``: ``svgp.Trainer``'s."""
    X, Y = start['X'], start['Y']
    g = torch.Generator(device=X.device)
    g.manual_seed(start['train_seed'])
    t = svgp.Trainer(Arith(arith), svgp.initial_params(start['weights']),
                     cfg, tr, g, noise_dtype=X.dtype, **faults)
    losses, first, qs, backs = [], None, [], []
    for _ in range(CHECKED_STEPS):
        loss, grads = t.step(X, Y)
        t.final_check(X, Y)
        losses.append(float(loss))
        if first is None:
            first = _host({k: grads[k] for k in svgp.ADAM_LEAVES})
        qs.append(_host({k: t.params[k] for k in svgp.NATGRAD_LEAVES}))
        backs.append(float(t.steps_back))
    return losses, first, qs, _host(t.params), backs


def numbers(prog, ref, p0: dict) -> dict:
    """The numbers compared (``CHECKS``) and their detail; ``prog`` and
    ``ref`` as :func:`checked_start` reads them."""
    losses, g1, qs, p3, backs = prog
    rlosses, rg1, rqs, rp3, rbacks = ref
    loss_rel = max(abs(a - b) / abs(b) if math.isfinite(a) else math.inf
                   for a, b in zip(losses, rlosses))
    gn, rgn = compare._norms(g1), compare._norms(rg1)
    grads = compare._scaled({k: abs(gn[k] - rgn[k]) for k in rgn}, rgn)
    # The first step the reference commits: its steps_back does not grow.
    committed = [i for i, b in enumerate(rbacks)
                 if b == (rbacks[i - 1] if i else 0.0)]
    if committed:
        i = committed[0]
        rd = compare._norms({k: rqs[i][k] - p0[k] for k in rqs[i]})
        natgrad = compare._scaled(
            compare._norms({k: qs[i][k] - rqs[i][k] for k in rqs[i]}), rd)
    else:
        natgrad = {k: math.inf for k in svgp.NATGRAD_LEAVES}
    dn = compare._norms({k: p3[k] - p0[k] for k in rp3})
    rdn = compare._norms({k: rp3[k] - p0[k] for k in rp3})
    changes = compare._scaled({k: abs(dn[k] - rdn[k]) for k in rdn}, rdn)
    return {'loss_rel': loss_rel, 'grad_gap': max(grads.values()),
            'natgrad_gap': max(natgrad.values()),
            'change_gap': max(changes.values()),
            'detail': {'losses': losses, 'reference_losses': rlosses,
                       'steps_back': backs, 'reference_steps_back': rbacks,
                       'natgrad_step': committed[0] + 1 if committed else None,
                       'grad_gaps': grads, 'natgrad_gaps': natgrad,
                       'change_gaps': changes}}


def traced_stretch(ctx, state, tc, X, Y, steps: int, attempts: int = 6):
    """``kinds/train.py``'s traced stretch with the 'natgrad' bucket
    (``tracing_natgrad``): the eager step of a fresh capture profiled with
    Python stacks, then ``steps`` replayed steps traced in the benchmark's
    window region after ``tracing.WARM`` replays outside it; (source
    microseconds of the stretch, the stretch's trace).  A stretch whose
    replayed steps hold fewer device events than the eager step is traced
    again, an eager step with fewer than a replay profiled again."""
    def capture():
        state.graphs = None
        program.run_chunk(state, tc, X, Y, 1)

    def stretch():
        program.run_chunk(state, tc, X, Y, tracing.WARM)
        ctx.synchronize()
        with torch.profiler.record_function(tracing.WINDOW):
            program.run_chunk(state, tc, X, Y, steps)
            ctx.synchronize()

    reference_trace = tracing.profile(capture, with_stack=True)
    for attempt in range(1, attempts + 1):
        chunk = tracing.profile(stretch)
        eager, _ = tracing.eager_step(reference_trace)
        counts = tracing.replay_counts(chunk)
        if counts == [len(eager)]:
            return (tracing_natgrad.source_us(reference_trace, chunk, steps),
                    chunk)
        ctx.log(f'trace {attempt}: replayed steps of {counts} device '
                f'events against the eager step\'s {len(eager)}')
        if counts and len(eager) < counts[-1]:
            reference_trace = tracing.profile(capture, with_stack=True)
    raise RuntimeError(f'the profiler lost device events in {attempts} '
                       'traces of the stretch')


def run(ctx):
    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    chunk = tr['chunk_steps']
    start = checked_start(cfg, tr, ctx.seed, device)
    state, tc, X, Y = start['state'], start['tc'], start['X'], start['Y']
    program.run_chunk(state, tc, X, Y, chunk)
    ctx.synchronize()
    ctx.setup_done()

    backs0 = float(state.steps_back)
    traces, steps = [], 0
    t0 = time.perf_counter()
    while True:
        traces.append(program.run_chunk(state, tc, X, Y, chunk))
        ctx.synchronize()
        steps += chunk
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    rate = steps / elapsed
    failed = int((~torch.isfinite(torch.cat(traces))).sum())
    ctx.metric('train_steps_per_s', rate)
    ctx.count(attempted=steps, failed=failed)
    ctx.log(f'NatGrad backoffs in the window: '
            f'{float(state.steps_back) - backs0:g} '
            f'(steps_back {float(state.steps_back):g} after {steps} steps)')

    if ctx.trace:
        sources, chunk_trace = traced_stretch(ctx, state, tc, X, Y, chunk)
        ctx.traced(chunk_trace, units=chunk, sources=sources)
        ctx.log('device ms a step by source: ' + str(
            {k: round(v / 1e3 / chunk, 4) for k, v in sorted(
                sources.items(), key=lambda kv: -kv[1])}))
    ctx.memory_peak()
    del state, start['state']
    program.release(device)

    out = numbers(start['readings'], reference(start, cfg, tr), start['p0'])
    ctx.log('training comparison: ' + str(out['detail']))
    for name in CHECKS:
        ctx.check(name, out[name])
