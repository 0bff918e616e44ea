"""A training cell: one client running the graphed ``run_chunk`` in a
closed loop, whole chunks of the traffic's ``chunk_steps`` steps, each
ending in ``synchronize()``.

Set-up builds one training state from the seed, drives it through its
first three steps by the window's own call (``run_chunk``, graphed) and
keeps what the comparison reads, warms up one whole chunk, and hands the
same state to the window."""

from __future__ import annotations

import time

import torch

from portbench import compare, inputs, program, tracing
from portbench.reference import convgp as ref

CHECKED_STEPS = 3


def _host(d: dict) -> dict:
    return {k: v.detach().double().cpu() for k, v in d.items()}


def traced_stretch(ctx, state, tc, X, Y, steps: int, attempts: int = 6):
    """The eager step of a fresh capture profiled with Python stacks, then
    ``steps`` replayed steps traced in the benchmark's window region, after
    ``tracing.WARM`` replays under the same profiler outside it (the first
    launches of a profiler's session take the host far longer): (source
    microseconds of the stretch, the stretch's trace).  The
    profiler can lose device events; a stretch whose replayed steps hold
    fewer than the eager step is traced again, an eager step with fewer
    than a replay is profiled again (a new capture); ``attempts`` traces
    short of events raise."""
    def capture():
        state.graphs = None
        program.run_chunk(state, tc, X, Y, 1)

    def stretch():
        program.run_chunk(state, tc, X, Y, tracing.WARM)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        with torch.profiler.record_function(tracing.WINDOW):
            program.run_chunk(state, tc, X, Y, steps)
            if torch.cuda.is_available():
                torch.cuda.synchronize()

    reference = tracing.profile(capture, with_stack=True)
    for attempt in range(1, attempts + 1):
        chunk = tracing.profile(stretch)
        eager, _ = tracing.eager_step(reference)
        counts = tracing.replay_counts(chunk)
        if counts == [len(eager)]:
            return tracing.source_us(reference, chunk, steps), chunk
        ctx.log(f'trace {attempt}: replayed steps of {counts} device '
                f'events against the eager step\'s {len(eager)}')
        if counts and len(eager) < counts[-1]:
            reference = tracing.profile(capture, with_stack=True)
    raise RuntimeError(f'the profiler lost device events in {attempts} '
                       'traces of the stretch')


def checked_start(cfg: dict, tr: dict, seed: int, device) -> dict:
    """One training state from the seed, driven through its first
    ``CHECKED_STEPS`` steps by the window's own call, and what the
    comparison reads of them: the losses, the first gradient from Adam's
    first moment after one step, the parameters before and after."""
    X, Y = inputs.training_set(cfg, seed, device)
    weights = inputs.weights(cfg, seed, device)
    model = program.training_model(cfg, weights, tr['samples'], device)
    train_seed = inputs.subseed(seed, 'training stream')
    state, tc = program.training_state(model, cfg, tr, train_seed)
    p0 = _host(state.params)
    elbos, g1 = [], None
    for _ in range(CHECKED_STEPS):
        elbos.append(program.run_chunk(state, tc, X, Y, 1))
        if g1 is None:
            g1 = _host({k: m.double() / (1.0 - ref.ADAM_B1)
                        for k, m in state.opt_state['mu'].items()})
    readings = ([-float(e[0]) for e in elbos], g1, _host(state.params))
    return dict(X=X, Y=Y, weights=weights, train_seed=train_seed,
                state=state, tc=tc, p0=p0, readings=readings)


def reference(start: dict, cfg: dict, tr: dict, seed: int,
              arith: str = 'float64', half_batch: bool = False):
    """The reference's (or, in 'tf32', the control's) first steps from
    the same weights, batches and noise."""
    return compare.reference_steps(
        ref.Arith(arith), cfg, tr, start['weights'], start['X'], start['Y'],
        start['train_seed'], inputs.subseed(seed, 'reference dither'),
        CHECKED_STEPS, half_batch=half_batch)


def run(ctx):
    cfg, tr, device = ctx.config, ctx.traffic, ctx.device
    chunk = tr['chunk_steps']
    start = checked_start(cfg, tr, ctx.seed, device)
    state, tc, X, Y = start['state'], start['tc'], start['X'], start['Y']
    program.run_chunk(state, tc, X, Y, chunk)
    ctx.synchronize()
    ctx.setup_done()

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

    if ctx.trace:
        sources, chunk_trace = traced_stretch(ctx, state, tc, X, Y, chunk)
        ctx.traced(chunk_trace, units=chunk, sources=sources)
    ctx.memory_peak()
    del state, start['state']
    program.release(device)

    numbers = compare.training_numbers(
        start['readings'], reference(start, cfg, tr, ctx.seed), start['p0'])
    detail = numbers['detail']
    ctx.log('training comparison: ' + str({k: detail[k] for k in (
        'losses', 'reference_losses', 'grad_leaf', 'change_leaf',
        'left_out')}))
    for name in ('loss_rel', 'grad_gap', 'change_gap', 'grad_err_median'):
        ctx.check(name, numbers[name])
