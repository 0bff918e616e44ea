"""A serving cell: one client calling ``Predictor.predict_proba`` in a
closed loop, the way a batch-scoring job does, each request the next
``rows`` images of the held-out set, timed on the host clock from the call
to the returned array.

Set-up writes the weights as a snapshot under ``$TMPDIR``, loads it with
``Predictor.from_run_dir`` and serves the traffic's warm-up requests (the
first captures the request's graph)."""

from __future__ import annotations

import shutil
import tempfile
import time

import numpy as np
import torch

from portbench import compare, inputs, program, tracing
from portbench.reference import convgp as ref


class Session:
    """The served model of a cell and its client."""

    def __init__(self, cfg: dict, tr: dict, seed: int, device, log):
        self.cfg, self.tr, self.log = cfg, tr, log
        self.rows, self.samples = tr['rows'], tr['samples']
        held = inputs.held_out_set(cfg, seed, device)
        self.distinct = held.shape[0] // self.rows
        self.held = held.cpu().numpy()
        self.weights = inputs.weights(cfg, seed, device)
        self.seed = inputs.subseed(seed, 'serving stream') % (1 << 31)
        self.root = tempfile.mkdtemp(prefix='portbench-')
        run_dir = program.write_run(self.root, cfg, self.weights, self.samples)
        self.predictor = program.predictor(run_dir, cfg, tr, self.seed, device)
        self.served = 0       # requests so far: request k draws with k + 1

    def images(self, k: int) -> np.ndarray:
        i = k % self.distinct
        return self.held[i * self.rows:(i + 1) * self.rows]

    def request(self):
        """(k, the probabilities or None if it raised, seconds)."""
        k = self.served
        self.served += 1
        X = self.images(k)
        t = time.perf_counter()
        try:
            p = self.predictor.predict_proba(X)
        except Exception as err:  # a failed request is counted, not fatal
            self.log(f'request {k} raised {err!r}')
            p = None
        return k, p, time.perf_counter() - t

    def close(self) -> None:
        self.predictor = None
        shutil.rmtree(self.root, ignore_errors=True)

    def numbers(self, answers: list, pick_seed: int, arith: str = 'float64'):
        """The numbers compared over a sample of ``answers`` [(k, p)]
        drawn from ``pick_seed``, with the last; in 'tf32' the control's
        probabilities stand in for the program's."""
        rng = np.random.default_rng(pick_seed)
        count = min(self.tr['compared_requests'], len(answers))
        picked = sorted(set(rng.choice(len(answers), count, replace=False)
                            .tolist()) | {len(answers) - 1})
        device = self.weights[0]['Z'].device
        pairs = []
        for i in picked:
            k, p = answers[i]
            X = torch.as_tensor(self.images(k), device=device)

            def probs(a):
                return compare.reference_probabilities(
                    ref.Arith(a), self.cfg, self.weights, X,
                    (self.seed << 32) + k + 1, self.samples)
            if arith != 'float64':
                p = probs(arith).double().cpu().numpy()
            elif p is None:
                p = np.full((self.rows, self.cfg['num_classes']), np.nan)
            pairs.append((p, probs('float64')))
        return compare.serving_numbers(pairs)


# The program's trace region of one replayed request.
REPLAY_REQUEST = 'graph replay predict_proba'


def traced_stretch(ctx, stretch, attempts: int = 6):
    """The stretch's trace, traced again while the profiler loses device
    events (the replays then hold different numbers of them)."""
    for attempt in range(1, attempts + 1):
        trace = tracing.profile(stretch)
        counts = tracing.replay_counts(trace, REPLAY_REQUEST)
        if len(counts) == 1 and counts[0] > 0:
            return trace
        ctx.log(f'trace {attempt}: replayed requests of {counts} device '
                'events')
    raise RuntimeError(f'the profiler lost device events in {attempts} '
                       'traces of the stretch')


def run(ctx):
    s = Session(ctx.config, ctx.traffic, ctx.seed, ctx.device, ctx.log)
    try:
        for _ in range(ctx.traffic['warmup_requests']):
            s.request()
        ctx.setup_done()
        answers, latencies = [], []
        t0 = time.perf_counter()
        while True:
            k, p, lat = s.request()
            answers.append((k, p))
            latencies.append(lat)
            elapsed = time.perf_counter() - t0
            if elapsed >= ctx.seconds:
                break
        failed = sum(p is None or not np.isfinite(p).all() for _, p in answers)
        ctx.metric('serve_images_per_s', s.rows * len(answers) / elapsed)
        ctx.metric('serve_p95_ms', 1e3 * float(np.percentile(latencies, 95)))
        ctx.count(attempted=len(answers), failed=failed)
        if ctx.trace:
            n = ctx.traffic['traced_requests']

            def stretch():
                for _ in range(tracing.WARM):
                    s.request()
                ctx.synchronize()
                with torch.profiler.record_function(tracing.WINDOW):
                    for _ in range(n):
                        s.request()

            ctx.traced(traced_stretch(ctx, stretch), units=n)
        ctx.memory_peak()
    finally:
        s.close()
    program.release(ctx.device)
    numbers = s.numbers(answers, inputs.subseed(ctx.seed, 'sample'))
    ctx.log(f'serving comparison: {numbers["detail"]}')
    ctx.check('prob_gap', numbers['prob_gap'])
