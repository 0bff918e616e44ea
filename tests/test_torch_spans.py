"""The port's spans, recorder and counters (``utils/profiling.py``): spans
nest with their parents and requests, self times, the shared null context
while nothing traces or records, spans as regions of a Chrome trace, the
summary's busy union and idle charging from given device intervals, and
the spans of ``run_chunk`` and the Predictor on the CPU (the capture
counter is held in ``test_torch_graphs_mesh.py``, beside its stub graph
cache)."""

import glob
import json
import os
import time
import types

import numpy as np
import pytest
import torch

from deepcgp_tpu_torch.models.builder import build_model
from deepcgp_tpu_torch.serving import Predictor
from deepcgp_tpu_torch.training import graphs, trainer
from deepcgp_tpu_torch.utils import profiling

IMAGE = (12, 12, 1)


def small_port(seed=0):
    flags = types.SimpleNamespace(
        M='6,8', feature_maps='2', filter_sizes='5,3', strides='2,1',
        base_kernel='rbf', last_kernel='conv', white=False,
        identity_mean=False, num_samples=3)
    rng = np.random.RandomState(seed)
    X = rng.randn(40, *IMAGE)
    Y = rng.randint(0, 10, size=(40, 1))
    model = build_model(flags, IMAGE, images=X,
                        generator=torch.Generator().manual_seed(seed),
                        dtype=torch.float64, device='cpu')
    return model, torch.as_tensor(X.reshape(40, -1)), torch.as_tensor(Y)


def span(name, id, parent, start, end, device=None, request=None):
    return profiling.Span(name, id, parent, request, start, end, device)


def test_spans_nest_with_parents_and_requests():
    with profiling.recording() as rec:
        with profiling.annotate('outer', request=7):
            with profiling.annotate('inner', request=(7, 0)):
                with profiling.annotate('leaf'):
                    pass
            with profiling.annotate('inner', request=(7, 1)):
                pass
        with profiling.annotate('second'):
            pass
    got = [(s.name, s.id, s.parent, s.request) for s in rec.spans]
    assert got == [('outer', 0, None, 7), ('inner', 1, 0, (7, 0)),
                   ('leaf', 2, 1, None), ('inner', 3, 0, (7, 1)),
                   ('second', 4, None, None)]
    for s in rec.spans:
        assert rec.start_ns <= s.start_ns <= s.end_ns <= rec.end_ns
        if s.parent is not None:
            p = rec.spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns
        assert s.device_ns is None      # no card: host times only


def test_self_ms_is_the_duration_less_the_childrens():
    with profiling.recording() as rec:
        with profiling.annotate('parent'):
            time.sleep(0.002)
            for _ in range(2):
                with profiling.annotate('child'):
                    time.sleep(0.003)
    out = rec.summary()['spans']
    parent, child = rec.spans[0], rec.spans[1:]
    dur = [(s.end_ns - s.start_ns) / 1e6 for s in rec.spans]
    assert out['child'] == {'count': 2, 'ms': pytest.approx(dur[1] + dur[2]),
                            'self_ms': pytest.approx(dur[1] + dur[2])}
    assert out['parent']['count'] == 1
    assert out['parent']['ms'] == pytest.approx(dur[0])
    assert out['parent']['self_ms'] == pytest.approx(dur[0] - dur[1] - dur[2])
    assert out['parent']['self_ms'] >= 1.9 and parent.parent is None
    assert all(c.parent == 0 for c in child)


def test_off_returns_the_shared_null_context_and_records_nothing(
        monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, 'record_function',
                        lambda name: made.append(name))
    assert profiling._RECORDER is None
    assert not torch.autograd.profiler._is_profiler_enabled
    a = profiling.annotate('a', request=1, device=True)
    b = profiling.annotate('b')
    assert a is b is profiling._OFF
    with profiling.annotate('off'):
        pass
    with profiling.recording() as rec:
        with profiling.annotate('on'):
            pass
    with profiling.annotate('off again'):
        pass
    assert [s.name for s in rec.spans] == ['on'] and made == []
    assert profiling._RECORDER is None


def test_one_recording_at_a_time():
    with profiling.recording():
        with pytest.raises(RuntimeError, match='already on'):
            with profiling.recording():
                pass
    with profiling.recording() as rec:
        pass
    assert rec.spans == [] and rec.summary()['busy_ns'] == 0


def test_a_span_is_a_trace_region_only_under_the_profiler(tmp_path):
    with profiling.annotate('before the trace'):
        torch.ones(8) + 1
    with profiling.trace(str(tmp_path)):
        with profiling.annotate('span in the trace', request=3, device=True):
            with profiling.annotate('nested span'):
                torch.ones(8) + 1
    (path,) = glob.glob(os.path.join(str(tmp_path), 'trace_*.json'))
    regions = {e['name'] for e in json.load(open(path))['traceEvents']
               if e.get('cat') == 'user_annotation'}
    assert {'span in the trace', 'nested span'} <= regions
    assert 'before the trace' not in regions


def test_summary_busy_union_idle_and_self_times():
    """Synthetic spans over a window [0, 100]: a request [10, 90] with
    children h2d [12, 20] (device [15, 25]), replay [20, 30] (device
    [24, 60]) and wait [30, 80]; a second root [92, 98]."""
    spans = [span('request', 0, None, 10, 90, request=1),
             span('h2d', 1, 0, 12, 20, device=(15, 25)),
             span('replay', 2, 0, 20, 30, device=(24, 60)),
             span('wait', 3, 0, 30, 80),
             span('other', 4, None, 92, 98, device=(-5, 2))]
    out = profiling.summary(spans, 0, 100)
    assert out['wall_ns'] == 100
    # [0, 2] (clipped) + [15, 60]
    assert out['busy_ns'] == 2 + 45
    # Gaps: [2, 15] mid 8.5 in no span; [60, 100] mid 80 -- the wait ends
    # at 80 and covers it.
    assert out['idle_ms'] == {profiling.OUTSIDE_SPANS: pytest.approx(13e-6),
                              'wait': pytest.approx(40e-6)}
    s = out['spans']
    assert s['request'] == {'count': 1, 'ms': pytest.approx(80e-6),
                            'self_ms': pytest.approx(12e-6)}
    assert s['wait']['self_ms'] == pytest.approx(50e-6)
    assert s['other']['count'] == 1
    # A gap in the middle of a span with no child there is the span's.
    out = profiling.summary(spans[:1], 0, 100)
    assert out['busy_ns'] == 0 and out['idle_ms'] == {'request': 100e-6}


def test_summary_overlapping_device_intervals_merge():
    spans = [span('a', 0, None, 0, 10, device=(0, 40)),
             span('b', 1, None, 10, 20, device=(30, 50)),
             span('c', 2, None, 20, 70, device=(60, 70))]
    out = profiling.summary(spans, 0, 80)
    assert out['busy_ns'] == 50 + 10
    assert out['idle_ms'] == {'c': pytest.approx(10e-6),
                              profiling.OUTSIDE_SPANS: pytest.approx(10e-6)}


def test_span_names_the_benchmark_reads_stay():
    key = ('step', 'k')
    assert graphs.region('eager', key) == 'graph eager step'
    assert graphs.region('replay', key) == 'graph replay step'
    assert graphs.region('replay', ('predict_proba', 1)) == \
        'graph replay predict_proba'
    assert graphs.region('capture', key) == 'graph capture step'


def test_run_chunk_is_one_span_a_call_counting_the_states_chunks():
    model, X, Y = small_port()
    config = trainer.TrainConfig(batch_size=8)
    state = trainer.init_state(model, config, seed=1)
    trainer.run_chunk(state, config, X, Y, 1)
    with profiling.recording() as rec:
        trainer.run_chunk(state, config, X, Y, 2)
        trainer.run_chunk(state, config, X, Y, 1)
    assert [(s.name, s.request, s.parent) for s in rec.spans] == [
        ('run_chunk', 2, None), ('run_chunk', 3, None)]
    assert state.chunks == 3


@pytest.mark.parametrize('entry', ['predict_proba', 'log_density'])
def test_predictor_request_spans_and_phases(entry, tmp_path):
    """A request is one span over its phases, the same answers with the
    recorder or the profiler on as off."""
    model, X, Y = small_port()
    images, labels = X[:12].numpy(), Y[:12].numpy()

    def call(pred):
        fn = getattr(pred, entry)
        return fn(images) if entry == 'predict_proba' else fn(images, labels)
    plain = Predictor(model, batch_size=8, device='cpu')
    answers = [call(plain) for _ in range(3)]
    pred = Predictor(model, batch_size=8, device='cpu')
    np.testing.assert_array_equal(call(pred), answers[0])
    with profiling.recording() as rec:
        np.testing.assert_array_equal(call(pred), answers[1])
    with profiling.trace(str(tmp_path)):
        np.testing.assert_array_equal(call(pred), answers[2])
    names = [(s.name, s.parent) for s in rec.spans]
    assert names == [(entry, None), ('serve prepare', 0), ('serve h2d', 0),
                     ('serve batch', 0), ('serve batch', 0),
                     ('serve wait', 0), ('serve finish', 0)]
    assert rec.spans[0].request == 2
    out = rec.summary()['spans']
    assert out['serve batch']['count'] == 2
    (path,) = glob.glob(os.path.join(str(tmp_path), 'trace_*.json'))
    regions = {e['name'] for e in json.load(open(path))['traceEvents']
               if e.get('cat') == 'user_annotation'}
    assert {entry, 'serve prepare', 'serve h2d', 'serve batch',
            'serve wait', 'serve finish'} <= regions


@pytest.mark.card
def test_device_intervals_on_the_host_clock():
    """On a card, a device span's interval lies on the host clock after
    its host start, and the busy time covers a long kernel."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the CUDA-event path')
    a = torch.randn(2048, 2048, device='cuda')
    with profiling.recording() as rec:
        with profiling.annotate('matmul', device=True):
            for _ in range(20):
                a = a @ a / 2048
        with profiling.annotate('host'):
            time.sleep(0.01)
    mm = rec.spans[0]
    assert mm.device_ns is not None and rec.spans[1].device_ns is None
    assert mm.start_ns - 1e5 <= mm.device_ns[0] <= mm.device_ns[1]
    assert mm.device_ns[1] <= rec.end_ns
    out = rec.summary()
    assert 0 < out['busy_ns'] <= out['wall_ns']
