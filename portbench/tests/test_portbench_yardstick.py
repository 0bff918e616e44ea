"""The yardstick: the copied FLOP count against the program's
``utils/flops``, the least time of the cross-covariance worked by hand,
the per-layer readers' arithmetic, and the trace reading on a made-up
trace."""

import json
import os
import types

import pytest

from portbench import harness, inputs, program, tracing, yardstick

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config(name):
    with open(os.path.join(ROOT, 'portbench', 'configs', f'{name}.json')) as f:
        return json.load(f)


@pytest.mark.parametrize('name', ['cifar10-convgp-2l', 'mnist-convgp-m1024'])
def test_the_copied_flop_count_is_the_programs(name):
    from deepcgp_tpu_torch.utils import flops
    cfg = config(name)
    model = program.training_model(cfg, inputs.weights(cfg, 1, 'cpu'), 10,
                                   'cpu')
    assert yardstick.training_step_flops(cfg, 32, 10) == \
        flops.training_step_flops(model, 32)


def test_the_flagship_step_is_45_66_gflop():
    cfg = config('cifar10-convgp-2l')
    assert round(yardstick.training_step_flops(cfg, 32, 10) / 1e9, 2) == 45.66
    assert yardstick.COMPUTE_PEAK_FLOPS == 165e12


def test_the_cross_covariance_least_time_by_hand():
    cfg = config('mnist-convgp-m1024')
    (what, ops, nbytes), (gram, g_ops, g_bytes) = \
        yardstick.cross_covariance_parts(cfg, 32, 10)
    N, P, M, L = 32, 576, 1024, 25
    # Forward: the distance product and the images' own patch grams;
    # backward: dZ alone, the data takes no gradient.
    assert ops == 2 * (2 * N * P * M * L + N * P * (P + 1) * L)
    image, z, out = 4 * N * 28 * 28, 4 * M * L, 4 * (N * M + N)
    assert nbytes == (image + z + out) + (image + z + out + z)
    assert g_ops == M * (M + 1) * L + 2 * M * M * L
    least, bound = yardstick.cross_covariance_least_s(cfg, 32, 10)
    assert bound == 'operations'
    want = sum(max(o / 165e12, b / 3.35e12) for o, b in
               ((ops, nbytes), (g_ops, g_bytes)))
    assert least == pytest.approx(want, rel=1e-12)


def reading(kind, **kw):
    cfg = config('cifar10-convgp-2l')
    traffic = ({'batch': 32, 'samples': 10} if kind == 'train'
               else {'rows': 128, 'samples': 5})
    base = dict(kind=kind, workload='w', config=cfg, traffic=traffic,
                units=100, busy_s=0.9, window_s=1.0,
                sources=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_the_readers():
    r = reading('train', sources={'optimizer': 70000.0, 'qsqrt-term': 140000.0,
                                  'conv-Kuf': 124000.0})
    assert harness.read_metric('device_idle_pct.train', r) == pytest.approx(10.0)
    assert harness.read_metric('device_idle_pct.serve', r) is None
    assert harness.read_metric('optim_ms_per_step.train', r) == pytest.approx(0.7)
    assert harness.read_metric('conditional_ms_per_step.train', r) == pytest.approx(1.4)
    least, _ = yardstick.cross_covariance_least_s(r.config, 32, 10)
    assert harness.read_metric('cross_cov_roofline_pct.train', r) == \
        pytest.approx(100 * least / 1.24e-3)
    assert harness.read_metric('step_mfu_pct.train', r) == pytest.approx(
        100 * 45.664468992e9 * 100 / 0.9 / 165e12)
    assert harness.read_metric('step_mfu_pct.serve', r) is None
    # A reader that finds nothing to read returns nothing, never 0.
    assert harness.read_metric('cross_cov_roofline_pct.train',
                               reading('train')) is None
    s = reading('serve')
    assert harness.read_metric('step_mfu_pct.serve', s) == pytest.approx(
        100 * yardstick.request_flops(s.config, 128, 5) * 100 / 0.9 / 165e12)
    for kind in ('train', 'serve'):
        assert harness.read_metric(f'step_mfu_pct.{kind}',
                                   reading(kind, busy_s=None)) is None


def test_busy_time_and_breakdown_of_a_made_up_trace(tmp_path):
    events = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': tracing.WINDOW,
         'ts': 0, 'dur': 100, 'pid': 1, 'tid': 1, 'args': {}},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaGraphLaunch',
         'ts': 1, 'dur': 3, 'pid': 1, 'tid': 1, 'args': {'correlation': 7}},
        {'ph': 'X', 'cat': 'cuda_runtime', 'name': 'cudaStreamSynchronize',
         'ts': 50, 'dur': 40, 'pid': 1, 'tid': 1, 'args': {}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k1', 'ts': 10, 'dur': 20,
         'pid': 0, 'tid': 7, 'args': {'correlation': 7}},
        {'ph': 'X', 'cat': 'kernel', 'name': 'k2', 'ts': 25, 'dur': 15,
         'pid': 0, 'tid': 8, 'args': {'correlation': 7}},
        {'ph': 'X', 'cat': 'gpu_memcpy', 'name': 'copy', 'ts': 60, 'dur': 10,
         'pid': 0, 'tid': 7, 'args': {}},
    ]
    path = tmp_path / 't.json'
    path.write_text(json.dumps({'traceEvents': events}))
    trace = tracing.parse_trace(str(path))
    busy, window = tracing.busy_and_window_s(trace)
    assert busy == pytest.approx(40e-6) and window == pytest.approx(100e-6)
    b = tracing.breakdown(trace)
    assert b['device_ops'][0] == ['k1', pytest.approx(20e-6)]
    gaps = dict(b['idle_gaps'])
    assert gaps['cudaStreamSynchronize'] == pytest.approx(50e-6)


def test_only_the_replays_inside_the_window_are_read(tmp_path):
    events = [
        {'ph': 'X', 'cat': 'user_annotation', 'name': tracing.WINDOW,
         'ts': 100, 'dur': 100, 'pid': 1, 'tid': 1, 'args': {}}]
    for i, t in enumerate((10, 120, 160)):       # a warm replay, then two
        events += [
            {'ph': 'X', 'cat': 'user_annotation', 'name': tracing.REPLAY_STEP,
             'ts': t, 'dur': 10, 'pid': 1, 'tid': 1, 'args': {}},
            {'ph': 'X', 'cat': 'cuda_runtime', 'name': tracing.GRAPH_LAUNCH,
             'ts': t + 1, 'dur': 3, 'pid': 1, 'tid': 1,
             'args': {'correlation': i}},
            {'ph': 'X', 'cat': 'kernel', 'name': 'k', 'ts': t + 5, 'dur': 20,
             'pid': 0, 'tid': 7, 'args': {'correlation': i}}]
    path = tmp_path / 't.json'
    path.write_text(json.dumps({'traceEvents': events}))
    trace = tracing.parse_trace(str(path))
    assert len(tracing.replayed_steps(trace)) == 3
    inside = tracing.replayed_steps(trace, within=tracing.window_span(trace))
    assert [[e['ts'] for e in r] for r in inside] == [[125], [165]]
