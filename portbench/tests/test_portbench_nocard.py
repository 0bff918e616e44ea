"""Without a CUDA card, and in a directory that holds only the benchmark,
a run exits with a code other than 0 and prints no result."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
ARGS = ['--workload', 'cifar10-convgp-2l.train-adam-b32', '--seed',
        str(2 ** 31 + 5), '--seconds', '1', '--trace', '0']


def run_in(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES='')
    return subprocess.run([sys.executable, 'portbench/run.py', *ARGS],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_card_no_result():
    p = run_in(ROOT)
    assert p.returncode != 0
    assert p.stdout.strip() == ''
    assert 'CUDA device' in p.stderr


def test_the_benchmark_alone_is_not_enough(tmp_path):
    shutil.copy(os.path.join(ROOT, 'BENCHMARK.json'), tmp_path)
    shutil.copytree(os.path.join(ROOT, 'portbench'), tmp_path / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    p = run_in(tmp_path)
    assert p.returncode != 0
    assert p.stdout.strip() == ''
