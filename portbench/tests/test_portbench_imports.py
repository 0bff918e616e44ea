"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either; top-level names are
compared whole, since ``deepcgp_tpu_torch`` begins with ``deepcgp_tpu``."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, 'portbench')
JAX = {'jax', 'jaxlib', 'flax', 'deepcgp_tpu'}


def top_level_imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split('.')[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split('.')[0])
    return names


def sources(under: str) -> list:
    return [os.path.join(d, f) for d, _, fs in os.walk(under)
            for f in fs if f.endswith('.py')]


def test_top_level_names_are_compared_whole():
    assert top_level_imports(__file__) <= {'ast', 'os', 'subprocess', 'sys'}
    names = {'deepcgp_tpu_torch', 'torch', 'numpy'}
    assert not names & JAX


def test_no_benchmark_module_imports_jax_or_the_jax_package():
    for path in sources(BENCH):
        found = top_level_imports(path) & JAX
        assert not found, (path, found)


def test_the_reference_imports_nothing_of_the_program():
    for path in sources(os.path.join(BENCH, 'reference')):
        assert top_level_imports(path) <= {'__future__', 'math', 'numpy',
                                           'torch'}, path


def test_the_run_refuses_a_process_holding_the_jax_package():
    code = ('import sys; sys.path.insert(0, %r); '
            'from portbench import harness; '
            'import deepcgp_tpu_torch; print(harness.forbidden_loaded()); '
            'sys.modules["deepcgp_tpu"] = sys; '
            'sys.modules["jax.numpy"] = sys; print(harness.forbidden_loaded())'
            % ROOT)
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, check=True).stdout.split('\n')
    assert out[0] == '[]'
    assert out[1] == "['deepcgp_tpu', 'jax']"
