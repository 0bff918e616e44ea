"""Run one cell of the port's benchmark once, on the machine it is started
on, from the root of a checkout:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result, one JSON object; the
last lines of standard error are the numbers compared against their
limits.  Without as many CUDA devices as the cell asks for it exits with
a code other than 0 and prints no result.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Every build and kernel cache in fixed directories of the checkout.
for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                 ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                 ('CUDA_CACHE_PATH', 'cuda_jit')):
    os.environ[var] = os.path.join(ROOT, 'build', 'portbench', sub)
os.environ['USE_FLAX'] = '0'
# The checkout's root in place of this script's directory on the path.
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or '.') != HERE]

if __name__ == '__main__':
    from portbench import harness
    sys.exit(harness.main())
