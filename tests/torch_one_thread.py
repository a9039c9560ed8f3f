"""Imported by the port's test files (`tests/test_torch_*.py`): PyTorch runs
its CPU ops on one thread in the test process. Every pytest worker imports
every test file when it collects, so the setting holds for the whole run
(`test_torch_checkpoint.py`, which does not import this, included).

The test command runs six pytest workers on the machine's cores at once,
and every worker also runs XLA. PyTorch's default pool of one OpenMP
thread per core in each worker keeps spinning between the tiny ops of
these tests and takes the cores from the other workers' XLA compiles; on
one thread the port's files run about twice as fast under that load. The
tests compare nothing across thread counts: every side of a comparison
runs in the same process, on this setting.
"""

import torch

torch.set_num_threads(1)
