"""Caps torch's intra-op thread pool in the port's CPU tests.

Every tests/test_torch_*.py imports this module (most through
torch_parity) before its first torch op.  The tests run in several
pytest-xdist workers on one host, each beside XLA's own pool; torch's
default pool is as wide as the host, and the oversubscribed pools slow
every worker several times over.
"""

import torch

THREADS = 2
torch.set_num_threads(THREADS)
