"""Each pytest-xdist worker gets its share of the CPU cores.

Every worker would otherwise open torch's intra-op pool and the BLAS pool
at the full core count, so ``-n`` workers oversubscribe the cores many
times over. Inside a worker (xdist sets ``PYTEST_XDIST_WORKER_COUNT``
before the worker loads its conftests) the OpenMP, MKL and OpenBLAS pools
get ``cores // workers`` threads, at least one: the environment before
torch is imported (and for every process a test starts), torch's pool
itself if it is loaded already, and numpy's OpenBLAS pool through
threadpoolctl where that is installed (a pytest plugin, jaxtyping's,
imports numpy before any conftest). The controller loads this file as
well and its environment is what the workers inherit, so the share is
decided and written in the worker, over any inherited value. A run
without xdist is left as it is. XLA's pools are left alone: the JAX
tests' virtual 8-device mesh depends on them (``tests/conftest.py``).
"""

import os
import sys


def worker_threads():
    """This xdist worker's share of the cores, or None outside a worker."""
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers is None:
        return None
    return max(1, len(os.sched_getaffinity(0)) // int(workers))


_threads = worker_threads()
if _threads is not None:
    for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[_var] = str(_threads)
    if "torch" in sys.modules:
        sys.modules["torch"].set_num_threads(_threads)
    if "numpy" in sys.modules:
        try:
            from threadpoolctl import threadpool_limits
        except ImportError:
            pass
        else:
            threadpool_limits(_threads, user_api="blas")
