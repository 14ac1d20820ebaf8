"""One intra-op thread for torch, and one BLAS thread for numpy, in each
test process of the port.

The suite runs under several pytest-xdist workers at once, and by
default each worker's torch starts as many intra-op threads as the
machine has cores, and so does numpy's OpenBLAS, whose idle threads keep
spinning after a call: the workers' threads oversubscribe the cores and
the port's small CPU tensors spend their time switching threads. Every
``test_torch_*.py`` (and ``_torch_serving.py``) imports this module
first, before any torch op runs. numpy is loaded before it (``conftest``
imports JAX), too late for ``OPENBLAS_NUM_THREADS``, so its pool is
capped through ``threadpoolctl`` where that is installed (without it the
pool keeps its threads and only the run is slower). XLA's threads (the
JAX reference) are left as they are.
"""
import torch

torch.set_num_threads(1)

try:
    from threadpoolctl import threadpool_limits
except ImportError:
    threadpool_limits = None
if threadpool_limits is not None:
    threadpool_limits(limits=1, user_api="blas")
