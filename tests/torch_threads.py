"""One intra-op thread for torch's CPU ops in every port test process.

The suite runs in several worker processes at once (``-n 6``), on a
machine with few more CPUs than workers, beside reference subprocesses
that keep their own thread pools.  At torch's default, each worker would
start one intra-op thread per CPU, and the oversubscribed threads make
the port's tensors, all of them small, many times slower than one thread
runs them.  One thread also fixes the order of every CPU reduction, which
the bars that hold two runs of the port to the same bits need: a sum
split over several threads is not added in one order from run to run.

Every ``tests/test_torch_*.py`` imports this module first, so the setting
does not depend on which file a worker collects first.  A port process
that a test starts itself gets ``OMP_NUM_THREADS=1`` in its environment.
"""

import torch

torch.set_num_threads(1)
