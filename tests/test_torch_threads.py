"""One intra-op thread for torch's CPU ops in every test process.

The suite runs in several processes at once (pytest-xdist), and every
process collects every test module. Torch's default of one intra-op
thread per core then puts several times as many threads as cores on the
machine, and the port's tests, whose tensors are tiny, spend most of
their time handing work between threads (on an 8-core host under
``-n 6``, six of the port's test files took 2.2x as long with the
default as with one thread).
Setting it here, at collection, applies it to the whole session of each
process, as the mesh tests' fixtures already do before they start their
ranks. Results do not depend on it: every test passes either way.
"""

import torch

torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1
