"""Each pytest-xdist worker runs torch with one intra-op thread, and the
processes its tests start (the CLI, the DDP and ZeRO ranks) with one
OpenMP thread.

Six workers that each start a thread per core oversubscribe the host many
times over: `test_torch_vq.py::test_vq_encode_chunked_matches_jax_chunked`
takes 2 s alone and took 150 s inside a full run. Every torch result the
port's tests check is held exactly or within a stated tolerance whatever the
thread count. Outside xdist nothing changes.

The setting is made when this module is imported, which every worker does
while it collects the suite, before any test runs.
"""
import os

import torch

WORKER = os.environ.get("PYTEST_XDIST_WORKER")
if WORKER:
    torch.set_num_threads(1)
    os.environ["OMP_NUM_THREADS"] = "1"


def test_xdist_workers_run_torch_on_one_thread():
    if WORKER:
        assert torch.get_num_threads() == 1 and os.environ["OMP_NUM_THREADS"] == "1"
    else:
        assert torch.get_num_threads() >= 1
