"""The spawned ranks' entry of ``tests/test_torch_parallel.py``: importable
by name in a fresh process, and free of JAX."""

import os
import time

import torch

from yoloret_tpu_torch.tools.scaling import data_parallel_steps


def run_jobs(device, jobs):
    """Each ``(fn, kwargs)`` of ``jobs`` in turn, as ``fn(device, **kwargs)``."""
    for fn, kwargs in jobs:
        fn(device, **kwargs)


def steps_from_file(device, start_path, timeout=300.0, **kwargs):
    """``data_parallel_steps`` from the state that the test process writes
    to ``start_path`` (atomically) while the ranks run their other jobs."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(start_path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{start_path} did not appear in {timeout} s")
        time.sleep(0.1)
    data_parallel_steps(device, None, start=torch.load(start_path, weights_only=True), **kwargs)
