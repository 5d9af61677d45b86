"""Helpers for the port's tests."""

from __future__ import annotations

import os

import torch


def cap_threads_for_xdist() -> None:
    """Share the machine's cores among pytest-xdist's workers: each worker
    gets ``cores // workers`` intra-op threads (at least 1).  Without the
    cap every worker starts torch's default pool of one thread a core, and
    six such pools on eight cores spend most of a run contending for them.
    Outside xdist (``PYTEST_XDIST_WORKER`` unset) nothing changes."""
    if "PYTEST_XDIST_WORKER" not in os.environ:
        return
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    cores = len(os.sched_getaffinity(0)) if hasattr(os, "sched_getaffinity") else os.cpu_count()
    torch.set_num_threads(max(1, (cores or 1) // max(1, workers)))
