"""TMR bitwise majority vote with per-replica mismatch counts (K4): the
wrapper of the CUDA kernel in ``csrc/redundancy_epilogue.cu`` and its
plain PyTorch version.

Replaces the Pallas kernel ``repro/kernels/tmr_vote.py::tmr_vote`` (TPU)
and its oracle ``repro/kernels/ref.py::tmr_vote_ref``: over three flat
u32 word streams (``int32`` tensors holding the bits) it returns the
voted stream ``(a & b) | (a & c) | (b & c)`` and the three int32 counts
of words in which each replica differs from the vote, in one pass (3
reads and 1 write per word).  ``tmr_vote`` takes the plain version for
CPU tensors only; a CUDA tensor reaches the kernel or an exception.
"""

from __future__ import annotations

import torch

from .state_hash import launch, on_cpu


def tmr_vote_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """The plain version: (voted, counts (3,) int32)."""
    voted = (a & b) | (a & c) | (b & c)
    counts = torch.stack([(r != voted).sum() for r in (a, b, c)]).to(torch.int32)
    return voted, counts


def tmr_vote(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """(voted stream, per-replica mismatching-word counts (3,) int32) over
    three 1-D int32 word streams of one length."""
    if on_cpu("tmr_vote", [a, b, c]):
        return tmr_vote_plain(a, b, c)
    voted = torch.empty_like(a)
    counts = launch("tmr_vote", [a, b, c], voted, 3)
    tmr_vote.launches += 1
    return voted, counts


tmr_vote.launches = 0
