"""The fused per-step redundancy kernels of the ``lockstep_cuda`` back-end
(K1, K2): wrappers of the CUDA kernels in ``csrc/redundancy_epilogue.cu``
and their plain PyTorch versions.

Replace the Pallas kernels ``repro/kernels/fused_step.py::dmr_compare``
and ``::tmr_step`` (TPU), which collapse a replicated cell's whole
dependability epilogue into one pass:

  * ``dmr_compare`` -- the count of mismatching words of two replica
    streams AND both replicas' 4 x u32 fingerprints (2 reads per word);
  * ``tmr_step``    -- the bitwise 2-of-3 vote, the per-replica counts of
    words that differ from it, and the voted stream's fingerprint (3
    reads and 1 write per word).

The fingerprints are ``state_hash``'s over the same stream, so a caller
that pads its stream as the JAX package does (to a multiple of
``pick_block``) gets the JAX kernels' fingerprints bit for bit.  Streams
are ``int32`` tensors holding u32 bits.  Each wrapper takes its plain
version for CPU tensors only; a CUDA tensor reaches the kernel or an
exception.  ``launches`` on each wrapper counts kernel launches.
"""

from __future__ import annotations

import torch

from .state_hash import launch, on_cpu, state_hash_plain
from .tmr_vote import tmr_vote_plain

#: the JAX package's VMEM-friendly block: 64Ki words = 256 KiB per replica
DEFAULT_BLOCK = 64 * 1024


def pick_block(total_words: int, cap: int = DEFAULT_BLOCK) -> int:
    """Words per grid step for a state of ``total_words`` u32 words: one
    lane-aligned block for small states, the VMEM cap for large ones (the
    flat stream is zero-padded to a multiple of the block).  Copied from
    the JAX package: the padding it sets is part of the fingerprint."""
    if total_words >= cap:
        return cap
    return max(128, -(-total_words // 128) * 128)


def dmr_compare_plain(a: torch.Tensor, b: torch.Tensor):
    """The plain version: (diff () int32, fingerprints (2, 4) int32)."""
    diff = (a != b).sum().to(torch.int32)
    return diff, torch.stack([state_hash_plain(a), state_hash_plain(b)])


def tmr_step_plain(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """The plain version: (voted, counts (3,) int32, fingerprint (4,))."""
    voted, counts = tmr_vote_plain(a, b, c)
    return voted, counts, state_hash_plain(voted)


def dmr_compare(a: torch.Tensor, b: torch.Tensor):
    """(mismatching word count: () int32, fingerprints: (2, 4) int32 of
    u32 bits) over two 1-D int32 replica streams, in one pass."""
    if on_cpu("dmr_compare", [a, b]):
        return dmr_compare_plain(a, b)
    out = launch("dmr_compare", [a, b], None, 9)
    dmr_compare.launches += 1
    return out[0], out[1:].view(2, 4)


def tmr_step(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor):
    """(voted stream, per-replica mismatching-word counts (3,) int32,
    voted fingerprint (4,) int32) over three 1-D int32 replica streams,
    in one pass."""
    if on_cpu("tmr_step", [a, b, c]):
        return tmr_step_plain(a, b, c)
    voted = torch.empty_like(a)
    out = launch("tmr_step", [a, b, c], voted, 7)
    tmr_step.launches += 1
    return voted, out[:3], out[3:]


dmr_compare.launches = 0
tmr_step.launches = 0
