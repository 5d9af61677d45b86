"""The fused per-step redundancy kernels of the ``lockstep_cuda`` back-end
(K1, K2): wrappers of the CUDA kernels in ``csrc/redundancy_epilogue.cu``
and their plain PyTorch versions.

Replace the Pallas kernels ``repro/kernels/fused_step.py::dmr_compare``
and ``::tmr_step`` (TPU), which collapse a replicated cell's whole
dependability epilogue into one pass over the replicas' word streams:

  * ``dmr_compare`` -- the count of mismatching words of two replicas AND
    both replicas' 4 x u32 fingerprints (2 reads per word);
  * ``tmr_step``    -- the bitwise 2-of-3 vote, the per-replica counts of
    words that differ from it, and the voted stream's fingerprint (3
    reads per word, and the voted word written into all 3 replicas of
    the output).

A replica's stream is ``ops.flatten_to_u32`` of its state padded to a
multiple of ``multiple`` words; the fingerprints are ``state_hash``'s over
it, so a caller that pads as the JAX package does (``pick_block``) gets
the JAX kernels' fingerprints bit for bit.  The wrappers take the
replicated state TREE (leaves lead with a replica axis) and read it where
it lies, without the packed copy of ``ops.flatten_replicas``:
``plan_segments`` gives the kernel one segment per leaf, a u32 view of
the replicas' bytes, at the leaf's word offset in the stream, and one
segment of zero words for the padding, so counts and fingerprints are
those of the padded stream.  A leaf whose replica is not a whole number
of aligned words (an odd count of bf16 or int8 values, say), or that is
not contiguous, gets a packed copy of its own.  ``tmr_step`` writes the
voted words straight into the three replicas of the re-replicated output
tree.  A flat stream is a one-leaf tree.

Each wrapper takes its plain version (``*_tree_plain``: the flatten
path) for CPU trees only; a CUDA tree reaches the kernel or an
exception.  ``launches`` on each wrapper counts kernel launches.
"""

from __future__ import annotations

from typing import Any

import torch

from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from . import ops
from .state_hash import Seg, launch_segments, state_hash_plain
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


def dmr_compare_tree_plain(tree: Any, multiple: int, layout=None):
    """The plain version of ``dmr_compare``: flatten, then compare."""
    return dmr_compare_plain(*ops.flatten_replicas(tree, 2, multiple=multiple, layout=layout))


def tmr_step_tree_plain(tree: Any, multiple: int, layout=None):
    """The plain version of ``tmr_step``: flatten, vote, unflatten and
    re-replicate."""
    layout = ops.word_layout(tree, lead=1) if layout is None else layout
    flats = ops.flatten_replicas(tree, 3, multiple=multiple, layout=layout)
    voted, counts, fp = tmr_step_plain(flats[0], flats[1], flats[2])
    one = ops.unflatten_from_u32(voted, tree_map(lambda x: x[0], tree), layout=layout)
    return tree_map(lambda x: x.unsqueeze(0).repeat(3, *([1] * x.dim())), one), counts, fp


# --------------------------------------------------------------------------
# the kernels over a replicated state tree, read in place
# --------------------------------------------------------------------------
def _in_place(x: torch.Tensor, rows: int) -> bool:
    """Can the kernel read (or write) a leaf's replicas where they lie: a
    contiguous leaf whose replica is a whole number of 4-byte-aligned
    words."""
    return x.is_contiguous() and (x.numel() // rows * x.element_size()) % 4 == 0 \
        and x.data_ptr() % 4 == 0


def plan_segments(tree: Any, rows: int, multiple: int, *, vote: bool = False, layout=None):
    """The segments of ``ops.flatten_replicas(tree, rows, multiple=...)``
    read where the leaves lie (``layout``: the tree's word layout with
    ``lead=1``, if the caller has it), as the kernels' C interface takes
    them.  Returns ``(segs, finish)``: ``segs`` a ctypes array of ``Seg``
    (a leaf's replica r is the r-th equal share of its bytes), whose
    pointers stay valid while ``finish`` lives, since it holds the packed
    copies.  ``finish()`` (after the launch) lets them go and, with
    ``vote``, gives the output tree: new leaves of the input's shapes whose
    replicas all hold the voted words (else None)."""
    layout = ops.word_layout(tree, lead=1) if layout is None else layout
    leaves, treedef = tree_flatten(tree)
    plan, held, made = [], [], []
    for x, off, nw in zip(leaves, layout.offsets, layout.n_words):
        src = x if _in_place(x, rows) else ops.flatten_replicas(
            [x], rows, layout=ops.word_layout([x], lead=1))  # a packed copy of this leaf alone
        held.append(src)
        dst = None
        if vote:
            y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
            dst = y if _in_place(y, rows) else torch.empty((rows, nw), dtype=torch.int32,
                                                           device=x.device)
            made.append((y, dst))
        if nw:
            plan.append((src, dst, nw, off))
    pad = layout.padded(multiple) - layout.total
    if pad:
        plan.append((None, None, pad, layout.total))

    segs = (Seg * len(plan))()
    for g, (src, dst, n, off) in zip(segs, plan):
        for t, ptrs in ((src, g.inp), (dst, g.out)):
            if t is not None:
                share = t.numel() // rows * t.element_size()
                for r in range(rows):
                    ptrs[r] = t.data_ptr() + r * share
        g.n, g.off = n, off

    def finish():
        held.clear()  # the launch that reads the packed copies is enqueued: they may go
        if not vote:
            return None
        out = []
        for y, dst in made:
            if dst is not y:  # written packed: unpack
                u8 = dst.view(torch.uint8)[:, : y.numel() // rows * y.element_size()]
                y = u8.contiguous().view(y.dtype).reshape(y.shape)
            out.append(y)
        return tree_unflatten(treedef, out)

    return segs, finish


def _tree_on_cpu(kernel: str, tree: Any, rows: int) -> bool:
    leaves = tree_leaves(tree)
    dev = leaves[0].device
    if any(x.device != dev for x in leaves):
        raise ValueError(f"{kernel}: all leaves must be on one device")
    if any(x.dim() < 1 or x.shape[0] != rows for x in leaves):
        raise ValueError(f"{kernel}: every leaf must lead with a replica axis of {rows}")
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on cuda or cpu, not {dev}")
    return False


def dmr_compare(tree: Any, multiple: int, layout=None):
    """(mismatching word count: () int32, fingerprints: (2, 4) int32 of
    u32 bits) of the two replicas of a state tree (leaves lead with a
    replica axis of 2), as flattened and padded to a multiple of
    ``multiple`` words, in one pass over the leaves where they lie."""
    if _tree_on_cpu("dmr_compare", tree, 2):
        return dmr_compare_tree_plain(tree, multiple, layout)
    segs, finish = plan_segments(tree, 2, multiple, layout=layout)
    out = launch_segments("dmr_compare", segs, tree_leaves(tree)[0].device, 9)
    finish()
    dmr_compare.launches += 1
    return out[0], out[1:].view(2, 4)


def tmr_step(tree: Any, multiple: int, layout=None):
    """(the voted tree re-replicated, with a replica axis of 3; per-replica
    mismatching-word counts (3,) int32; the voted stream's fingerprint
    (4,) int32) of the three replicas of a state tree, in one pass over
    the leaves where they lie."""
    if _tree_on_cpu("tmr_step", tree, 3):
        return tmr_step_tree_plain(tree, multiple, layout)
    segs, finish = plan_segments(tree, 3, multiple, vote=True, layout=layout)
    out = launch_segments("tmr_step", segs, tree_leaves(tree)[0].device, 7)
    tmr_step.launches += 1
    return finish(), out[:3], out[3:]


dmr_compare.launches = 0
tmr_step.launches = 0
