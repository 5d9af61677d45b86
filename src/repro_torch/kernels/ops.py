"""The kernels' public entry points: attention and the SSD scan, and
state trees <-> flat u32 word streams with the vote and fingerprint of
whole state trees.

``attention`` and ``ssd`` are the counterparts of ``repro/kernels/ops.py``'s:
the tensor's device picks the route (CUDA -> the hand-written kernel, CPU
-> its plain version); there is no ``pallas=`` switch and no fallback.

The word layer of ``repro/kernels/ops.py`` (JAX): a state tree is packed
into one stream of u32 words, held in an ``int32`` tensor:

  * leaves in JAX order (``repro_torch.tree``: dict keys sorted);
  * ``bool`` as ``uint8`` 0/1;
  * 8- and 16-bit leaves packed 4 or 2 to a word, element 0 in the low
    bits, an odd tail zero-padded to a whole word;
  * 32-bit leaves one word per element, 64-bit leaves as (low, high);
  * the whole stream zero-padded to a ``multiple`` of words.

That is the bytes of each leaf laid end to end, little-endian, which is
what a byte-level ``.view()`` of a contiguous tensor gives on both the
CPU and the card.  The stream is bitwise the JAX package's
``flatten_to_u32``, so the kernels' counts and fingerprints over it are
the JAX kernels'.  (The padding matters: pad words are 0, but their
position weights are not, so they enter the fingerprint.)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional

import numpy as np
import torch

from ..distributed.sharding import Sharded
from ..tree import tree_flatten, tree_leaves, tree_map, tree_unflatten
from .flash_attention import flash_attention
from .ssd_scan import ssd_scan
from .state_hash import state_hash
from .tmr_vote import tmr_vote

Tree = Any

#: words per block of the JAX package's vote and hash wrappers; the stream
#: is padded to a multiple of it
VOTE_BLOCK = 64 * 1024
HASH_BLOCK = 128 * 1024


def attention(q, k, v, *, causal=True, window=None, scale=None, q_offset=0):
    """Blocked attention, q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D), through K7
    (``flash_attention``)."""
    return flash_attention(q, k, v, causal=causal, window=window, scale=scale,
                           q_offset=q_offset)


def ssd(x, dt, a, b, c, *, h0=None, chunk=128):
    """The Mamba2 SSD scan through K8 (``ssd_scan``): (y, final state)."""
    return ssd_scan(x, dt, a, b, c, h0=h0, chunk=chunk)


@dataclasses.dataclass(frozen=True)
class WordLayout:
    """Static u32-word layout of a flattened state tree, computed once per
    (shapes, dtypes) signature: it depends on leaf specs, never values."""

    n_words: tuple[int, ...]  # u32 words per leaf (after sub-word packing)
    offsets: tuple[int, ...]  # word offset of each leaf in the flat stream
    total: int  # unpadded total words

    def padded(self, multiple: int) -> int:
        if multiple <= 1:
            return self.total
        return self.total + (-self.total) % multiple


def _leaf_bits(dtype: torch.dtype) -> int:
    return 8 if dtype == torch.bool else dtype.itemsize * 8


@functools.lru_cache(maxsize=512)
def _word_layout(specs: tuple) -> WordLayout:
    n_words, offsets, off = [], [], 0
    for shape, dtype in specs:
        size = 1
        for d in shape:
            size *= d
        w = -(-size * _leaf_bits(dtype) // 32)
        offsets.append(off)
        n_words.append(w)
        off += w
    return WordLayout(tuple(n_words), tuple(offsets), off)


def word_layout(tree: Tree, *, lead: int = 0) -> WordLayout:
    """Cached u32-word layout of a tree of tensors; ``lead`` leading axes
    of every leaf (a replica axis) are left out of the layout."""
    return _word_layout(tuple((tuple(x.shape[lead:]), x.dtype) for x in tree_leaves(tree)))


def _pack(leaves: list, rows: int, layout: WordLayout, padded: int, device) -> torch.Tensor:
    """(rows, padded) int32 stream: row r holds row r of every leaf."""
    out = torch.empty((rows, padded), dtype=torch.int32, device=device)
    return _pack_into(out, leaves, layout)


def _pack_into(out: torch.Tensor, leaves: list, layout: WordLayout) -> torch.Tensor:
    """Fill the (rows, padded) int32 ``out`` as ``_pack`` does."""
    rows = out.shape[0]
    ob = out.view(torch.uint8)
    for x, off, nw in zip(leaves, layout.offsets, layout.n_words):
        if x.element_size() >= 4:  # whole words: copy 4 bytes per element
            out[:, off : off + nw].copy_(x.reshape(rows, -1).contiguous().view(torch.int32))
            continue
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        b = x.reshape(rows, -1).contiguous().view(torch.uint8)
        lo = 4 * off
        ob[:, lo : lo + b.shape[1]].copy_(b)
        ob[:, lo + b.shape[1] : 4 * (off + nw)].zero_()  # sub-word tail
    ob[:, 4 * layout.total :].zero_()  # the stream's padding
    return out


def flatten_to_u32(
    tree: Tree, *, multiple: int = 1, layout: Optional[WordLayout] = None
) -> torch.Tensor:
    """One int32 word stream holding the tree's bits, zero-padded to a
    multiple of ``multiple`` words (``repro/kernels/ops.py::flatten_to_u32``)."""
    layout = word_layout(tree) if layout is None else layout
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else torch.device("cpu")
    return _pack(leaves, 1, layout, layout.padded(multiple), device)[0]


def flatten_replicas(
    tree: Tree, rows: int, *, multiple: int = 1, layout: Optional[WordLayout] = None
) -> torch.Tensor:
    """(rows, padded) int32: row r is ``flatten_to_u32`` of the tree's
    replica r, for a tree whose leaves lead with a ``rows`` axis.  One
    copy per leaf for all replicas; ``layout`` is one replica's."""
    layout = word_layout(tree, lead=1) if layout is None else layout
    leaves = tree_leaves(tree)
    device = leaves[0].device if leaves else torch.device("cpu")
    return _pack(leaves, rows, layout, layout.padded(multiple), device)


def unflatten_from_u32(
    flat: torch.Tensor, like: Tree, *, layout: Optional[WordLayout] = None
) -> Tree:
    """Inverse of ``flatten_to_u32`` (trailing padding words are ignored):
    the leaves of ``like``'s shapes and dtypes, read from the stream.
    Leaves are views of ``flat`` where the alignment allows."""
    layout = word_layout(like) if layout is None else layout
    leaves, treedef = tree_flatten(like)
    out = []
    for x, off, nw in zip(leaves, layout.offsets, layout.n_words):
        nbytes = x.numel() * (1 if x.dtype == torch.bool else x.element_size())
        u8 = flat[off : off + nw].view(torch.uint8)[:nbytes]
        if x.dtype == torch.bool:
            out.append(u8.to(torch.bool).reshape(x.shape))
            continue
        if u8.storage_offset() % x.element_size():  # a 64-bit leaf at an odd word
            u8 = u8.clone()
        out.append(u8.view(x.dtype).reshape(x.shape))
    return tree_unflatten(treedef, out)


def tmr_vote_pytree(replicated: Tree):
    """Vote a 3-replicated state tree (leaves lead with a replica axis of
    3) through K4.  Returns (voted tree, counts (3,) int32): each
    replica's count of u32 words that differ from the vote."""
    layout = word_layout(replicated, lead=1)
    flats = flatten_replicas(replicated, 3, multiple=VOTE_BLOCK, layout=layout)
    voted, counts = tmr_vote(flats[0], flats[1], flats[2])
    like = tree_map(lambda x: x[0], replicated)
    return unflatten_from_u32(voted, like, layout=layout), counts


def tiebreak_vote(disagreeing: list, third_fn):
    """The §IV tie-break's vote through K4, frugal with memory for a state
    of tens of GB.  ``disagreeing`` is a one-element list holding the
    replicated tree (leaves lead with an axis of 2): its two replicas are
    packed into rows 0-1 of the word streams and the list is emptied, so
    that, when the caller holds no other reference, their memory returns
    before ``third_fn()`` computes the third transition into row 2.  Then
    K4 votes.  Returns (voted tree, counts (3,) int32).

    The vote is by device: each device's distinct blocks (every block of
    a ``Sharded`` leaf that some member holds there, once, and the plain
    leaves on that device) are packed into that device's word streams,
    so a block shared by several members is voted once and nothing
    crosses between devices.  K4 launches = the number of distinct
    devices holding the state (1 for a plain state or a mesh of one
    card); the counts are summed over them."""
    leaves, treedef = tree_flatten(disagreeing[0])
    reps = [[x[r] for x in leaves] for r in (0, 1)]
    del leaves
    pieces, layouts = _pieces(reps[0])
    by_dev: dict = {}
    for p in pieces:
        by_dev.setdefault(_piece(reps[0], *p).device, []).append(p)
    streams = {}
    for dev, ps in by_dev.items():
        ts = [_piece(reps[0], *p) for p in ps]
        layout = word_layout(ts)
        flats = torch.empty((3, layout.padded(VOTE_BLOCK)), dtype=torch.int32, device=dev)
        _pack_into(flats[0:1], ts, layout)
        _pack_into(flats[1:2], [_piece(reps[1], *p) for p in ps], layout)
        likes = [torch.empty(t.shape, dtype=t.dtype, device="meta") for t in ts]
        streams[dev] = (ps, layout, flats, likes)
        del ts
    del reps
    disagreeing.clear()
    third = tree_leaves(third_fn())
    voted, counts = {}, None
    for dev, (ps, layout, flats, likes) in streams.items():
        _pack_into(flats[2:], [_piece(third, *p) for p in ps], layout)
        v, cnt = tmr_vote(flats[0], flats[1], flats[2])
        counts = cnt if counts is None else counts + cnt.to(counts.device)
        for p, t in zip(ps, unflatten_from_u32(v, likes, layout=layout)):
            voted[p] = t
    del third, streams
    out = []
    for i, lay in enumerate(layouts):
        if lay is None:
            out.append(voted[(i, None)])
            continue
        mesh, spec, shape, dtype, owner = lay
        shards = np.empty(owner.shape, dtype=object)
        for c in np.ndindex(*owner.shape):
            shards[c] = voted[(i, owner[c])]
        out.append(Sharded(mesh, spec, shape, dtype, shards))
    return tree_unflatten(treedef, out), counts


def _pieces(leaves: list) -> tuple[list, list]:
    """``tiebreak_vote``'s pieces, ``(leaf, coord)``: each plain leaf
    (coord None) and each distinct block of a ``Sharded`` leaf; and each
    leaf's layout (None for a plain leaf).  A function of its own so
    that no loop variable keeps a replica's leaf alive past it."""
    pieces, layouts = [], []
    for i, x in enumerate(leaves):
        if isinstance(x, Sharded):
            first = {id(t): c for c, t in x.distinct()}
            owner = np.empty(x.shards.shape, dtype=object)
            for c in x.coords():
                owner[c] = first[id(x.local(c))]
            layouts.append((x.mesh, x.spec, x.shape, x.dtype, owner))
            pieces += [(i, c) for c, _ in x.distinct()]
        else:
            layouts.append(None)
            pieces.append((i, None))
    return pieces, layouts


def _piece(leaves: list, i: int, coord):
    x = leaves[i]
    return x if coord is None else x.local(coord)


def fingerprint_fused(state: Tree) -> torch.Tensor:
    """(4,) int32 (u32 bits) fingerprint of a whole state tree in one
    fused pass through K3."""
    return state_hash(flatten_to_u32(state, multiple=HASH_BLOCK))
