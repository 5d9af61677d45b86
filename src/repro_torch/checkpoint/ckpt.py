"""Checkpointing keyed on the MISO double buffer (a port of
``repro/checkpoint/ckpt.py``).

MISO transitions read the *previous* state and never write it, so the
previous buffer is a consistent snapshot for free: the ``host`` executor
(``compile(prog, backend="host", checkpoint_cb=callback(dir),
checkpoint_every=k)``) hands it to ``save``, whose file IO may run on a
thread while the next step computes.

The on-disk format is the JAX package's, so a checkpoint written by
either package restores in the other: ``<dir>/step_XXXXXXXX/`` holds one
``.npy`` per leaf (named by its key path) and ``manifest.json`` with the
tree structure, each leaf's name, shape, dtype name and CRC32, committed
by an atomic rename.  Restore verifies every CRC: a corrupted checkpoint
is detected.  numpy has no bfloat16 without ``ml_dtypes``, which this
package does not use: a bf16 leaf is written as its 16-bit words in a
2-byte void dtype (what ``np.save`` makes of JAX's bf16 arrays) under the
manifest dtype ``"bfloat16"``, and read back the same way.

A state laid out on a device mesh (``Sharded`` leaves) is saved as its
global tensors, so its files are the unsharded state's byte for byte (a
leaf whose members hold diverging values, the trainer's error-feedback
buffer, is saved as its first member's, as JAX's host view reads it).
``restore(..., shardings=)`` lays each leaf out by a tree of
``NamedSharding``s, in any mesh shape; without it each leaf is placed as
``like``'s is.
"""

from __future__ import annotations

import json
import pathlib
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from ..distributed.sharding import NamedSharding, Sharded, _flatten_up_to, shard_leaf
from ..tree import tree_flatten, tree_paths, tree_unflatten

Tree = Any

_NP_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
    torch.uint16: "uint16", torch.uint32: "uint32", torch.uint64: "uint64",
    torch.bool: "bool",
}
_TORCH = {v: k for k, v in _NP_NAMES.items()}


def _names(tree: Tree) -> list[str]:
    """Leaf file names: the key path joined by "_" (JAX's naming)."""
    return ["_".join(str(k) for k in path).replace("/", "_") for path in tree_paths(tree)]


def _treedef_str(tree: Tree) -> str:
    """The structure as JAX's ``str(treedef)`` spells it."""

    def spell(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {spell(node[k])}" for k in sorted(node)) + "}"
        if isinstance(node, list):
            return "[" + ", ".join(spell(x) for x in node) + "]"
        if isinstance(node, tuple):
            return "(" + ", ".join(spell(x) for x in node) + ("," if len(node) == 1 else "") + ")"
        return "None" if node is None else "*"

    return f"PyTreeDef({spell(tree)})"


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host array of the leaf's bytes; bf16 as 2-byte void words."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    if t.dtype in (torch.uint16, torch.uint32, torch.uint64):
        signed = {2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
        return t.view(signed).numpy().view(_NP_NAMES[t.dtype])
    return t.numpy()


def _save_npy(path: pathlib.Path, arr: np.ndarray, dtype_name: str) -> None:
    """``np.save``, with a bf16 leaf's header spelled as numpy spells
    JAX's ml_dtypes bfloat16 (``'<V2'``), so both packages write the same
    file byte for byte."""
    if dtype_name != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).reshape(-1).view(np.uint8).data)


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    dtype = _TORCH[dtype_name]
    if dtype == torch.bfloat16 or arr.dtype.kind in "uV":
        signed = {1: np.int8, 2: np.int16, 4: np.int32, 8: np.int64}[arr.dtype.itemsize]
        t = torch.from_numpy(np.ascontiguousarray(arr).view(signed).copy())
        return t.view(dtype)
    return torch.from_numpy(np.ascontiguousarray(arr).copy())


def _crc32(arr: np.ndarray) -> int:
    """CRC32 of the array's bytes in C order (JAX's ``tobytes()``),
    read in place."""
    return zlib.crc32(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def save(directory, step: int, state: Tree, *, blocking: bool = True,
         extra: Optional[dict] = None) -> Optional[threading.Thread]:
    """Write ``state`` to ``<dir>/step_<n>/``.  With ``blocking=False`` the
    device-to-host copy happens now (snapshot semantics) and the file IO
    on a thread, which is returned."""
    d = pathlib.Path(directory) / f"step_{step:08d}"
    d.mkdir(parents=True, exist_ok=True)
    leaves, _ = tree_flatten(state)
    host = [_to_numpy((x.full() if isinstance(x, Sharded) else x).detach().cpu())
            for x in leaves]
    names = _names(state)
    treedef = _treedef_str(state)

    def _write():
        manifest = {"step": step, "treedef": treedef, "leaves": [], "extra": extra or {}}
        for name, leaf, t in zip(names, host, leaves):
            _save_npy(d / f"{name}.npy", leaf, _NP_NAMES[t.dtype])
            manifest["leaves"].append({
                "name": name,
                "shape": list(leaf.shape),
                "dtype": _NP_NAMES[t.dtype],
                "crc32": _crc32(leaf),
            })
        tmp = d / "manifest.json.tmp"
        tmp.write_text(json.dumps(manifest))
        tmp.rename(d / "manifest.json")  # atomic commit

    if blocking:
        _write()
        return None
    t = threading.Thread(target=_write, daemon=True)
    t.start()
    return t


def callback(directory, *, blocking: bool = False):
    """A ``(step, prev_states) -> None`` for the ``checkpoint_cb`` option
    of ``compile(..., backend="host")``.  Non-blocking by default: the
    snapshot is taken in the loop, the file IO on a thread."""

    def cb(step: int, prev_states: Tree) -> None:
        save(directory, step, prev_states, blocking=blocking)

    return cb


def latest_step(directory) -> Optional[int]:
    d = pathlib.Path(directory)
    if not d.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in d.glob("step_*")
             if (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _place(t: torch.Tensor, like, sharding) -> Any:
    """A restored leaf laid out by ``sharding`` (a ``NamedSharding``), or
    as ``like`` is (its spec and mesh, or its device)."""
    if isinstance(sharding, NamedSharding):
        return shard_leaf(t, sharding.spec, sharding.mesh)
    if isinstance(like, Sharded):
        return shard_leaf(t, like.spec, like.mesh)
    return t.to(like.device)


def restore(directory, like: Tree, *, step: Optional[int] = None, shardings=None,
            verify: bool = True) -> tuple[Tree, int]:
    """Restore into the structure of ``like``.  ``shardings``: a tree of
    ``NamedSharding`` (or None, for a leaf placed as ``like``'s) in
    ``like``'s structure, laying each leaf out on its mesh (elastic
    restore onto another mesh shape); without it each leaf is placed as
    ``like``'s: by its spec and mesh if ``Sharded``, else on its
    device."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    d = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    by_name = {m["name"]: m for m in manifest["leaves"]}
    leaves_like, treedef = tree_flatten(like)
    shard_leaves = (_flatten_up_to(like, shardings) if shardings is not None
                    else [None] * len(leaves_like))
    out = []
    for name, leaf, sharding in zip(_names(like), leaves_like, shard_leaves):
        arr = np.load(d / f"{name}.npy")
        meta = by_name[name]
        if verify:
            crc = _crc32(arr)
            if crc != meta["crc32"]:
                raise IOError(f"checkpoint leaf {name} corrupted (crc {crc} != {meta['crc32']})")
        out.append(_place(_from_numpy(arr, meta["dtype"]).reshape(meta["shape"]), leaf, sharding))
    return tree_unflatten(treedef, out), step
