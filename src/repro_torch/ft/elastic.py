"""Fail-stop recovery (the fail-stop half of ``repro/ft/elastic.py``).

What the MISO machinery (``core/redundancy.py``) covers is *silent*
corruption.  A fail-stop (the process or its host dies) is covered by
checkpoints: the ``host`` executor (``compile(prog, backend="host",
checkpoint_cb=ckpt.callback(dir), checkpoint_every=k)``) checkpoints the
immutable previous buffer every k steps; ``elastic_restore`` places the
latest intact checkpoint on a device and ``elastic_resume`` hands it
back to any executor to continue with ``exe.run(states, n,
start_step=step)``.  The data cell's PRNG-keyed stream makes the replay
deterministic, so a resumed run is bitwise an uninterrupted one.

The JAX package re-places the state under a *new* mesh (``new_ctx``,
``pspec_fn``); here a ``device`` takes their place, and a mesh waits for
the multi-device port, as does the straggler half (``spatial_lockstep``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

from ..checkpoint import ckpt
from ..tree import tree_map

Tree = Any


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "restoring onto a device mesh waits for the multi-device port "
            "(ROADMAP Queue 1 item 7)")


def elastic_restore(directory: str, like: Tree, device=None, *, mesh=None,
                    step: Optional[int] = None):
    """Restore a checkpoint into the structure of ``like`` on ``device``
    (None: where ``like``'s leaves are).  Returns (states, step)."""
    _no_mesh(mesh)
    states, step = ckpt.restore(directory, like, step=step)
    if device is not None:
        states = tree_map(lambda x: x.to(device), states)
    return states, step


def elastic_resume(directory: str, exe, *, generator=None, mesh=None,
                   step: Optional[int] = None) -> tuple[Tree, int]:
    """Restore a checkpoint into an executor's state structure on its
    device, ready for ``exe.run(states, n, start_step=step)``.  The
    structure comes from ``exe.init`` (replica axes, optimizer slots and
    all match the policies ``exe`` was compiled with)."""
    _no_mesh(mesh)
    like = exe.init(generator if generator is not None else 0)
    return elastic_restore(directory, like, exe.device, step=step)


@dataclasses.dataclass
class FailureLog:
    events: list = dataclasses.field(default_factory=list)

    def record(self, step: int, kind: str, detail: str = ""):
        self.events.append({"step": step, "kind": kind, "detail": detail, "t": time.time()})
