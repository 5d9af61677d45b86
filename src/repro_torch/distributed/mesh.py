"""The device mesh: a named grid of ``torch.device``s driven by one
controller (the counterpart of ``jax.sharding.Mesh`` / ``jax.make_mesh``).

The JAX package is single-controller: its spatial back-end runs one
program over a ``Mesh`` whose ``pod`` axis carries the replicas, and its
tests force eight host devices into one process.  This mesh is the same
shape of thing for PyTorch: one Python process owns every device, each
pod has its own CUDA stream, and the cross-pod collectives
(``collectives.py``) are tensor operations between the pods' own
allocations.

    mesh = make_mesh((2,), ("pod",))                          # two cards
    mesh = make_mesh((2,), ("pod",), devices=["cuda:0"] * 2)  # two pods, one card
    mesh = make_mesh((8,), ("pod",), devices=["cpu"] * 8)     # the tests' eight host devices

``make_mesh`` without ``devices`` takes distinct CUDA cards and raises
when there are too few, as ``jax.make_mesh`` does; several pods on one
card (or on the CPU) happen only when ``devices=`` says so.  On one card
the pods are separate allocations on separate streams: the memory is
duplicated and the transitions run on their own streams, but no byte
crosses a wire between cards.

Within a pod, the members of the other axes (``data``, ``model``) hold
the same value, as in the JAX package's fully manual spatial body; a pod
is computed once, on its first device (``pod_device``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..tree import tree_leaves


def _as_device(d) -> torch.device:
    """A ``torch.device`` with its index: "cuda" names the current card,
    so that it compares equal to the device of a tensor made there."""
    d = d if isinstance(d, torch.device) else torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A grid of devices with named axes.

    devices    -- nested sequences (or an object array) of ``torch.device``
                  or device strings, of the grid's shape.
    axis_names -- one name per grid axis.

    ``.shape[axis]`` is an axis's size, ``.axis_names`` the names and
    ``.devices`` the object array of ``torch.device``s.  The spatial
    back-ends read ``pod_device(p)`` (where pod p's replica lives) and
    ``pod_stream(p)`` (the stream its transitions are issued on; None
    on the CPU).
    """

    def __init__(self, devices, axis_names: Sequence[str]):
        arr = np.asarray(devices, dtype=object)
        axis_names = tuple(axis_names)
        if arr.ndim != len(axis_names):
            raise ValueError(
                f"devices of rank {arr.ndim} do not match the {len(axis_names)} axis "
                f"names {axis_names}")
        if len(set(axis_names)) != len(axis_names):
            raise ValueError(f"axis names must be distinct, got {axis_names}")
        self.devices = np.vectorize(_as_device, otypes=[object])(arr) if arr.size else arr
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, arr.shape))
        self._streams: dict[int, Optional[torch.cuda.Stream]] = {}

    def pod_device(self, p: int, axis: str = "pod") -> torch.device:
        """The first device of member ``p`` of ``axis``: where pod p's
        replica of a spatial cell lives and its transition runs."""
        idx = [0] * self.devices.ndim
        idx[self.axis_names.index(axis)] = p
        return self.devices[tuple(idx)]

    def home(self, axis: str = "pod") -> torch.device:
        """The controller's device: pod 0's (the mesh's first device when
        it has no ``axis``).  Cells that are not placed spatially, and the
        collectives' reductions, live here."""
        return self.pod_device(0, axis) if axis in self.axis_names else self.devices.flat[0]

    def pod_stream(self, p: int, axis: str = "pod") -> Optional[torch.cuda.Stream]:
        """The CUDA stream pod ``p``'s work is issued on (made on first
        use, one per pod even when pods share a card); None on the CPU."""
        if p not in self._streams:
            dev = self.pod_device(p, axis)
            self._streams[p] = torch.cuda.Stream(device=dev) if dev.type == "cuda" else None
        return self._streams[p]

    @contextlib.contextmanager
    def on_pod(self, p: int, reads=(), axis: str = "pod"):
        """Run the enclosed work on pod ``p``'s stream.  The stream first
        waits for the current streams of the controller's device and of
        its own, so it sees every input made there, and the CUDA tensors
        of ``reads`` (a tree) are marked as in use by it
        (``record_stream``), so the caching allocator does not hand their
        memory to another tensor while the pod still reads them.  On the
        CPU nothing changes."""
        s = self.pod_stream(p, axis)
        if s is None:
            yield
            return
        for dev in {self.home(axis), s.device}:
            s.wait_stream(torch.cuda.current_stream(dev))
        for x in tree_leaves(reads):
            if isinstance(x, torch.Tensor) and x.device == s.device:
                x.record_stream(s)
        with torch.cuda.stream(s):
            yield

    def collect(self, p: int, tree=None, axis: str = "pod"):
        """Order the controller after pod ``p``: the current streams of the
        controller's device and of the pod's wait for the pod's stream
        (an event wait, no host synchronisation), and the CUDA tensors of
        ``tree`` are marked as in use by them.  Call it before the
        controller reads what pod p made; an adopted straggler step never
        calls it for the slow pod.  Returns ``tree``."""
        s = self.pod_stream(p, axis)
        if s is None:
            return tree
        for dev in {self.home(axis), s.device}:
            cur = torch.cuda.current_stream(dev)
            cur.wait_stream(s)
            for x in tree_leaves(tree):
                if isinstance(x, torch.Tensor) and x.device == dev:
                    x.record_stream(cur)
        return tree

    def __repr__(self) -> str:
        grid = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({grid}; devices={[str(d) for d in self.devices.flat]})"


def make_mesh(shape: Sequence[int], axes: Sequence[str], *, devices=None) -> Mesh:
    """A mesh of ``shape`` with axis names ``axes``.

    With ``devices=None`` the mesh takes the first ``prod(shape)`` distinct
    CUDA cards and raises when there are fewer, as ``jax.make_mesh`` does:
    nothing is placed on the CPU or twice on one card unless the caller
    asks.  ``devices=`` (a flat sequence of ``prod(shape)`` devices or
    device strings, laid out in row-major order) may repeat a device:
    ``["cuda:0"] * 3`` is three pods on one card, ``["cpu"] * 8`` the
    counterpart of eight forced host devices."""
    shape = tuple(int(n) for n in shape)
    if len(shape) != len(tuple(axes)):
        raise ValueError(f"shape {shape} and axes {tuple(axes)} differ in length")
    n = math.prod(shape)
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n:
            raise ValueError(
                f"make_mesh{shape} needs {n} distinct CUDA devices but {have} are present; "
                f"to place several pods on one card or on the CPU pass devices= explicitly, "
                f"e.g. devices=['cuda:0'] * {n} or ['cpu'] * {n}")
        devices = [torch.device("cuda", i) for i in range(n)]
    devices = [_as_device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"make_mesh{shape} needs {n} devices, got {len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axes)
