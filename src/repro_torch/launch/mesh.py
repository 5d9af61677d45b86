"""Production mesh construction (a port of ``repro/launch/mesh.py``).

The JAX package lays its production meshes over TPU v5e chips (16 x 16
a pod, two pods); this one lays the same axes over the CUDA cards
present:

  single-pod:  (cards, 1)        axes ("data", "model")
  multi-pod:   (2, cards/2, 1)   axes ("pod", "data", "model")

The ``pod`` axis leads, as in the JAX package, and carries the MISO
replica axis under spatial placement (``core/backend_spatial.py``).  The
``model`` axis has size 1 until the model-parallel slice (``ShardCtx``,
``make_ctx``, ``make_spatial_ctx``: ROADMAP item 7b).  Importing this
module touches no device; meshes are built by the function only.
"""

from __future__ import annotations

import torch

from ..distributed.mesh import Mesh, make_mesh


def make_production_mesh(*, multi_pod: bool = False, devices=None) -> Mesh:
    """The production mesh over every CUDA card present (or over
    ``devices``, a flat list, which may repeat a device).  ``multi_pod``
    needs an even number of devices: half of them a pod."""
    n = len(devices) if devices is not None else (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if n < 1:
        raise ValueError("make_production_mesh needs at least one CUDA device "
                         "(or devices= given explicitly)")
    if multi_pod:
        if n % 2:
            raise ValueError(f"a two-pod mesh needs an even number of devices, got {n}")
        return make_mesh((2, n // 2, 1), ("pod", "data", "model"), devices=devices)
    return make_mesh((n, 1), ("data", "model"), devices=devices)
