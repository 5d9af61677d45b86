"""Production mesh construction (a port of ``repro/launch/mesh.py``).

The JAX package lays its production meshes over TPU v5e chips (16 x 16
a pod, two pods); this one lays the same axes over the CUDA cards
present:

  single-pod:  (cards/model, model)        axes ("data", "model")
  multi-pod:   (2, cards/2/model, model)   axes ("pod", "data", "model")

The ``pod`` axis leads, as in the JAX package, and carries the MISO
replica axis under spatial placement (``core/backend_spatial.py``).  The
``model`` axis is the tensor-parallel one (``model=1`` by default).
``make_ctx`` binds a mesh into the ``ShardCtx`` the model code reads.
Importing this module touches no device; meshes are built by the
functions only.
"""

from __future__ import annotations

import torch

from ..distributed.mesh import Mesh, make_mesh
from ..distributed.sharding import ShardCtx


def make_production_mesh(*, multi_pod: bool = False, devices=None, model: int = 1) -> Mesh:
    """The production mesh over every CUDA card present (or over
    ``devices``, a flat list, which may repeat a device), ``model`` of
    them a tensor-parallel group.  ``multi_pod`` needs an even number of
    devices: half of them a pod."""
    n = len(devices) if devices is not None else (
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    if n < 1:
        raise ValueError("make_production_mesh needs at least one CUDA device "
                         "(or devices= given explicitly)")
    if multi_pod and n % 2:
        raise ValueError(f"a two-pod mesh needs an even number of devices, got {n}")
    pods = 2 if multi_pod else 1
    if model < 1 or n % (pods * model):
        raise ValueError(f"{n} devices do not split into {pods} pod(s) of model groups of {model}")
    if multi_pod:
        return make_mesh((2, n // (2 * model), model), ("pod", "data", "model"), devices=devices)
    return make_mesh((n // model, model), ("data", "model"), devices=devices)


#: the vocabulary table size (bf16 bytes) past which ``make_ctx``'s
#: ``embed_strategy="auto"`` picks the one-hot embedding
ONEHOT_EMBED_BYTES = 512 * 1024 * 1024


def make_ctx(mesh, *, pod_role: str = "data", fsdp: bool = False,
             embed_strategy: str = "auto", vocab_size: int = 0, d_model: int = 0,
             **kw) -> ShardCtx:
    """The ``ShardCtx`` of ``mesh``: the batch over ``("pod", "data")``
    when the pod axis carries data parallelism (``pod_role="data"``),
    over ``("data",)`` when it carries the MISO replicas; FSDP over the
    data axis with ``fsdp``; the one-hot embedding (``"auto"``) when a
    replicated bf16 table would pass ``ONEHOT_EMBED_BYTES``.  ``kw`` sets
    the other ``ShardCtx`` fields (``decode_shardmap``, ``serve_ep2d``,
    ...)."""
    axes = mesh.axis_names
    data_axes = ("pod", "data") if "pod" in axes and pod_role == "data" else ("data",)
    if embed_strategy == "auto":
        table_bytes = vocab_size * d_model * 2
        embed_strategy = "onehot" if table_bytes > ONEHOT_EMBED_BYTES else "gather"
    return ShardCtx(mesh=mesh, data_axes=data_axes, model_axis="model",
                    fsdp_axes=("data",) if fsdp else (), embed_strategy=embed_strategy, **kw)


def make_spatial_ctx(mesh, **kw) -> ShardCtx:
    """The ``ShardCtx`` of a transition run by a spatial executor: the pod
    axis carries the MISO replicas, and every mesh axis is marked manual
    (in the JAX package the executor's cross-pod ``shard_map`` runs the
    body fully manual, so its constraints must not mention them; here
    ``constrain`` is a no-op either way)."""
    return make_ctx(mesh, pod_role="replica", manual_axes=tuple(mesh.axis_names), **kw)
