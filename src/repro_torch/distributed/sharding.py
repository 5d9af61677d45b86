"""Sharding rules: logical axes -> mesh PartitionSpecs, per architecture
(a port of ``repro/distributed/sharding.py``), and the sharded leaf that
holds a tensor laid out by one.

Logical axes used by the model code:
  dp   -- batch-parallel axes (("data",) single-pod; ("pod","data") when the
          pod axis carries data parallelism; just ("data",) when the pod axis
          carries MISO replicas)
  tp   -- tensor-parallel axis ("model"): attention heads, FFN hidden,
          vocabulary, experts
  fsdp -- optional parameter/optimizer sharding over the data axes (ZeRO-3
          style, needed to fit the 671B config)

Rules are name-based over the parameter tree; any dimension whose size does
not divide the assigned mesh axes falls back to replication (e.g. KV heads
when n_kv < |model|).  ``param_pspecs``, ``cache_pspecs`` and
``zero_pspecs`` give the JAX package's specs entry for entry.

The JAX package hands these specs to its partitioner.  This one holds a
sharded leaf as a ``Sharded``: one allocation for each mesh member, on
the member's device, laid out by the spec (``shard`` / ``unshard``).  A
member whose block of the global tensor equals another's on the same
device shares that tensor: a leaf replicated along an axis is one tensor
for each distinct device, so on one card the ``data`` members of a
(2, 4) mesh share one copy of every replicated weight.  The model code
does the work of the partitioner explicitly, by the same specs
(``models/layers.py::matmul``, ``distributed/decode.py``,
``models/moe.py::_moe_spmd``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Optional

import numpy as np
import torch

from ..tree import tree_flatten, tree_paths, tree_unflatten
from . import wire

Pytree = Any


# --------------------------------------------------------------------------
# specs
# --------------------------------------------------------------------------
class PartitionSpec:
    """``jax.sharding.PartitionSpec``: one entry a dimension, each None
    (replicated), an axis name, or a tuple of axis names (first major).
    Trailing dimensions past the entries are replicated.  Not a tuple
    subclass, so a tree of specs has the specs as its leaves; ``tuple(p)``
    gives the entries and a spec equals the tuple of its entries."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, PartitionSpec):
            return self.entries == other.entries
        if isinstance(other, tuple):
            return self.entries == other
        return NotImplemented

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{self.entries!r}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """``jax.sharding.NamedSharding``: a spec bound to a mesh."""

    mesh: Any
    spec: PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Everything the model needs to know about the mesh, or None of it.

    The fields are the JAX package's, and none is silently ignored:

      * ``block_k`` is the prefill's blockwise-attention KV block;
      * ``decode_shardmap`` picks, in JAX, between its partitioner and
        the flash-decoding layout of ``distributed/decode.py``.  The port
        has no partitioner, so a sharded decode cache needs it True (the
        layers raise otherwise), and a layout that neither divides falls
        back to each data member's own rows, as JAX's ``None`` does;
      * ``manual_axes`` are dropped from ``constrain``'s spec, as in JAX;
      * ``remat`` is honoured: with grad enabled ``transformer.forward``
        checkpoints each layer as JAX does (``"full"``: nothing saved,
        ``"dots"``: the outputs of products with no batch dimension
        saved, ``"none"``: every activation kept);
      * ``seq_shard_acts`` is honoured: between the sub-blocks of every
        attention layer (``attn_mlp``, ``attn_moe``) of a forward without
        a decode cache the residual is a ``Sharded`` leaf laid out by
        ``seq_spec`` (Megatron-style sequence parallelism: the batch over
        the data axes, the sequence over the model axis), the normed
        activation gathered before the column-parallel products and the
        row-parallel ones reduce-scattered into it
        (``models/layers.py``);
      * ``pallas`` and ``unroll`` steer JAX's compiler (the port's layers
        run as a Python loop and the kernels are chosen by device).  The
        port does not honour them, and a value other than the default
        raises ``NotImplementedError``.
    """

    mesh: Optional[Any] = None
    data_axes: tuple = ("data",)
    model_axis: str = "model"
    fsdp_axes: tuple = ()            # () = ZeRO-1 only; ("data",) = FSDP
    embed_strategy: str = "gather"   # gather | onehot (vocab-sharded)
    block_k: int = 1024              # blockwise-attention KV block
    seq_shard_acts: bool = False     # Megatron-SP style activation constraint
    remat: str = "full"              # none | full | dots
    pallas: Optional[bool] = None    # kernel path override
    unroll: bool = False             # unroll layer scans
    tp_off: bool = False             # fold the model axis into data parallelism
    decode_shardmap: bool = False    # flash-decoding layout for decode attention
    serve_ep2d: bool = False         # serve layout: experts over (data x model),
                                     # dense/embed TP-only (no fsdp)
    manual_axes: tuple = ()          # mesh axes already manual (JAX: inside an
                                     # enclosing shard_map)

    def __post_init__(self):
        if self.remat not in ("full", "dots", "none"):
            raise ValueError(f"ShardCtx.remat={self.remat!r}: full | dots | none")
        for name, default in _UNHONOURED.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"ShardCtx.{name}={getattr(self, name)!r}: the port does not honour this "
                    f"field (it steers JAX's partitioner or compiler); leave it {default!r}")

    # -- logical -> physical ------------------------------------------------
    def _axes(self, logical) -> Any:
        if logical == "dp":
            axes = self.data_axes
            if self.tp_off:
                axes = axes + (self.model_axis,)
            return axes if len(axes) > 1 else axes[0]
        if logical == "tp":
            return None if self.tp_off else self.model_axis
        if logical == "fsdp":
            if not self.fsdp_axes:
                return None
            return self.fsdp_axes if len(self.fsdp_axes) > 1 else self.fsdp_axes[0]
        return logical

    def pspec(self, *logical) -> PartitionSpec:
        return P(*(self._axes(a) for a in logical))

    def constrain(self, x, *logical):
        """``x`` unchanged.  JAX pins an activation's layout for its
        partitioner here; the port has none to talk to: an activation is
        an ordinary tensor on the controller's device, and passes.  A
        ``Sharded`` leaf is already laid out by a spec, which must equal
        the constraint's (``manual_axes`` dropped from it, as JAX drops
        them, and nothing checked when none is left): an assertion,
        raising ``ValueError`` when they differ."""
        if self.mesh is None or not isinstance(x, Sharded):
            return x
        spec = self.pspec(*logical)
        if self.manual_axes:
            drop = set(self.manual_axes)

            def keep(entry):
                if isinstance(entry, tuple):
                    left = tuple(a for a in entry if a not in drop)
                    return left if len(left) > 1 else (left[0] if left else None)
                return None if entry in drop else entry

            spec = P(*(keep(e) for e in spec))
            if all(e is None for e in spec):
                return x  # nothing left to constrain, as in JAX
        pad = (None,) * max(x.dim() - len(spec), 0)
        want, have = tuple(spec) + pad, tuple(x.spec) + (None,) * max(x.dim() - len(x.spec), 0)
        if want != have:
            raise ValueError(f"constrain{logical}: {x!r} is laid out {tuple(x.spec)}, "
                             f"the constraint says {tuple(spec)}")
        return x

    def axis_size(self, logical: str) -> int:
        if self.mesh is None:
            return 1
        ax = self._axes(logical)
        if ax is None:
            return 1
        if isinstance(ax, tuple):
            return math.prod(self.mesh.shape[a] for a in ax)
        return self.mesh.shape[ax]

    def seq_spec(self, shape) -> Optional[PartitionSpec]:
        """The layout of a (B, S, d) residual under sequence parallelism:
        ``(dp, tp, None)``, an entry dropped to None where its axes do not
        divide the dimension (as ``_physical`` does for weights) and the
        ``manual_axes`` left out of it (as ``constrain`` drops them).  None
        when the model axis does not split S (decode's S = 1, a ragged
        prompt, ``tp_off``): then nothing is laid out."""
        if self.mesh is None:
            return None

        def entry(ax, n):
            axes = tuple(a for a in _entry_axes(ax) if a not in self.manual_axes)
            size = _axes_size(self.mesh, axes) if axes else 1
            if size <= 1 or n % size:
                return None
            return axes if len(axes) > 1 else axes[0]

        tp = entry(self._axes("tp"), shape[1])
        return None if tp is None else P(entry(self._axes("dp"), shape[0]), tp, None)

    def sharding(self, *logical) -> Optional[NamedSharding]:
        if self.mesh is None:
            return None
        return NamedSharding(self.mesh, self.pspec(*logical))


#: the fields the port does not honour, with the defaults it accepts
_UNHONOURED = {"pallas": None, "unroll": False}

LOCAL = ShardCtx()



# --------------------------------------------------------------------------
# parameter rules (matched on the last path component)
# --------------------------------------------------------------------------
def _rule(name: str) -> tuple:
    """Logical spec for the *trailing* dims of the named parameter."""
    table = {
        # embeddings / heads
        "embed": ("tp", None),           # (V, d) vocab-sharded
        "lm_head": (None, "tp"),         # (d, V)
        "mtp_proj": ("fsdp", None),
        # attention
        "wq": ("fsdp", "tp"),
        "wk": ("fsdp", "tp@kv"),         # shard only if kv heads divide
        "wv": ("fsdp", "tp@kv"),
        "wo": ("tp", "fsdp"),
        "bq": ("tp",), "bk": ("tp@kv",), "bv": ("tp@kv",),
        # MLA
        "wq_a": ("fsdp", None),
        "wq_b": (None, "tp"),
        "wkv_a": ("fsdp", None),
        "wkv_b": (None, "tp"),
        # MLP
        "w1": ("fsdp", "tp"),
        "w3": ("fsdp", "tp"),
        "w2": ("tp", "fsdp"),
        # MoE (experts over tp on dim 0; rules applied to trailing 3 dims)
        "router": (None, None),
        # mamba
        "w_z": ("fsdp", "tp"),
        "w_x": ("fsdp", "tp"),
        "w_bc": ("fsdp", None),
        "w_dt": ("fsdp", None),
        "conv_x": (None, "tp"),
        "conv_x_b": ("tp",),
        "conv_bc": (None, None),
        "conv_bc_b": (None,),
        "out_proj": ("tp", "fsdp"),
        "in_proj": ("fsdp", None),       # zamba concat-proj (2d, d)
        "d_skip": (None,), "a_log": (None,), "dt_bias": (None,),
    }
    return table.get(name, ())


_MOE_EXPERT_RULES = {
    "w1": ("tp", "fsdp", None),
    "w3": ("tp", "fsdp", None),
    "w2": ("tp", None, "fsdp"),
}


def _axes_size(mesh, ax) -> int:
    return math.prod(mesh.shape[a] for a in (ax if isinstance(ax, tuple) else (ax,)))


def _map_with_path(fn, tree: Pytree) -> Pytree:
    leaves, treedef = tree_flatten(tree)
    names = [[str(k) for k in path] for path in tree_paths(tree)]
    return tree_unflatten(treedef, [fn(n, x) for n, x in zip(names, leaves)])


def _physical(ctx: ShardCtx, shape, logical) -> PartitionSpec:
    """Logical entries -> mesh axes, an entry dropped to None where its
    axes do not divide the dimension (or have size 1)."""
    phys = []
    for dim, log in zip(shape, logical):
        ax = ctx._axes(log) if log else None
        size = _axes_size(ctx.mesh, ax) if ax is not None else 1
        phys.append(ax if ax is not None and size > 1 and dim % size == 0 else None)
    return P(*phys)


def param_pspecs(ctx: ShardCtx, params: Pytree, cfg=None) -> Pytree:
    """PartitionSpec tree for a parameter tree (stack dims -> None)."""
    mesh = ctx.mesh
    kv_divides = True
    if cfg is not None and mesh is not None:
        kv_divides = cfg.n_kv_heads > 0 and cfg.n_kv_heads % ctx.axis_size("tp") == 0

    def spec_for(names, leaf):
        name = names[-1] if names else ""
        in_moe = any(n in ("experts", "moe") for n in names)
        if ctx.serve_ep2d and in_moe and name in _MOE_EXPERT_RULES:
            # serve layout: one expert (slice) per chip, weights stationary
            ep_axes = tuple(ctx.data_axes) + (ctx.model_axis,)
            if leaf.shape[-3] % _axes_size(mesh, ep_axes) == 0:
                return P(*(None,) * (leaf.dim() - 3), ep_axes, None, None)
        rule = (_MOE_EXPERT_RULES[name] if in_moe and name in _MOE_EXPERT_RULES
                else _rule(name))
        if not rule:
            return P()
        if ctx.serve_ep2d:
            # dense/embed weights: TP only (replicated over data)
            rule = tuple(None if r == "fsdp" else r for r in rule)
        rule = tuple(("tp" if kv_divides else None) if r == "tp@kv" else r for r in rule)
        pad = leaf.dim() - len(rule)
        if pad < 0:
            return P()
        return _physical(ctx, leaf.shape, (None,) * pad + rule)

    return _map_with_path(spec_for, params)


def cache_pspecs(ctx: ShardCtx, cache: Pytree, cfg=None) -> Pytree:
    """Decode-cache sharding: batch over dp; heads/latent over tp when they
    divide; slot_pos tables over dp only."""

    def spec_for(names, leaf):
        name = names[-1] if names else ""
        if name in ("k", "v"):           # (..., B, H, S, D)
            kv_ok = cfg is not None and cfg.n_kv_heads % max(ctx.axis_size("tp"), 1) == 0
            # kv heads shard when they divide; otherwise sequence-shard the
            # cache (flash-decoding partial softmax, distributed/decode.py)
            rule = ("dp", "tp", None, None) if kv_ok else ("dp", None, "tp", None)
        elif name in ("ckv", "krope"):   # (..., B, S, r)
            rule = ("dp", "tp", None)    # sequence-sharded latent
        elif name == "slot_pos":
            rule = ("dp", None)
        elif name == "ssm":              # (..., B, H, N, P)
            rule = ("dp", "tp", None, None)
        elif name == "conv_x":           # (..., B, k-1, C)
            rule = ("dp", None, "tp")
        elif name == "conv_bc":
            rule = ("dp", None, None)
        elif name == "pos":
            rule = ("dp",)
        else:
            return P()
        pad = leaf.dim() - len(rule)
        if pad < 0:
            return P()
        return _physical(ctx, leaf.shape, (None,) * pad + rule)

    return _map_with_path(spec_for, cache)


def _flatten_up_to(structure: Pytree, tree: Pytree) -> list:
    """``tree``'s subtrees at the leaf positions of ``structure``."""
    if isinstance(structure, dict):
        return [x for k in sorted(structure) for x in _flatten_up_to(structure[k], tree[k])]
    if isinstance(structure, (list, tuple)):
        return [x for s, t in zip(structure, tree) for x in _flatten_up_to(s, t)]
    if structure is None:
        return []
    return [tree]


def zero_pspecs(ctx: ShardCtx, param_specs: Pytree, opt_state: Pytree, params: Pytree) -> Pytree:
    """ZeRO-1 sharding for optimizer state: each moment/master leaf takes its
    parameter's spec plus the data axes on the first still-unsharded,
    divisible dimension.  Quantized moments ({"q","scale"}) keep the param
    shape so the same spec applies; scale drops the last dim."""
    mesh = ctx.mesh
    dp = ctx.data_axes
    pleaves, ptree = tree_flatten(params)
    bases = _flatten_up_to(params, param_specs)

    def zspec(shape, base: PartitionSpec) -> PartitionSpec:
        base_t = tuple(base) + (None,) * (len(shape) - len(base))
        used = {a for s in base_t for a in (s if isinstance(s, tuple) else (s,)) if a is not None}
        dp_free = [a for a in (dp if isinstance(dp, tuple) else (dp,)) if a not in used]
        if not dp_free:
            return P(*base_t)   # already fully sharded over the data axes
        free_size = math.prod(mesh.shape[a] for a in dp_free)
        out = list(base_t)
        for i, (dim, s) in enumerate(zip(shape, base_t)):
            if s is None and dim % free_size == 0 and free_size > 1:
                out[i] = tuple(dp_free) if len(dp_free) > 1 else dp_free[0]
                break
        return P(*out)

    def build(tree_m):
        out = []
        for pl, base, leaf in zip(pleaves, bases, _flatten_up_to(params, tree_m)):
            if isinstance(leaf, dict) and "q" in leaf:
                qspec = zspec(pl.shape, base)
                out.append({"q": qspec, "scale": P(*(tuple(qspec)[:-1] + (None,)))})
            else:
                out.append(zspec(leaf.shape, base))
        return tree_unflatten(ptree, out)

    specs = {"step": P(), "m": build(opt_state["m"]), "v": build(opt_state["v"])}
    if "master" in opt_state:
        specs["master"] = build(opt_state["master"])
    return specs


def named(ctx: ShardCtx, pspecs: Pytree) -> Pytree:
    leaves, treedef = tree_flatten(pspecs)
    return tree_unflatten(treedef, [NamedSharding(ctx.mesh, s) for s in leaves])


# --------------------------------------------------------------------------
# the sharded leaf
# --------------------------------------------------------------------------
def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def spec_block(mesh, spec, shape, coord) -> tuple:
    """The block (one slice a dimension) of a global ``shape`` that the
    member at ``coord`` (a mesh-grid index) holds under ``spec``.  An
    entry of several axes splits its dimension first axis major."""
    names = tuple(mesh.axis_names)
    return _spec_block(names, tuple(mesh.shape[a] for a in names), tuple(spec), tuple(shape),
                       tuple(int(c) for c in coord))


@functools.lru_cache(maxsize=1 << 16)
def _spec_block(names, sizes, spec, shape, coord) -> tuple:
    out = []
    for d, n in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        k, idx = 1, 0
        for a in axes:
            i = names.index(a)
            idx = idx * sizes[i] + coord[i]
            k *= sizes[i]
        if n % k:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not divide over {axes}")
        out.append(slice(idx * (n // k), (idx + 1) * (n // k)))
    return tuple(out)


def _key(block: tuple) -> tuple:
    return tuple((s.start, s.stop) for s in block)


def _itemsize(dtype) -> int:
    return 1 if dtype == torch.bool else dtype.itemsize


def _foreign(index: tuple, own: tuple) -> int:
    """Elements of the region ``index`` that the block ``own`` does not
    hold (what a member must receive to assemble it)."""
    n = math.prod(s.stop - s.start for s in index)
    both = math.prod(max(0, min(s.stop, b.stop) - max(s.start, b.start))
                     for s, b in zip(index, own))
    return n - both


class Sharded:
    """A global tensor held as one allocation for each mesh member.

    ``shards`` is an object array of the mesh grid's shape: ``shards[c]``
    is the tensor of member ``c``, on ``mesh.devices[c]``, holding the
    block ``block(c)`` of the global tensor.  Members whose blocks are
    equal and whose devices are the same hold the same tensor object.
    ``shape``/``dtype`` are the global tensor's.  Reading the whole value
    is ``full()``; ``x[i]`` indexes an unsharded leading axis (a stacked
    layer), giving views of the members' tensors."""

    __slots__ = ("mesh", "spec", "shape", "dtype", "shards", "_blocks")

    def __init__(self, mesh, spec, shape, dtype, shards: np.ndarray):
        self.mesh = mesh
        self.spec = P(*tuple(spec)) if not isinstance(spec, PartitionSpec) else spec
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.shards = shards
        self._blocks = None

    # -- tensor-like surface ---------------------------------------------
    @property
    def device(self) -> torch.device:
        return self.mesh.devices.flat[0]

    @property
    def is_cuda(self) -> bool:
        return self.device.type == "cuda"

    def dim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    def __repr__(self) -> str:
        return f"Sharded({tuple(self.shape)}, {self.dtype}, {self.spec!r}, {self.mesh!r})"

    # -- members -----------------------------------------------------------
    def coords(self):
        """Every member's grid index, row-major."""
        return list(np.ndindex(*self.shards.shape))

    def block(self, coord) -> tuple:
        return spec_block(self.mesh, self.spec, self.shape, coord)

    def local(self, coord) -> torch.Tensor:
        return self.shards[tuple(coord)]

    def distinct(self) -> list:
        """``(coord, tensor)`` for each distinct tensor, first member first."""
        seen, out = set(), []
        for c in self.coords():
            t = self.shards[c]
            if id(t) not in seen:
                seen.add(id(t))
                out.append((c, t))
        return out

    def map(self, fn, shape=None, spec=None) -> "Sharded":
        """``fn`` once per distinct tensor (sharing kept), as a new
        ``Sharded`` of global ``shape`` (default: unchanged) and of the
        results' dtype."""
        made: dict = {}
        out = np.empty(self.shards.shape, dtype=object)
        for c in self.coords():
            t = self.shards[c]
            if id(t) not in made:
                made[id(t)] = fn(t)
            out[c] = made[id(t)]
        first = out.flat[0]
        return Sharded(self.mesh, self.spec if spec is None else spec,
                       self.shape if shape is None else shape,
                       first.dtype if isinstance(first, torch.Tensor) else self.dtype, out)

    def __getitem__(self, i):
        """Index ``i`` (an int, or a 0-d integer tensor) of the leading
        axis.  Unsharded there (a stacked layer, a temporal replica
        axis): views of the members' tensors.  Sharded there (a replica
        axis on ``"pod"``): every member takes the view of the member
        that differs from it only along the leading entry's axes and
        holds row ``i`` (pod i's blocks), so the result is laid out by
        the rest of the spec with its tensors where row ``i`` lives."""
        rest = P(*tuple(self.spec)[1:])
        if not len(self.spec) or self.spec[0] is None:
            if not isinstance(i, (int, torch.Tensor)):
                raise TypeError("a Sharded leaf is indexed by an int on its leading axis only")
            return self.map(lambda t: t[i], shape=self.shape[1:], spec=rest)
        i = int(i)
        out, made = np.empty(self.shards.shape, dtype=object), {}
        for c in self.coords():
            for m in self.mesh.members(c, _entry_axes(self.spec[0])):
                lead = self.block(m)[0]
                if lead.start <= i < lead.stop:
                    t = self.shards[m]
                    if (id(t), i) not in made:
                        made[(id(t), i)] = t[i - lead.start]
                    out[c] = made[(id(t), i)]
                    break
        return Sharded(self.mesh, rest, self.shape[1:], self.dtype, out)

    def clone(self) -> "Sharded":
        return self.map(torch.clone)

    def full(self, device=None) -> torch.Tensor:
        """The global tensor on ``device`` (the mesh's first device): a
        replicated leaf is its tensor there, uncopied; a sharded one is
        gathered from one member of each block."""
        dev = self.device if device is None else torch.device(device)
        blocks = {}
        for c in self.coords():
            blocks.setdefault(_key(self.block(c)), (c, self.shards[c]))
        if len(blocks) == 1:
            t = next(iter(blocks.values()))[1]
            return t if t.device == dev else t.to(dev)
        if wire.active():
            wire.record("all-gather", self.numel() * _itemsize(self.dtype), len(blocks),
                        site="full", axes=wire.spec_axes(*self.spec))
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        for key, (_, t) in blocks.items():
            out[tuple(slice(a, b) for a, b in key)] = t.to(dev)
        return out

    def blocks(self) -> list:
        """``(block, tensor)`` for each distinct block of the global
        tensor, from its first member: every element once."""
        if self._blocks is None:
            seen, out = set(), []
            for c in self.coords():
                blk = self.block(c)
                if _key(blk) not in seen:
                    seen.add(_key(blk))
                    out.append((blk, self.shards[c]))
            self._blocks = out
        return list(self._blocks)

    def region(self, index: tuple, coord=None, device=None) -> torch.Tensor:
        """The global region ``index`` (one slice a dimension) on member
        ``coord``'s device (or on ``device``; default the mesh's first):
        a member's own tensor there, uncopied, when its block is exactly
        the region (``coord``'s own first); else assembled there from the
        blocks that cover it."""
        index = tuple(slice(*s.indices(n)[:2]) for s, n in zip(index, self.shape))
        coords = ([tuple(coord)] if coord is not None else []) + self.coords()
        dev = (torch.device(device) if device is not None
               else self.mesh.devices[coords[0]])
        for c in coords:
            if _key(self.block(c)) == _key(index) and self.shards[c].device == dev:
                return self.shards[c]
        if wire.active():
            wire.record("collective-permute",
                        _foreign(index, self.block(coords[0])) * _itemsize(self.dtype), 2,
                        site="region", axes=wire.spec_axes(*self.spec))
        out = torch.empty([s.stop - s.start for s in index], dtype=self.dtype, device=dev)
        for blk, t in self.blocks():
            lo = [max(s.start, b.start) for s, b in zip(index, blk)]
            hi = [min(s.stop, b.stop) for s, b in zip(index, blk)]
            if any(a >= b for a, b in zip(lo, hi)):
                continue
            src = t[tuple(slice(a - b.start, z - b.start) for a, z, b in zip(lo, hi, blk))]
            out[tuple(slice(a - s.start, z - s.start) for a, z, s in zip(lo, hi, index))] = src.to(dev)
        return out


def map_blocks(fn, x: Sharded, *others: Sharded) -> Sharded:
    """``fn(block, t, *others_t)`` once per distinct tensor ``t`` of ``x``
    (``block`` its global slices, ``others_t`` the same member's tensors
    of ``others``, which share ``x``'s layout), as a new ``Sharded`` of
    ``x``'s layout.  A member-wise operation on sharded leaves."""
    made: dict = {}
    out = np.empty(x.shards.shape, dtype=object)
    for c in x.coords():
        t = x.local(c)
        if id(t) not in made:
            made[id(t)] = fn(x.block(c), t, *(o.local(c) for o in others))
        out[c] = made[id(t)]
    return Sharded(x.mesh, x.spec, x.shape, out.flat[0].dtype, out)


def stack(xs, entry=None, *, copy: bool = True) -> "Sharded":
    """``torch.stack`` of ``Sharded`` leaves of one layout along a new
    leading axis laid out by ``entry`` (None: unsharded, every member
    holds every item; a mesh axis such as ``"pod"``: member c holds the
    items of its block of the new axis), member by member; members that
    share every tensor they stack share the stacked one.  With
    ``copy=False`` a block of one item is a view of that item's tensor
    (no copy; a freshly computed replica handed over to its pod)."""
    x0 = xs[0]
    spec = P(entry, *tuple(x0.spec))
    shape = (len(xs),) + tuple(x0.shape)
    made: dict = {}
    out = np.empty(x0.shards.shape, dtype=object)
    for c in x0.coords():
        lead = spec_block(x0.mesh, spec, shape, c)[0]
        ts = [x.local(c) for x in xs[lead.start:lead.stop]]
        key = (lead.start,) + tuple(id(t) for t in ts)
        if key not in made:
            made[key] = ts[0].unsqueeze(0) if len(ts) == 1 and not copy else torch.stack(ts)
        out[c] = made[key]
    return Sharded(x0.mesh, spec, shape, x0.dtype, out)


def reshard(x, spec, mesh=None) -> Sharded:
    """``x`` (a tensor, or a ``Sharded`` leaf of any layout) laid out by
    ``spec`` on ``mesh`` (default: ``x``'s).  From a ``Sharded`` leaf each
    new block is a member's own tensor where its block is already that
    region on that device, else assembled on the member's device from
    the old blocks that cover it: a slice where the new layout divides
    the old (the local half of a reduce-scatter), a concatenation where
    it joins blocks (an all-gather).  Members with equal new blocks on
    one device share one tensor."""
    if not isinstance(x, Sharded):
        return shard_leaf(x, spec, mesh)
    mesh = x.mesh if mesh is None else mesh
    spec = P(*tuple(spec)) if not isinstance(spec, PartitionSpec) else spec
    out = np.empty(mesh.devices.shape, dtype=object)
    made: dict = {}
    moved = 0
    metered = wire.active() and mesh is x.mesh
    for c in np.ndindex(*mesh.devices.shape):
        dev = mesh.devices[c]
        blk = spec_block(mesh, spec, x.shape, c)
        if metered:
            moved += _foreign(blk, x.block(c))
        key = (_key(blk), str(dev))
        if key not in made:
            own = c if mesh is x.mesh else None
            with wire.paused():
                made[key] = x.region(blk, coord=own, device=dev)
        out[c] = made[key]
    if metered:  # every member receives what its own old block does not hold
        wire.record("collective-permute", moved * _itemsize(x.dtype), 2, site="reshard",
                    axes=wire.spec_axes(*x.spec))
    return Sharded(mesh, spec, x.shape, x.dtype, out)


def shard_leaf(x: torch.Tensor, spec, mesh) -> Sharded:
    """``x`` laid out on ``mesh`` by ``spec``: every member's block is its
    own contiguous allocation on the member's device, except that members
    with equal blocks on one device share one tensor, and a fully
    replicated leaf already on a member's device is that tensor itself."""
    spec = P(*tuple(spec)) if not isinstance(spec, PartitionSpec) else spec
    out = np.empty(mesh.devices.shape, dtype=object)
    made: dict = {}
    for c in np.ndindex(*mesh.devices.shape):
        dev = mesh.devices[c]
        blk = spec_block(mesh, spec, x.shape, c)
        key = (_key(blk), str(dev))
        if key not in made:
            whole = all(s.start == 0 and s.stop == n for s, n in zip(blk, x.shape))
            if whole:
                made[key] = x if x.device == dev else x.to(dev)
            else:
                made[key] = x[blk].to(dev, copy=True).contiguous()
        out[c] = made[key]
    return Sharded(mesh, spec, x.shape, x.dtype, out)


def _walk(tree, specs, fn, release: bool):
    """``fn(leaf, spec)`` over a dict/list tree; with ``release`` each of
    ``tree``'s dicts and lists lets go of a leaf once it is mapped."""
    if isinstance(tree, dict):
        out = {}
        for k in list(tree):
            out[k] = _walk(tree[k], specs[k] if specs is not None else None, fn, release)
            if release:
                del tree[k]
        return out
    if isinstance(tree, list):
        out = []
        for i in range(len(tree)):
            out.append(_walk(tree[i], specs[i] if specs is not None else None, fn, release))
            if release:
                tree[i] = None
        return out
    if isinstance(tree, tuple):
        return type(tree)(_walk(t, specs[i] if specs is not None else None, fn, False)
                          for i, t in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, specs)


def shard(tree: Pytree, specs: Pytree, mesh, *, release: bool = False) -> Pytree:
    """``tree`` with every tensor leaf laid out by its spec (``specs`` a
    tree of ``PartitionSpec``s of the same structure) as a ``Sharded``
    on ``mesh``.  ``release=True`` empties ``tree``'s containers as it
    goes, so each full leaf can be freed once sharded: the peak is the
    tree plus one leaf's shards, not twice the tree (a 40 GB model on an
    80 GB card).  ``unshard(shard(t, s, m))`` equals ``t`` bitwise."""
    return _walk(tree, specs, lambda x, s: shard_leaf(x, s, mesh), release)


def unshard(tree: Pytree, device=None) -> Pytree:
    """Every ``Sharded`` leaf of ``tree`` as its global tensor
    (``Sharded.full``) on ``device``; other leaves pass through."""
    return _walk(tree, None, lambda x, _: x.full(device) if isinstance(x, Sharded) else x, False)
