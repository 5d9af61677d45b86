"""Leaf-granular read/write sets from FX graphs (the analyzer's foundation).

A MISO transition is a pure function ``prev: dict[cell, state] -> new own
state``.  Tracing it with ``make_fx`` over fake tensors made from
``MisoProgram.state_specs()`` (no FLOPs, no buffers; the JAX package
traces with ``jax.make_jaxpr``) yields an FX graph of aten operators
whose placeholders correspond 1:1 with the flattened leaves of the
*full* program state.  From that we compute, per cell:

  * which leaves of which neighbor states the transition actually
    consumes (a backward liveness walk over the graph),
  * which output leaves are genuinely written vs carried over bit-for-bit
    (an output that *is* the matching own-state placeholder, seen through
    pure aliases),
  * which declared ``reads`` are dead (declared, zero leaves consumed).

The trace follows ``core.cell.abstract_eval``'s conventions: kernel
wrappers take their plain branches on the fake CPU tensors, a real
tensor the transition closes over is a constant (an FX ``get_attr``
node, a jaxpr's constvar), ``core.cell.scan_steps`` evaluates one step
for the whole walk, and ``torch.autograd.grad`` is recorded as the
backward's aten operators.

Where FX differs from a jaxpr, the walk corrects for it:

  * uses that read only metadata are not reads: ``zeros_like``,
    ``empty_like``, ``new_zeros``, ``sym_size`` and the like keep their
    tensor argument as an input in FX, where ``jnp.zeros_like`` leaves it
    out of the jaxpr (unless the argument's shape is data-dependent: then
    its size is data);
  * the graph is not functional: an in-place operator writes the storage
    its ``self`` (or ``out=``) shares with every view of it.  A live node
    reading a storage makes every earlier write into it live;
  * JAX elides a same-shape ``reshape`` and a same-dtype ``astype``; FX
    keeps an ``aten.view``/``alias``/``_to_copy`` node.  Output
    classification looks through such pure aliases; a mutated input is
    never carried.

The liveness walk is deliberately *conservative*: any operator keeps all
of its inputs live unless it is one of the metadata readers above.
Over-approximating "used" means undeclared reads are never missed
(soundness of MISO001) and dead reads are never falsely reported
(deleting a MISO002 read is always safe).
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Any, Mapping

import torch

from ..core.cell import abstract_mode
from ..tree import tree_flatten, tree_paths, tree_unflatten

Pytree = Any

aten = torch.ops.aten


def keystr(path: tuple) -> str:
    """``jax.tree_util.keystr`` of a ``repro_torch.tree`` key path:
    ``"['params']['segments'][0]['attn']['wk']"``."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)


def dtype_name(dtype) -> str:
    """A dtype by JAX's name (``float32``, ``bfloat16``, ``int32``,
    ``uint32``, ``bool``), not ``torch.float32``."""
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# The graph: aliasing, metadata-only uses, backward liveness
# ---------------------------------------------------------------------------

#: operators whose first (tensor) argument contributes only its shape,
#: dtype and device
_META_ONLY = {
    aten.zeros_like, aten.ones_like, aten.empty_like, aten.full_like,
    aten.new_zeros, aten.new_ones, aten.new_empty, aten.new_full,
    aten.new_empty_strided, aten.sym_size, aten.sym_stride, aten.sym_numel,
    aten.sym_storage_offset,
}

#: operators that return their input's value unchanged when the shape,
#: dtype and strides stay (JAX elides the same-shape ``reshape`` and the
#: same-dtype ``astype`` these stand for); ``clone`` is a copy, as
#: ``jnp.copy``'s equation is, and ``detach`` is ``stop_gradient``'s
_PURE_ALIAS = {aten.alias, aten.view, aten._unsafe_view, aten.reshape, aten.expand, aten._to_copy}


def _packet(node):
    t = node.target
    return getattr(t, "overloadpacket", None) if node.op == "call_function" else None


def _schema(node):
    return getattr(node.target, "_schema", None) if node.op == "call_function" else None


def _val(node):
    return node.meta.get("val")


def _static_shape(node) -> bool:
    v = _val(node)
    return isinstance(v, torch.Tensor) and all(isinstance(s, int) for s in v.shape)


def meta_only_arg(node):
    """The argument ``node`` reads for its metadata alone, or None."""
    if _packet(node) in _META_ONLY and node.args:
        a = node.args[0]
        if isinstance(a, torch.fx.Node) and _static_shape(a):
            return a
    return None


def data_inputs(node) -> list:
    """The nodes whose values ``node`` reads (its inputs less the one it
    reads for metadata alone)."""
    skip = meta_only_arg(node)
    return [a for a in node.all_input_nodes if a is not skip]


def _written_args(node) -> list:
    """The nodes an in-place operator (or ``out=``) writes."""
    schema = _schema(node)
    if schema is None:
        return []
    out = []
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        v = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
        for a in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(a, torch.fx.Node):
                out.append(a)
    return out


def _view_base(node):
    """The node whose storage ``node``'s result shares (a view or an
    in-place result), or None."""
    if node.op == "call_function" and node.target is operator.getitem:
        return node.args[0]
    schema = _schema(node)
    if schema is None or not schema.returns or schema.returns[0].alias_info is None:
        return None
    sets = schema.returns[0].alias_info.before_set
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is not None and arg.alias_info.before_set & sets:
            v = node.args[i] if i < len(node.args) else node.kwargs.get(arg.name)
            if isinstance(v, torch.fx.Node):
                return v
    return None


class GraphFacts:
    """Storage groups and the writes into each of an FX graph."""

    def __init__(self, graph: torch.fx.Graph):
        self.nodes = list(graph.nodes)
        self.pos = {n: i for i, n in enumerate(self.nodes)}
        self._parent: dict = {}
        for n in self.nodes:
            base = _view_base(n)
            if base is not None:
                self._union(n, base)
        self.writes: dict = {}
        for n in self.nodes:
            for w in _written_args(n):
                self.writes.setdefault(self.group(w), []).append(n)

    def group(self, n):
        """The representative node of ``n``'s storage."""
        while self._parent.get(n, n) is not n:
            n = self._parent[n]
        return n

    def _union(self, a, b):
        ra, rb = self.group(a), self.group(b)
        if ra is not rb:
            self._parent[ra] = rb

    def writes_before(self, n, reader) -> list:
        """The in-place writes into ``n``'s storage that precede ``reader``."""
        p = self.pos[reader]
        return [w for w in self.writes.get(self.group(n), ()) if self.pos[w] < p]

    def mutated(self, n) -> bool:
        return bool(self.writes.get(self.group(n)))


def live_nodes(graph: torch.fx.Graph, live_out: list[bool], facts: GraphFacts | None = None) -> set:
    """Backward data-flow: the nodes whose value can reach a live output
    (``live_out[i]`` for the output's i-th entry)."""
    facts = facts or GraphFacts(graph)
    live: set = set()
    out_node = next(n for n in reversed(facts.nodes) if n.op == "output")

    def use(n, reader):
        live.add(n)
        live.update(facts.writes_before(n, reader))

    outs = out_node.args[0]
    outs = outs if isinstance(outs, (list, tuple)) else [outs]
    for v, is_live in zip(outs, live_out):
        if is_live and isinstance(v, torch.fx.Node):
            use(v, out_node)
    for n in reversed(facts.nodes):
        if n in live and n.op == "call_function":
            for a in data_inputs(n):
                use(a, n)
    return live


def look_through(node):
    """``node`` seen through pure aliases that keep shape, dtype and
    strides (see ``_PURE_ALIAS``)."""
    while _packet(node) in _PURE_ALIAS and node.args and isinstance(node.args[0], torch.fx.Node):
        src = node.args[0]
        a, b = _val(node), _val(src)
        if not (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)):
            break
        if (a.shape != b.shape or a.dtype != b.dtype or a.device != b.device
                or (a.layout == torch.strided and b.layout == torch.strided and a.stride() != b.stride())):
            break
        node = src
    return node


def state_derived(facts: GraphFacts) -> dict:
    """Forward taint: node -> whether a state placeholder reaches it
    through the values its operators read (an in-place write into a value
    it reads included).  What no state reaches derives only from
    constants."""
    out: dict = {}
    for n in facts.nodes:
        if n.op == "placeholder":
            out[n] = True
        elif n.op == "get_attr":
            out[n] = False
        else:
            out[n] = any(out.get(a, True) or any(out[w] for w in facts.writes_before(a, n))
                         for a in data_inputs(n))
    return out


# ---------------------------------------------------------------------------
# Per-cell access extraction
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class OutLeaf:
    """Classification of one output leaf of a transition."""

    path: str  # keystr within the cell state, e.g. "['cache']['pos']"
    kind: str  # "written" | "carried" | "const"
    shape: tuple[int, ...] = ()
    dtype: str = ""


@dataclasses.dataclass
class CellAccess:
    """Exact leaf-granular access sets of one cell's transition."""

    cell: str
    declared: tuple[str, ...]
    #: cell -> leaf paths of that cell's state actually consumed
    reads: dict[str, tuple[str, ...]]
    #: declared reads with zero consumed leaves (false serialization edges)
    dead_reads: tuple[str, ...]
    #: reads of cells absent from {self} | declared (MISO001 material)
    undeclared: tuple[str, ...]
    out_leaves: tuple[OutLeaf, ...]
    graph: torch.fx.GraphModule = dataclasses.field(repr=False)

    @property
    def read_cells(self) -> tuple[str, ...]:
        """Cells (beside self) with at least one leaf actually consumed."""
        return tuple(c for c in self.reads if c != self.cell)

    @property
    def carried_leaves(self) -> tuple[str, ...]:
        return tuple(o.path for o in self.out_leaves if o.kind == "carried")

    @property
    def written_leaves(self) -> tuple[str, ...]:
        return tuple(o.path for o in self.out_leaves if o.kind != "carried")

    def to_dict(self) -> dict:
        return {
            "cell": self.cell,
            "declared": list(self.declared),
            "reads": {c: list(ps) for c, ps in self.reads.items()},
            "dead_reads": list(self.dead_reads),
            "undeclared": list(self.undeclared),
            "out_leaves": [dataclasses.asdict(o) for o in self.out_leaves],
        }


class TraceFailure(Exception):
    """The transition could not be abstractly evaluated (MISO004)."""


def trace_graph(cell, specs: Mapping[str, Pytree]):
    """``(graph module, output tree)`` of ``cell.transition`` traced over
    fakes of the *full* state ``specs``; the graph's placeholders are the
    state's leaves and its output the new state's, in tree order."""
    leaves, treedef = tree_flatten(dict(specs))
    mode = abstract_mode()
    with mode:
        fakes = [torch.empty(s.shape, dtype=s.dtype, device="cpu") for s in leaves]
    box = {}

    def flat_transition(*xs):
        out = cell.transition(tree_unflatten(treedef, list(xs)))
        box["out"] = out
        return tree_flatten(out)[0]

    from torch.fx.experimental.proxy_tensor import make_fx

    try:
        gm = make_fx(flat_transition, tracing_mode="fake")(*fakes)
    except Exception as e:  # noqa: BLE001 — any trace failure is MISO004
        raise TraceFailure(f"{type(e).__name__}: {e}") from e
    return gm, box["out"]


def trace_cell(cell, specs: Mapping[str, Pytree]) -> CellAccess:
    """Trace ``cell.transition`` against the *full* program state and
    compute its exact leaf-granular access sets.

    ``specs`` maps every cell name to the ``ShapeDtype`` skeleton of its
    state as a transition sees it (``MisoProgram.state_specs()``).
    Passing the full dict (not the restricted view) is what lets
    undeclared reads surface as data-flow facts instead of KeyErrors.
    """
    full = dict(specs)
    gm, out_tree = trace_graph(cell, full)
    graph = gm.graph
    placeholders = [n for n in graph.nodes if n.op == "placeholder"]
    in_paths = tree_paths(full)
    if len(placeholders) != len(in_paths):
        raise TraceFailure(
            f"placeholder/leaf mismatch: {len(placeholders)} placeholders vs "
            f"{len(in_paths)} input leaves"
        )

    # placeholder -> (cell name, leaf path within that cell's state)
    leaf_of = [(path[0], keystr(path[1:])) for path in in_paths]
    facts = GraphFacts(graph)
    out_node = next(n for n in reversed(facts.nodes) if n.op == "output")
    outs = list(out_node.args[0])
    live = live_nodes(graph, [True] * len(outs), facts)

    reads: dict[str, list[str]] = {}
    for (cname, lpath), ph in zip(leaf_of, placeholders):
        if ph in live:
            reads.setdefault(cname, []).append(lpath)

    declared = tuple(cell.reads)
    allowed = {cell.name, *declared}
    undeclared = tuple(sorted(c for c in reads if c not in allowed))
    dead = tuple(c for c in declared if c not in reads)

    # Output leaf classification: an output that *is* (through pure
    # aliases) the placeholder of the matching own-state leaf, never
    # written in place, was carried over bit-for-bit; a 0-d output no
    # state reaches is a constant (JAX folds it into a literal; a shaped
    # constant stays an equation there, so it is "written" in both).
    own_ph = {lpath: ph for (cname, lpath), ph in zip(leaf_of, placeholders) if cname == cell.name}
    derived = state_derived(facts)
    out_paths = [keystr(p) for p in tree_paths(out_tree)]
    out_leaves = []
    for path, v, leaf in zip(out_paths, outs, tree_flatten(out_tree)[0]):
        t = leaf if isinstance(leaf, torch.Tensor) else torch.as_tensor(leaf)
        shape, dtype = tuple(t.shape), dtype_name(t.dtype)
        if not isinstance(v, torch.fx.Node):
            kind = "const"
        else:
            src = look_through(v)
            if own_ph.get(path) is src and not facts.mutated(src):
                kind = "carried"
            elif not shape and not derived[src] and not any(
                    derived[w] for w in facts.writes_before(src, out_node)):
                kind = "const"
            else:
                kind = "written"
        out_leaves.append(OutLeaf(path=path, kind=kind, shape=shape, dtype=dtype))

    return CellAccess(
        cell=cell.name,
        declared=declared,
        reads={c: tuple(ps) for c, ps in reads.items()},
        dead_reads=dead,
        undeclared=undeclared,
        out_leaves=tuple(out_leaves),
        graph=gm,
    )
