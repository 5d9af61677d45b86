"""Parity-hazard lints: what silently breaks bitwise DMR/TMR (§IV).

The dependability contract of the whole repo is *bitwise* replica
equality: every subsystem's tests compare replicas with ``state_hash`` or
exact tensor equality.  Two classes of transition code break that
contract without ever raising:

  * **Replica-variant PRNG** (MISO101).  A replicated cell's transition
    draws randomness from a key derived only from compile-time constants.
    Every replica then draws the *same* stream every step — the stream is
    not threaded through the replicated state, so it never diverges per
    replica *and* it repeats identically across transitions, making the
    "random" draw a constant and any fault in it undetectable by replica
    comparison.  The blessed pattern is the data cell's: keep the key in
    the cell state and ``prng.split`` it each transition.

    The port draws through ``repro_torch.prng``, whose cipher is one
    operator (``torch.ops.repro_torch.threefry2x32``): a draw whose two
    key words derive only from constants is the hazard, as JAX's
    ``threefry2x32``/``random_bits``/``random_fold_in``/``random_seed``
    equations with constant keys are.  torch's own random operators
    (``rand*``, ``normal``, ``uniform_``, ``bernoulli``, ``multinomial``,
    ...) draw from the process-wide generator, a key no state carries:
    in a replicated cell each of them is the same hazard.
  * **Order-sensitive accumulation** (MISO102).  JAX's rule: a
    ``scatter-add``/``scatter-mul`` with ``unique_indices=False``
    accumulates in an order XLA does not fix across backends/replica
    placements; float non-associativity then produces replica-divergent
    bits.  aten has no ``unique_indices`` promise, so every operator that
    accumulates at indices that may repeat counts:

      - ``index_add`` and ``scatter_add`` (CUDA accumulates with atomics);
      - ``scatter_reduce`` with ``sum``/``prod``/``mean``, ``scatter`` with
        ``reduce="add"``/``"multiply"``, ``index_reduce`` with
        ``prod``/``mean`` (``amax``/``amin`` do not depend on the order);
      - ``index_put``, ``_unsafe_index_put``, ``_index_put_impl_`` and
        ``put`` with ``accumulate=True``;
      - the backward operators that lower to these:
        ``embedding_dense_backward`` and ``_embedding_bag_backward``
        (the gradient of a gather at repeated ids), ``index`` and
        ``gather``'s backward reach the graph as ``index_put``
        (accumulate) / ``scatter_add`` already, and are caught above.

    A write at repeated indices without accumulation (``index_put`` with
    ``accumulate=False``, ``index_copy``, ``scatter``) is not flagged:
    JAX's scatter is not either.

Both are found by a forward constant-taint walk over the FX graph: a
value is *const-tainted* iff it derives only from constants (``get_attr``
nodes, literals, shape arithmetic), never from the transition's state
placeholders.  The graph is flat (``make_fx`` inlines every call), so
every draw and accumulation is visited.
"""

from __future__ import annotations

import torch

from .. import prng  # noqa: F401 -- registers repro_torch::threefry2x32
from .access import CellAccess, GraphFacts, state_derived
from .diagnostics import Diagnostic

aten = torch.ops.aten

#: operator -> indices of its *key* operands (const key => MISO101)
_PRNG_KEY_OPERANDS = {torch.ops.repro_torch.threefry2x32: (0, 1)}

#: torch's generator-backed random operators: always a draw from a key no
#: state carries
_TORCH_RANDOM = {
    aten.rand, aten.rand_like, aten.randn, aten.randn_like, aten.randint,
    aten.randint_like, aten.randperm, aten.normal, aten.normal_, aten.uniform,
    aten.uniform_, aten.bernoulli, aten.bernoulli_, aten.multinomial,
    aten.exponential_, aten.geometric_, aten.cauchy_, aten.log_normal_,
    aten.random_, aten.native_dropout, aten.poisson, aten._standard_gamma,
    aten.rrelu_with_noise,
}

_ALWAYS_ACCUM = {
    aten.index_add, aten.index_add_, aten.scatter_add, aten.scatter_add_,
    aten.embedding_dense_backward, aten._embedding_bag_backward,
}

#: operator -> (argument, the values of it that accumulate)
_ACCUM_IF = {
    aten.scatter_reduce: ("reduce", {"sum", "prod", "mean"}),
    aten.scatter_reduce_: ("reduce", {"sum", "prod", "mean"}),
    aten.scatter: ("reduce", {"add", "multiply"}),
    aten.scatter_: ("reduce", {"add", "multiply"}),
    aten.index_reduce: ("reduce", {"prod", "mean"}),
    aten.index_reduce_: ("reduce", {"prod", "mean"}),
    aten.index_put: ("accumulate", {True}),
    aten.index_put_: ("accumulate", {True}),
    aten._unsafe_index_put: ("accumulate", {True}),
    aten._index_put_impl_: ("accumulate", {True}),
    aten.put: ("accumulate", {True}),
    aten.put_: ("accumulate", {True}),
}


def _arg(node, name):
    """Argument ``name`` of an operator node, its default when not given."""
    if name in node.kwargs:
        return node.kwargs[name]
    for i, a in enumerate(node.target._schema.arguments):
        if a.name == name:
            return node.args[i] if i < len(node.args) else a.default_value
    return None


def classify_node(node, const: dict) -> tuple[str | None, str | None]:
    """``(draw, accumulation)``: the name of the constant-key draw and of
    the order-sensitive accumulation ``node`` is, each or None."""
    if node.op != "call_function":
        return None, None
    packet = getattr(node.target, "overloadpacket", None)
    if packet is None:
        return None, None
    key_ops = _PRNG_KEY_OPERANDS.get(packet)
    if key_ops is not None:
        keys = [node.args[i] for i in key_ops]
        if all(not isinstance(k, torch.fx.Node) or const[k] for k in keys):
            return packet.__name__, None
        return None, None
    if packet in _TORCH_RANDOM:
        return str(packet), None  # "aten.rand"
    if packet in _ALWAYS_ACCUM:
        return None, str(packet)
    rule = _ACCUM_IF.get(packet)
    if rule is not None and _arg(node, rule[0]) in rule[1]:
        return None, str(packet)
    return None, None


def lint_cell(cell, access: CellAccess, program: str = "") -> list[Diagnostic]:
    """Parity-hazard lints over one traced cell.

    MISO101 fires only for replicated cells (level >= 2): an unreplicated
    cell is free to use deterministic constant-key draws (the data
    pipeline's bigram table is the in-repo example); with replicas the
    same pattern silently voids the §IV comparison.
    """
    diags: list[Diagnostic] = []
    replicated = cell.redundancy.level > 1
    graph = access.graph.graph
    const = {n: not d for n, d in state_derived(GraphFacts(graph)).items()}
    const_draws: list[str] = []
    unordered_accums: list[str] = []
    for node in graph.nodes:
        draw, accum = classify_node(node, const)
        if draw:
            const_draws.append(draw)
        if accum:
            unordered_accums.append(accum)

    if replicated and const_draws:
        diags.append(
            Diagnostic(
                code="MISO101",
                program=program,
                cell=cell.name,
                message=(
                    f"replicated cell {cell.name!r} (level "
                    f"{cell.redundancy.level}) draws randomness from a "
                    f"compile-time-constant PRNG key "
                    f"({len(const_draws)} draw(s): "
                    f"{sorted(set(const_draws))})"
                ),
                notes=(
                    "every replica draws the identical stream every step: "
                    "the draw is a constant and replica comparison cannot "
                    "cover it",
                    "thread the key through the cell state and "
                    "prng.split it each transition (see "
                    "repro_torch.data.pipeline for the pattern)",
                ),
                data={"draws": sorted(set(const_draws))},
            )
        )
    if replicated and unordered_accums:
        diags.append(
            Diagnostic(
                code="MISO102",
                program=program,
                cell=cell.name,
                message=(
                    f"replicated cell {cell.name!r} accumulates with "
                    f"{sorted(set(unordered_accums))} and "
                    f"unique_indices=False: accumulation order is "
                    f"backend-chosen, so float non-associativity can "
                    f"diverge replicas bitwise"
                ),
                notes=(
                    "write each index once (index_copy_ with unique "
                    "indices) when indices are provably unique, or "
                    "restructure to a segment-sum with a fixed order",
                ),
                data={"primitives": sorted(set(unordered_accums))},
            )
        )
    return diags
