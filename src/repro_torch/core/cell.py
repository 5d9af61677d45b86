"""MISO cells: state + transition function (paper §II).

A *cell* is the unit of the MISO intermediate language: a named, typed
state and a transition function from the previous program state to the
cell's next state.  The semantic contract from the paper:

    "there can be only writes to the current state, or local variables.
     Reads can be performed from the previous state of either the current
     cell or any other cell."

A transition is a function ``(prev_states: dict[str, tree]) -> new own
state`` that receives only the states it declared in ``reads`` (plus its
own) and must not write into them: the previous buffer is kept intact
for the §IV replay.  States are nested dicts/lists of tensors with the
same keys, shapes and dtypes as in the JAX package.

``check_single_output`` holds a transition to the single-output
contract without running it: the transition is evaluated on fake
tensors (``abstract_eval``), which carry shapes and dtypes but no data,
the way ``jax.eval_shape`` evaluates it in the JAX package.
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Any, Callable, Mapping

import torch

from ..tree import tree_flatten, tree_map

Tree = Any
Transition = Callable[[Mapping[str, Tree]], Tree]


class MisoSemanticsError(Exception):
    """A cell violates the MISO §II contract (reads/shape/single-output)."""


@dataclasses.dataclass(frozen=True)
class RedundancyPolicy:
    """Paper §IV: runtime-selected replication level for a cell.

    level      -- 1 = none, 2 = DMR (detect + tie-break), 3 = TMR
                  (detect + majority-vote correction).
    placement  -- "temporal": replicas computed on the same device
                  (cost = level x compute).  "spatial": one replica a
                  pod of a device mesh (``backend="spatial_lockstep"``,
                  ``compile(..., mesh=...)``; temporal elsewhere).
    compare    -- "bitwise": full-state bitwise comparison;
                  "hash": 128-bit fingerprint comparison.
    compare_every -- compare replicas every k-th transition.
    """

    level: int = 1
    placement: str = "temporal"
    compare: str = "bitwise"
    compare_every: int = 1

    def __post_init__(self):
        if self.level not in (1, 2, 3):
            raise ValueError(f"redundancy level must be 1|2|3, got {self.level}")
        if self.placement not in ("temporal", "spatial"):
            raise ValueError(f"bad placement {self.placement!r}")
        if self.compare not in ("bitwise", "hash"):
            raise ValueError(f"bad compare mode {self.compare!r}")
        if self.compare_every < 1:
            raise ValueError("compare_every must be >= 1")


NO_REDUNDANCY = RedundancyPolicy(level=1)


@dataclasses.dataclass(frozen=True)
class CellType:
    """One MISO cell type (paper §II).

    name       -- unique cell name within a program.
    init       -- ``(generator: torch.Generator, device) -> state tree``.
    transition -- ``(prev: dict[name, state]) -> new own state``.  ``prev``
                  contains exactly ``{self.name} | set(reads)``.
    reads      -- names of other cells whose *previous* state the
                  transition may read (self-reads are implicit).
    instances  -- informational SIMD width.
    redundancy -- RedundancyPolicy (paper §IV).
    critical   -- marks the cell for selective replication sweeps.
    """

    name: str
    init: Callable[..., Tree]
    transition: Transition
    reads: tuple[str, ...] = ()
    instances: int = 1
    redundancy: RedundancyPolicy = NO_REDUNDANCY
    critical: bool = False

    def __post_init__(self):
        if not self.name.isidentifier():
            raise ValueError(f"cell name {self.name!r} must be an identifier")
        if self.name in self.reads:
            object.__setattr__(
                self, "reads", tuple(r for r in self.reads if r != self.name)
            )

    def with_redundancy(self, policy: RedundancyPolicy) -> "CellType":
        """Selective replication: same cell, different runtime policy (§IV)."""
        return dataclasses.replace(self, redundancy=policy)


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """One leaf of a state spec: the shape and dtype of a tensor (the
    port's ``jax.ShapeDtypeStruct``).  A dataclass, not a tuple, so that
    ``repro_torch.tree`` sees it as a leaf."""

    shape: tuple
    dtype: torch.dtype


def _leaf_spec(x) -> ShapeDtype:
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(x)
    return ShapeDtype(tuple(t.shape), t.dtype)


def state_spec(state: Tree) -> Tree:
    """``ShapeDtype`` skeleton of a state tree, leaf for leaf in
    ``repro_torch.tree`` order."""
    return tree_map(_leaf_spec, state)


def _written_tensors(func, args, kwargs):
    """The tensors an operator writes: its arguments the schema marks
    mutable (``self`` of an in-place op, ``out=``)."""
    for i, arg in enumerate(func._schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        v = args[i] if i < len(args) else kwargs.get(arg.name)
        for t in v if isinstance(v, (list, tuple)) else (v,):
            if isinstance(t, torch.Tensor):
                yield t


class RealWriteError(RuntimeError):
    """An operator under ``abstract_eval`` would write a real tensor."""

    def __init__(self, func):
        super().__init__(f"{func} writes a real tensor the transition closes over")
        self.func = func


def abstract_mode():
    """The fake-tensor mode of ``abstract_eval`` (see there), not yet
    entered: the static analyzer traces transitions to FX graphs over
    fakes made in it."""
    from torch._subclasses.fake_tensor import FakeTensorMode, is_fake
    from torch.fx.experimental.symbolic_shapes import ShapeEnv

    class Mode(FakeTensorMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            for t in _written_tensors(func, args, kwargs or {}):
                if not is_fake(t):
                    raise RealWriteError(func)
            return super().__torch_dispatch__(func, types, args, kwargs)

    return Mode(shape_env=ShapeEnv(), allow_non_fake_inputs=True)


@contextlib.contextmanager
def abstract_eval():
    """Evaluate on fake CPU tensors: shapes and dtypes propagate, nothing
    is computed and no device memory is taken (``jax.eval_shape``'s
    role).  A ``ShapeEnv`` gives data-dependent sizes (``nonzero``) a
    symbol instead of refusing them.  On CPU tensors every kernel wrapper
    takes its plain branch, so no kernel launches.  A real tensor that a
    transition closes over is read as a fake of itself (a constant
    table, a mask), as ``jax.eval_shape`` reads a captured array; an
    operator that would write one raises ``RealWriteError`` and leaves
    it as it was.  A captured CUDA tensor meets the fake CPU state on
    another device and is refused by the operator that mixes them."""
    with abstract_mode():
        yield


def scan_steps(step: Callable[[int, torch.Tensor], torch.Tensor], carry: torch.Tensor,
               n: int) -> list:
    """The carries after each of ``n`` steps ``carry = step(i, carry)``.
    On a fake tensor of ``abstract_eval`` one step is evaluated and
    stands for all ``n``, which fixes the carry's shape and dtype, as
    ``jax.eval_shape`` traces a scan's body once."""
    from torch._subclasses.fake_tensor import is_fake

    if n and is_fake(carry):
        return [step(0, carry)] * n
    out = []
    for i in range(n):
        carry = step(i, carry)
        out.append(carry)
    return out


def _fake(spec: ShapeDtype) -> torch.Tensor:
    return torch.empty(spec.shape, dtype=spec.dtype, device="cpu")


def _structure(td) -> str:
    """A tree structure as text, leaves shown as ``*``."""
    if td == "*":
        return "*"
    kind = td[0]
    if kind == "d":
        return "{" + ", ".join(f"{k!r}: {_structure(c)}" for k, c in zip(td[1], td[2])) + "}"
    if kind in ("l", "t"):
        inner = ", ".join(_structure(c) for c in td[2])
        return f"[{inner}]" if kind == "l" else f"({inner})"
    return "None"


def abstract_error(cell: CellType, err: Exception) -> RuntimeError:
    """A transition that fake tensors cannot evaluate: named with its cell
    and the operator that refused.  ``validate`` does not fall back to a
    real run."""
    op = getattr(err, "func", None)
    if op is None:
        found = re.search(r"aten\.[\w.]+", str(err))
        op = found.group(0) if found else "unknown"
    return RuntimeError(
        f"cell {cell.name!r}: the transition cannot be evaluated abstractly "
        f"(operator {op}): {type(err).__name__}: {err}"
    )


def undeclared_read_error(
    cell: CellType, key: object, available: tuple[str, ...]
) -> MisoSemanticsError:
    """The diagnostic for a transition touching a state it never declared:
    names the offending cell, the undeclared read, and the declared +
    available set."""
    return MisoSemanticsError(
        f"cell {cell.name!r}: transition reads undeclared cell {key!r}.\n"
        f"  declared reads: {list(cell.reads)} (self-reads are implicit)\n"
        f"  available states: {sorted(available)}\n"
        f"  fix: add {key!r} to CellType(name={cell.name!r}, reads=...), or "
        f"delete the access."
    )


def check_single_output(cell: CellType, prev_specs: Mapping[str, Tree]) -> None:
    """MISO single-output invariant: the transition must produce a state
    with exactly the structure, shapes and dtypes of the cell's own state
    (so the double-buffered update is well-formed for every step).  The
    transition runs on fake tensors made from ``prev_specs``, restricted
    to its declared reads."""
    own = prev_specs[cell.name]
    allowed = {cell.name, *cell.reads}
    restricted = {k: v for k, v in prev_specs.items() if k in allowed}
    with abstract_eval():
        try:
            out = state_spec(cell.transition(tree_map(_fake, restricted)))
        except KeyError as e:  # read of an undeclared cell
            raise undeclared_read_error(
                cell, e.args[0] if e.args else e, tuple(restricted)
            ) from None
        except MisoSemanticsError:
            raise
        except Exception as e:  # noqa: BLE001 -- named and re-raised
            raise abstract_error(cell, e) from e
    own_flat, own_def = tree_flatten(own)
    out_flat, out_def = tree_flatten(out)
    if own_def != out_def:
        raise MisoSemanticsError(
            f"cell {cell.name!r}: transition output structure {_structure(out_def)} "
            f"!= state structure {_structure(own_def)}"
        )
    for i, (a, b) in enumerate(zip(own_flat, out_flat)):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise MisoSemanticsError(
                f"cell {cell.name!r}: state leaf {i} drifts across the "
                f"transition: {a.shape}/{a.dtype} -> {b.shape}/{b.dtype}"
            )


def restrict_reads(cell: CellType, states: Mapping[str, Tree]) -> dict:
    """The view of the program state a transition is allowed to see."""
    allowed = {cell.name, *cell.reads}
    return {k: states[k] for k in allowed if k in states}
