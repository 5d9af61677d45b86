"""The MISO textual intermediate language (paper §II, Listing 1).

The port of the JAX package's ``core/ir.py``: programs written in the
paper's concrete syntax parse to an AST, dependencies are extracted *from
the transition expressions themselves* (paper §III: "MISO describes those
dependencies explicitly in the transition function"), and the result
compiles to a :class:`MisoProgram` that this package's back-ends execute:
lock-step, wavefront, or replicated, without changing the source.  The
tokenizer, AST, parser, constant folding and dependency extraction are a
copy of the JAX package's (which imports JAX); only the evaluation of a
transition is written in torch.

Grammar (a superset of Listing 1; ``//`` comments allowed)::

    program    := (celldef | instdef)*
    celldef    := 'cell' NAME '{' vardecl* transition? '}'
    vardecl    := 'var' NAME ':' ('Int'|'Float') ('=' NUMBER)? ';'
    transition := 'transition' '{' stmt* '}'
    stmt       := ('let')? NAME '=' expr ';'
    expr       := term (('+'|'-') term)*
    term       := unary (('*'|'/') unary)*
    unary      := '-' unary | atom postfix*
    atom       := NUMBER | NAME | 'this' | '(' expr ')'
    postfix    := '(' expr ')' | '[' expr ']' | '.' NAME
    instdef    := NAME '=' 'new' NAME '(' expr ')' ';'?

Semantics, per the paper:
  * a bare slot name on the RHS reads the *previous* state of this cell;
  * ``other(idx).slot`` / ``other[idx].slot`` reads the previous state of
    instance-cell ``other`` at index ``idx`` (``this.pos`` = own index);
  * assignments write the *next* state; a slot may be written at most once;
  * unassigned slots carry over (StaticImage's empty transition);
  * ``let`` introduces local variables (explicitly allowed by §II).

Arithmetic follows the JAX package's dtypes: a number literal is a float32
scalar, ``this.pos`` an int32 index vector, ``Int`` slots int32 and
``Float`` slots float32, with JAX's promotion (int32 op float32 ->
float32), so index arithmetic runs in float32 (exact below 2^24
elements).  A read ``other(idx).slot`` truncates ``idx`` to int32, clamps
it into ``[0, n-1]`` and gathers; a write casts to the slot's dtype by
truncation.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Optional

import torch

from .cell import CellType, MisoSemanticsError
from .program import MisoProgram

# --------------------------------------------------------------------------
# tokens
# --------------------------------------------------------------------------
_TOKEN_RE = re.compile(
    r"\s+|//[^\n]*"
    r"|(?P<num>\d+\.\d*|\.\d+|\d+)"
    r"|(?P<name>[A-Za-z_]\w*)"
    r"|(?P<op>[{}()\[\];:=+\-*/.,])"
)


def _tokenize(src: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if not m:
            raise SyntaxError(f"MISO: bad character {src[pos]!r} at {pos}")
        pos = m.end()
        if m.lastgroup:
            out.append((m.lastgroup, m.group()))
    out.append(("eof", ""))
    return out


# --------------------------------------------------------------------------
# AST
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Num:
    value: float


@dataclasses.dataclass
class Name:
    ident: str


@dataclasses.dataclass
class ThisPos:
    pass


@dataclasses.dataclass
class BinOp:
    op: str
    lhs: Any
    rhs: Any


@dataclasses.dataclass
class Neg:
    arg: Any


@dataclasses.dataclass
class CellRef:  # other(idx).slot
    cell: str
    index: Any  # expr or None (aligned: this.pos)
    slot: Optional[str]


@dataclasses.dataclass
class VarDecl:
    name: str
    dtype: str
    default: float


@dataclasses.dataclass
class Assign:
    target: str
    expr: Any
    local: bool


@dataclasses.dataclass
class CellDef:
    name: str
    slots: list[VarDecl]
    body: list[Assign]


@dataclasses.dataclass
class InstDef:
    name: str
    cell: str
    count_expr: Any


# --------------------------------------------------------------------------
# parser
# --------------------------------------------------------------------------
class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        kind, tok = self.next()
        if tok != val:
            raise SyntaxError(f"MISO: expected {val!r}, got {tok!r}")
        return tok

    def accept(self, val) -> bool:
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # expressions ----------------------------------------------------------
    def expr(self):
        node = self.term()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            node = BinOp(op, node, self.term())
        return node

    def term(self):
        node = self.unary()
        while self.peek()[1] in ("*", "/"):
            op = self.next()[1]
            node = BinOp(op, node, self.unary())
        return node

    def unary(self):
        if self.accept("-"):
            return Neg(self.unary())
        return self.postfix(self.atom())

    def atom(self):
        kind, tok = self.next()
        if kind == "num":
            return Num(float(tok))
        if kind == "name":
            if tok == "this":
                self.expect(".")
                kind2, tok2 = self.next()
                if tok2 != "pos":
                    raise SyntaxError("MISO: only this.pos is defined")
                return ThisPos()
            return Name(tok)
        if tok == "(":
            e = self.expr()
            self.expect(")")
            return e
        raise SyntaxError(f"MISO: unexpected token {tok!r}")

    def postfix(self, node):
        while True:
            if self.peek()[1] in ("(", "["):
                close = ")" if self.next()[1] == "(" else "]"
                idx = self.expr()
                self.expect(close)
                if not isinstance(node, Name):
                    raise SyntaxError("MISO: indexing applies to cell names")
                node = CellRef(node.ident, idx, None)
            elif self.peek()[1] == ".":
                self.next()
                kind, slot = self.next()
                if kind != "name":
                    raise SyntaxError("MISO: expected slot name after '.'")
                if isinstance(node, CellRef) and node.slot is None:
                    node = CellRef(node.cell, node.index, slot)
                elif isinstance(node, Name):
                    node = CellRef(node.ident, None, slot)
                else:
                    raise SyntaxError("MISO: bad field access")
            else:
                return node

    # declarations -----------------------------------------------------------
    def celldef(self) -> CellDef:
        self.expect("cell")
        _, name = self.next()
        self.expect("{")
        slots, body = [], []
        while not self.accept("}"):
            if self.peek()[1] == "var":
                self.next()
                _, vname = self.next()
                self.expect(":")
                _, dtype = self.next()
                if dtype not in ("Int", "Float"):
                    raise SyntaxError(f"MISO: unknown type {dtype!r}")
                default = 0.0
                if self.accept("="):
                    e = self.expr()
                    default = _const_eval(e)
                self.expect(";")
                slots.append(VarDecl(vname, dtype, default))
            elif self.peek()[1] == "transition":
                self.next()
                self.expect("{")
                while not self.accept("}"):
                    local = self.accept("let")
                    _, tname = self.next()
                    self.expect("=")
                    e = self.expr()
                    self.expect(";")
                    body.append(Assign(tname, e, local))
            else:
                raise SyntaxError(
                    f"MISO: unexpected {self.peek()[1]!r} in cell body"
                )
        return CellDef(name, slots, body)

    def program(self) -> tuple[list[CellDef], list[InstDef]]:
        cells, insts = [], []
        while self.peek()[0] != "eof":
            if self.peek()[1] == "cell":
                cells.append(self.celldef())
            else:
                _, name = self.next()
                self.expect("=")
                self.expect("new")
                _, cname = self.next()
                self.expect("(")
                count = self.expr()
                self.expect(")")
                self.accept(";")
                insts.append(InstDef(name, cname, count))
        return cells, insts


def _const_eval(node) -> float:
    if isinstance(node, Num):
        return node.value
    if isinstance(node, Neg):
        return -_const_eval(node.arg)
    if isinstance(node, BinOp):
        a, b = _const_eval(node.lhs), _const_eval(node.rhs)
        return {"+": a + b, "-": a - b, "*": a * b, "/": a / b}[node.op]
    raise SyntaxError("MISO: expected a constant expression")


# --------------------------------------------------------------------------
# dependency extraction (§III) + compilation to a MisoProgram
# --------------------------------------------------------------------------
def _extract_reads(body: list[Assign], own_slots: set[str]) -> set[str]:
    reads: set[str] = set()

    def walk(node):
        if isinstance(node, CellRef):
            if node.cell not in own_slots:
                reads.add(node.cell)
            if node.index is not None:
                walk(node.index)
        elif isinstance(node, BinOp):
            walk(node.lhs)
            walk(node.rhs)
        elif isinstance(node, Neg):
            walk(node.arg)

    for stmt in body:
        walk(stmt.expr)
    return reads


_DTYPES = {"Int": torch.int32, "Float": torch.float32}


def parse(src: str) -> tuple[list[CellDef], list[InstDef]]:
    return _Parser(_tokenize(src)).program()


def compile_source(
    src: str,
    inputs: Optional[dict[str, dict[str, Any]]] = None,
) -> MisoProgram:
    """Compile MISO source text into a MisoProgram.

    ``inputs``: optional runtime-loaded initial state per instance
    (paper: "loading input and output data can be performed by the runtime"),
    e.g. ``{"image2": {"r": arr, "g": arr, "b": arr}}``.
    """
    cells, insts = parse(src)
    celldefs = {c.name: c for c in cells}
    inst_count = {}
    inst_cell = {}
    for inst in insts:
        if inst.cell not in celldefs:
            raise MisoSemanticsError(f"MISO: unknown cell type {inst.cell!r}")
        inst_count[inst.name] = int(_const_eval(inst.count_expr))
        inst_cell[inst.name] = celldefs[inst.cell]

    program = MisoProgram()
    inputs = inputs or {}

    for iname, cdef in inst_cell.items():
        n = inst_count[iname]
        own_slots = {v.name for v in cdef.slots}
        reads = _extract_reads(cdef.body, own_slots)
        unknown = reads - set(inst_count)
        if unknown:
            raise MisoSemanticsError(
                f"MISO: instance {iname!r} reads unknown instance(s) {unknown}"
            )

        def make_init(cdef=cdef, iname=iname, n=n):
            def init(generator, device):
                state = {}
                bound = inputs.get(iname, {})
                for v in cdef.slots:
                    if v.name in bound:
                        arr = torch.as_tensor(bound[v.name], dtype=_DTYPES[v.dtype],
                                              device=device)
                        if tuple(arr.shape) != (n,):
                            raise ValueError(
                                f"{iname}.{v.name}: expected shape ({n},), "
                                f"got {tuple(arr.shape)}"
                            )
                        state[v.name] = arr
                    else:
                        state[v.name] = torch.full((n,), v.default,
                                                   dtype=_DTYPES[v.dtype], device=device)
                return state

            return init

        def make_transition(cdef=cdef, iname=iname, n=n):
            own_slots = {v.name for v in cdef.slots}
            dtypes = {v.name: _DTYPES[v.dtype] for v in cdef.slots}

            def transition(prev):
                own = prev[iname]
                local: dict[str, Any] = {}
                written: dict[str, Any] = {}
                device = next(iter(own.values())).device if own else None
                pos = torch.arange(n, dtype=torch.int32, device=device)

                def ev(node):
                    if isinstance(node, Num):
                        # a 0-d float32 host tensor: torch passes it to a
                        # device kernel by value (no copy), and promotes
                        # with JAX's rules (int32 op float32 -> float32)
                        return torch.tensor(node.value, dtype=torch.float32)
                    if isinstance(node, ThisPos):
                        return pos
                    if isinstance(node, Name):
                        if node.ident in local:
                            return local[node.ident]
                        if node.ident in own_slots:
                            return own[node.ident]  # previous state (§II)
                        raise MisoSemanticsError(
                            f"MISO: {iname}: unknown name {node.ident!r}"
                        )
                    if isinstance(node, Neg):
                        return -ev(node.arg)
                    if isinstance(node, BinOp):
                        a, b = ev(node.lhs), ev(node.rhs)
                        if node.op == "+":
                            return a + b
                        if node.op == "-":
                            return a - b
                        if node.op == "*":
                            return a * b
                        return a / b
                    if isinstance(node, CellRef):
                        if node.cell in own_slots:  # own.slot style not allowed
                            raise MisoSemanticsError(
                                f"MISO: {iname}: {node.cell} is a slot"
                            )
                        other = prev[node.cell]
                        if node.slot is None or node.slot not in other:
                            raise MisoSemanticsError(
                                f"MISO: {iname}: bad slot on {node.cell!r}"
                            )
                        arr = other[node.slot]
                        idx = pos if node.index is None else ev(node.index)
                        idx = idx.to(torch.int32).clamp(0, arr.shape[0] - 1)
                        # jnp.take of a 1-D slot: the result has idx's shape
                        flat = idx.reshape(-1).to(arr.device)
                        return arr.index_select(0, flat).reshape(idx.shape)
                    raise TypeError(node)

                for stmt in cdef.body:
                    val = ev(stmt.expr)
                    if stmt.local:
                        local[stmt.target] = val
                    else:
                        if stmt.target not in own_slots:
                            raise MisoSemanticsError(
                                f"MISO: {iname}: write to undeclared slot "
                                f"{stmt.target!r}"
                            )
                        if stmt.target in written:
                            raise MisoSemanticsError(
                                f"MISO: {iname}: slot {stmt.target!r} written "
                                f"twice (writes go to the next state once)"
                            )
                        written[stmt.target] = val.to(dtypes[stmt.target])
                # unassigned slots carry over
                return {
                    v.name: written.get(v.name, own[v.name])
                    for v in cdef.slots
                }

            return transition

        program.add(
            CellType(
                name=iname,
                init=make_init(),
                transition=make_transition(),
                reads=tuple(sorted(reads)),
                instances=n,
            )
        )
    return program


# The paper's Listing 1, verbatim modulo comments (300x200 images).
LISTING_1 = """
cell ImageBlend {
  var r: Int = 0;
  var g: Int = 0;
  var b: Int = 0;
  transition {
    r = .99 * r + .01 * image2(this.pos).r;
    g = .99 * g + .01 * image2(this.pos).g;
    b = .99 * b + .01 * image2(this.pos).b;
  }
}
cell StaticImage {
  var r: Int = 0;
  var g: Int = 0;
  var b: Int = 0;
  transition { }
}
image1 = new ImageBlend(300*200)
image2 = new StaticImage(300*200)
"""
