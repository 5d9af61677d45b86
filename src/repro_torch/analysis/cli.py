"""``python -m repro_torch.analysis`` — the MISO static analyzer CLI.

Examples::

    python -m repro_torch.analysis --list
    python -m repro_torch.analysis serve:gqa train:mamba
    python -m repro_torch.analysis --all --json > analysis.json
    python -m repro_torch.analysis ir:listing1 path/to/prog.miso --dag-out out/
    python -m repro_torch.analysis --all --fail-on warning

The analysis is abstract: transitions are traced on fake CPU tensors, so
it takes no ``--device`` and uses no accelerator memory.

Exit status: nonzero iff any diagnostic at or above ``--fail-on``
(default: ``error``) was emitted, or a program failed to build.
"""

from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys

from .contracts import ProgramAnalysis, analyze_program
from .diagnostics import SEVERITY_ORDER, count_by_severity
from .ir_lint import lint_source
from .registry import ProgramSpec, registry


def _analyze_spec(spec: ProgramSpec) -> ProgramAnalysis:
    """Build + analyze one registry entry (IR entries are AST-linted
    first; a lint error skips the compile, mirroring a real frontend)."""
    diags = []
    if spec.kind == "ir" and spec.source is not None:
        diags = lint_source(spec.source, program=spec.name)
        if any(d.severity == "error" for d in diags):
            return ProgramAnalysis(
                program=spec.name, accesses={}, diagnostics=diags, dag=None
            )
    program = spec.build()
    result = analyze_program(program, name=spec.name)
    result.diagnostics = diags + result.diagnostics
    return result


def _resolve(names: list[str], use_all: bool) -> list[ProgramSpec]:
    reg = registry()
    if use_all:
        return list(reg.values())
    specs = []
    for name in names:
        if name in reg:
            specs.append(reg[name])
            continue
        path = pathlib.Path(name)
        if path.suffix == ".miso" or path.exists():
            from ..core.ir import compile_source

            src = path.read_text()
            specs.append(
                ProgramSpec(
                    name=str(path),
                    kind="ir",
                    build=lambda s=src: compile_source(s),
                    source=src,
                )
            )
            continue
        if ":" in name:
            # dotted.module:factory — a zero-arg callable returning a
            # MisoProgram (how out-of-repo programs reach the analyzer).
            mod_name, _, attr = name.rpartition(":")
            try:
                mod = importlib.import_module(mod_name)
                factory = getattr(mod, attr)
            except (ImportError, AttributeError):
                factory = None
            if factory is not None:
                specs.append(ProgramSpec(name=name, kind="python", build=factory))
                continue
        raise SystemExit(
            f"unknown program {name!r} (not in registry, not a file, not "
            f"an importable module:factory); try --list"
        )
    return specs


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="MISO static analyzer: leaf-granular read/write sets, "
        "contract + parity-hazard diagnostics, refined dependency DAG.  "
        "Abstract: transitions are traced to FX graphs on fake CPU "
        "tensors, so no --device is needed and no accelerator memory is used.",
    )
    ap.add_argument(
        "programs",
        nargs="*",
        help="registry names (see --list), .miso source files, or "
        "dotted.module:factory callables returning a MisoProgram",
    )
    ap.add_argument(
        "--all", action="store_true", help="analyze every registered program"
    )
    ap.add_argument("--list", action="store_true", help="list registered programs")
    ap.add_argument(
        "--json",
        action="store_true",
        help="emit one JSON document on stdout instead of text",
    )
    ap.add_argument(
        "--dag-out",
        metavar="DIR",
        help="write <program>.json and <program>.dot DAG exports here",
    )
    ap.add_argument(
        "--fail-on",
        choices=["error", "warning"],
        default="error",
        help="lowest severity that makes the exit status nonzero",
    )
    ap.add_argument(
        "--verbose",
        action="store_true",
        help="also print info-severity diagnostics",
    )
    args = ap.parse_args(argv)

    if args.list:
        for name, spec in registry().items():
            print(f"{name:24s} [{spec.kind}]")
        return 0
    if not args.programs and not args.all:
        ap.print_usage(sys.stderr)
        print(
            "error: give at least one program, or --all / --list",
            file=sys.stderr,
        )
        return 2

    specs = _resolve(args.programs, args.all)
    threshold = SEVERITY_ORDER[args.fail_on]
    failed = False
    results: list[ProgramAnalysis] = []
    for spec in specs:
        try:
            result = _analyze_spec(spec)
        except Exception as e:  # noqa: BLE001 — surface as a build failure
            print(
                f"error: program {spec.name!r} failed to build: "
                f"{type(e).__name__}: {e}",
                file=sys.stderr,
            )
            failed = True
            continue
        results.append(result)
        if any(SEVERITY_ORDER[d.severity] >= threshold for d in result.diagnostics):
            failed = True

    if args.dag_out:
        out_dir = pathlib.Path(args.dag_out)
        out_dir.mkdir(parents=True, exist_ok=True)
        for result in results:
            if result.dag is None:
                continue
            safe = result.program.replace(":", "_").replace("/", "_")
            (out_dir / f"{safe}.json").write_text(result.dag.to_json())
            (out_dir / f"{safe}.dot").write_text(result.dag.to_dot())

    if args.json:
        doc = {
            "programs": [r.to_dict() for r in results],
            "summary": {
                "n_programs": len(results),
                "counts": count_by_severity(
                    [d for r in results for d in r.diagnostics]
                ),
                "failed": failed,
            },
        }
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 1 if failed else 0

    for result in results:
        shown = 0
        for d in result.diagnostics:
            if d.severity == "info" and not args.verbose:
                continue
            print(d.render())
            shown += 1
        counts = count_by_severity(result.diagnostics)
        m = result.dag.metrics() if result.dag is not None else {}
        bits = [
            f"{m.get('n_cells', len(result.accesses))} cells",
            f"critical path {m.get('critical_path', '?')}",
            f"width {m.get('width', '?')}",
            f"{counts['error']} error(s)",
            f"{counts['warning']} warning(s)",
            f"{counts['info']} info",
        ]
        print(f"{result.program}: " + ", ".join(bits))
    return 1 if failed else 0
