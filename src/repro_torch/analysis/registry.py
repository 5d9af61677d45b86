"""Registry of analyzable in-repo programs.

One name -> one buildable program, so the CLI (and the CI ``analysis``
lane) can enumerate everything the repo ships: train and serve programs
for every model family (reduced configs — the analyzer only needs
shapes), paged-serve variants where the arch supports paging, and the
textual-IR examples.  The names and reduced configs are the JAX
package's, built through the port's own program factories.

Naming scheme::

    train:<family>        make_train_program on the reduced config
    serve:<family>        make_slot_serve_program, dense cache
    serve-paged:<family>  make_slot_serve_program, paged KV cache
    ir:<example>          a textual-MISO listing (linted + compiled)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from ..configs import get_reduced
from ..core.ir import LISTING_1, compile_source
from ..core.program import MisoProgram
from ..data.pipeline import DataConfig
from ..models.lm_cells import (
    ServeConfig,
    TrainConfig,
    make_slot_serve_program,
    make_train_program,
    paged_serving_supported,
)

#: family nickname -> canonical arch id (reduced config)
FAMILIES: dict[str, str] = {
    "gqa": "internlm2-1.8b",
    "mla": "deepseek-v3-671b",
    "mamba": "mamba2-2.7b",
    "zamba": "zamba2-2.7b",
    "vision": "qwen2-vl-7b",
    "windowed": "h2o-danube-3-4b",
    "moe": "granite-moe-1b-a400m",
    "codebook": "musicgen-large",
}

#: two mutually-reading cells: the smallest nontrivial SCC, exercising
#: the condensation path of the DAG export.
PINGPONG = """
cell Ping {
  var v: Float = 1;
  transition { v = 0.5 * v + 0.5 * pong(this.pos).v; }
}
cell Pong {
  var v: Float = 0;
  transition { v = 0.5 * v + 0.5 * ping(this.pos).v; }
}
ping = new Ping(8)
pong = new Pong(8)
"""

#: the 1-D heat stencil from the IR tests: one self-reading cell.
HEAT = """
cell Rod {
  var t: Float = 0;
  transition {
    let left = rod(this.pos - 1).t;
    let right = rod(this.pos + 1).t;
    t = t + 0.25 * (left - 2*t + right);
  }
}
rod = new Rod(64)
"""

IR_SOURCES: dict[str, str] = {
    "listing1": LISTING_1,
    "heat": HEAT,
    "pingpong": PINGPONG,
}


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """One registry entry: a named, buildable program."""

    name: str
    kind: str  # "python" | "ir"
    build: Callable[[], MisoProgram]
    source: Optional[str] = None  # IR text when kind == "ir"


def _train(arch: str) -> Callable[[], MisoProgram]:
    def build() -> MisoProgram:
        cfg = get_reduced(arch)
        tcfg = TrainConfig(
            data=DataConfig(
                batch=2,
                seq_len=16,
                vocab=cfg.vocab_size,
                n_codebooks=cfg.n_codebooks,
            )
        )
        return make_train_program(cfg, tcfg)

    return build


def _serve(arch: str, paged: bool) -> Callable[[], MisoProgram]:
    def build() -> MisoProgram:
        cfg = get_reduced(arch)
        scfg = ServeConfig(batch=2, max_len=32, paged=paged, page_size=8)
        return make_slot_serve_program(cfg, scfg)

    return build


def _ir(src: str) -> Callable[[], MisoProgram]:
    return lambda: compile_source(src)


def registry() -> dict[str, ProgramSpec]:
    """All analyzable programs, keyed by name (stable iteration order)."""
    out: dict[str, ProgramSpec] = {}
    for fam, arch in FAMILIES.items():
        out[f"train:{fam}"] = ProgramSpec(
            name=f"train:{fam}", kind="python", build=_train(arch)
        )
        out[f"serve:{fam}"] = ProgramSpec(
            name=f"serve:{fam}", kind="python", build=_serve(arch, False)
        )
        if paged_serving_supported(get_reduced(arch)):
            out[f"serve-paged:{fam}"] = ProgramSpec(
                name=f"serve-paged:{fam}",
                kind="python",
                build=_serve(arch, True),
            )
    for ex, src in IR_SOURCES.items():
        out[f"ir:{ex}"] = ProgramSpec(
            name=f"ir:{ex}", kind="ir", build=_ir(src), source=src
        )
    return out
