"""``repro_torch``, ``chip_smoke.py`` and the port's examples
(``examples/*_torch.py``) import no ``jax`` and nothing of the JAX package
``repro`` — not even its JAX-free modules.  Checked twice: statically
(every import statement of every source file), and by importing every
module of the package in a subprocess whose import system refuses
``jax``/``jaxlib``/``repro``."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest

from repro_torch.testing import cap_threads_for_xdist

cap_threads_for_xdist()

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
SOURCES = (sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
           + sorted((ROOT / "examples").glob("*_torch.py")))
MODULES = sorted(
    ".".join(p.relative_to(ROOT / "src").with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)
FORBIDDEN = ("jax", "jaxlib", "repro")


def forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_statement_names_jax_or_repro(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad = [n for n in names if forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


BLOCKER = r"""
import importlib, importlib.abc, importlib.util, json, sys
FORBIDDEN = {"jax", "jaxlib", "repro"}

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in FORBIDDEN:
            raise ImportError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, Block())
out = {}
for mod in json.loads(sys.argv[1]):
    try:
        importlib.import_module(mod)
        out[mod] = "ok"
    except Exception as e:
        out[mod] = f"{type(e).__name__}: {e}"
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[2])
try:
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    out["chip_smoke"] = "ok"
except Exception as e:
    out["chip_smoke"] = f"{type(e).__name__}: {e}"
out["_leaked"] = sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def blocked_imports():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run(
        [sys.executable, "-c", BLOCKER, json.dumps(MODULES), str(ROOT / "chip_smoke.py")],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(ROOT),
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("mod", MODULES + ["chip_smoke"])
def test_module_imports_with_jax_and_repro_blocked(blocked_imports, mod):
    assert blocked_imports[mod] == "ok"


def test_every_kernel_and_model_module_is_checked():
    """The module list is found by globbing the package: the kernel
    wrappers, entry points and models of every slice are in it."""
    for mod in ("repro_torch.kernels.flash_attention", "repro_torch.kernels.ssd_scan",
                "repro_torch.kernels.ops", "repro_torch.kernels.paged_decode",
                "repro_torch.models.ssm", "repro_torch.configs.mamba2_2_7b",
                "repro_torch.configs.deepseek_v3_671b", "repro_torch.prng",
                "repro_torch.data.pipeline", "repro_torch.optim.adamw",
                "repro_torch.checkpoint.ckpt", "repro_torch.ft.elastic",
                "repro_torch.launch.train", "repro_torch.analysis.access",
                "repro_torch.analysis.parity", "repro_torch.analysis.contracts",
                "repro_torch.analysis.dag", "repro_torch.analysis.diagnostics",
                "repro_torch.analysis.ir_lint", "repro_torch.analysis.registry",
                "repro_torch.analysis.cli", "repro_torch.analysis.__main__",
                "repro_torch.distributed.sharding", "repro_torch.distributed.decode",
                "repro_torch.launch.mesh"):
        assert mod in MODULES


def test_nothing_forbidden_reached_sys_modules(blocked_imports):
    assert blocked_imports["_leaked"] == []
