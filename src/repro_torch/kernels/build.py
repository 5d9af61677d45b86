"""Build the CUDA kernels of ``repro_torch/csrc`` with nvcc and load them
with ctypes.

Each ``csrc/<name>.cu`` exports plain C functions (no PyTorch headers, so
a build takes seconds) and compiles into ``_build/lib<name>-<hash>.so``
next to the package, at first use.  The hash covers the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited kernel
rebuilds and a stale library is never loaded.
``build`` starts one nvcc per missing library, all at once.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent.parent
CSRC = PACKAGE / "csrc"
BUILD_DIR = PACKAGE / "_build"

#: sm_90a: Hopper with its architecture-specific instructions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
BUILD_TIMEOUT_S = 600

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin``, or PATH."""
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
        shutil.which("nvcc") or "",
    ):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, Path]:
    """Compile every named kernel whose library is missing, one nvcc per
    source, all running together.  Returns name -> library path; raises
    with nvcc's output when a build fails.  ptxas' register and
    shared-memory report lands in ``<library>.log``."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = {}
    try:
        for n, p in todo.items():
            tmp = p.with_suffix(f".tmp{os.getpid()}")
            cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for n, (tmp, proc) in procs.items():
            log, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            todo[n].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on csrc/{n}.cu:\n{log}")
            os.replace(tmp, todo[n])
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return paths


@functools.cache
def sm_count(device_index: int) -> int:
    """Streaming multiprocessors of a CUDA device; wrappers size grids by it."""
    import torch

    return torch.cuda.get_device_properties(device_index).multi_processor_count


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build([name])[name]))
    return _loaded[name]
