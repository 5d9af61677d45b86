"""Architecture configs (``--arch <id>``) ported so far.

Each module defines ``CONFIG`` (the published configuration, identical to
the JAX package's) and ``reduced()`` (a tiny same-family config for CPU
tests).  Ported so far: the GQA/MLP decoder internlm2-1.8b and the
attention-free Mamba2 (SSD) model mamba2-2.7b.
"""

from __future__ import annotations

import importlib

ARCHS = ["internlm2_1_8b", "mamba2_2_7b"]
CANONICAL = ["internlm2-1.8b", "mamba2-2.7b"]


def _key(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise ValueError(f"arch {name!r} is not ported yet; ported: {CANONICAL}")
    return key


def get_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{_key(name)}").CONFIG


def get_reduced(name: str):
    return importlib.import_module(f"repro_torch.configs.{_key(name)}").reduced()
