"""Architecture configs (``--arch <id>``) ported so far.

Each module defines ``CONFIG`` (the published configuration, identical to
the JAX package's) and ``reduced()`` (a tiny same-family config for CPU
tests).  Ported so far: the GQA/MLP decoder internlm2-1.8b, the
attention-free Mamba2 (SSD) model mamba2-2.7b, and deepseek-v3-671b,
whose MLA layers are served through ``deepseek_v3_671b.dense_prefix``
(the MoE layers are not ported).
"""

from __future__ import annotations

import importlib

ARCHS = ["deepseek_v3_671b", "internlm2_1_8b", "mamba2_2_7b"]
CANONICAL = ["deepseek-v3-671b", "internlm2-1.8b", "mamba2-2.7b"]


def _key(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise ValueError(f"arch {name!r} is not ported yet; ported: {CANONICAL}")
    return key


def get_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{_key(name)}").CONFIG


def get_reduced(name: str):
    return importlib.import_module(f"repro_torch.configs.{_key(name)}").reduced()
