"""Architecture configs (``--arch <id>``) ported so far.

Each module defines ``CONFIG`` (the published configuration, identical to
the JAX package's) and ``reduced()`` (a tiny same-family config for CPU
tests).  Ported so far: the GQA/MLP decoders internlm2-1.8b,
granite-20b (MQA, biases, GELU) and command-r-plus-104b (cut by
``command_r_plus_104b.layer_prefix`` to fit one card), the
attention-free Mamba2 (SSD) model mamba2-2.7b, the hybrid zamba2-2.7b
(Mamba2 layers and a weight-shared attention block), the MoE decoder
granite-moe-1b-a400m, and deepseek-v3-671b (MLA and MoE), cut by
``deepseek_v3_671b.dense_prefix`` or ``moe_prefix``.  Not yet:
h2o-danube-3-4b, qwen2-vl-7b, musicgen-large.
"""

from __future__ import annotations

import importlib

ARCHS = ["command_r_plus_104b", "deepseek_v3_671b", "granite_20b", "granite_moe_1b_a400m",
         "internlm2_1_8b", "mamba2_2_7b", "zamba2_2_7b"]
CANONICAL = ["command-r-plus-104b", "deepseek-v3-671b", "granite-20b", "granite-moe-1b-a400m",
             "internlm2-1.8b", "mamba2-2.7b", "zamba2-2.7b"]


def _key(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise ValueError(f"arch {name!r} is not ported yet; ported: {CANONICAL}")
    return key


def get_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{_key(name)}").CONFIG


def get_reduced(name: str):
    return importlib.import_module(f"repro_torch.configs.{_key(name)}").reduced()
