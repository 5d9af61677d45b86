"""Architecture configs (``--arch <id>``) ported so far.

Each module defines ``CONFIG`` (the published configuration, identical to
the JAX package's) and ``reduced()`` (a tiny same-family config for CPU
tests).  All ten architectures: the GQA/MLP decoders internlm2-1.8b,
granite-20b (MQA, biases, GELU), command-r-plus-104b (cut by
``command_r_plus_104b.layer_prefix`` to fit one card), h2o-danube-3-4b
(sliding window), qwen2-vl-7b (M-RoPE and a stub of precomputed vision
embeddings) and musicgen-large (four codebooks, untied heads), the
attention-free Mamba2 (SSD) model mamba2-2.7b, the hybrid zamba2-2.7b
(Mamba2 layers and a weight-shared attention block), the MoE decoder
granite-moe-1b-a400m, and deepseek-v3-671b (MLA and MoE), cut by
``deepseek_v3_671b.dense_prefix`` or ``moe_prefix``.
"""

from __future__ import annotations

import importlib

ARCHS = ["command_r_plus_104b", "deepseek_v3_671b", "granite_20b", "granite_moe_1b_a400m",
         "h2o_danube_3_4b", "internlm2_1_8b", "mamba2_2_7b", "musicgen_large", "qwen2_vl_7b",
         "zamba2_2_7b"]
CANONICAL = ["command-r-plus-104b", "deepseek-v3-671b", "granite-20b", "granite-moe-1b-a400m",
             "h2o-danube-3-4b", "internlm2-1.8b", "mamba2-2.7b", "musicgen-large", "qwen2-vl-7b",
             "zamba2-2.7b"]


def _key(name: str) -> str:
    key = name.replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise ValueError(f"unknown arch {name!r}; known: {CANONICAL}")
    return key


def get_config(name: str):
    return importlib.import_module(f"repro_torch.configs.{_key(name)}").CONFIG


def get_reduced(name: str):
    return importlib.import_module(f"repro_torch.configs.{_key(name)}").reduced()
