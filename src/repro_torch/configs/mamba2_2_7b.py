"""Mamba2 2.7B: attention-free SSD.  [arXiv:2405.21060; unverified]"""

import dataclasses

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    attn_type="none",
    mixer_type="mamba2",
    ssm=SSMConfig(state=128, headdim=64, expand=2, ngroups=1),
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG,
        n_layers=3,
        d_model=64,
        vocab_size=256,
        ssm=SSMConfig(state=16, headdim=8, expand=2, ngroups=1, chunk=16),
    )
