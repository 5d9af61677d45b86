"""Zamba2 2.7B: Mamba2 backbone + weight-shared attention block every 6
layers (input = concat(hidden, original embedding)).  [arXiv:2411.15242; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    attn_type="gqa",
    mixer_type="mamba2",
    ssm=SSMConfig(state=64, headdim=64, expand=2, ngroups=1),
    shared_attn_every=6,
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=256, shared_attn_every=2,
        ssm=SSMConfig(state=16, headdim=8, expand=2, ngroups=1, chunk=16),
    )
