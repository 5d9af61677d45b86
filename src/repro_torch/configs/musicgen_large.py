"""MusicGen-large: decoder-only over EnCodec tokens (4 codebooks,
2048-way each); the EnCodec frontend is a stub — token ids come
precomputed.  [arXiv:2306.05284; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,              # MHA
    d_ff=8192,
    vocab_size=2048,
    mlp_act="gelu",
    n_codebooks=4,
    tie_embeddings=False,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab_size=64, n_codebooks=2,
    )
