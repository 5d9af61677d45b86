"""Qwen2-VL 7B: GQA kv=4 with M-RoPE (t/h/w sections); the vision tower is
a stub — precomputed patch embeddings are merged into the sequence.
[arXiv:2409.12191; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18944,
    vocab_size=152064,
    mrope_sections=(16, 24, 24),   # t/h/w over head_dim/2 = 64
    rope_theta=1e6,
    use_bias=True,
    n_vision_tokens=256,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, mrope_sections=(4, 2, 2), n_vision_tokens=8,
    )
