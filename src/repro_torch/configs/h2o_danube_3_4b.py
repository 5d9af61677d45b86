"""H2O Danube3 4B: llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-3-4b",
    n_layers=24,
    d_model=3840,
    n_heads=32,
    n_kv_heads=8,
    d_ff=10240,
    vocab_size=32000,
    window=4096,                # SWA -> runs long_500k
    rope_theta=1e4,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab_size=256, window=32,
    )
