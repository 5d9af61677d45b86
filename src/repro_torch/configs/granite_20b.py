"""IBM Granite 20B (code): MQA (kv=1), GELU MLP.  [arXiv:2405.04324; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-20b",
    n_layers=52,
    d_model=6144,
    n_heads=48,
    n_kv_heads=1,               # MQA
    d_ff=24576,
    vocab_size=49152,
    mlp_act="gelu",
    use_bias=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, d_ff=128,
        vocab_size=256,
    )
