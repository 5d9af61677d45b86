"""Cohere Command R+ 104B: GQA kv=8, no biases, large vocab.
[hf:CohereForAI/c4ai-command-r-v01; unverified]"""
import dataclasses

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    n_layers=64,
    d_model=12288,
    n_heads=96,
    n_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    rope_theta=75e6,
    use_bias=False,
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=96, n_heads=6, n_kv_heads=2, d_ff=192,
        vocab_size=256,
    )


def layer_prefix(cfg: ModelConfig, n: int) -> ModelConfig:
    """The model's first ``n`` layers at full width (the tied 256000-row
    embedding kept): the cut that fits one card, since the whole model's
    bf16 weights (about 208 GB) do not."""
    if not 1 <= n <= cfg.n_layers:
        raise ValueError(f"layer_prefix: n={n} not in [1, {cfg.n_layers}]")
    return dataclasses.replace(cfg, n_layers=n)
