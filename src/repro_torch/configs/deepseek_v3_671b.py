"""DeepSeek-V3 671B: MLA + 256-expert MoE (1 shared + top-8 routed),
61 layers (first 3 dense), MTP head.  [arXiv:2412.19437; hf]

Two cuts keep full width on one card: ``dense_prefix`` (the 3 dense
layers alone, no experts) and ``moe_prefix`` (the 3 dense layers and the
first ``n_moe`` MoE layers, the MTP head as the full model has it)."""

import dataclasses

from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                 # dense-layer FFN (first 3 layers)
    vocab_size=129280,
    attn_type="mla",
    mixer_type="moe",
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048,
                  n_shared_experts=1, router_act="sigmoid",
                  n_dense_layers=3),
    tie_embeddings=False,
    mtp=True,
    rope_theta=1e4,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256,
        mla=MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                      qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16),
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      n_shared_experts=1, router_act="sigmoid",
                      n_dense_layers=1),
    )


def dense_prefix(cfg: ModelConfig) -> ModelConfig:
    """The model's first ``moe.n_dense_layers`` layers alone: MLA attention
    with a dense MLP, no experts (3 layers of the full config)."""
    return dataclasses.replace(cfg, n_layers=cfg.moe.n_dense_layers, mixer_type="mlp", moe=None)


def moe_prefix(cfg: ModelConfig, n_moe: int) -> ModelConfig:
    """The model's ``moe.n_dense_layers`` dense layers followed by its
    first ``n_moe`` MoE layers, every width as published (``n_moe=1``:
    3 dense + 1 MoE layer of 256 experts, 15.11 B parameters)."""
    if not 1 <= n_moe <= cfg.n_layers - cfg.moe.n_dense_layers:
        raise ValueError(f"moe_prefix: n_moe={n_moe} not in [1, "
                         f"{cfg.n_layers - cfg.moe.n_dense_layers}]")
    return dataclasses.replace(cfg, n_layers=cfg.moe.n_dense_layers + n_moe)
