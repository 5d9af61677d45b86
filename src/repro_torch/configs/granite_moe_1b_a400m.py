"""IBM Granite 3.0 1B-A400M: 32-expert top-8 MoE, GQA kv=8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
import dataclasses

from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                   # unused (all layers MoE)
    vocab_size=49155,
    mixer_type="moe",
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512,
                  router_act="softmax"),
    tie_embeddings=True,
)


def reduced():
    return dataclasses.replace(
        CONFIG, n_layers=3, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=256,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32,
                      router_act="softmax"),
    )
