"""Model configuration dataclasses (a port of ``repro/models/config.py``).

The dataclasses are the JAX package's, field for field, so a config
means the same model in both packages; ``compute_dtype`` returns a
``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


_DTYPES = {
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float32": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style multi-head latent attention dims."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0       # deepseek shared expert(s)
    router_act: str = "softmax"     # softmax | sigmoid (deepseek v3)
    capacity_factor: float = 1.25
    aux_coef: float = 0.001
    n_dense_layers: int = 0         # first-k layers stay dense (deepseek: 3)


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 128      # N
    headdim: int = 64     # P
    expand: int = 2
    ngroups: int = 1
    conv_kernel: int = 4
    chunk: int = 128
    dt_min: float = 0.001
    dt_max: float = 0.1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int                  # query heads (0 for attention-free)
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 -> d_model // n_heads
    # per-layer block structure
    attn_type: str = "gqa"        # gqa | mla | none
    mixer_type: str = "mlp"       # mlp | moe | mamba2
    mlp_act: str = "swiglu"       # swiglu | gelu
    # attention details
    window: Optional[int] = None  # sliding-window attention (SWA)
    rope_theta: float = 1e4
    mrope_sections: Optional[tuple[int, ...]] = None  # qwen2-vl M-RoPE
    use_bias: bool = False
    # sub-configs
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): shared attention block applied every k mamba layers
    shared_attn_every: int = 0
    # heads / embeddings
    n_codebooks: int = 1          # musicgen: 4 EnCodec codebooks
    tie_embeddings: bool = True
    # modality stubs
    n_vision_tokens: int = 0      # qwen2-vl: precomputed patch embeds
    # numerics
    dtype: str = "bfloat16"
    rms_eps: float = 1e-5
    # multi-token prediction (deepseek) — extra head predicting t+2
    mtp: bool = False

    # ---- derived ----------------------------------------------------------
    @property
    def head_dim(self) -> int:
        if self.d_head:
            return self.d_head
        if self.attn_type == "mla":
            return (self.mla or MLAConfig()).qk_nope_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def compute_dtype(self) -> torch.dtype:
        return _DTYPES[self.dtype]

    @property
    def d_inner(self) -> int:
        return (self.ssm.expand if self.ssm else 2) * self.d_model

    def n_params(self) -> float:
        """Approximate total parameter count (for roofline MODEL_FLOPS)."""
        return _count_params(self)

    def n_active_params(self) -> float:
        """Active-per-token parameters (MoE: shared + top_k experts)."""
        return _count_params(self, active_only=True)


def _mlp_params(d_model: int, d_ff: int, act: str) -> float:
    return d_model * d_ff * (3 if act == "swiglu" else 2)


def _attn_params(cfg: ModelConfig) -> float:
    d = cfg.d_model
    if cfg.attn_type == "none":
        return 0.0
    if cfg.attn_type == "mla":
        m = cfg.mla or MLAConfig()
        h = cfg.n_heads
        qk = m.qk_nope_dim + m.qk_rope_dim
        return (
            d * m.q_lora_rank + m.q_lora_rank * h * qk          # q path
            + d * (m.kv_lora_rank + m.qk_rope_dim)              # kv down
            + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
            + h * m.v_head_dim * d                              # out proj
        )
    dh = cfg.head_dim
    return d * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)


def _mamba_params(cfg: ModelConfig) -> float:
    s = cfg.ssm or SSMConfig()
    d, di = cfg.d_model, cfg.d_inner
    h = di // s.headdim
    conv_dim = di + 2 * s.ngroups * s.state
    return (
        d * (2 * di + 2 * s.ngroups * s.state + h)  # in_proj (z,x,B,C,dt)
        + conv_dim * s.conv_kernel                  # depthwise conv
        + 3 * h + di                                # A_log, dt_bias, D, norm
        + di * d                                    # out_proj
    )


def _count_params(cfg: ModelConfig, active_only: bool = False) -> float:
    d = cfg.d_model
    total = cfg.vocab_size * d * cfg.n_codebooks    # embeddings
    if not cfg.tie_embeddings:
        total += cfg.vocab_size * d * cfg.n_codebooks
    for i in range(cfg.n_layers):
        if cfg.mixer_type == "mamba2":
            total += _mamba_params(cfg) + d  # + norm
            if cfg.shared_attn_every:
                # shared transformer block weights are counted once below
                if i % cfg.shared_attn_every == cfg.shared_attn_every - 1:
                    total += 2 * d * d + d  # per-invocation in-proj + norm
            continue
        total += _attn_params(cfg) + 2 * d
        moe = cfg.moe
        if cfg.mixer_type == "moe" and moe and i >= moe.n_dense_layers:
            per_expert = _mlp_params(d, moe.d_ff_expert, cfg.mlp_act)
            n_used = moe.top_k if active_only else moe.n_experts
            total += per_expert * (n_used + moe.n_shared_experts)
            total += d * moe.n_experts  # router
        else:
            total += _mlp_params(d, cfg.d_ff, cfg.mlp_act)
    if cfg.shared_attn_every and cfg.mixer_type == "mamba2":
        dh = cfg.head_dim
        total += (
            d * dh * (cfg.n_heads * 2 + cfg.n_kv_heads * 2)
            + _mlp_params(d, cfg.d_ff, cfg.mlp_act) + 2 * d
        )
    total += d  # final norm
    return float(total)


# --------------------------------------------------------------------------
# the dry-run's cells (``launch/dryrun.py``)
# --------------------------------------------------------------------------
def segment_counts(cfg: ModelConfig) -> list[int]:
    """Scan lengths of each homogeneous layer segment (mirrors
    transformer.segment_plan)."""
    if cfg.mixer_type == "mamba2":
        if cfg.shared_attn_every:
            return [cfg.n_layers // cfg.shared_attn_every]
        return [cfg.n_layers]
    if cfg.mixer_type == "moe" and cfg.moe and cfg.moe.n_dense_layers:
        return [cfg.moe.n_dense_layers, cfg.n_layers - cfg.moe.n_dense_layers]
    return [cfg.n_layers]


def with_segment_counts(cfg: ModelConfig, counts: list[int]) -> ModelConfig:
    """A config whose segments have the given (small) counts — used by the
    dry-run's layer-differencing cost extraction."""
    if cfg.mixer_type == "mamba2":
        k = cfg.shared_attn_every or 1
        return dataclasses.replace(cfg, n_layers=counts[0] * k)
    if cfg.mixer_type == "moe" and cfg.moe and cfg.moe.n_dense_layers:
        nd, nm = counts
        return dataclasses.replace(
            cfg, n_layers=nd + nm,
            moe=dataclasses.replace(cfg.moe, n_dense_layers=nd),
        )
    return dataclasses.replace(cfg, n_layers=counts[0])


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned (input-shape) cell: what gets lowered in the dry-run."""

    name: str           # train_4k | prefill_32k | decode_32k | long_500k
    kind: str           # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def sub_quadratic(cfg: ModelConfig) -> bool:
    """Can this arch run long_500k? (SSM/hybrid state or sliding window.)"""
    return cfg.mixer_type == "mamba2" or cfg.window is not None


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if sub_quadratic(cfg):
        names.append("long_500k")
    return names
