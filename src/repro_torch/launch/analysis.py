"""Roofline accounting for the dry-run on H100 meshes (a port of
``repro/launch/analysis.py``; no hardware needed).

Hardware model (``HW``), one NVIDIA H100 SXM card, datasheet figures:

  * ``peak_flops`` 989e12 -- dense bf16 on the tensor cores;
  * ``hbm_bw`` 3.35e12 B/s -- HBM3;
  * ``nvlink_bw`` 450e9 B/s -- NVLink 4, one direction, between the 8
    cards of an HGX node (900 GB/s both ways);
  * ``network_bw`` 50e9 B/s -- the node's network, one NDR 400 Gb/s
    adapter a card.

``chip_smoke.py`` reads its bounds from the same table.

The JAX package reads its terms from XLA: ``compiled.cost_analysis()``
and the partitioned HLO's collectives.  The port has neither; its
dry-run (``launch/dryrun.py``) counts FLOPs with
``torch.utils.flop_counter`` over an abstract step, and the bytes that
cross between mesh members with ``distributed/wire.py``'s meter, whose
per-member factors are the ring model of JAX's ``collective_bytes``
(``wire.wire_bytes``; the HLO parser is not ported, there being no
HLO).  The memory term uses ``analytic_hbm_bytes``, as JAX's does.

Terms (seconds, per step, per card; the dry-run splits the counts evenly
over the cards):

  compute    = flops_per_chip / peak_flops
  memory     = hbm_bytes_per_chip / hbm_bw
  collective = nvlink_bytes / nvlink_bw + network_bytes / network_bw

where a collective whose group lies within the ``model`` axis (at most 8
cards on the production meshes, one NVLink domain) is NVLink traffic
and any other is network traffic.

``analytic_hbm_bytes``, ``_uses_fsdp``, ``_cache_bytes`` and
``model_flops_for`` are JAX's, operation for operation, so they give the
same Python floats; ``Roofline`` too, given JAX's table as ``hw``.
"""

from __future__ import annotations

import dataclasses

HW = {
    "peak_flops": 989e12,   # bf16 dense, tensor cores (H100 SXM datasheet)
    "hbm_bw": 3.35e12,      # bytes/s, HBM3 (H100 SXM datasheet)
    "nvlink_bw": 450e9,     # bytes/s one way, NVLink 4 within an HGX node
    "network_bw": 50e9,     # bytes/s a card, NDR 400 Gb/s
}


def collective_seconds(by_link: dict, hw: dict = HW) -> float:
    """The collective term of one card's wire bytes by link
    (``{"nvlink": b, "network": b}``, ``wire.WireMeter.by_link`` over the
    cards)."""
    return by_link.get("nvlink", 0.0) / hw["nvlink_bw"] + by_link.get("network", 0.0) / hw["network_bw"]


@dataclasses.dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_chip: float
    hbm_bytes_per_chip: float
    wire_bytes_per_chip: float
    model_flops: float            # 6*N_active*tokens (or 2*N for inference)
    chips: int
    hw: dict = dataclasses.field(default_factory=lambda: HW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / global counted flops."""
        total = self.flops_per_chip * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """useful-FLOPs time / bound time == achievable MFU upper bound."""
        ideal_s = self.model_flops / (self.chips * self.hw["peak_flops"])
        return ideal_s / self.bound_s if self.bound_s else 0.0

    def to_dict(self) -> dict:
        return {
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "dominant": self.dominant,
            "flops_per_chip": self.flops_per_chip,
            "hbm_bytes_per_chip": self.hbm_bytes_per_chip,
            "wire_bytes_per_chip": self.wire_bytes_per_chip,
            "model_flops": self.model_flops,
            "useful_ratio": self.useful_ratio,
            "roofline_fraction": self.roofline_fraction,
            "chips": self.chips,
        }


def analytic_hbm_bytes(cfg, shape, *, chips: int, tp: int, dp: int,
                       remat: str = "full", redundancy: int = 1) -> float:
    """Napkin per-chip HBM traffic per step (JAX's model, unchanged):

      train:  3x param reads (fwd, bwd, remat recompute) + grad write/read
              + optimizer state read+write + activation checkpoints (one
              (B,S,d) residual per layer, write+read) + logits write+read
      prefill: 1x param read + activations + logits + cache write
      decode: 1x param read + full cache read + slot write
    """
    n_active = cfg.n_active_params()
    shard = tp * (dp if _uses_fsdp(cfg) else 1)
    p_loc = 2.0 * n_active / shard                 # bf16 local params touched
    B_loc = max(shape.global_batch // dp, 1)
    S = shape.seq_len
    d = cfg.d_model
    L = cfg.n_layers
    act = 2.0 * B_loc * S * d                      # one bf16 residual
    logits_loc = 2.0 * B_loc * S * cfg.vocab_size / tp * cfg.n_codebooks

    if shape.kind == "train":
        reads = 3.0 if remat == "full" else 2.0
        params_traffic = reads * p_loc + 2.0 * p_loc          # + grad w/r
        opt = 2.0 * (12.0 if True else 6.0) * (
            cfg.n_active_params() / chips)                    # zero-sharded
        acts = (2.0 + (1.0 if remat == "full" else 0.0)) * act * L
        total = params_traffic + opt + acts + 2.0 * logits_loc
    elif shape.kind == "prefill":
        total = p_loc + 2.0 * act * L + logits_loc + _cache_bytes(
            cfg, B_loc, S, tp)
    else:  # decode
        total = p_loc + _cache_bytes(cfg, B_loc, S, tp) + 2.0 * B_loc * d * L
    return total * redundancy


def _uses_fsdp(cfg) -> bool:
    return cfg.n_params() > 3e10


def _cache_bytes(cfg, B_loc: int, S: int, tp: int) -> float:
    if cfg.mixer_type == "mamba2":
        s = cfg.ssm
        d_inner = s.expand * cfg.d_model
        H = d_inner // s.headdim
        per_layer = 4.0 * B_loc * H * s.state * s.headdim / tp
        total = per_layer * cfg.n_layers
        if cfg.shared_attn_every:
            S_eff = min(S, 10**9)
            inv = cfg.n_layers // cfg.shared_attn_every
            total += (inv * 2.0 * B_loc * cfg.n_kv_heads * S_eff
                      * (cfg.d_model // max(cfg.n_heads, 1)) * 2 / tp)
        return total
    if cfg.attn_type == "mla":
        m = cfg.mla
        return (2.0 * B_loc * S * (m.kv_lora_rank + m.qk_rope_dim)
                * cfg.n_layers / tp)
    S_eff = min(S, cfg.window) if cfg.window else S
    dh = cfg.d_model // max(cfg.n_heads, 1)
    kv_shard = tp if cfg.n_kv_heads % tp == 0 else tp  # seq- or head-shard
    return (2.0 * 2.0 * B_loc * cfg.n_kv_heads * S_eff * dh
            * cfg.n_layers / kv_shard)


def model_flops_for(cfg, shape) -> float:
    """6*N_active*tokens for training; 2*N_active*tokens for inference."""
    n = cfg.n_active_params()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch   # decode: one token per sequence
