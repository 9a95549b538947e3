"""Architecture + run configuration system.

Every assigned architecture gets a ``configs/<id>.py`` exporting
``make_config()`` (full, dry-run-only) and ``make_smoke_config()``
(reduced: <=2 layers, d_model<=512, <=4 experts — runs on CPU).

Derived fields (padded heads/vocab, ssm dims) are computed in
``finalize`` so the raw numbers in each config file match the cited
source exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads
    citation: str = ""

    # attention flavor
    rope: bool = True
    rope_theta: float = 1e4
    qkv_bias: bool = False
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    pos_embed: str = "none"         # none | learned
    max_positions: int = 0
    full_attn_threshold: int = 2048

    # norms / activations
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    tie_embeddings: bool = False

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    expert_shard: str = "expert"    # expert | ffn
    moe_groups: int = 1             # group-local dispatch (perf; §Perf log)
    moe_pad_experts: int = 0        # pad expert dim to this for clean EP
                                    # sharding (perf; §Perf mixtral iter 2)

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_groups: int = 1
    ssm_streaming: bool = False     # scan chunks sequentially (perf; §Perf log)
    attn_every: int = 0             # hybrid: shared attn block every k ssm blocks

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0            # precomputed frame embeddings (stub frontend)

    # VLM
    vision_patches: int = 0         # precomputed patch embeddings (stub frontend)

    # system
    dtype: str = "bfloat16"
    remat: str = "none"             # none | full
    tp_pad: int = 16                # pad q heads to multiple of this (model axis)
    vocab_pad: int = 256

    # derived (set by finalize)
    num_heads_padded: int = 0
    vocab_padded: int = 0
    ssm_inner: int = 0
    ssm_heads: int = 0

    def finalize(self) -> "ModelConfig":
        hd = self.head_dim or (self.d_model // max(self.num_heads, 1))
        hp = _round_up(self.num_heads, self.tp_pad) if self.num_heads else 0
        vp = _round_up(self.vocab_size, self.vocab_pad)
        di = self.ssm_expand * self.d_model if self.ssm_state else 0
        sh = di // self.ssm_headdim if self.ssm_state else 0
        return dataclasses.replace(
            self, head_dim=hd, num_heads_padded=hp, vocab_padded=vp,
            ssm_inner=di, ssm_heads=sh)

    def with_overrides(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw).finalize()


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def smoke_base(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model<=512, <=4 experts."""
    kw = dict(
        num_layers=2, d_model=256, d_ff=512,
        num_heads=4, num_kv_heads=max(1, min(cfg.num_kv_heads, 2)),
        head_dim=64, vocab_size=512, tp_pad=1, vocab_pad=16,
        full_attn_threshold=4096,
    )
    if cfg.num_experts:
        kw.update(num_experts=4, experts_per_token=min(cfg.experts_per_token, 2))
    if cfg.ssm_state:
        kw.update(ssm_state=16, ssm_headdim=32, ssm_chunk=8)
    if cfg.attn_every:
        kw.update(num_layers=4, attn_every=2)
    if cfg.encoder_layers:
        kw.update(encoder_layers=2, encoder_seq=16)
    if cfg.vision_patches:
        kw.update(vision_patches=8)
    if cfg.pos_embed == "learned":
        kw.update(max_positions=128)
    if cfg.sliding_window:
        kw.update(sliding_window=32)
    return cfg.with_overrides(**kw)
