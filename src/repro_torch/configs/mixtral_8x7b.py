"""mixtral-8x7b [arXiv:2401.04088] — MoE: 8 experts top-2, sliding-window
attention (4096).

32L, d_model=4096, 32 heads (GQA kv=8), per-expert d_ff=14336,
vocab=32000. 8 experts do not divide the 16-way model axis, so expert
FFNs are sharded on their hidden dim instead (``expert_shard="ffn"``,
14336/16 = 896 — DESIGN.md §6). SWA makes long_500k native (ring KV
cache of 4096 slots).
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "mixtral-8x7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=14336, vocab_size=32000,
        num_experts=8, experts_per_token=2, expert_shard="ffn",
        sliding_window=4096, rope_theta=1e6,
        citation="arXiv:2401.04088 (Mixtral of Experts)",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
