"""olmoe-1b-7b [arXiv:2409.02060] — MoE with 64 experts, top-8 routing.

16L, d_model=2048, 16 heads (kv=16), per-expert d_ff=1024, vocab=50304.
QK-norm per the OLMoE release. Experts sharded over the model axis
(64/16 = 4 per shard).
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "olmoe-1b-7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
        d_ff=1024, vocab_size=50304,
        num_experts=64, experts_per_token=8, expert_shard="expert",
        qk_norm=True,
        citation="arXiv:2409.02060 (OLMoE-1B-7B)",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
