"""qwen3-14b [hf:Qwen/Qwen3-8B family card, 14B tier] — dense decoder
with QK-norm and GQA.

40L, d_model=5120, 40 heads (GQA kv=8), d_ff=17408, vocab=151936,
rope_theta=1e6.
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "qwen3-14b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8,
        d_ff=17408, vocab_size=151936,
        qk_norm=True, rope_theta=1e6, head_dim=128,
        citation="hf:Qwen/Qwen3-8B (family config, 14B tier)",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
