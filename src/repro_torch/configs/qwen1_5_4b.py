"""qwen1.5-4b [hf:Qwen/Qwen1.5-0.5B family card, scaled tier] — dense
decoder with QKV bias. 40L, d_model=2560, 20 heads (GQA kv=20),
d_ff=6912, vocab=151936, rope_theta=5e6 (Qwen1.5 family).
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "qwen1.5-4b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=40, d_model=2560, num_heads=20, num_kv_heads=20,
        d_ff=6912, vocab_size=151936,
        qkv_bias=True, rope_theta=5e6,
        citation="hf:Qwen/Qwen1.5-0.5B (family config, 4B tier)",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
