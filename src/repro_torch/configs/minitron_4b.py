"""minitron-4b [arXiv:2407.14679] — pruned Nemotron dense decoder.

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=9216, vocab=256000.
Squared-ReLU MLP (Nemotron family); full RoPE (the released model uses
partial-rotary — approximation noted in DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "minitron-4b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=9216, vocab_size=256000,
        act="relu2", norm="layernorm",
        citation="arXiv:2407.14679 (Minitron / pruned Nemotron-4)",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
