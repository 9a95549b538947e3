"""phi4-mini-3.8b [arXiv:2412.08905] — dense decoder: RoPE, SwiGLU, GQA.

32L, d_model=3072, 24 heads (GQA kv=8), d_ff=8192, vocab=200064.
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "phi4-mini-3.8b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        num_layers=32, d_model=3072, num_heads=24, num_kv_heads=8,
        d_ff=8192, vocab_size=200064,
        tie_embeddings=True,  # phi4-mini shares input/output embeddings
        citation="arXiv:2412.08905 (Phi-4 family, mini tier)",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
