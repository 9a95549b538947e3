"""mamba2-1.3b [arXiv:2405.21060] — attention-free SSD (state-space
duality) decoder.

48L, d_model=2048, ssm_state=128, headdim=64 (=> 64 SSD heads,
d_inner=4096), vocab=50280 (padded to 50432). Tied embeddings.
Decode state is O(1) in context length — long_500k is the native
use-case for this architecture.
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "mamba2-1.3b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        num_layers=48, d_model=2048, num_heads=0, num_kv_heads=0,
        d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_headdim=64, ssm_expand=2,
        rope=False, tie_embeddings=True,
        citation="arXiv:2405.21060 (Mamba2 / SSD)",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
