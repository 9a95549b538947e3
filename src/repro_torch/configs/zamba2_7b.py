"""zamba2-7b [arXiv:2411.15242] — hybrid Mamba2 backbone with a SHARED
attention+MLP block applied periodically (Zamba2's shared-block design).

81 layers, d_model=3584, 32 heads (kv=32), d_ff=14336, vocab=32000,
ssm_state=64. We apply the shared block every 9 Mamba2 blocks (81 = 9×9;
the released model interleaves at a similar cadence — approximation
recorded in DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "zamba2-7b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="hybrid",
        num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32,
        d_ff=14336, vocab_size=32000,
        ssm_state=64, ssm_headdim=64, ssm_expand=2, attn_every=9,
        citation="arXiv:2411.15242 (Zamba2)",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
