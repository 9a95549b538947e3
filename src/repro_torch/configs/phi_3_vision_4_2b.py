"""phi-3-vision-4.2b [hf:microsoft/Phi-3-vision-128k-instruct] — VLM:
phi3-mini language backbone consuming CLIP patch embeddings.

32L, d_model=3072, 32 heads (kv=32), d_ff=8192, vocab=32064.
The ViT/CLIP vision tower is a STUB per the assignment carve-out:
``input_specs()`` provides precomputed patch embeddings (B, 144, 3072)
which a learned projector maps into the decoder's embedding space.
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "phi-3-vision-4.2b"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="vlm",
        num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
        d_ff=8192, vocab_size=32064,
        vision_patches=144,
        citation="hf:microsoft/Phi-3-vision-128k-instruct",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
