"""whisper-large-v3 [arXiv:2212.04356] — encoder-decoder audio model.

32 encoder + 32 decoder layers, d_model=1280, 20 heads (kv=20),
d_ff=5120, vocab=51866 (padded to 51968 for TP divisibility).
The mel-spectrogram + conv frontend is a STUB per the assignment
carve-out: ``input_specs()`` provides precomputed frame embeddings
(B, 1500, 1280). Position embeddings are learned (as in Whisper).
decode_32k / long_500k entries are structural validations only —
Whisper's decoder context is 448 tokens (DESIGN.md §5).
"""
from repro_torch.configs.base import ModelConfig, smoke_base

ARCH_ID = "whisper-large-v3"


def make_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="encdec",
        num_layers=32, encoder_layers=32, encoder_seq=1500,
        d_model=1280, num_heads=20, num_kv_heads=20, d_ff=5120,
        vocab_size=51866,
        rope=False, pos_embed="learned", max_positions=448,
        qkv_bias=True, norm="layernorm", act="gelu",
        tie_embeddings=True,
        citation="arXiv:2212.04356 (Whisper), openai/whisper-large-v3",
    ).finalize()


def make_smoke_config() -> ModelConfig:
    return smoke_base(make_config())
