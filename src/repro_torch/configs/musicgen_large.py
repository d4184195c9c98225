"""musicgen-large [audio] — 48L d_model=2048 32H (GQA kv=32 = MHA) d_ff=8192,
vocab=2048 (EnCodec codebook).  Decoder-only transformer over EnCodec tokens.
[arXiv:2306.05284]

The EnCodec conv codec frontend is a STUB per the assignment carve-out:
``input_specs`` supplies precomputed frame embeddings of shape (B, S, d_model).
The decoder itself (what we implement) is a standard causal transformer whose
logits rank the 2048-entry codebook.
"""
from repro_torch.configs.base import ModelConfig, register


@register("musicgen-large")
def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        arch_type="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=8192,
        vocab_size=2048,
        block_pattern=("attn",),
        embedding_inputs=True,          # EnCodec frontend stubbed
        tie_embeddings=False,
        source="arXiv:2306.05284",
        notes="decoder-only over EnCodec tokens; codec frontend stubbed",
    )
