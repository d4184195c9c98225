"""yi-9b [dense] — 48L d_model=4096 32H (GQA kv=4) d_ff=11008 vocab=64000.
Llama-architecture GQA. [arXiv:2403.04652]
"""
from repro_torch.configs.base import ModelConfig, register


@register("yi-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="yi-9b",
        arch_type="dense",
        num_layers=48,
        d_model=4096,
        num_heads=32,
        num_kv_heads=4,
        head_dim=128,
        d_ff=11008,
        vocab_size=64000,
        block_pattern=("attn",),
        rope_theta=10_000.0,
        tie_embeddings=False,
        source="arXiv:2403.04652",
    )
