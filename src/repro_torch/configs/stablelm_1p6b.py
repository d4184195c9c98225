"""stablelm-1.6b [dense] — 24L d_model=2048 32H (GQA kv=32 = MHA) d_ff=5632
vocab=100352. [hf:stabilityai/stablelm-2-1_6b]
"""
from repro_torch.configs.base import ModelConfig, register


@register("stablelm-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b",
        arch_type="dense",
        num_layers=24,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab_size=100352,
        block_pattern=("attn",),
        rope_theta=10_000.0,
        tie_embeddings=False,
        source="hf:stabilityai/stablelm-2-1_6b",
    )
