"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16 = MHA) d_ff=1024/expert
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060]
"""
from repro_torch.configs.base import ModelConfig, register


@register("olmoe-1b-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        arch_type="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1024,                    # per-expert FFN width
        vocab_size=50304,
        block_pattern=("moe",),
        num_experts=64,
        num_experts_per_tok=8,
        rope_theta=10_000.0,
        tie_embeddings=False,
        source="arXiv:2409.02060",
        notes="fine-grained 64-expert MoE, every layer",
    )
