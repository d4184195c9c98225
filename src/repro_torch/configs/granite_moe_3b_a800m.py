"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family; the assignment's bracket note
"32 experts" matches the 1b-a400m card — the 3b-a800m spec line says 40e, which
we follow.]
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-moe-3b-a800m")
def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        arch_type="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,                      # per-expert FFN width
        vocab_size=49155,
        block_pattern=("moe",),
        num_experts=40,
        num_experts_per_tok=8,
        rope_theta=10_000.0,
        source="hf:ibm-granite/granite-3.0-1b-a400m-base",
        notes="every layer MoE, fine-grained experts (d_ff=512), top-8 of 40",
    )
