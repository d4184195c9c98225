"""rwkv6-1.6b (Finch) [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536.  Data-dependent decay WKV6 recurrence. [arXiv:2404.05892]

num_heads here is the WKV head count (d_model / ssm_head_dim = 32 heads of 64).
Decode state is O(1) in sequence length: (B, H, d_head, d_head) per layer plus
the token-shift carry — this arch runs long_500k natively.
"""
from repro_torch.configs.base import ModelConfig, register


@register("rwkv6-1.6b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-1.6b",
        arch_type="ssm",
        num_layers=24,
        d_model=2048,
        num_heads=32,               # wkv heads
        num_kv_heads=32,
        head_dim=64,
        d_ff=7168,
        vocab_size=65536,
        block_pattern=("rwkv6",),
        ssm_state_size=64,          # = ssm_head_dim: matrix-valued state
        ssm_head_dim=64,
        tie_embeddings=False,
        source="arXiv:2404.05892",
        notes="Finch: per-channel data-dependent decay via low-rank (lora) proj",
    )
