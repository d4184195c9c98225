"""zamba2-2.7b [hybrid] — 54L d_model=2560 32H (GQA kv=32) d_ff=10240
vocab=32000, ssm_state=64.  Mamba2 backbone + shared attention blocks.
[arXiv:2411.15242]

Pattern: 5 Mamba2 blocks then one SHARED attention block (one set of attention
weights reused at every application — the Zamba trick), repeated 9 times for
54 layers.  The shared block's params are stored once and closed over by the
scan, exactly matching the memory-saving motivation of the paper.
"""
from repro_torch.configs.base import ModelConfig, register


@register("zamba2-2.7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-2.7b",
        arch_type="hybrid",
        num_layers=54,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=10240,
        vocab_size=32000,
        block_pattern=("mamba2", "mamba2", "mamba2", "mamba2", "mamba2",
                       "shared_attn"),
        ssm_state_size=64,
        ssm_head_dim=64,
        ssm_expand=2,
        source="arXiv:2411.15242",
        notes="shared attention weights reused across all 9 applications",
    )
