"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152.  GQA + RoPE. [arXiv:2402.19173]
"""
from repro_torch.configs.base import ModelConfig, register


@register("starcoder2-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-7b",
        arch_type="dense",
        num_layers=32,
        d_model=4608,
        num_heads=36,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18432,
        vocab_size=49152,
        block_pattern=("attn",),
        rope_theta=100_000.0,
        tie_embeddings=False,
        source="arXiv:2402.19173",
        notes="36 heads is not a multiple of the 16-way model axis: relies on "
              "GSPMD padding at baseline (see EXPERIMENTS.md §Perf)",
    )
