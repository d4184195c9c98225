"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144.  5:1 local(sliding-window 1024):global attention, 128k context.
[hf:google/gemma-3-1b-pt family]

head_dim=256 (gemma3 uses wide heads: q_dim 4096 != d_model).  Pattern is
(swa x5, attn x1) repeated 8 times = 48 layers.  Logit softcapping per gemma.
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma3-12b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma3-12b",
        arch_type="dense",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        head_dim=256,
        d_ff=15360,
        vocab_size=262144,
        block_pattern=("swa", "swa", "swa", "swa", "swa", "attn"),
        sliding_window=1024,
        rope_theta=1_000_000.0,
        attn_logit_softcap=0.0,
        tie_embeddings=True,
        source="hf:google/gemma-3-1b-pt",
        notes="5:1 local:global; local layers window=1024. For long_500k the "
              "global layers switch to the 8192 serving window (DESIGN.md §4)",
    )
