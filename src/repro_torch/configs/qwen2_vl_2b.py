"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936.
M-RoPE (multimodal rotary: temporal/height/width sections), dynamic resolution.
[arXiv:2409.12191]

The ViT vision encoder + projector is a STUB per the assignment carve-out:
``input_specs`` supplies pre-projected patch embeddings (B, P, d_model) plus
3-axis M-RoPE position ids (3, B, S).  We implement the language decoder that
consumes interleaved text tokens and vision embeddings.
"""
from repro_torch.configs.base import ModelConfig, register


@register("qwen2-vl-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        arch_type="vlm",
        num_layers=28,
        d_model=1536,
        num_heads=12,
        num_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151936,
        block_pattern=("attn",),
        use_mrope=True,
        mrope_sections=(16, 24, 24),    # sums to head_dim//2
        rope_theta=1_000_000.0,
        source="arXiv:2409.12191",
        notes="M-RoPE; ViT frontend stubbed, patch embeds via input_specs",
    )
