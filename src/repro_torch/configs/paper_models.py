"""The paper's own two models (Table 3), expressed in the same config system.

* ``gte-base-en-v1.5`` — the embedding model EdgeRAG regenerates cluster
  embeddings with (dim 768).  We model it as a 12-layer bidirectional encoder;
  its forward cost is what Alg. 1/2/3 profile and trade against storage.
* ``sheared-llama-2.7b`` — the generation model; its prefill latency is the
  second TTFT term.
"""
from repro_torch.configs.base import ModelConfig, register


@register("gte-base-en-v1.5")
def gte_base() -> ModelConfig:
    return ModelConfig(
        name="gte-base-en-v1.5",
        arch_type="dense",
        num_layers=12,
        d_model=768,
        num_heads=12,
        num_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab_size=30528,
        block_pattern=("attn",),
        rope_theta=10_000.0,
        source="arXiv:2308.03281 (gte); paper Table 3",
        notes="embedding model, dim=768; used bidirectionally (is_causal=False)",
    )


@register("sheared-llama-2.7b")
def sheared_llama() -> ModelConfig:
    return ModelConfig(
        name="sheared-llama-2.7b",
        arch_type="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab_size=32000,
        block_pattern=("attn",),
        rope_theta=10_000.0,
        tie_embeddings=False,
        source="arXiv:2310.06694; paper Table 3",
        notes="generation model for TTFT prefill",
    )
