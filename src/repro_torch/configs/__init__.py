"""Config registry of the port.  ``--arch <id>`` ids use dashes; module
files use underscores.  Importing the package registers the paper's two
models (``paper_models.py``) and the assigned architectures the port runs
(``ASSIGNED_ARCHS``, the JAX package's ten: dense ``"attn"`` blocks,
M-RoPE, embedding inputs, gemma3-12b's sliding-window ``"swa"`` blocks,
the ``"moe"`` blocks of olmoe-1b-7b and granite-moe-3b-a800m, rwkv6-1.6b's
``"rwkv6"`` blocks, and zamba2-2.7b's ``"mamba2"`` blocks with one
``"shared_attn"`` block)."""
from repro_torch.configs.base import ModelConfig, get_config, list_configs, register  # noqa
from repro_torch.configs.shapes import INPUT_SHAPES, InputShape, get_shape, LONG_CONTEXT_WINDOW  # noqa
from repro_torch.configs import (  # noqa: F401  (registers)
    gemma3_12b, granite_moe_3b_a800m, musicgen_large, olmoe_1b_7b,
    paper_models, qwen2_vl_2b, rwkv6_1p6b, stablelm_1p6b, starcoder2_7b,
    yi_9b, zamba2_2p7b)

ASSIGNED_ARCHS = (
    "granite-moe-3b-a800m",
    "musicgen-large",
    "qwen2-vl-2b",
    "starcoder2-7b",
    "yi-9b",
    "stablelm-1.6b",
    "gemma3-12b",
    "olmoe-1b-7b",
    "rwkv6-1.6b",
    "zamba2-2.7b",
)

PAPER_MODELS = ("gte-base-en-v1.5", "sheared-llama-2.7b")
