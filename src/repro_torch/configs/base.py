"""Model configuration system.

A copy of ``repro.configs.base`` for the PyTorch port (the port imports
nothing of the JAX package).  Every architecture is expressed as a
:class:`ModelConfig`, a plain frozen dataclass; ``reduced()`` is unchanged so
that a reduced config means the same shapes in both packages.

The ``block_pattern`` field drives the block stack in
``repro_torch.models.model``: the stack is ``depth_repeat`` repetitions of
the pattern, and each entry is the *kind* of block ("attn", "swa"
sliding-window attention, "moe", "mamba2", "rwkv6", "shared_attn"); the
port runs every kind.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

BlockKind = str  # "attn" | "swa" | "moe" | "swa_moe" | "mamba2" | "rwkv6" | "shared_attn"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                      # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    # --- block pattern (see module docstring) ---
    block_pattern: Tuple[BlockKind, ...] = ("attn",)
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 0
    expert_capacity_factor: float = 1.25
    router_aux_loss_coef: float = 0.01
    # --- SSM (mamba2 / rwkv6) ---
    ssm_state_size: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2                 # mamba2 inner dim = expand * d_model
    ssm_conv_width: int = 4
    # --- attention details ---
    rope_theta: float = 10_000.0
    use_mrope: bool = False             # qwen2-vl multimodal RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)  # t/h/w head_dim split
    sliding_window: int = 0             # window for "swa" blocks
    attn_logit_softcap: float = 0.0
    # --- embedding / IO ---
    tie_embeddings: bool = True
    embedding_inputs: bool = False      # audio/vlm stub frontends feed embeddings
    norm_eps: float = 1e-6
    # --- source citation ---
    source: str = ""
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        assert self.num_layers % len(self.block_pattern) == 0, (
            f"{self.name}: num_layers={self.num_layers} not divisible by "
            f"pattern length {len(self.block_pattern)}")

    # ---- derived quantities -------------------------------------------------
    @property
    def depth_repeat(self) -> int:
        return self.num_layers // len(self.block_pattern)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_attention_free(self) -> bool:
        return all(k in ("mamba2", "rwkv6") for k in self.block_pattern)

    @property
    def has_ssm_state(self) -> bool:
        return any(k in ("mamba2", "rwkv6") for k in self.block_pattern)

    @property
    def ssm_inner_dim(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_inner_dim // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (matches models.model.init to the unit)."""
        c = self
        n = c.vocab_size * c.d_model          # token embedding
        if not c.tie_embeddings:
            n += c.vocab_size * c.d_model
        n += c.d_model                         # final norm
        per_pattern = 0
        for kind in c.block_pattern:
            if kind in ("attn", "swa", "shared_attn"):
                per_pattern += c.d_model * (c.q_dim + 2 * c.kv_dim)  # qkv
                per_pattern += c.q_dim * c.d_model                   # out proj
                per_pattern += 2 * c.d_model                         # 2 norms
                per_pattern += 3 * c.d_model * c.d_ff                # swiglu mlp
            elif kind in ("moe", "swa_moe"):
                per_pattern += c.d_model * (c.q_dim + 2 * c.kv_dim)
                per_pattern += c.q_dim * c.d_model
                per_pattern += 2 * c.d_model
                per_pattern += c.d_model * c.num_experts             # router
                per_pattern += 3 * c.num_experts * c.d_model * c.d_ff
            elif kind == "mamba2":
                # mixer-only block (real Mamba stacks carry no FFN; for
                # zamba2 the d_ff MLP lives in the shared attention block)
                d_in = c.ssm_inner_dim
                nh = c.ssm_num_heads
                per_pattern += c.d_model * (2 * d_in + 2 * c.ssm_state_size + nh)
                per_pattern += nh + nh                               # A_log, D
                per_pattern += d_in                                  # gate norm
                per_pattern += d_in * c.d_model                      # out proj
                per_pattern += c.d_model                             # pre-norm
            elif kind == "rwkv6":
                H = c.d_model // c.ssm_head_dim
                per_pattern += 5 * c.d_model * c.d_model             # r,k,v,g,o
                per_pattern += 2 * c.d_model * 64 + 0                # decay lora (w1,w2)
                per_pattern += 64 * c.d_model
                per_pattern += H * c.ssm_head_dim                    # u (bonus)
                per_pattern += 2 * c.d_model                         # 2 norms
                per_pattern += 2 * c.d_model * c.d_ff                # rwkv channel-mix (k,v)
            else:
                raise ValueError(kind)
        n += per_pattern * self.depth_repeat
        # shared blocks are counted once, not per repeat: subtract extras
        shared = [k for k in self.block_pattern if k == "shared_attn"]
        if shared and self.depth_repeat > 1:
            sz = (c.d_model * (c.q_dim + 2 * c.kv_dim) + c.q_dim * c.d_model
                  + 2 * c.d_model + 3 * c.d_model * c.d_ff)
            n -= sz * len(shared) * (self.depth_repeat - 1)
        return n

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        dense_expert = 3 * self.d_model * self.d_ff
        n_moe_blocks = sum(1 for k in self.block_pattern if k in ("moe", "swa_moe"))
        n_moe_blocks *= self.depth_repeat
        inactive = (self.num_experts - self.num_experts_per_tok)
        return self.param_count() - n_moe_blocks * inactive * dense_expert

    def reduced(self, num_layers: int = 2, d_model: int = 256,
                max_experts: int = 4) -> "ModelConfig":
        """Smoke-test variant: same family, tiny dims, runs on CPU."""
        pat = self.block_pattern
        if num_layers % len(pat) != 0:
            num_layers = len(pat)
        head_dim = 64
        num_heads = max(2, d_model // head_dim)
        num_kv = max(1, min(self.num_kv_heads, num_heads))
        # keep GQA ratio representative: kv <= heads, heads % kv == 0
        while num_heads % num_kv:
            num_kv -= 1
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=num_layers,
            d_model=d_model,
            num_heads=num_heads,
            num_kv_heads=num_kv,
            head_dim=head_dim,
            d_ff=max(128, d_model * 2),
            vocab_size=min(self.vocab_size, 512),
            num_experts=min(self.num_experts, max_experts) if self.num_experts else 0,
            num_experts_per_tok=min(self.num_experts_per_tok, 2) if self.num_experts else 0,
            expert_capacity_factor=4.0,   # dropless at smoke scale
            ssm_state_size=min(self.ssm_state_size, 16) if self.ssm_state_size else 0,
            ssm_head_dim=32,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            mrope_sections=(16, 8, 8),
        )


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers every config)
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs():
    import repro_torch.configs  # noqa: F401  (registers every config)
    return sorted(_REGISTRY)
