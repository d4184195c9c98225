"""Decoder / encoder model of attention, RWKV6 and Mamba2 blocks, in PyTorch.

Port of ``repro.models.model`` for every block kind (``"attn"``, ``"swa"``
(sliding window), ``"moe"``, ``"swa_moe"``, ``"rwkv6"``, ``"mamba2"``,
``"shared_attn"``): the paper's generator and embedder and the assigned
architectures (``configs.ASSIGNED_ARCHS``: yi-9b, starcoder2-7b,
stablelm-1.6b, musicgen-large and qwen2-vl-2b with their stubbed
frontends' embedding inputs, qwen2-vl with M-RoPE, gemma3-12b's 5:1
pattern of sliding-window and global layers, the mixture-of-experts
olmoe-1b-7b and granite-moe-3b-a800m, the attention-free rwkv6-1.6b, and
the hybrid zamba2-2.7b).  A :class:`Model` is an ``nn.Module`` whose
parameters keep the JAX package's names and (in, out) matrix layout, one
block per layer in the order of ``cfg.block_pattern`` repeated (an
:class:`AttnBlock`, a :class:`~repro_torch.models.rwkv6.RwkvBlock` for
``"rwkv6"``, a :class:`MambaBlock` for ``"mamba2"``; the JAX pytree stacks
each pattern position over depth; ``repro_torch.convert`` unstacks).  A
``"shared_attn"`` block is ONE :class:`AttnBlock` that stands at every
position of that kind, as the reference closes over one ``params["shared"]``
at every application: one set of parameters (``parameters()`` and
``param_count`` see it once), each application with its own KV cache.

Public entry points, as in the JAX package:
  init_params                          (random weights from a seed)
  prefill / decode_step                (serving)
  encode                               (mean-pooled sentence embedding)

Inputs, as the reference's ``_embed_inputs`` and ``_default_positions``
take them: ``batch["tokens"]`` (B, S), or ``batch["embeds"]`` (B, S, d) in
their place; ``batch["vision_embeds"]`` (B, P, d) written over the first P
positions; ``batch["positions"]`` (B, S), or (3, B, S) under M-RoPE, else
0..S-1 (offset by ``cache_len`` in decode, per slot included) on every
stream.

Semantics kept from the reference: ``rms_norm`` scales by ``1 + w``; RoPE
rotates the two halves of the head dim (M-RoPE each band by its stream's
position); SwiGLU MLP, or in a ``"moe"`` / ``"swa_moe"`` layer the
mixture of experts of ``models.moe`` (dropless in decode, ``capacity = B *
S``; the config's capacity factor in prefill and encode; its load-balance
loss is dropped here, as serving drops it); an untied ``lm_head`` when the
config says so; prefill attends causally with NO padding mask (an
``"swa"`` / ``"swa_moe"`` layer also within its window); decode inserts k /
v at ``cache_len`` (an int, or (B,) per-slot lengths) and attends over
``cache_len + 1`` tokens, a windowed layer over its ring cache
(``models.cache``: the window's last tokens).  An ``"rwkv6"`` layer
ignores positions and ``cache_len``: it carries its recurrent state and
token shifts in its cache (``models.rwkv6``), and launches no attention
kernel.  A ``"mamba2"`` layer (``x + mixer(norm(x))``, ``models.mamba2``)
ignores them too and carries its SSM state and conv carry; the engine's
left padding runs through its state and conv, unmasked, as in the JAX
engine.

Attention on the card is the hand-written kernels, whatever ``attn_impl``
says (``"reference"`` and ``"chunked"`` are two plain formulations of the
one function the prefill kernel computes): ``flash_attention`` in prefill
(causal, with an ``"swa"`` layer's window) and ``encode`` (non-causal),
``decode_attention`` in decode (over a ring with no window: a ring holds
only the window's tokens, and a length of its rows or more makes every
row valid).  On the CPU the model runs the plain functions of
``models.attention``.  The
kernels have no logit softcap (nor have the TPU kernels), so a config with
one raises on the card.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.decode_attention import (DecodeLengths,
                                                  decode_attention,
                                                  decode_lengths)
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import attention as attn_lib
from repro_torch.models.cache import Cache, KVCache
from repro_torch.models.layers import (apply_mrope, apply_rope, dense_init,
                                       mlp, rms_norm, rope_frequencies)
from repro_torch.models.mamba2 import MambaCache, init_mamba2, mamba2_mixer
from repro_torch.models.moe import init_moe, moe_block
from repro_torch.models.rwkv6 import RwkvBlock

MOE_KINDS = ("moe", "swa_moe")
WINDOW_KINDS = ("swa", "swa_moe")
KINDS = ("attn", "swa", *MOE_KINDS, "shared_attn", "rwkv6", "mamba2")

# sequences at least this long use the online-softmax chunked attention
CHUNKED_ATTN_MIN_SEQ = 2048


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class AttnBlock(nn.Module):
    """Pre-norm attention + feed-forward block (JAX block kinds ``"attn"``,
    ``"swa"``, ``"moe"``, ``"swa_moe"`` and ``"shared_attn"``, the last an
    ``"attn"`` block that the model places at several layers: the ``swa``
    kinds attend within
    ``cfg.sliding_window``; the ``moe`` kinds hold a mixture of experts,
    the submodule ``moe`` with ``router``, ``gate``, ``up`` and ``down``,
    in place of the SwiGLU ``gate``, ``up`` and ``down``)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device, kind: str = "attn"):
        super().__init__()
        self.kind = kind
        self.window = cfg.sliding_window if kind in WINDOW_KINDS else 0
        d = cfg.d_model
        z = lambda n: torch.zeros((n,), dtype=torch.float32, device=device)
        w = lambda shape: dense_init(shape, generator, device)
        self.norm1 = _param(z(d))
        self.wq = _param(w((d, cfg.q_dim)))
        self.wk = _param(w((d, cfg.kv_dim)))
        self.wv = _param(w((d, cfg.kv_dim)))
        self.wo = _param(w((cfg.q_dim, d)))
        self.norm2 = _param(z(d))
        if kind in MOE_KINDS:
            self.moe = nn.ParameterDict({
                name: _param(t) for name, t in init_moe(
                    d, cfg.d_ff, cfg.num_experts, generator, device).items()})
        else:
            self.moe = None
            self.gate = _param(w((d, cfg.d_ff)))
            self.up = _param(w((d, cfg.d_ff)))
            self.down = _param(w((cfg.d_ff, d)))

    def forward(self, x, cfg: ModelConfig, *, positions, inv_freq,
                causal: bool, mode: str, cache: Optional[KVCache],
                cache_len: Union[int, torch.Tensor],
                lengths: Union[int, torch.Tensor, DecodeLengths],
                attn_impl: str):
        """``cache_len``: where decode inserts the token; ``lengths``: the
        valid tokens it attends over, the current one included."""
        b, s, _ = x.shape
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        q = (h @ self.wq).view(b, s, cfg.num_heads, cfg.head_dim)
        k = (h @ self.wk).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = (h @ self.wv).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        if cfg.use_mrope:
            q = apply_mrope(q, positions, inv_freq, cfg.mrope_sections)
            k = apply_mrope(k, positions, inv_freq, cfg.mrope_sections)
        else:
            q = apply_rope(q, positions, inv_freq)
            k = apply_rope(k, positions, inv_freq)
        cap, window = cfg.attn_logit_softcap, self.window
        card = q.is_cuda
        if card and cap:
            raise NotImplementedError(
                f"{cfg.name}: attn_logit_softcap={cap} has no attention "
                f"kernel on the card (the TPU kernels have no softcap)")
        if mode == "decode":
            assert cache is not None and s == 1
            cache.insert(k, v, cache_len)
            if card:
                out = decode_attention(q, cache.k, cache.v, lengths,
                                       window=0 if cache.circular
                                       else window)
            else:
                out = attn_lib.attend_decode(q, cache.k, cache.v, lengths,
                                             window=window, logit_cap=cap,
                                             circular=cache.circular)
        else:
            if cache is not None:
                cache.prefill(k, v)
            if card:
                out = flash_attention(q, k, v, causal=causal, window=window)
            elif attn_impl == "chunked" or (attn_impl == "auto"
                                            and s >= CHUNKED_ATTN_MIN_SEQ):
                out = attn_lib.attend_chunked(q, k, v, causal=causal,
                                              window=window, logit_cap=cap)
            else:
                out = attn_lib.attend_reference(q, k, v, causal=causal,
                                                window=window, logit_cap=cap)
        x = x + out.reshape(b, s, cfg.q_dim) @ self.wo
        h = rms_norm(x, self.norm2, cfg.norm_eps)
        if self.moe is None:
            return x + mlp(self.gate, self.up, self.down, h)
        # decode is dropless: capacity = T covers the all-to-one worst case
        y, _ = moe_block(self.moe, h, num_experts=cfg.num_experts,
                         top_k=cfg.num_experts_per_tok,
                         capacity_factor=cfg.expert_capacity_factor,
                         capacity=b * s if mode == "decode" else 0)
        return x + y


class MambaBlock(nn.Module):
    """The ``"mamba2"`` block: ``x + mamba2_mixer(rms_norm(x, norm1))``, its
    mixer's parameters (:func:`~repro_torch.models.mamba2.init_mamba2`)
    the submodule ``mixer``, named as the reference's."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.norm1 = _param(torch.zeros((cfg.d_model,), device=device))
        self.mixer = nn.ParameterDict({
            name: _param(t) for name, t in init_mamba2(
                cfg, generator, device).items()})

    def forward(self, x, cfg: ModelConfig,
                cache: Optional[MambaCache]) -> torch.Tensor:
        """``cache`` None starts from zeros (``encode``), else it is read
        and then written in place."""
        y, _ = mamba2_mixer(self.mixer, rms_norm(x, self.norm1, cfg.norm_eps),
                            cfg, cache)
        return x + y


class Model(nn.Module):
    """Token embedding, ``num_layers`` blocks, final norm, output head."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__()
        bad = sorted(set(cfg.block_pattern) - set(KINDS))
        if bad:
            raise ValueError(f"{cfg.name}: unknown block kinds {bad} (the "
                             f"kinds are {', '.join(KINDS)})")
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = _param(dense_init((cfg.vocab_size, cfg.d_model), g, dev,
                                       scale=0.02))
        blocks, shared = [], None
        for i in range(cfg.num_layers):
            kind = cfg.block_pattern[i % len(cfg.block_pattern)]
            if kind == "shared_attn":       # drawn once, at its first layer
                if shared is None:
                    shared = AttnBlock(cfg, g, dev, kind)
                blocks.append(shared)
            elif kind == "rwkv6":
                blocks.append(RwkvBlock(cfg, g, dev))
            elif kind == "mamba2":
                blocks.append(MambaBlock(cfg, g, dev))
            else:
                blocks.append(AttnBlock(cfg, g, dev, kind))
        self.blocks = nn.ModuleList(blocks)
        self.attends = any(isinstance(b, AttnBlock) for b in blocks)
        self.final_norm = _param(torch.zeros((cfg.d_model,), device=dev))
        self.lm_head = (None if cfg.tie_embeddings else
                        _param(dense_init((cfg.d_model, cfg.vocab_size), g,
                                          dev)))
        self.register_buffer("inv_freq", torch.from_numpy(
            rope_frequencies(cfg.head_dim, cfg.rope_theta)).to(dev),
            persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_inputs(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(B, S, d) f32: ``batch["embeds"]`` if given, else the embedding
        of ``batch["tokens"]``; ``batch["vision_embeds"]`` (B, P, d), if
        given, replaces the first P positions (an image prefix)."""
        embeds = batch.get("embeds")
        if embeds is not None:
            x = embeds.to(torch.float32)
        else:
            x = self.embed[batch["tokens"]]
        ve = batch.get("vision_embeds")
        if ve is not None:
            if ve.shape[0] != x.shape[0] or ve.shape[1] > x.shape[1] or \
                    ve.shape[2] != x.shape[2]:
                raise ValueError(f"vision_embeds {tuple(ve.shape)} do not "
                                 f"fit the inputs {tuple(x.shape)}")
            x = torch.cat([ve.to(torch.float32), x[:, ve.shape[1]:]], dim=1)
        return x

    def positions(self, b: int, s: int,
                  offset: Union[int, torch.Tensor] = 0) -> torch.Tensor:
        """The reference's ``_default_positions``: 0..s-1 plus ``offset``
        (one, or (B,) per slot), (B, S), broadcast to (3, B, S) under
        M-RoPE (text positions: the three streams equal)."""
        if isinstance(offset, torch.Tensor):
            offset = offset.reshape(-1, 1)              # per-slot (B, 1)
        pos = (torch.arange(s, device=self.device) + offset).expand(b, s)
        return pos.expand(3, b, s) if self.cfg.use_mrope else pos

    def run(self, x: torch.Tensor, positions: Optional[torch.Tensor], *,
            causal: bool, mode: str, caches: Optional[List[Cache]],
            cache_len: Union[int, torch.Tensor],
            attn_impl: str) -> torch.Tensor:
        """Apply every block to the embedded inputs ``x`` (B, S, d);
        returns the residual stream (B, S, d) before the final norm.
        ``positions`` None means :meth:`positions`, starting at
        ``cache_len`` in decode; the lengths the layers attend over are
        checked once here, not once per layer (and not at all without an
        attention layer)."""
        b, s, _ = x.shape
        if positions is None:
            positions = self.positions(
                b, s, cache_len if mode == "decode" else 0)
        elif tuple(positions.shape) != ((3, b, s) if self.cfg.use_mrope
                                        else (b, s)):
            raise ValueError(f"{self.cfg.name}: positions "
                             f"{tuple(positions.shape)} for inputs "
                             f"{tuple(x.shape)}")
        lengths = cache_len + 1
        if mode == "decode" and x.is_cuda and self.attends:
            lengths = decode_lengths(lengths, b, x.device)
        for i, block in enumerate(self.blocks):
            cache = None if caches is None else caches[i]
            if isinstance(block, (RwkvBlock, MambaBlock)):
                x = block(x, self.cfg, cache)
                continue
            x = block(x, self.cfg, positions=positions,
                      inv_freq=self.inv_freq, causal=causal,
                      mode=mode, cache=cache,
                      cache_len=cache_len, lengths=lengths,
                      attn_impl=attn_impl)
        return x

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if self.lm_head is None:
            return x @ self.embed.T
        return x @ self.lm_head


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None) -> Model:
    """A :class:`Model` with random weights drawn on ``device`` (the card
    unless ``"cpu"``) from ``torch.Generator().manual_seed(seed)``."""
    return Model(cfg, seed=seed, device=device)


def param_count(model: Model) -> int:
    """Every parameter once: a shared block's, at several layers, too."""
    return sum(p.numel() for p in model.parameters())


@torch.no_grad()
def prefill(model: Model, batch: Dict[str, torch.Tensor],
            caches: List[Cache], *, attn_impl: str = "auto"
            ) -> Tuple[torch.Tensor, List[Cache]]:
    """Run the full prompt (``batch`` as the module docstring says),
    filling ``caches`` in place.  Returns (last-position logits (B, vocab),
    caches)."""
    x = model.run(model.embed_inputs(batch), batch.get("positions"),
                  causal=True, mode="prefill", caches=caches, cache_len=0,
                  attn_impl=attn_impl)
    return model.logits(x[:, -1]), caches


@torch.no_grad()
def decode_step(model: Model, tokens_or_embeds: torch.Tensor,
                caches: List[Cache], cache_len: Union[int, torch.Tensor]
                ) -> Tuple[torch.Tensor, List[Cache]]:
    """One-token serve step: tokens (B, 1) (the audio model decodes codec
    ids) or embeds (B, 1, d), at position ``cache_len``, one for every
    slot or a (B,) integer tensor of per-slot positions (every M-RoPE
    stream at it).  Returns (logits (B, vocab), caches updated in
    place)."""
    if isinstance(cache_len, torch.Tensor):
        cache_len = cache_len.to(device=model.device, dtype=torch.long)
    key = "tokens" if tokens_or_embeds.dim() == 2 else "embeds"
    x = model.run(model.embed_inputs({key: tokens_or_embeds}), None,
                  causal=True, mode="decode", caches=caches,
                  cache_len=cache_len, attn_impl="auto")
    return model.logits(x[:, 0]), caches


@torch.no_grad()
def encode(model: Model, batch: Dict[str, torch.Tensor], *,
           attn_impl: str = "auto") -> torch.Tensor:
    """Bidirectional mean-pooled, unit-norm sentence embedding.  Padded
    tokens are attended; ``batch["attn_mask"]`` only selects what is
    pooled."""
    x = model.run(model.embed_inputs(batch), batch.get("positions"),
                  causal=False, mode="train", caches=None, cache_len=0,
                  attn_impl=attn_impl)
    x = rms_norm(x, model.final_norm, model.cfg.norm_eps)
    mask = batch.get("attn_mask")
    if mask is None:
        emb = x.mean(dim=1)
    else:
        m = mask.to(x.dtype)[..., None]
        emb = (x * m).sum(1) / torch.clamp(m.sum(1), min=1.0)
    return emb / torch.clamp(torch.linalg.norm(emb, dim=-1, keepdim=True),
                             min=1e-9)
