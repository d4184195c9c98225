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
  forward / loss_fn                    (training)
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
S``; the config's capacity factor in prefill, training and encode; its
load-balance losses, summed over the layers, are what ``forward`` returns
as ``aux`` and ``loss_fn`` adds, and what serving drops); an untied
``lm_head`` when the
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
``models.attention``, and its gradient is autograd's through them, as the
JAX package differentiates its ``jnp`` attention; on the card the
gradient of ``flash_attention`` is its hand-written backward kernel.  In
training (:func:`forward` under grad mode) each block runs under
``torch.utils.checkpoint`` (non-reentrant), so its activations are
recomputed in the backward, as the reference checkpoints each pattern
group: every attention layer launches ``flash_attention`` twice a step
(the forward and its recompute) and its backward once.  The
kernels have no logit softcap (nor have the TPU kernels), so a config with
one raises on the card.

``compute_dtype`` (float32 by default; bfloat16) follows the reference op
by op: the inputs are embedded, then cast to it; every product casts its
weight to the residual stream's dtype (so f32 parameters are rounded per
product and the residual adds are bf16 adds); ``rms_norm`` and RoPE
compute in f32 and round back; attention computes in f32 on its widened
inputs and rounds its output to q's dtype; decode writes k / v in the
cache's dtype; ``loss_fn`` takes the log-softmax of f32 logits.  On the
card a bf16 prefill launches ``flash_attention``'s bf16 entry, and a bf16
decode step ``decode_attention``'s bf16 entry over a bf16 cache or, over an
f32 cache (the batcher's, as the reference's), its f32 entry on q widened
to f32, rounded back: ``attend_decode``'s own function.  An f32 q over a
bf16 cache, which no caller of the reference makes, runs the plain
function on the CPU and raises ``NotImplementedError`` on the card.  An
``"rwkv6"`` layer over shift caches wider than the compute dtype raises
``TypeError`` before any work, as the reference's layer scan does (its
carry would change dtype); ``init_cache(dtype=torch.bfloat16)`` is the
cache that runs it in bf16.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

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
from repro_torch.models.rwkv6 import RwkvBlock, RwkvCache

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
                attn_impl: str
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``cache_len``: where decode inserts the token; ``lengths``: the
        valid tokens it attends over, the current one included.  Returns
        (x, the MoE load-balance loss, or None without experts)."""
        b, s, _ = x.shape
        dt = x.dtype                  # each weight cast to it per product
        h = rms_norm(x, self.norm1, cfg.norm_eps)
        q = (h @ self.wq.to(dt)).view(b, s, cfg.num_heads, cfg.head_dim)
        k = (h @ self.wk.to(dt)).view(b, s, cfg.num_kv_heads, cfg.head_dim)
        v = (h @ self.wv.to(dt)).view(b, s, cfg.num_kv_heads, cfg.head_dim)
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
            widen = q.dtype != cache.k.dtype
            if card and widen and cache.k.dtype != torch.float32:
                raise NotImplementedError(
                    f"decode of a {q.dtype} q over a {cache.k.dtype} cache "
                    f"has no kernel entry on the card (no caller of the "
                    f"reference makes it)")
            cache.insert(k, v, cache_len)
            if card:   # over an f32 cache: the f32 entry on q widened
                out = decode_attention(q.float() if widen else q, cache.k,
                                       cache.v, lengths,
                                       window=0 if cache.circular
                                       else window).to(q.dtype)
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
        x = x + out.reshape(b, s, cfg.q_dim) @ self.wo.to(dt)
        h = rms_norm(x, self.norm2, cfg.norm_eps)
        if self.moe is None:
            return x + mlp(self.gate, self.up, self.down, h), None
        # decode is dropless: capacity = T covers the all-to-one worst case
        y, aux = moe_block(self.moe, h, num_experts=cfg.num_experts,
                           top_k=cfg.num_experts_per_tok,
                           capacity_factor=cfg.expert_capacity_factor,
                           capacity=b * s if mode == "decode" else 0)
        return x + y, aux


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
    """Token embedding, ``num_layers`` blocks, final norm, output head.
    The weights are drawn in f32 from the generator, then each is cast to
    ``dtype`` as soon as it is drawn (the same values as ``Model(cfg)``
    cast, without its f32 copy of the whole model on the device)."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0,
                 device: DeviceLike = None, dtype=torch.float32):
        super().__init__()
        bad = sorted(set(cfg.block_pattern) - set(KINDS))
        if bad:
            raise ValueError(f"{cfg.name}: unknown block kinds {bad} (the "
                             f"kinds are {', '.join(KINDS)})")
        dev = resolve_device(device)
        g = torch.Generator(device=dev).manual_seed(seed)
        self.cfg = cfg
        self.embed = _param(dense_init((cfg.vocab_size, cfg.d_model), g, dev,
                                       scale=0.02).to(dtype))
        blocks, shared = [], None
        for i in range(cfg.num_layers):
            kind = cfg.block_pattern[i % len(cfg.block_pattern)]
            if kind == "shared_attn":       # drawn once, at its first layer
                if shared is None:
                    shared = AttnBlock(cfg, g, dev, kind).to(dtype)
                blocks.append(shared)
            elif kind == "rwkv6":
                blocks.append(RwkvBlock(cfg, g, dev).to(dtype))
            elif kind == "mamba2":
                blocks.append(MambaBlock(cfg, g, dev).to(dtype))
            else:
                blocks.append(AttnBlock(cfg, g, dev, kind).to(dtype))
        self.blocks = nn.ModuleList(blocks)
        self.attends = any(isinstance(b, AttnBlock) for b in blocks)
        self.final_norm = _param(torch.zeros((cfg.d_model,), dtype=dtype,
                                             device=dev))
        self.lm_head = (None if cfg.tie_embeddings else
                        _param(dense_init((cfg.d_model, cfg.vocab_size), g,
                                          dev).to(dtype)))
        self.register_buffer("inv_freq", torch.from_numpy(
            rope_frequencies(cfg.head_dim, cfg.rope_theta)).to(dev),
            persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def embed_inputs(self, batch: Dict[str, torch.Tensor],
                     compute_dtype=torch.float32) -> torch.Tensor:
        """(B, S, d) in ``compute_dtype``: ``batch["embeds"]`` if given,
        else the embedding of ``batch["tokens"]``, cast;
        ``batch["vision_embeds"]`` (B, P, d), if given, cast and written
        over the first P positions (an image prefix)."""
        embeds = batch.get("embeds")
        if embeds is not None:
            x = embeds.to(compute_dtype)
        else:
            x = self.embed[batch["tokens"]].to(compute_dtype)
        ve = batch.get("vision_embeds")
        if ve is not None:
            if ve.shape[0] != x.shape[0] or ve.shape[1] > x.shape[1] or \
                    ve.shape[2] != x.shape[2]:
                raise ValueError(f"vision_embeds {tuple(ve.shape)} do not "
                                 f"fit the inputs {tuple(x.shape)}")
            x = torch.cat([ve.to(compute_dtype), x[:, ve.shape[1]:]], dim=1)
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
            cache_len: Union[int, torch.Tensor], attn_impl: str,
            remat: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Apply every block to the embedded inputs ``x`` (B, S, d);
        returns (the residual stream (B, S, d) before the final norm, the
        MoE layers' load-balance losses summed in layer order, or None
        without a MoE layer).  ``positions`` None means :meth:`positions`,
        starting at ``cache_len`` in decode; the lengths the layers attend
        over are checked once here, not once per layer (and not at all
        without an attention layer).  ``remat``: each block under
        ``torch.utils.checkpoint`` (non-reentrant), its activations
        recomputed in the backward."""
        b, s, _ = x.shape
        if positions is None:
            positions = self.positions(
                b, s, cache_len if mode == "decode" else 0)
        elif tuple(positions.shape) != ((3, b, s) if self.cfg.use_mrope
                                        else (b, s)):
            raise ValueError(f"{self.cfg.name}: positions "
                             f"{tuple(positions.shape)} for inputs "
                             f"{tuple(x.shape)}")
        if caches is not None:
            for c in caches:
                if isinstance(c, RwkvCache) and torch.promote_types(
                        c.shift_t.dtype, x.dtype) != x.dtype:
                    raise TypeError(
                        f"{self.cfg.name}: an rwkv6 layer computing in "
                        f"{x.dtype} over {c.shift_t.dtype} shift caches "
                        f"would return a wider stream than it takes, as the "
                        f"reference's layer scan refuses; make the caches "
                        f"with init_cache(dtype={x.dtype})")
        lengths = cache_len + 1
        if mode == "decode" and x.is_cuda and self.attends:
            lengths = decode_lengths(lengths, b, x.device)
        def apply(x, block, cache):
            if isinstance(block, (RwkvBlock, MambaBlock)):
                return block(x, self.cfg, cache), None
            return block(x, self.cfg, positions=positions,
                         inv_freq=self.inv_freq, causal=causal, mode=mode,
                         cache=cache, cache_len=cache_len, lengths=lengths,
                         attn_impl=attn_impl)

        aux_total = None
        for i, block in enumerate(self.blocks):
            cache = None if caches is None else caches[i]
            if remat:
                x, aux = checkpoint(apply, x, block, cache,
                                    use_reentrant=False)
            else:
                x, aux = apply(x, block, cache)
            if aux is not None:
                aux_total = aux if aux_total is None else aux_total + aux
        return x, aux_total

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head in x's dtype, its weight cast per product."""
        x = rms_norm(x, self.final_norm, self.cfg.norm_eps)
        if self.lm_head is None:
            return x @ self.embed.to(x.dtype).T
        return x @ self.lm_head.to(x.dtype)


def init_params(cfg: ModelConfig, *, seed: int = 0,
                device: DeviceLike = None, dtype=torch.float32) -> Model:
    """A :class:`Model` with random weights drawn on ``device`` (the card
    unless ``"cpu"``) from ``torch.Generator().manual_seed(seed)`` in f32,
    then cast to ``dtype`` (the reference's ``init_params(dtype=)``)."""
    return Model(cfg, seed=seed, device=device, dtype=dtype)


def param_count(model: Model) -> int:
    """Every parameter once: a shared block's, at several layers, too."""
    return sum(p.numel() for p in model.parameters())


def forward(model: Model, batch: Dict[str, torch.Tensor], *,
            attn_impl: str = "auto", compute_dtype=torch.float32, dist=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The training forward: (logits (B, S, vocab), the MoE load-balance
    losses summed over the layers, an f32 scalar, 0 without experts), the
    reference's ``forward(mode="train")`` (serving's modes are
    :func:`prefill` and :func:`decode_step`).  Under grad mode each block
    runs under ``torch.utils.checkpoint``, as the reference checkpoints
    each group in train mode.  The logits are in ``compute_dtype``.  On
    one device: ``dist`` raises (the multi-device item 5)."""
    if dist is not None:
        raise NotImplementedError("forward(dist=...): the port runs on one "
                                  "device (multi-device is ROADMAP item 5)")
    x, aux = model.run(model.embed_inputs(batch, compute_dtype),
                       batch.get("positions"),
                       causal=True, mode="train", caches=None, cache_len=0,
                       attn_impl=attn_impl, remat=torch.is_grad_enabled())
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return model.logits(x), aux


def loss_fn(model: Model, batch: Dict[str, torch.Tensor], *,
            compute_dtype=torch.float32, attn_impl: str = "auto",
            dist=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token cross-entropy over ``batch["labels"]`` (B, S) under
    ``batch["loss_mask"]`` (all ones if absent), plus
    ``cfg.router_aux_loss_coef`` times the MoE load-balance loss.  Returns
    (total, {"ce", "aux"}), f32 scalars, as the reference's ``loss_fn``."""
    logits, aux = forward(model, batch, compute_dtype=compute_dtype,
                          attn_impl=attn_impl, dist=dist)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    labels = batch["labels"].to(device=logp.device, dtype=torch.long)
    ll = logp.gather(-1, labels[..., None])[..., 0]
    mask = batch.get("loss_mask")
    mask = torch.ones_like(ll) if mask is None else mask.to(ll)
    ce = -(ll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    total = ce + model.cfg.router_aux_loss_coef * aux
    return total, {"ce": ce, "aux": aux}


@torch.no_grad()
def prefill(model: Model, batch: Dict[str, torch.Tensor],
            caches: List[Cache], *, compute_dtype=torch.float32,
            attn_impl: str = "auto") -> Tuple[torch.Tensor, List[Cache]]:
    """Run the full prompt (``batch`` as the module docstring says) in
    ``compute_dtype``, filling ``caches`` in place.  Returns (last-position
    logits (B, vocab) in ``compute_dtype``, caches)."""
    x, _ = model.run(model.embed_inputs(batch, compute_dtype),
                     batch.get("positions"),
                     causal=True, mode="prefill", caches=caches, cache_len=0,
                     attn_impl=attn_impl)
    return model.logits(x[:, -1]), caches


@torch.no_grad()
def decode_step(model: Model, tokens_or_embeds: torch.Tensor,
                caches: List[Cache], cache_len: Union[int, torch.Tensor], *,
                compute_dtype=torch.float32
                ) -> Tuple[torch.Tensor, List[Cache]]:
    """One-token serve step in ``compute_dtype``: tokens (B, 1) (the audio
    model decodes codec ids) or embeds (B, 1, d), at position
    ``cache_len``, one for every slot or a (B,) integer tensor of per-slot
    positions (every M-RoPE stream at it).  Returns (logits (B, vocab) in
    ``compute_dtype``, caches updated in place)."""
    if isinstance(cache_len, torch.Tensor):
        cache_len = cache_len.to(device=model.device, dtype=torch.long)
    key = "tokens" if tokens_or_embeds.dim() == 2 else "embeds"
    x, _ = model.run(model.embed_inputs({key: tokens_or_embeds},
                                        compute_dtype), None,
                     causal=True, mode="decode", caches=caches,
                     cache_len=cache_len, attn_impl="auto")
    return model.logits(x[:, 0]), caches


@torch.no_grad()
def encode(model: Model, batch: Dict[str, torch.Tensor], *,
           compute_dtype=torch.float32, attn_impl: str = "auto"
           ) -> torch.Tensor:
    """Bidirectional mean-pooled, unit-norm sentence embedding, in
    ``compute_dtype``.  Padded tokens are attended; ``batch["attn_mask"]``
    only selects what is pooled."""
    x, _ = model.run(model.embed_inputs(batch, compute_dtype),
                     batch.get("positions"),
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
