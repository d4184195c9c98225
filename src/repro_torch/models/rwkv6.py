"""RWKV6 ("Finch") block: the WKV recurrence with a data-dependent decay.

Port of ``repro.models.rwkv6``.  Per head (dk = dv = head_dim), a
matrix-valued state S (dk, dv):

    S_t = diag(w_t) S_{t-1} + k_t (x) v_t          w_t in (0, 1)^dk
    o_t = r_t . (S_{t-1} + diag(u) (k_t (x) v_t))   u: the learned bonus

with ``w_t = exp(logw_t)``, ``logw = -exp(clip(w0 + tanh(xw W1) W2, -20,
10))`` (the Finch low-rank decay, in f32).  A token shift (a lerp with the
previous token) feeds every projection of the time mix and the channel
mix; the block carries the last token of each, and the state, from one
call to the next.

A one-token input (decode, or a one-token prompt) runs
:func:`wkv6_recurrent`; a longer one :func:`wkv6_chunked`, chunks of 32
(a partial last chunk padded with zeros in r, k, v and a log decay of 0).
Within a chunk the pairwise decay ``exp(csl_t - cs_s)`` is masked to -inf
for s >= t BEFORE ``exp``, never factorised into ``exp(csl_t) *
exp(-cs_s)``: ``exp(-cs_s)`` overflows under strong decay.

The state is O(1) in the sequence length: an :class:`RwkvCache` of the
(B, H, dk, dv) f32 state and the two (B, d) shift carries a layer, updated
IN PLACE (``copy_``), so a cache made of views of a batched cache's rows
(the batcher's admission) writes through.  No kernel of the port runs
here: the reference has no Pallas kernel for WKV6, and the block runs the
same PyTorch on the device of its parameters, the card or the CPU.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm, silu

DECAY_LORA = 64
CHUNK = 32

Tensor = torch.Tensor


class RwkvCache:
    """A layer's decode state: ``wkv`` (B, H, dk, dv) f32, ``shift_t`` and
    ``shift_c`` (B, d), the last normed token of the time and channel
    mixes."""

    def __init__(self, wkv: Tensor, shift_t: Tensor, shift_c: Tensor):
        self.wkv = wkv
        self.shift_t = shift_t
        self.shift_c = shift_c

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.wkv, self.shift_t, self.shift_c))

    def fresh_row(self, slot: int) -> "RwkvCache":
        """Zeroes ``slot``'s row and returns a one-row cache of views of it
        (a prefill into it writes the batched cache)."""
        row = [t[slot:slot + 1] for t in (self.wkv, self.shift_t,
                                          self.shift_c)]
        for t in row:
            t.zero_()
        return RwkvCache(*row)


def init_rwkv_cache(cfg: ModelConfig, batch: int, *, device: torch.device,
                    dtype=torch.float32) -> RwkvCache:
    d, hd = cfg.d_model, cfg.ssm_head_dim
    zeros = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt,
                                                 device=device)
    return RwkvCache(zeros(batch, d // hd, hd, hd, dt=torch.float32),
                     zeros(batch, d), zeros(batch, d))


def init_rwkv6(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device) -> Dict[str, Tensor]:
    """The reference's parameters, names and (in, out) layout: the five
    d x d projections, the decay LoRA ``w1`` / ``w2`` at scale 0.02 and the
    channel mix drawn by :func:`dense_init` from ``generator``, in that
    order; ``mu`` (5, d) and ``mu_c`` 0.5, ``w0`` -0.6, ``u`` (H, hd) 0.1,
    the norms zero."""
    d, hd = cfg.d_model, cfg.ssm_head_dim
    w = lambda shape, scale=None: dense_init(shape, generator, device,
                                             scale=scale)
    full = lambda shape, v: torch.full(shape, v, dtype=torch.float32,
                                       device=device)
    p = {"norm_t": full((d,), 0.0), "mu": full((5, d), 0.5)}
    for name in ("Wr", "Wk", "Wv", "Wg", "Wo"):
        p[name] = w((d, d))
    p["w0"] = full((d,), -0.6)
    p["w1"] = w((d, DECAY_LORA), 0.02)
    p["w2"] = w((DECAY_LORA, d), 0.02)
    p["u"] = full((d // hd, hd), 0.1)
    p["norm_c"] = full((d,), 0.0)
    p["mu_c"] = full((d,), 0.5)
    p["Wck"] = w((d, cfg.d_ff))
    p["Wcv"] = w((cfg.d_ff, d))
    return p


def token_shift(x: Tensor, carry: Tensor) -> Tuple[Tensor, Tensor]:
    """x (B, S, d), carry (B, d), the previous segment's last token:
    returns (each position's previous token (B, S, d) in x's dtype, x's
    last token).  A carry wider than x is refused before this is reached
    (``Model.run``), as the reference refuses it."""
    prev = torch.cat([carry[:, None].to(x.dtype), x[:, :-1]], dim=1)
    return prev, x[:, -1]


def wkv6_recurrent(r: Tensor, k: Tensor, v: Tensor, logw: Tensor,
                   u: Tensor, state0: Tensor) -> Tuple[Tensor, Tensor]:
    """Token by token.  r / k / logw (B, S, H, K), v (B, S, H, V), logw <=
    0; u (H, K); state0 (B, H, K, V).  Returns (o (B, S, H, V), the final
    state), f32."""
    r, k, v, w = (a.to(torch.float32) for a in (r, k, v, logw))
    u = u.to(torch.float32)[None, :, :, None]
    s = state0.to(torch.float32)
    out = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]      # (B, H, K, V)
        out.append(torch.einsum("bhk,bhkv->bhv", r[:, t], s + u * kv))
        s = s * torch.exp(w[:, t])[..., None] + kv
    return torch.stack(out, dim=1), s


def wkv6_chunked(r: Tensor, k: Tensor, v: Tensor, logw: Tensor, u: Tensor,
                 state0: Tensor, *, chunk: int = CHUNK
                 ) -> Tuple[Tensor, Tensor]:
    """The same function as :func:`wkv6_recurrent`, exact, a chunk of
    ``chunk`` tokens at a time with stable pairwise decays."""
    b, s, h, _ = r.shape
    pad = (-s) % chunk
    r, k, v, w = (a.to(torch.float32) for a in (r, k, v, logw))
    if pad:                             # decay 0 => w = 1, and k = 0
        r, k, v, w = (nn.functional.pad(a, (0, 0, 0, 0, 0, pad))
                      for a in (r, k, v, w))
    uf = u.to(torch.float32)
    mask = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=r.device).tril(-1)[None, :, :, None, None]
    state = state0.to(torch.float32)
    out = []
    for c0 in range(0, s + pad, chunk):
        rk, kk, vk, wk = (a[:, c0:c0 + chunk] for a in (r, k, v, w))
        cs = torch.cumsum(wk, dim=1)             # inclusive (B, Q, H, K)
        csl = cs - wk                            # exclusive: sum_{i<t}
        # D[t, s] = exp(csl_t - cs_s) for s < t, masked before the exp
        diff = csl[:, :, None] - cs[:, None, :]  # (B, t, s, H, K)
        a = torch.exp(torch.where(mask, diff, float("-inf")))
        scores = (rk[:, :, None] * a * kk[:, None]).sum(-1)   # (B,t,s,H)
        o = torch.einsum("btsh,bshv->bthv", scores, vk)
        o = o + (rk * uf * kk).sum(-1)[..., None] * vk        # s == t
        o = o + torch.einsum("bthk,bhkv->bthv", rk * torch.exp(csl), state)
        wl = torch.exp(cs[:, -1:] - cs)          # decay to the chunk's end
        state = (state * torch.exp(cs[:, -1])[..., None]
                 + torch.einsum("bshk,bshv->bhkv", kk * wl, vk))
        out.append(o)
    return torch.cat(out, dim=1)[:, :s], state


def _param(t: Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class RwkvBlock(nn.Module):
    """The ``"rwkv6"`` block: x + time_mix(norm_t(x)), then + channel_mix(
    norm_c(.)), its parameters named as the reference's
    (:func:`init_rwkv6`)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator,
                 device: torch.device):
        super().__init__()
        self.heads, self.head_dim = (cfg.d_model // cfg.ssm_head_dim,
                                     cfg.ssm_head_dim)
        for name, t in init_rwkv6(cfg, generator, device).items():
            setattr(self, name, _param(t))

    def forward(self, x: Tensor, cfg: ModelConfig,
                cache: Optional[RwkvCache]) -> Tensor:
        """x (B, S, d); ``cache`` None starts from zeros (``encode``), else
        it is read and then written in place."""
        b, s, d = x.shape
        h = rms_norm(x, self.norm_t, cfg.norm_eps)
        tm, state, shift_t = self.time_mix(h, cache)
        x = x + tm
        h = rms_norm(x, self.norm_c, cfg.norm_eps)
        prev, shift_c = token_shift(h, h.new_zeros((b, d)) if cache is None
                                    else cache.shift_c)
        dt = h.dtype                  # each weight cast to it per product
        xk = h + self.mu_c.to(dt) * (prev - h)
        x = x + torch.relu(xk @ self.Wck.to(dt)).square() @ self.Wcv.to(dt)
        if cache is not None:
            cache.wkv.copy_(state)
            cache.shift_t.copy_(shift_t)
            cache.shift_c.copy_(shift_c)
        return x

    def time_mix(self, h: Tensor, cache: Optional[RwkvCache]
                 ) -> Tuple[Tensor, Tensor, Tensor]:
        """Returns (the time mix's output, the new state, the new shift
        carry) for the normed ``h``."""
        b, s, d = h.shape
        nh, hd = self.heads, self.head_dim
        prev, shift_t = token_shift(h, h.new_zeros((b, d)) if cache is None
                                    else cache.shift_t)
        delta, dt, f32 = prev - h, h.dtype, torch.float32
        mu = self.mu.to(dt)
        xr, xk, xv, xg, xw = (h + mu[i] * delta for i in range(5))
        r = (xr @ self.Wr.to(dt)).view(b, s, nh, hd)
        k = (xk @ self.Wk.to(dt)).view(b, s, nh, hd)
        v = (xv @ self.Wv.to(dt)).view(b, s, nh, hd)
        g = silu(xg @ self.Wg.to(dt))
        # the decay in f32 (bf16 weights widened exactly, as jnp promotes)
        ww = self.w0.to(f32) + torch.tanh(xw.to(f32) @ self.w1.to(f32)) \
            @ self.w2.to(f32)
        logw = -torch.exp(torch.clamp(ww, -20.0, 10.0)).view(b, s, nh, hd)
        state0 = (h.new_zeros((b, nh, hd, hd), dtype=torch.float32)
                  if cache is None else cache.wkv)
        wkv = wkv6_recurrent if s == 1 else wkv6_chunked
        o, state = wkv(r, k, v, logw, self.u, state0)
        o = o.reshape(b, s, d).to(dt) * g
        return o @ self.Wo.to(dt), state, shift_t
