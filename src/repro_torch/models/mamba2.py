"""Mamba2 (SSD) mixer: a state-space recurrence with a scalar decay a head.

Port of ``repro.models.mamba2``.  Per head h, a matrix-valued state S
(head_dim, N):

    S_t = exp(A_h dt_t) S_{t-1} + dt_t (x_t (x) B_t)
    y_t = S_t . C_t + D_h x_t

with B and C shared by every head (one group), ``dt = softplus(x W_dt +
dt_bias)`` and ``A = -exp(A_log)``.  The x, B and C projections pass a
depthwise causal conv of width ``ssm_conv_width`` and ``silu`` first; the
output is gated by ``silu(z)`` and normed before the out projection.

A one-token input (decode, or a one-token prompt) runs
:func:`ssd_reference`, the recurrence; a longer one :func:`ssd_chunked`,
chunks of 64 (a partial last chunk padded with zeros in x, B and C and a
log decay of 0).  Within a chunk the pairwise decay ``exp(cs_t - cs_s)``
is masked to -inf for s > t BEFORE ``exp``: the other half's exponents
are positive and overflow.  The scan over chunks and its cumulative sums
run in f32.

The state is O(1) in the sequence length: a :class:`MambaCache` of the
(B, nh, head_dim, N) f32 SSM state and the (B, W - 1, conv_dim) conv
carry (the last W - 1 projections before the conv), updated IN PLACE
(``copy_``), so a cache made of views of a batched cache's rows (the
batcher's admission) writes through.  No kernel of the port runs here:
the reference computes SSD in plain ``jnp`` (it has no Pallas kernel for
it), and the mixer runs the same PyTorch on the device of its parameters,
the card or the CPU.

The three depthwise convs of the x, B and C projections run as one conv
over their channels side by side (the reference splits them for its
sharding; a depthwise conv splits exactly, so every channel takes the
same products in the same order).  ``softplus`` is ``logaddexp(x, 0)``,
the JAX package's form (``torch.nn.functional.softplus`` returns x past
its threshold).  The one departure, in rounding only: the reference's
three-operand contractions are taken as two steps, in another order.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm, silu

CHUNK = 64

Tensor = torch.Tensor


class MambaCache:
    """A layer's decode state: ``ssm`` (B, nh, head_dim, N) f32 and
    ``conv`` (B, W - 1, conv_dim), the last W - 1 x / B / C projections
    before the conv, side by side."""

    def __init__(self, ssm: Tensor, conv: Tensor):
        self.ssm = ssm
        self.conv = conv

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in (self.ssm,
                                                          self.conv))

    def fresh_row(self, slot: int) -> "MambaCache":
        """Zeroes ``slot``'s row and returns a one-row cache of views of it
        (a prefill into it writes the batched cache)."""
        row = [t[slot:slot + 1] for t in (self.ssm, self.conv)]
        for t in row:
            t.zero_()
        return MambaCache(*row)


def conv_dim(cfg: ModelConfig) -> int:
    return cfg.ssm_inner_dim + 2 * cfg.ssm_state_size


def init_mamba_cache(cfg: ModelConfig, batch: int, *, device: torch.device,
                     dtype=torch.float32) -> MambaCache:
    return MambaCache(
        torch.zeros((batch, cfg.ssm_num_heads, cfg.ssm_head_dim,
                     cfg.ssm_state_size), dtype=torch.float32,
                    device=device),
        torch.zeros((batch, cfg.ssm_conv_width - 1, conv_dim(cfg)),
                    dtype=dtype, device=device))


def init_mamba2(cfg: ModelConfig, generator: torch.Generator,
                device: torch.device) -> Dict[str, Tensor]:
    """The reference's parameters, names and (in, out) layout, projections
    split by destination: ``in_z``, ``in_x``, ``in_b``, ``in_c``,
    ``in_dt`` and the three depthwise convs (scale 0.5) drawn by
    :func:`dense_init` from ``generator`` in that order; ``A_log`` =
    log(linspace(1, 16, nh)), ``D`` ones, ``dt_bias`` the inverse softplus
    of exp(U(0, 1) x 3.5 - 4.6), the gate norm zero; then ``out_proj``."""
    d, d_in, n = cfg.d_model, cfg.ssm_inner_dim, cfg.ssm_state_size
    nh, w = cfg.ssm_num_heads, cfg.ssm_conv_width
    dense = lambda shape, scale=None: dense_init(shape, generator, device,
                                                 scale=scale)
    p = {"in_z": dense((d, d_in)), "in_x": dense((d, d_in)),
         "in_b": dense((d, n)), "in_c": dense((d, n)),
         "in_dt": dense((d, nh)), "conv_x": dense((w, d_in), 0.5),
         "conv_b": dense((w, n), 0.5), "conv_c": dense((w, n), 0.5)}
    p["A_log"] = torch.log(torch.linspace(1.0, 16.0, nh, device=device))
    p["D"] = torch.ones((nh,), device=device)
    u = torch.rand((nh,), generator=generator, device=device)
    p["dt_bias"] = torch.log(torch.expm1(torch.exp(u * 3.5 - 4.6)))
    p["gate_norm"] = torch.zeros((d_in,), device=device)
    p["out_proj"] = dense((d_in, d))
    return p


def _causal_conv(x: Tensor, w: Tensor, carry: Optional[Tensor] = None
                 ) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv.  x (B, S, C), w (W, C) (cast to x's dtype),
    carry (B, W - 1, C) (None: zeros).  Returns (out (B, S, C), the new
    carry: the last W - 1 rows of ``carry`` then ``x``, old rows among them
    when S < W - 1), both in the wider of x's and the carry's dtypes, as the
    reference's concatenation promotes (a bf16 x over an f32 carry: f32)."""
    width, s = w.shape[0], x.shape[1]
    if carry is None:
        carry = x.new_zeros((x.shape[0], width - 1, x.shape[2]))
    w = w.to(x.dtype)
    xp = torch.cat([carry, x], dim=1)
    out = xp[:, :s] * w[0]                   # the reference's sum, in order
    for i in range(1, width):
        out = out + xp[:, i:i + s] * w[i]
    return out, xp[:, -(width - 1):]


def ssd_reference(x: Tensor, log_a: Tensor, b: Tensor, c: Tensor,
                  state0: Tensor) -> Tuple[Tensor, Tensor]:
    """Token by token.  x (B, S, nh, hd), already dt-scaled; log_a (B, S,
    nh) <= 0; b, c (B, S, N); state0 (B, nh, hd, N).  Returns (y (B, S, nh,
    hd) in x's dtype, the final state f32)."""
    xf, a, bf, cf = (t.to(torch.float32) for t in (x, log_a, b, c))
    state = state0.to(torch.float32)
    ys = []
    for t in range(x.shape[1]):
        state = (state * torch.exp(a[:, t])[:, :, None, None]
                 + xf[:, t, :, :, None] * bf[:, t, None, None, :])
        ys.append(torch.einsum("bhdn,bn->bhd", state, cf[:, t]))
    return torch.stack(ys, dim=1).to(x.dtype), state


def ssd_chunked(x: Tensor, log_a: Tensor, b: Tensor, c: Tensor,
                state0: Tensor, *, chunk: int = CHUNK
                ) -> Tuple[Tensor, Tensor]:
    """The same function as :func:`ssd_reference`, a chunk of ``chunk``
    tokens at a time: within a chunk a (t, s) decay-masked product, across
    chunks the state carried in f32."""
    s = x.shape[1]
    pad = (-s) % chunk
    xf, a, bf, cf = (t.to(torch.float32) for t in (x, log_a, b, c))
    if pad:                              # log decay 0 => decay 1, x = 0
        xf = nn.functional.pad(xf, (0, 0, 0, 0, 0, pad))
        a, bf, cf = (nn.functional.pad(t, (0, 0, 0, pad))
                     for t in (a, bf, cf))
    tri = torch.ones((chunk, chunk), dtype=torch.bool,
                     device=x.device).tril()[None, :, :, None]   # s <= t
    state = state0.to(torch.float32)
    out = []
    for c0 in range(0, s + pad, chunk):
        xk, ak, bk, ck = (t[:, c0:c0 + chunk] for t in (xf, a, bf, cf))
        cs = torch.cumsum(ak, dim=1)                    # (B, Q, nh) incl.
        # y_t += sum_{s<=t} exp(cs_t - cs_s) (c_t . b_s) x_s, masked
        # before the exp: the s > t half's exponents are positive
        diff = cs[:, :, None, :] - cs[:, None, :, :]    # (B, t, s, nh)
        decay = torch.exp(torch.where(tri, diff, float("-inf")))
        scores = torch.einsum("btn,bsn->bts", ck, bk)
        y = torch.einsum("btsh,bshd->bthd", scores[..., None] * decay, xk)
        # the carried state: y_t += exp(cs_t) (c_t . S)
        y = y + (torch.einsum("btn,bhdn->bthd", ck, state)
                 * torch.exp(cs)[..., None])
        # S' = exp(cs_last) S + sum_s exp(cs_last - cs_s) x_s (x) b_s
        wlast = torch.exp(cs[:, -1:] - cs)              # (B, Q, nh)
        state = (state * torch.exp(cs[:, -1])[:, :, None, None]
                 + torch.einsum("bshd,bsn->bhdn", xk * wlast[..., None], bk))
        out.append(y)
    return torch.cat(out, dim=1)[:, :s].to(x.dtype), state


def softplus(x: Tensor) -> Tensor:
    """``logaddexp(x, 0)``, as ``jax.nn.softplus`` computes it."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def mamba2_mixer(params: Mapping[str, Tensor], x: Tensor, cfg: ModelConfig,
                 cache: Optional[MambaCache] = None
                 ) -> Tuple[Tensor, MambaCache]:
    """in_proj -> conv -> SSD -> gated norm -> out_proj, for any S >= 1
    (decode: S == 1 with a cache).  ``cache`` None starts from zeros and
    returns a new :class:`MambaCache`; a given one is read, then written in
    place and returned."""
    bsz, s, _ = x.shape
    d_in, n = cfg.ssm_inner_dim, cfg.ssm_state_size
    nh, hd = cfg.ssm_num_heads, cfg.ssm_head_dim
    proj = lambda name: x @ params[name].to(x.dtype)
    z = proj("in_z")
    # the reference's three depthwise convs as one over their channels side
    # by side (a depthwise conv splits exactly: the same products a channel)
    xbc = torch.cat([proj("in_x"), proj("in_b"), proj("in_c")], dim=-1)
    w = torch.cat([params["conv_x"], params["conv_b"], params["conv_c"]],
                  dim=-1)
    xbc, new_conv = _causal_conv(xbc, w, None if cache is None
                                 else cache.conv)
    xs, b, c = silu(xbc).split([d_in, n, n], dim=-1)
    xs = xs.reshape(bsz, s, nh, hd)
    dt = softplus(proj("in_dt").to(torch.float32)
                  + params["dt_bias"])                     # (B, S, nh)
    log_a = -torch.exp(params["A_log"]) * dt               # <= 0
    x_dt = xs.to(torch.float32) * dt[..., None]
    state0 = (x.new_zeros((bsz, nh, hd, n), dtype=torch.float32)
              if cache is None else cache.ssm)
    if s == 1:
        y, state = ssd_reference(x_dt, log_a, b, c, state0)
    else:
        y, state = ssd_chunked(x_dt, log_a, b, c, state0)
    y = y + xs.to(y.dtype) * params["D"][:, None].to(y.dtype)
    y = y.reshape(bsz, s, d_in).to(x.dtype)
    y = rms_norm(y * silu(z), params["gate_norm"], cfg.norm_eps)
    out = y @ params["out_proj"].to(x.dtype)
    if cache is None:
        return out, MambaCache(state, new_conv)
    cache.ssm.copy_(state)
    cache.conv.copy_(new_conv)
    return out, cache
