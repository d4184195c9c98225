"""The port's attention against the JAX package on the CPU: the plain
versions of the prefill and decode attention kernels (``flash_attention``,
``decode_attention``) against the Pallas kernels in interpret mode and their
jnp references, per-slot decode lengths against the model's
``attend_decode``, the per-slot ``KVCache.insert``, the ring caches of
sliding-window layers (insert, prefill scatter, ``attend_decode(circular=
True)``), and ``decode_step`` / ``prefill`` / ``encode`` of carried-over
models, also through the route the model takes on the card (the wrappers,
here in their CPU versions).

Tolerance: both packages compute in fp32 on the CPU with other blockings and
exp implementations.  :func:`_tol` is the JAX package's own bound for its
kernels against their references (2e-5 at D = 64, unit-normal inputs,
``tests/test_kernels.py``), scaled by D / 64 for wider heads: a score's
rounding grows with the number of terms.  bf16 outputs, each rounded once
from f32, may also land one bf16 ulp of the reference element apart
(:func:`_bf16_ulp`).  The bound is tight enough to catch K and V staged in
bf16 (``test_f32_bound_catches_kv_rounded_to_bf16``).  Model logits use
2e-5, as ``tests/test_torch_model.py`` does.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.kernel import flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import decode_step as jax_decode  # noqa: E402
from repro.models import encode as jax_encode  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.cache import KVCache as JaxKVCache  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    DecodeLengths, decode_attention, decode_lengths)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, flash_attention, flash_attention_ref)
from repro_torch.models import (decode_step, encode, init_cache,  # noqa: E402
                                prefill)
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.cache import KVCache  # noqa: E402

MODEL_TOL = 2e-5


def _tol(d):
    return 2e-5 * max(1.0, d / 64)


def _bf16_ulp(ref):
    """One bf16 ulp of each element of ``ref`` (0 where it is 0)."""
    ref = np.asarray(ref, np.float32)
    _, e = np.frexp(ref)
    return np.where(ref == 0, 0.0, np.ldexp(1.0, e - 8))


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _port_flash(q, k, v, causal, window):
    """Head-major numpy in and out, through the port's wrapper (model
    layout) where it takes the head dim, else its plain version."""
    if q.shape[-1] in HEAD_DIMS:
        out = flash_attention(_t(q.transpose(0, 2, 1, 3)),
                              _t(k.transpose(0, 2, 1, 3)),
                              _t(v.transpose(0, 2, 1, 3)), causal=causal,
                              window=window)
        return out.transpose(1, 2).float().numpy()
    return flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                               window=window).numpy()


# ---------------------------------------------------------------------------
# flash attention (K5)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,kh,sq,skv,d,causal,win", [
    (2, 4, 2, 128, 128, 64, True, 0),
    (1, 4, 4, 256, 256, 32, True, 64),
    (2, 2, 1, 128, 256, 64, False, 0),
    (1, 8, 2, 64, 64, 128, True, 0),
    (1, 2, 2, 192, 192, 64, True, 100),
    (1, 4, 4, 128, 128, 80, True, 0),          # sheared-llama's head dim
    (2, 4, 1, 64, 128, 80, False, 48),
    (1, 4, 2, 192, 192, 256, True, 64),        # gemma3's head dim, GQA 2
    (1, 2, 1, 128, 128, 256, False, 0),
])
def test_flash_plain_matches_jax_pallas_and_ref(b, h, kh, sq, skv, d, causal,
                                                win):
    rng = np.random.default_rng(sq + d)
    q, k, v = (_rand(rng, (b, n, s, d)) for n, s in
               ((h, sq), (kh, skv), (kh, skv)))
    out = _port_flash(q, k, v, causal, win)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pal = flash_attention_pallas(jq, jk, jv, causal=causal, window=win,
                                 bq=64, bk=64, interpret=True)
    ref = jax_flash_ref(jq, jk, jv, causal=causal, window=win)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=_tol(d))
    np.testing.assert_allclose(out, np.asarray(pal), rtol=0, atol=_tol(d))


@pytest.mark.parametrize("sq,skv,h,kh,d,causal,win", [
    (77, 150, 4, 1, 80, True, 0),
    (150, 77, 4, 2, 80, False, 20),   # rows q >= 96 have no valid key
    (33, 33, 2, 2, 64, True, 7),
    (1, 129, 2, 1, 128, False, 0),
])
def test_flash_plain_ragged_matches_jax_ref(sq, skv, h, kh, d, causal, win):
    """Lengths off the TPU kernel's block multiple: against the jnp
    reference only (the Pallas kernel asserts on them)."""
    rng = np.random.default_rng(sq * skv)
    q, k, v = (_rand(rng, (2, n, s, d)) for n, s in
               ((h, sq), (kh, skv), (kh, skv)))
    out = _port_flash(q, k, v, causal, win)
    ref = jax_flash_ref(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                        window=win)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=_tol(d))


def test_flash_plain_bf16_matches_jax_ref():
    rng = np.random.default_rng(9)
    tq, tk, tv = (_t(_rand(rng, (1, 2, 128, 64))).bfloat16()
                  for _ in range(3))
    out = _port_flash(*(t.float().numpy() for t in (tq, tk, tv)), True, 0)
    port = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                           tv.transpose(1, 2)).transpose(1, 2)
    assert port.dtype == torch.bfloat16
    ref = jax_flash_ref(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                          for t in (tq, tk, tv)))
    ref = np.asarray(ref, np.float32)
    allow = _tol(64) + _bf16_ulp(ref)
    assert (np.abs(port.float().numpy() - ref) <= allow).all()
    assert (np.abs(out - ref) <= allow).all()


@pytest.mark.parametrize("shape", ["prefill", "encode", "decode"])
def test_f32_bound_catches_kv_rounded_to_bf16(shape):
    """A control for the bound: the plain version on K and V rounded to
    bf16 (what a kernel staging them in bf16 would compute) misses
    :func:`_tol` at the model's prefill, encode and decode shapes, while
    the f32 plain version meets it against the JAX reference."""
    rng = np.random.default_rng(11)
    bf = lambda a: _t(a).bfloat16().float().numpy()
    if shape == "decode":                  # (1, 32, 80), cache 144, len 129
        q = _rand(rng, (1, 32, 80))
        kc, vc = _rand(rng, (1, 144, 32, 80)), _rand(rng, (1, 144, 32, 80))
        ref = np.asarray(jax_decode_ref(*(jnp.asarray(a) for a in (q, kc, vc)),
                                        129))
        run = lambda k, v: decode_attention(_t(q[:, None]), _t(k), _t(v),
                                            129)[:, 0].numpy()
        k, v, d = kc, vc, 80
    else:
        b, h, d, causal = ((1, 32, 80, True) if shape == "prefill"
                           else (2, 12, 64, False))
        q, k, v = (_rand(rng, (b, h, 128, d)) for _ in range(3))
        ref = np.asarray(jax_flash_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                       causal=causal))
        run = lambda k, v: _port_flash(q, k, v, causal, 0)
    np.testing.assert_allclose(run(k, v), ref, rtol=0, atol=_tol(d))
    assert np.abs(run(bf(k), bf(v)) - ref).max() > _tol(d)


def _tf32(a):
    """``a`` rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, as ``cvt.rna.tf32.f32`` rounds on the card."""
    bits = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000))
            & np.uint32(0xFFFFE000)).view(np.float32)


def _tf32_matmul(a, b, passes):
    """a @ b in f32 with every product made of TF32 parts: 3 passes add
    lo.hi + hi.lo + hi.hi (lo = tf32(x - hi)), small terms first; 1 pass
    takes hi.hi alone."""
    ah, bh = _tf32(a), _tf32(b)
    if passes == 1:
        return ah @ bh
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _tf32_attention(q, k, v, causal, passes):
    """Head-major attention with the prefill kernel's arithmetic: q
    pre-scaled, S = q k^T and P V through :func:`_tf32_matmul`, P = exp(S -
    max) in f32, divided by its row sum at the end."""
    s = _tf32_matmul(q * np.float32(q.shape[-1] ** -0.5),
                     k.swapaxes(-1, -2), passes)
    if causal:
        s = np.where(np.tril(np.ones(s.shape[-2:], bool)), s,
                     np.float32(-1e30))
    p = np.exp(s - s.max(-1, keepdims=True))
    return _tf32_matmul(p, v, passes) / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("shape", ["prefill", "encode"])
def test_f32_bound_holds_3xtf32_and_catches_1xtf32(shape):
    """The tensor-core arithmetic of the prefill kernel against the bound:
    with every product of S and of P V as 3xTF32 (what the kernel issues)
    attention stays within :func:`_tol` of the plain version at the
    model's prefill and encode shapes; with one TF32 product (what a
    1xTF32 kernel would compute) it misses the bound."""
    rng = np.random.default_rng(12)
    b, h, d, causal = ((1, 32, 80, True) if shape == "prefill"
                       else (2, 12, 64, False))
    q, k, v = (_rand(rng, (b, h, 128, d)) for _ in range(3))
    plain = _port_flash(q, k, v, causal, 0)
    err = {n: np.abs(_tf32_attention(q, k, v, causal, n) - plain).max()
           for n in (3, 1)}
    assert err[3] <= _tol(d) < err[1], err


# ---------------------------------------------------------------------------
# decode attention (K6)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("b,h,kh,smax,d,clen,win", [
    (2, 4, 2, 512, 64, 300, 0),
    (1, 8, 8, 256, 32, 256, 64),
    (3, 4, 1, 512, 128, 17, 0),
    (1, 2, 2, 1024, 64, 1024, 0),
    (1, 4, 4, 128, 64, 10_000, 0),             # ring: every slot valid
    (2, 4, 4, 256, 80, 144, 0),                # the main path's head dim
    (2, 8, 2, 256, 80, 200, 50),
    (1, 4, 2, 256, 256, 10_000, 0),            # head dim 256: a ring
    (2, 4, 2, 256, 256, 200, 50),              # and a window
])
def test_decode_plain_matches_jax_pallas_and_ref(b, h, kh, smax, d, clen,
                                                 win):
    rng = np.random.default_rng(smax + d + clen)
    q = _rand(rng, (b, h, d))
    kc, vc = _rand(rng, (b, smax, kh, d)), _rand(rng, (b, smax, kh, d))
    out = decode_attention(_t(q[:, None]), _t(kc), _t(vc), clen,
                           window=win)[:, 0].numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, kc, vc))
    pal = decode_attention_pallas(jq, jk, jv, clen, window=win,
                                  bk=min(128, smax), interpret=True)
    ref = jax_decode_ref(jq, jk, jv, clen, window=win)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=_tol(d))
    np.testing.assert_allclose(out, np.asarray(pal), rtol=0, atol=_tol(d))


@pytest.mark.parametrize("lens,win,kh", [
    ([1, 77, 144, 130], 0, 4),
    ([5, 150, 31, 144], 16, 2),
    ([1000, 70, 144, 2], 5, 1),      # a window can leave nothing valid
])
def test_decode_per_slot_lengths_match_jax_attend_decode(lens, win, kh):
    rng = np.random.default_rng(len(lens) + win)
    q = _rand(rng, (4, 1, 8, 80))
    kc, vc = _rand(rng, (4, 144, kh, 80)), _rand(rng, (4, 144, kh, 80))
    ref = np.asarray(jattn.attend_decode(
        *(jnp.asarray(a) for a in (q, kc, vc)),
        jnp.asarray(lens, jnp.int32), window=win))
    lengths = torch.tensor(lens, dtype=torch.int32)
    checked = decode_lengths(lengths, 4, torch.device("cpu"))
    assert isinstance(checked, DecodeLengths)
    for out in (decode_attention(_t(q), _t(kc), _t(vc), lengths, window=win),
                decode_attention(_t(q), _t(kc), _t(vc), checked, window=win),
                attn.attend_decode(_t(q), _t(kc), _t(vc), lengths,
                                   window=win)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=_tol(80))


def test_kv_cache_insert_per_slot_matches_jax():
    rng = np.random.default_rng(4)
    k, v = _rand(rng, (3, 10, 2, 8)), _rand(rng, (3, 10, 2, 8))
    kn, vn = _rand(rng, (3, 1, 2, 8)), _rand(rng, (3, 1, 2, 8))
    pos = np.array([0, 9, 4], np.int32)
    jc = JaxKVCache(jnp.asarray(k), jnp.asarray(v)).insert(
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos), circular=False)
    pc = KVCache(_t(k), _t(v))
    kept = pc.k
    pc.insert(_t(kn), _t(vn), torch.from_numpy(pos).long())
    assert pc.k is kept                          # written in place
    assert np.array_equal(pc.k.numpy(), np.asarray(jc.k))
    assert np.array_equal(pc.v.numpy(), np.asarray(jc.v))
    with pytest.raises(ValueError, match="one token"):
        pc.insert(_t(k[:, :2]), _t(v[:, :2]), torch.from_numpy(pos).long())


# ---------------------------------------------------------------------------
# ring caches of sliding-window layers
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("per_slot", [False, True])
def test_kv_cache_ring_insert_matches_jax(per_slot):
    """Positions past the ring's 10 rows write at ``pos % 10``, in place."""
    rng = np.random.default_rng(8)
    k, v = _rand(rng, (3, 10, 2, 8)), _rand(rng, (3, 10, 2, 8))
    kn, vn = _rand(rng, (3, 1, 2, 8)), _rand(rng, (3, 1, 2, 8))
    pos = np.array([3, 10, 27], np.int32) if per_slot else 23
    jc = JaxKVCache(jnp.asarray(k), jnp.asarray(v)).insert(
        jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(pos), circular=True)
    pc = KVCache(_t(k), _t(v), circular=True)
    kept = pc.k
    pc.insert(_t(kn), _t(vn), torch.from_numpy(pos).long() if per_slot
              else pos)
    assert pc.k is kept
    assert np.array_equal(pc.k.numpy(), np.asarray(jc.k))
    assert np.array_equal(pc.v.numpy(), np.asarray(jc.v))


@pytest.mark.parametrize("s", [7, 16, 37])
def test_kv_cache_ring_prefill_matches_the_jax_scatter(s):
    """A prompt of ``s`` positions into a 16-row ring: from row 0 while it
    fits, else its last 16 tokens at ``p % 16`` (the JAX model's prefill,
    ``repro/models/model.py``, restated here on the JAX arrays)."""
    rng = np.random.default_rng(s)
    size = 16
    k, v = _rand(rng, (2, s, 2, 8)), _rand(rng, (2, s, 2, 8))
    zeros = jnp.zeros((2, size, 2, 8), jnp.float32)
    jc = JaxKVCache(zeros, zeros)
    if s <= size:
        jc = jc.insert(jnp.asarray(k), jnp.asarray(v), 0, circular=False)
    else:
        pos = jnp.arange(s - size, s) % size
        jc = JaxKVCache(jc.k.at[:, pos].set(jnp.asarray(k)[:, -size:]),
                        jc.v.at[:, pos].set(jnp.asarray(v)[:, -size:]))
    pc = KVCache(torch.zeros(zeros.shape), torch.zeros(zeros.shape),
                 circular=True)
    pc.prefill(_t(k), _t(v))
    assert np.array_equal(pc.k.numpy(), np.asarray(jc.k))
    assert np.array_equal(pc.v.numpy(), np.asarray(jc.v))
    full = KVCache(torch.zeros((2, 40, 2, 8)), torch.zeros((2, 40, 2, 8)))
    full.prefill(_t(k), _t(v))                # not a ring: from row 0
    assert np.array_equal(full.k[:, :s].numpy(), k)


@pytest.mark.parametrize("lens", [5, 64, 300, [1, 63, 64, 900]])
def test_attend_decode_circular_matches_jax(lens):
    """A 64-row ring: rows below ``min(length, 64)`` valid, the window
    ignored; and K6's CPU version with no window gives the same."""
    rng = np.random.default_rng(9)
    q = _rand(rng, (4, 1, 8, 64))
    kc, vc = _rand(rng, (4, 64, 2, 64)), _rand(rng, (4, 64, 2, 64))
    ref = np.asarray(jattn.attend_decode(
        *(jnp.asarray(a) for a in (q, kc, vc)), jnp.asarray(lens),
        window=64, circular=True))
    tl = torch.tensor(lens) if isinstance(lens, list) else lens
    for out in (attn.attend_decode(_t(q), _t(kc), _t(vc), tl, window=64,
                                   circular=True),
                decode_attention(_t(q), _t(kc), _t(vc), tl)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=_tol(64))


# ---------------------------------------------------------------------------
# the model: carried-over params, the CPU route and the card's route
# ---------------------------------------------------------------------------
def _hd80_cfgs():
    """Sheared-llama's head dim 80 at a tiny width, on both packages."""
    kw = dict(num_layers=2, d_model=160, num_heads=2, num_kv_heads=2,
              head_dim=80, d_ff=256, vocab_size=512)
    return (dataclasses.replace(get_config("sheared-llama-2.7b"), **kw),
            dataclasses.replace(jax_get_config("sheared-llama-2.7b"), **kw))


def _carried(cfg, jcfg, seed):
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    return params, params_from_jax(jax.tree.map(np.asarray, params), cfg,
                                   device="cpu")


class _Wrappers:
    """Stands in for ``models.attention`` inside the model: every attention
    call goes to the functions the model calls on the card
    (``flash_attention`` / ``decode_attention``), whose wrappers run their
    CPU versions on these CPU tensors."""

    @staticmethod
    def attend_reference(q, k, v, *, causal, window, logit_cap):
        assert not logit_cap
        return flash_attention(q, k, v, causal=causal, window=window)

    attend_chunked = attend_reference

    @staticmethod
    def attend_decode(q, k_cache, v_cache, lengths, *, window, logit_cap,
                      circular):
        """As the model on the card: no window over a ring."""
        assert not logit_cap
        return decode_attention(q, k_cache, v_cache, lengths,
                                window=0 if circular else window)


@pytest.fixture(params=["cpu", "wrappers"])
def route(request, monkeypatch):
    """``wrappers``: the model's attention is the kernels' wrappers
    (:class:`_Wrappers`); ``cpu``: the model as it runs on the CPU."""
    if request.param == "wrappers":
        monkeypatch.setattr(model_mod, "attn_lib", _Wrappers)
    return request.param


def test_decode_step_per_slot_lengths_match_jax(route):
    cfg, jcfg = _hd80_cfgs()
    params, model = _carried(cfg, jcfg, 0)
    jdecode = jax.jit(lambda p, t, c, n: jax_decode(p, jcfg, t, c, n))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    jc = jax_init_cache(jcfg, 3, 24)
    jl, jc = jax_prefill(params, jcfg, {"tokens": jnp.asarray(toks)}, jc)
    pc = init_cache(cfg, 3, 24, device=torch.device("cpu"))
    prefill(model, {"tokens": _t(toks).long()}, pc)
    lens = np.array([12, 7, 3], np.int32)       # slots at other positions
    for _ in range(3):
        nxt = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
        jl, jc = jdecode(params, jnp.asarray(nxt), jc, jnp.asarray(lens))
        pl, pc = decode_step(model, _t(nxt).long(), pc, torch.from_numpy(lens))
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                                   atol=MODEL_TOL)
        lens = lens + np.array([1, 2, 1], np.int32)


def test_head_dim_80_model_matches_jax(route):
    """Prefill, scalar-length decode and greedy tokens of a head-dim-80
    model (the width at which the generator runs K5 and K6 on the card)."""
    cfg, jcfg = _hd80_cfgs()
    params, model = _carried(cfg, jcfg, 1)
    jprefill = jax.jit(lambda p, b, c: jax_prefill(p, jcfg, b, c))
    jdecode = jax.jit(lambda p, t, c, n: jax_decode(p, jcfg, t, c, n))
    toks = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 20)).astype(np.int32)
    jc = jax_init_cache(jcfg, 2, 32)
    pc = init_cache(cfg, 2, 32, device=torch.device("cpu"))
    jl, jc = jprefill(params, {"tokens": jnp.asarray(toks)}, jc)
    pl, pc = prefill(model, {"tokens": _t(toks).long()}, pc)
    checked = 0
    for step in range(10):
        jl_np = np.asarray(jl)
        np.testing.assert_allclose(pl.numpy(), jl_np, rtol=0, atol=MODEL_TOL)
        top2 = np.sort(jl_np, axis=1)[:, -2:]
        jt, pt = jl_np.argmax(1), pl.numpy().argmax(1)
        sure = top2[:, 1] - top2[:, 0] > 2 * MODEL_TOL
        assert np.array_equal(jt[sure], pt[sure]), step
        checked += int(sure.sum())
        nxt = jt.astype(np.int32)[:, None]
        jl, jc = jdecode(params, jnp.asarray(nxt), jc, 20 + step)
        pl, pc = decode_step(model, _t(nxt).long(), pc, 20 + step)
    assert checked >= 16


def test_sliding_window_model_matches_jax(route):
    """gemma3-12b ``.reduced()`` (5 ``"swa"`` layers of window 64 and a
    global one): a 90-position prompt past the window, then 6 greedy steps,
    on the route of ``route`` (the card's passes the window to K5 and
    none to K6 over a ring)."""
    cfg = get_config("gemma3-12b").reduced()
    jcfg = jax_get_config("gemma3-12b").reduced()
    params, model = _carried(cfg, jcfg, 3)
    jprefill = jax.jit(lambda p, b, c: jax_prefill(p, jcfg, b, c))
    jdecode = jax.jit(lambda p, t, c, n: jax_decode(p, jcfg, t, c, n))
    toks = np.random.default_rng(10).integers(
        0, cfg.vocab_size, (2, 90)).astype(np.int32)
    jc = jax_init_cache(jcfg, 2, 104)
    pc = init_cache(cfg, 2, 104, device=torch.device("cpu"))
    jl, jc = jprefill(params, {"tokens": jnp.asarray(toks)}, jc)
    pl, pc = prefill(model, {"tokens": _t(toks).long()}, pc)
    for step in range(6):
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                                   atol=MODEL_TOL)
        nxt = np.asarray(jl).argmax(1).astype(np.int32)[:, None]
        jl, jc = jdecode(params, jnp.asarray(nxt), jc, 90 + step)
        pl, pc = decode_step(model, _t(nxt).long(), pc, 90 + step)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=MODEL_TOL)


def test_encode_matches_jax(route):
    """gte-base (non-causal, head dim 64) on the route of ``route``."""
    cfg = get_config("gte-base-en-v1.5").reduced(num_layers=2, d_model=128)
    jcfg = jax_get_config("gte-base-en-v1.5").reduced(num_layers=2,
                                                       d_model=128)
    params, model = _carried(cfg, jcfg, 2)
    rng = np.random.default_rng(6)
    toks = rng.integers(0, cfg.vocab_size, (3, 24)).astype(np.int32)
    mask = np.ones((3, 24), np.int32)
    mask[1, 15:] = 0
    je = jax_encode(params, jcfg, {"tokens": jnp.asarray(toks),
                                   "attn_mask": jnp.asarray(mask)})
    pe = encode(model, {"tokens": _t(toks).long(), "attn_mask": _t(mask)})
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=0,
                               atol=MODEL_TOL)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------
def test_wrappers_refuse_length_zero_and_unbuilt_head_dims():
    rng = np.random.default_rng(7)
    q, k, v = (_t(_rand(rng, (2, 8, 4, 64))) for _ in range(3))
    for bad in (0, -1, torch.tensor([3, 0])):
        with pytest.raises(ValueError, match=">= 1"):
            decode_attention(q[:, :1], k, v, bad)
        with pytest.raises(ValueError, match=">= 1"):
            decode_lengths(bad, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="DecodeLengths"):   # another B
        decode_attention(q[:1, :1], k[:1], v[:1], decode_lengths(
            torch.tensor([3, 4]), 2, torch.device("cpu")))
    q96 = _t(_rand(rng, (2, 8, 4, 96)))
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q96, q96, q96)
    with pytest.raises(ValueError, match="head dims"):
        decode_attention(q96[:, :1], q96, q96, 8)
    with pytest.raises(TypeError):
        flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :, :3], v[:, :, :3])   # H % KH != 0


def test_model_softcap_runs_capped_on_the_cpu():
    """A logit softcap stays the CPU's plain route; on the card the model
    refuses it (``test_torch_kernels.py``, ``gpu``)."""
    cfg = dataclasses.replace(get_config("sheared-llama-2.7b").reduced(
        num_layers=1, d_model=128), attn_logit_softcap=30.0)
    model = model_mod.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    cache = init_cache(cfg, 1, 8, device=torch.device("cpu"))
    logits, _ = prefill(model, {"tokens": toks}, cache)
    assert torch.isfinite(logits).all()
