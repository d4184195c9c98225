"""The port's int8 KV cache and its decode kernel against the JAX package on
the CPU: ``quantize_kv`` / ``dequantize_kv`` / ``quant_insert`` /
``init_quant_cache`` (``repro_torch.models.quantization``) against
``repro.models.quantization``, and ``decode_attention_q8`` (the plain
version the wrapper takes for CPU tensors) against the Pallas kernel
``decode_attention_pallas_q8`` in interpret mode, as
``tests/test_quantization.py`` runs it.  The same seeded numpy inputs go
to both packages.

Tolerances.  Quantization is elementwise f32 arithmetic in one order
(amax, max with 1e-8, / 127, x / scale, round half to even, clip), so
scales, codes, dequantized values and caches are compared bitwise.  The
attention outputs are held to :func:`_tol`, the JAX package's own bound
for its attention kernels against their references (2e-5 at D = 64,
``tests/test_kernels.py``; the same 2e-5 ``tests/test_quantization.py``
holds K7 to against K6 on the dequantized cache), scaled by D / 64 for
wider heads, as ``tests/test_torch_attention.py`` does.  The int8 cache
against the fp32 one is held to the JAX test's 0.03 at unit-variance
inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.kernel import decode_attention_pallas  # noqa: E402
from repro.kernels.decode_attention.kernel import decode_attention_pallas_q8  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.models import quantization as jquant  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention, decode_attention_q8, decode_attention_q8_ref,
    decode_lengths)
from repro_torch.models.quantization import (  # noqa: E402
    QuantKV, dequantize_kv, init_quant_cache, quant_insert, quantize_kv)

CPU = torch.device("cpu")


def _tol(d):
    return 2e-5 * max(1.0, d / 64)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.array(x)          # a writable copy, for torch.from_numpy


def _both_caches_equal(port: QuantKV, jax_cache) -> None:
    assert np.array_equal(port.q.numpy(), _np(jax_cache.q))
    assert np.array_equal(port.scale.numpy(), _np(jax_cache.scale))


# ---------------------------------------------------------------------------
# the KV half of models/quantization.py
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("shape,scale", [((2, 64, 4, 32), 3.0),
                                         ((2, 64, 4, 80), 1.0),
                                         ((1, 144, 32, 80), 0.9)])
def test_quantize_kv_matches_jax(shape, scale):
    """Scales and codes bitwise."""
    x = _rand(np.random.default_rng(sum(shape)), shape, scale)
    port, ref = quantize_kv(_t(x)), jquant.quantize_kv(jnp.asarray(x))
    assert port.q.dtype == torch.int8 and port.scale.dtype == torch.float32
    assert port.q.shape == shape and port.scale.shape == (*shape[:-1], 1)
    assert np.array_equal(port.scale.numpy(), _np(ref.scale))
    assert np.array_equal(port.q.numpy(), _np(ref.q))
    # the JAX test's round-trip bound: half a step of the scale grid
    err = float((dequantize_kv(port) - _t(x)).abs().max())
    assert err <= float(np.abs(x).max(-1).max()) / 127.0 * 1.01


def test_quantize_kv_all_zero_rows_use_the_floor_scale():
    x = np.zeros((1, 3, 2, 32), np.float32)
    x[0, 1, 1, 5] = -2.5
    port, ref = quantize_kv(_t(x)), jquant.quantize_kv(jnp.asarray(x))
    assert np.array_equal(port.scale.numpy(), _np(ref.scale))
    assert np.array_equal(port.q.numpy(), _np(ref.q))
    assert float(port.scale[0, 0, 0, 0]) == np.float32(1e-8) / np.float32(127)
    assert int(port.q[0, 1, 1, 5]) == -127


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dequantize_kv_bitwise(dtype):
    x = _rand(np.random.default_rng(5), (2, 40, 4, 80), 2.0)
    jq = jquant.quantize_kv(jnp.asarray(x))
    port = dequantize_kv(QuantKV(_t(_np(jq.q)), _t(_np(jq.scale))), dtype)
    ref = jquant.dequantize_kv(jq, jnp.float32 if dtype == torch.float32
                               else jnp.bfloat16)
    assert port.dtype == dtype
    assert np.array_equal(port.float().numpy(),
                          _np(ref.astype(jnp.float32)))


@pytest.mark.parametrize("case", ["scalar_1", "scalar_128", "per_slot"])
def test_quant_insert_matches_jax(case):
    rng = np.random.default_rng(11)
    b, smax, kh, d = 3, 144, 4, 80
    port = init_quant_cache(b, smax, kh, d, device="cpu")
    ref = jquant.init_quant_cache(b, smax, kh, d)
    if case == "per_slot":
        inserts = [(_rand(rng, (b, 1, kh, d)), np.array([5, 0, 143])),
                   (_rand(rng, (b, 1, kh, d)), np.array([6, 77, 142]))]
    else:
        s_new = 1 if case == "scalar_1" else 128
        inserts = [(_rand(rng, (b, s_new, kh, d)), 0),
                   (_rand(rng, (b, 1, kh, d)), s_new),
                   (_rand(rng, (b, 1, kh, d)), 143)]
    for new, pos in inserts:
        tpos = _t(pos) if isinstance(pos, np.ndarray) else pos
        jpos = jnp.asarray(pos) if isinstance(pos, np.ndarray) else pos
        out = quant_insert(port, _t(new), tpos)
        assert out is port                     # written in place
        ref = jquant.quant_insert(ref, jnp.asarray(new), jpos)
        _both_caches_equal(port, ref)


def test_quant_insert_refuses_rows_outside_the_cache():
    cache = init_quant_cache(2, 16, 2, 32, device="cpu")
    new = _t(_rand(np.random.default_rng(0), (2, 4, 2, 32)))
    with pytest.raises(ValueError, match="outside"):
        quant_insert(cache, new, 13)
    with pytest.raises(ValueError, match="one token"):
        quant_insert(cache, new, torch.tensor([0, 1]))
    row = new[:, :1]
    for pos in ([0, 16], [-1, 3]):
        with pytest.raises(ValueError, match="outside"):
            quant_insert(cache, row, torch.tensor(pos))
    for pos in (torch.tensor([0, 1, 2]), torch.tensor([0.0, 1.0])):
        with pytest.raises(ValueError, match=r"\(2,\) integer"):
            quant_insert(cache, row, pos)
    assert not cache.q.any() and not cache.scale.any()   # nothing written


def test_init_quant_cache_shapes_dtypes_and_bytes():
    cache = init_quant_cache(4, 1024, 8, 128, device="cpu")
    ref = jquant.init_quant_cache(4, 1024, 8, 128)
    assert cache.q.shape == ref.q.shape and cache.q.dtype == torch.int8
    assert cache.scale.shape == ref.scale.shape == (4, 1024, 8, 1)
    assert cache.scale.dtype == torch.float32
    assert not cache.q.any() and not cache.scale.any()
    q_bytes = cache.q.numel() + cache.scale.numel() * 4
    assert q_bytes < 0.6 * (4 * 1024 * 8 * 128 * 2)          # bf16, as JAX
    # the generator's head dim: (80 + 4) / 320 of fp32, (80 + 4) / 160 of
    # bf16
    c80 = init_quant_cache(1, 144, 32, 80, device="cpu")
    n = c80.q.numel()
    q80 = c80.q.numel() * c80.q.element_size() + \
        c80.scale.numel() * c80.scale.element_size()
    assert q80 / (4 * n) == pytest.approx(0.2625, abs=0, rel=1e-12)
    assert q80 / (2 * n) == pytest.approx(0.525, abs=0, rel=1e-12)


# ---------------------------------------------------------------------------
# decode_attention_q8 (K7) on the CPU route
# ---------------------------------------------------------------------------
def _q8_inputs(b, h, kh, smax, d, seed):
    rng = np.random.default_rng(seed)
    q = _rand(rng, (b, h, d))
    kc, vc = _rand(rng, (b, smax, kh, d)), _rand(rng, (b, smax, kh, d))
    return q, kc, vc, jquant.quantize_kv(jnp.asarray(kc)), \
        jquant.quantize_kv(jnp.asarray(vc))


def _port_q8(q, qk, qv, lengths, window=0, **kw):
    lengths = _t(lengths) if isinstance(lengths, np.ndarray) else lengths
    return decode_attention_q8(_t(q[:, None]), _t(_np(qk.q)),
                               _t(_np(qk.scale)), _t(_np(qv.q)),
                               _t(_np(qv.scale)), lengths, window=window,
                               **kw)[:, 0].numpy()


@pytest.mark.parametrize("b,h,kh,smax,d,clen,win", [
    (2, 4, 2, 256, 64, 200, 0),                # the JAX test's shapes
    (1, 8, 8, 128, 32, 128, 0),
    (2, 32, 32, 256, 80, 144, 0),              # the generator's width
    (2, 8, 2, 256, 80, 200, 50),               # GQA with a window
])
def test_decode_q8_matches_jax_k7(b, h, kh, smax, d, clen, win):
    q, kc, vc, qk, qv = _q8_inputs(b, h, kh, smax, d, smax + d + clen)
    before = decode_attention_q8.launches
    out = _port_q8(q, qk, qv, clen, win)
    assert decode_attention_q8.launches == before       # the plain route
    pal = decode_attention_pallas_q8(jnp.asarray(q), qk.q, qk.scale, qv.q,
                                     qv.scale, clen, window=win, bk=64,
                                     interpret=True)
    np.testing.assert_allclose(out, _np(pal), rtol=0, atol=_tol(d))
    # the JAX package's contract: K7 equals K6 on the dequantized cache
    deq = decode_attention_pallas(jnp.asarray(q), jquant.dequantize_kv(qk),
                                  jquant.dequantize_kv(qv), clen,
                                  window=win, bk=64, interpret=True)
    np.testing.assert_allclose(out, _np(deq), rtol=0, atol=_tol(d))
    # and the int8 cache stays within the JAX test's 0.03 of the fp32 one
    fp = jax_decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        clen, window=win)
    assert float(np.abs(out - _np(fp)).max()) < 0.03


def test_decode_q8_per_slot_lengths_match_jax_slot_by_slot():
    b, h, kh, smax, d = 4, 8, 2, 256, 80
    q, _, _, qk, qv = _q8_inputs(b, h, kh, smax, d, 3)
    lens = np.array([200, 1, 77, 256], np.int32)
    out = _port_q8(q, qk, qv, lens, 16)
    for i in range(b):
        s = slice(i, i + 1)
        pal = decode_attention_pallas_q8(
            jnp.asarray(q[s]), qk.q[s], qk.scale[s], qv.q[s], qv.scale[s],
            int(lens[i]), window=16, bk=64, interpret=True)
        np.testing.assert_allclose(out[s], _np(pal), rtol=0, atol=_tol(d))


def test_decode_q8_equals_k6_on_the_dequantized_cache():
    """On the CPU both wrappers take their plain versions, one the other
    after a dequantize: bitwise."""
    q, _, _, qk, qv = _q8_inputs(3, 8, 4, 96, 80, 4)
    lens = torch.tensor([96, 40, 1])
    out = _port_q8(q, qk, qv, lens.numpy())
    k6 = decode_attention(_t(q[:, None]),
                          dequantize_kv(QuantKV(_t(_np(qk.q)),
                                                _t(_np(qk.scale)))),
                          dequantize_kv(QuantKV(_t(_np(qv.q)),
                                                _t(_np(qv.scale)))),
                          lens)[:, 0].numpy()
    assert np.array_equal(out, k6)


def test_unit_scales_control_misses_the_bound():
    """K7 fed every scale as 1 (the int8 codes read as values) must miss
    the bound against the plain version with the true scales: the check
    that holds the kernel can tell whether the scales reached it."""
    q, _, _, qk, qv = _q8_inputs(2, 32, 32, 144, 80, 8)
    ref = decode_attention_q8_ref(_t(q), _t(_np(qk.q)), _t(_np(qk.scale)),
                                  _t(_np(qv.q)), _t(_np(qv.scale)), 129)
    ones = jquant.QuantKV(qk.q, jnp.ones_like(qk.scale))
    ones_v = jquant.QuantKV(qv.q, jnp.ones_like(qv.scale))
    got = _port_q8(q, ones, ones_v, 129)
    assert float(np.abs(got - ref.numpy()).max()) > 100 * _tol(80)


@pytest.mark.parametrize("per_slot", [False, True])
def test_slice_end_to_end_matches_jax(per_slot):
    """8 decode steps through both packages: a prompt of 32 rows inserted
    at 0, then per step one row inserted (at one position, or at (B,)
    per-slot positions) and K7 on that step's q.  Caches bitwise, outputs
    within the bound."""
    rng = np.random.default_rng(21)
    b, h, kh, d, prompt, steps = 2, 8, 4, 64, 32, 8
    smax = prompt + steps + 24
    port_k = init_quant_cache(b, smax, kh, d, device="cpu")
    port_v = init_quant_cache(b, smax, kh, d, device="cpu")
    jax_k = jquant.init_quant_cache(b, smax, kh, d)
    jax_v = jquant.init_quant_cache(b, smax, kh, d)
    k0, v0 = _rand(rng, (b, prompt, kh, d)), _rand(rng, (b, prompt, kh, d))
    quant_insert(port_k, _t(k0), 0)
    quant_insert(port_v, _t(v0), 0)
    jax_k = jquant.quant_insert(jax_k, jnp.asarray(k0), 0)
    jax_v = jquant.quant_insert(jax_v, jnp.asarray(v0), 0)
    offsets = np.array([0, 20]) if per_slot else np.array([0, 0])
    for step in range(steps):
        q = _rand(rng, (b, h, d))
        kn, vn = _rand(rng, (b, 1, kh, d)), _rand(rng, (b, 1, kh, d))
        pos = prompt + step + offsets
        if per_slot:
            quant_insert(port_k, _t(kn), _t(pos))
            quant_insert(port_v, _t(vn), _t(pos))
            jax_k = jquant.quant_insert(jax_k, jnp.asarray(kn),
                                        jnp.asarray(pos))
            jax_v = jquant.quant_insert(jax_v, jnp.asarray(vn),
                                        jnp.asarray(pos))
            lens = torch.from_numpy(pos + 1)
        else:
            quant_insert(port_k, _t(kn), int(pos[0]))
            quant_insert(port_v, _t(vn), int(pos[0]))
            jax_k = jquant.quant_insert(jax_k, jnp.asarray(kn), int(pos[0]))
            jax_v = jquant.quant_insert(jax_v, jnp.asarray(vn), int(pos[0]))
            lens = int(pos[0]) + 1
        _both_caches_equal(port_k, jax_k)
        _both_caches_equal(port_v, jax_v)
        out = decode_attention_q8(_t(q[:, None]), port_k.q, port_k.scale,
                                  port_v.q, port_v.scale, lens)[:, 0]
        for i in range(b):
            s = slice(i, i + 1)
            pal = decode_attention_pallas_q8(
                jnp.asarray(q[s]), jax_k.q[s], jax_k.scale[s], jax_v.q[s],
                jax_v.scale[s], int(pos[i]) + 1, bk=smax, interpret=True)
            np.testing.assert_allclose(out[s].numpy(), _np(pal), rtol=0,
                                       atol=_tol(d))


def test_decode_q8_refusals():
    q, _, _, qk, qv = _q8_inputs(2, 4, 2, 64, 64, 6)
    tq = _t(q[:, None])
    kq, ks, vq, vs = (_t(_np(a)) for a in (qk.q, qk.scale, qv.q, qv.scale))
    with pytest.raises(TypeError, match="k, v of torch.int8"):
        decode_attention_q8(tq, kq.float(), ks, vq.float(), vs, 8)
    with pytest.raises(TypeError, match="k, v of torch.int8"):
        decode_attention_q8(tq, kq.to(torch.uint8), ks, vq, vs, 8)
    with pytest.raises(TypeError, match="float32 scales"):
        decode_attention_q8(tq, kq, ks.double(), vq, vs.double(), 8)
    with pytest.raises(TypeError):
        decode_attention_q8(tq.half(), kq, ks, vq, vs, 8)
    with pytest.raises(ValueError, match="scales"):
        decode_attention_q8(tq, kq, ks[:, :32], vq, vs, 8)
    with pytest.raises(ValueError, match="scales"):
        decode_attention_q8(tq, kq, ks, vq, vs[..., 0], 8)
    with pytest.raises(ValueError, match="scales"):
        decode_attention_q8(tq, kq, ks.expand(2, 64, 2, 4), vq, vs, 8)
    for bad in (0, -3, torch.tensor([5, 0])):
        with pytest.raises(ValueError, match=">= 1"):
            decode_attention_q8(tq, kq, ks, vq, vs, bad)
    with pytest.raises(ValueError, match="DecodeLengths"):
        decode_attention_q8(tq[:1], kq[:1], ks[:1], vq[:1], vs[:1],
                            decode_lengths(torch.tensor([3, 4]), 2, CPU))
    q96 = _t(_rand(np.random.default_rng(0), (1, 1, 4, 96)))
    c96 = quantize_kv(_t(_rand(np.random.default_rng(1), (1, 8, 4, 96))))
    with pytest.raises(ValueError, match="head dims"):
        decode_attention_q8(q96, c96.q, c96.scale, c96.q, c96.scale, 8)
    with pytest.raises(ValueError, match="window"):
        decode_attention_q8(tq, kq, ks, vq, vs, 8, window=-1)
