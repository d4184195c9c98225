"""The port's model against the JAX package at ``.reduced(num_layers=2,
d_model=128)`` with the JAX params carried over (``params_from_jax``):
prefill and decode logits, encode embeddings, and greedy tokens.

Tolerance: both sides compute in fp32 on the CPU, but XLA and ATen block
their matmuls and evaluate exp / sin / cos / rsqrt differently, a few ulps
per op.  Through two blocks the logits (|x| < 4 here) differ by ~2e-6; the
bound 2e-5 leaves an order of magnitude for that drift.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import decode_step as jax_decode  # noqa: E402
from repro.models import encode as jax_encode  # noqa: E402
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import (decode_step, encode, init_cache,  # noqa: E402
                                init_params, param_count, prefill)

TOL = 2e-5


def _cfgs(name):
    cfg = get_config(name).reduced(num_layers=2, d_model=128)
    jcfg = jax_get_config(name).reduced(num_layers=2, d_model=128)
    return cfg, jcfg


def _jitted(jcfg):
    """jit the JAX serve steps once per config: eager dispatch of the
    unjitted layer scan costs seconds per step on the CPU."""
    return (jax.jit(lambda p, b, c: jax_prefill(p, jcfg, b, c)),
            jax.jit(lambda p, t, c, n: jax_decode(p, jcfg, t, c, n)))


def _carried(name, seed=0):
    cfg, jcfg = _cfgs(name)
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return cfg, jcfg, params, model


@pytest.mark.parametrize("name", ["sheared-llama-2.7b", "gte-base-en-v1.5"])
def test_config_copy_matches_reference(name):
    full = get_config(name)
    assert dataclasses.asdict(full) == dataclasses.asdict(jax_get_config(name))
    cfg, jcfg = _cfgs(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert full.param_count() == jax_get_config(name).param_count()


def test_param_count_matches_config():
    cfg, _ = _cfgs("sheared-llama-2.7b")
    model = init_params(cfg, seed=1, device="cpu")
    assert param_count(model) == cfg.param_count()
    assert model.lm_head is not None            # untied head
    assert float(model.blocks[0].norm1.abs().sum()) == 0.0   # 1 + w norms


def test_prefill_and_decode_logits_match_jax():
    cfg, jcfg, params, model = _carried("sheared-llama-2.7b")
    jprefill, jdecode = _jitted(jcfg)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    toks[:, :5] = 0                              # left padding, attended
    max_len = 32
    jc = jax_init_cache(jcfg, 2, max_len)
    jl, jc = jprefill(params, {"tokens": jnp.asarray(toks)}, jc)
    pc = init_cache(cfg, 2, max_len, device=torch.device("cpu"))
    pl, pc = prefill(model, {"tokens": torch.from_numpy(toks).long()}, pc)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0, atol=TOL)
    cache_len = toks.shape[1]
    for _ in range(4):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdecode(params, jnp.asarray(nxt), jc, cache_len)
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc,
                             cache_len)
        np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                                   atol=TOL)
        cache_len += 1


def test_greedy_tokens_match_jax_where_margin_exceeds_tol():
    cfg, jcfg, params, model = _carried("sheared-llama-2.7b", seed=3)
    jprefill, jdecode = _jitted(jcfg)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 16)).astype(np.int32)
    jc = jax_init_cache(jcfg, 1, 40)
    pc = init_cache(cfg, 1, 40, device=torch.device("cpu"))
    jl, jc = jprefill(params, {"tokens": jnp.asarray(toks)}, jc)
    pl, pc = prefill(model, {"tokens": torch.from_numpy(toks).long()}, pc)
    checked = 0
    for step in range(12):
        jl_np = np.asarray(jl)[0]
        top2 = np.sort(jl_np)[-2:]
        jt, pt = int(jl_np.argmax()), int(pl[0].argmax())
        if top2[1] - top2[0] > 2 * TOL:
            assert jt == pt, step
            checked += 1
        nxt = np.array([[jt]], np.int32)
        jl, jc = jdecode(params, jnp.asarray(nxt), jc, 16 + step)
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc,
                             16 + step)
    assert checked >= 10


def test_encode_matches_jax():
    cfg, jcfg, params, model = _carried("gte-base-en-v1.5")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    mask[1, 12:] = 0
    mask[2, 5:] = 0
    je = jax_encode(params, jcfg, {"tokens": jnp.asarray(toks),
                                   "attn_mask": jnp.asarray(mask)})
    pe = encode(model, {"tokens": torch.from_numpy(toks).long(),
                        "attn_mask": torch.from_numpy(mask)})
    np.testing.assert_allclose(pe.numpy(), np.asarray(je), rtol=0, atol=TOL)


def test_other_block_kinds_raise():
    """Every kind of the reference builds now; a kind it does not know
    still raises, as the reference's ``_init_block`` does."""
    cfg = dataclasses.replace(get_config("sheared-llama-2.7b").reduced(),
                              block_pattern=("retnet",))
    with pytest.raises(ValueError, match="unknown block kinds"):
        init_params(cfg, device="cpu")


@pytest.mark.parametrize("causal,window,kh", [(True, 0, 4), (False, 0, 2),
                                              (True, 24, 1)])
def test_attention_functions_match_jax(causal, window, kh):
    """The three plain attention functions against the JAX ones (GQA,
    masks, the online-softmax chunking over several KV blocks)."""
    from repro.models import attention as jattn
    from repro_torch.models import attention as attn
    rng = np.random.default_rng(kh)
    q = rng.standard_normal((2, 40, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, 40, kh, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, kh, 16)).astype(np.float32)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    j = [jnp.asarray(a) for a in (q, k, v)]
    ref = np.asarray(jattn.attend_reference(*j, causal=causal, window=window))
    for out in (attn.attend_reference(*t, causal=causal, window=window),
                attn.attend_chunked(*t, causal=causal, window=window,
                                    block_kv=16)):
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL)
    jd = jattn.attend_decode(j[0][:, :1], j[1], j[2], 25, window=window)
    pd = attn.attend_decode(t[0][:, :1], t[1], t[2], 25, window=window)
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=0, atol=TOL)
