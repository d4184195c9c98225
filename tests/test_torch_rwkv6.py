"""The RWKV6 block (``repro_torch.models.rwkv6``) and rwkv6-1.6b against the
JAX package: ``wkv6_recurrent`` / ``wkv6_chunked`` at
``tests/test_mixers.py``'s cases and under the strongest decays, a chunked
prefill continued by recurrent steps, ``RwkvBlock`` against
``rwkv6_block`` from a non-zero cache, the config copy, the parameter
tree, ``params_from_jax``, prefill and decode logits, the batcher, the
generator, ``serve`` and ``encode``.

Sizes: the WKV functions at (B 2, H 3, K 8) as ``tests/test_mixers.py``
has them; the model at ``.reduced(num_layers=2, d_model=128)`` (4 WKV heads
of 32, d_ff 256, vocab 512).

Tolerances, both sides fp32 on the CPU:
- ``TOL`` = 2e-5 on block outputs, states and logits, as
  ``tests/test_torch_archs.py`` states it (XLA and ATen order their sums,
  and evaluate exp / tanh / rsqrt, a few ulps apart);
- ``WKV_TOL`` = 1e-4 (absolute and relative) between the chunked and the
  recurrent forms of one package, ``tests/test_mixers.py``'s: the two sum
  the same terms in other orders, and the chunked form's decays are
  differences of cumulative sums.  A port form against the JAX package's
  same form is held to ``TOL``, absolute and relative: its outputs and
  states are sums over the sequence and grow with it (to ~10 here), and
  the two packages' sums of the same terms drift by ~3e-6 of them.
"""
import contextlib
import dataclasses
import io

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
from repro.models.rwkv6 import RwkvCache as JaxRwkvCache  # noqa: E402
from repro.models.rwkv6 import init_rwkv6 as jax_init_rwkv6  # noqa: E402
from repro.models.rwkv6 import rwkv6_block as jax_rwkv6_block  # noqa: E402
from repro.models.rwkv6 import wkv6_chunked as jax_chunked  # noqa: E402
from repro.models.rwkv6 import wkv6_recurrent as jax_recurrent  # noqa: E402
from repro.serving.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from repro.serving.engine import GeneratorModel as JaxGenerator  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (cache_bytes, decode_step,  # noqa: E402
                                encode, init_cache, init_params,
                                param_count, prefill)
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.rwkv6 import (RwkvBlock, RwkvCache,  # noqa: E402
                                      wkv6_chunked, wkv6_recurrent)
from repro_torch.serving import ContinuousBatcher, GeneratorModel  # noqa

TOL, WKV_TOL = 2e-5, 1e-4
NAME = "rwkv6-1.6b"
# the JAX init_params tree's leaves (the reference's param_count() counts
# 57 x d_model more a layer: ROADMAP's caveats of the reference)
TREE_PARAMS = {"full": 1_483_180_032, "reduced": 461_440}
CFG_PARAMS = {"full": 1_485_981_696, "reduced": 476_032}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _first_exp():
    """torch 2.13.0 built for the CPU computes the first float32 ``exp`` of
    a process wrong by up to ~1e-4 in some runs when that call is large
    enough to run on several threads (a ``where`` then an ``exp`` of
    12,288 elements was off in 8 of 40 fresh processes, with or without
    JAX imported); every later call, and a first call of a few elements,
    is right.  The port's chunked WKV is such a call, so the module makes
    one small call first, before any comparison."""
    torch.exp(torch.zeros(4))


def _reduced(get):
    return get(NAME).reduced(num_layers=2, d_model=128)


def _carried(cfg, jcfg, seed):
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return params, model


def _close(port, ref, rtol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=TOL)


def _wkv_inputs(seed, b, s, h, k, logw=None):
    """``tests/test_mixers.py``'s inputs: r, k, v N(0, 1); logw -|N(0,
    0.5)| - 0.05 unless given; u N(0, 0.2); state0 N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    n = lambda shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(
        np.float32)
    r, kk, v = n((b, s, h, k)), n((b, s, h, k)), n((b, s, h, k))
    if logw is None:
        logw = -np.abs(n((b, s, h, k), 0.5)) - 0.05
    else:
        logw = np.full((b, s, h, k), logw, np.float32)
    return r, kk, v, logw, n((h, k), 0.2), n((b, h, k, k), 0.1)


def _both(fn, jfn, args, **kw):
    """``fn`` on tensors and ``jfn`` on jax arrays of the numpy ``args``."""
    po, ps = fn(*(torch.from_numpy(a) for a in args), **kw)
    jo, js = jfn(*(jnp.asarray(a) for a in args), **kw)
    return po, ps, np.asarray(jo), np.asarray(js)


# ---------------------------------------------------------------------------
# the WKV functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", [(64, 16), (50, 32), (16, 16), (96, 32)])
def test_wkv6_chunked_and_recurrent_match_jax(s, chunk):
    args = _wkv_inputs(s + chunk, 2, s, 3, 8)
    po, ps, jo, js = _both(wkv6_chunked, jax_chunked, args, chunk=chunk)
    _close(po, jo, TOL)
    _close(ps, js, TOL)
    ro, rs, jro, jrs = _both(wkv6_recurrent, jax_recurrent, args)
    _close(ro, jro, TOL)
    _close(rs, jrs, TOL)
    np.testing.assert_allclose(po.numpy(), ro.numpy(), atol=WKV_TOL,
                               rtol=WKV_TOL)
    np.testing.assert_allclose(ps.numpy(), rs.numpy(), atol=WKV_TOL,
                               rtol=WKV_TOL)


@pytest.mark.parametrize("logw", [-30.0, -float(np.exp(np.float32(10.0)))])
def test_wkv6_strong_decay_stays_finite(logw):
    """``tests/test_mixers.py``'s near-total forgetting (logw -30): the
    chunked form stays finite (the pairwise decay is masked before its
    exp) and equals the recurrence and the JAX package's.  The model's
    strongest clipped decay (``ww`` = 10: logw = -exp(10)): both forms
    stay finite and equal the JAX package's, but the chunked form of
    either package departs from the recurrence by ~0.07, the same gap in
    both (its cumulative log decays reach ~3.5e5, whose fp32 ulp is 0.03,
    so ``csl_t - cs_s`` of adjacent tokens is not 0; ROADMAP §3)."""
    args = _wkv_inputs(4, 1, 64, 2, 4, logw=logw)
    po, ps, jo, js = _both(wkv6_chunked, jax_chunked, args, chunk=16)
    ro, rs, jro, _ = _both(wkv6_recurrent, jax_recurrent, args)
    for t in (po, ps, ro, rs):
        assert torch.isfinite(t).all()
    _close(po, jo, TOL)
    _close(ps, js, TOL)
    _close(ro, jro, TOL)
    if logw > -100:
        np.testing.assert_allclose(po.numpy(), ro.numpy(), atol=WKV_TOL)
        np.testing.assert_allclose(ps.numpy(), rs.numpy(), atol=WKV_TOL)
    else:
        gap = float((po - ro).abs().max())
        assert 0.01 < gap and abs(gap - np.abs(jo - jro).max()) <= TOL


def test_chunked_prefill_then_recurrent_steps_equal_the_recurrence():
    """A 40-token chunked prefill (chunk 16: a partial last chunk) carried
    on by 8 one-token recurrent steps equals the full 48-token recurrence
    of the port and of the JAX package."""
    args = _wkv_inputs(7, 2, 48, 3, 8)
    r, kk, v, logw, u, s0 = (torch.from_numpy(a) for a in args)
    o_pre, state = wkv6_chunked(r[:, :40], kk[:, :40], v[:, :40],
                                logw[:, :40], u, s0, chunk=16)
    outs = [o_pre]
    for t in range(40, 48):
        o_t, state = wkv6_recurrent(r[:, t:t + 1], kk[:, t:t + 1],
                                    v[:, t:t + 1], logw[:, t:t + 1], u,
                                    state)
        outs.append(o_t)
    got = torch.cat(outs, dim=1)
    ro, rs = wkv6_recurrent(r, kk, v, logw, u, s0)
    np.testing.assert_allclose(got.numpy(), ro.numpy(), atol=WKV_TOL,
                               rtol=WKV_TOL)
    np.testing.assert_allclose(state.numpy(), rs.numpy(), atol=WKV_TOL,
                               rtol=WKV_TOL)
    jo, js = jax_recurrent(*(jnp.asarray(a) for a in args))
    _close(ro, jo, TOL)
    _close(rs, js, TOL)


# ---------------------------------------------------------------------------
# the block
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 20, 40])
def test_rwkv_block_matches_jax_from_a_non_zero_cache(s):
    """``RwkvBlock`` holding the JAX ``init_rwkv6`` params (with ``w0``,
    ``mu``, ``u`` and the norms moved off their constants) against
    ``rwkv6_block``, from an incoming cache of random shift carries and
    state: the output and the new cache within ``TOL``, written in place
    into the given cache's tensors."""
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    rng = np.random.default_rng(s)
    params = jax.tree.map(np.asarray, jax_init_rwkv6(jax.random.PRNGKey(s),
                                                     jcfg))
    for name in ("w0", "mu", "u", "mu_c", "norm_t", "norm_c"):
        params[name] = (params[name] + 0.1 * rng.standard_normal(
            params[name].shape)).astype(np.float32)
    block = RwkvBlock(cfg, torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        for name, p in block.named_parameters():
            p.copy_(torch.from_numpy(params[name]))
    b, d, nh, hd = 2, cfg.d_model, 4, cfg.ssm_head_dim
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    cache = [rng.standard_normal(shape).astype(np.float32)
             for shape in ((b, nh, hd, hd), (b, d), (b, d))]
    jx, jc = jax_rwkv6_block({n: jnp.asarray(a) for n, a in params.items()},
                             jnp.asarray(x), jcfg,
                             JaxRwkvCache(*map(jnp.asarray, cache)))
    pc = RwkvCache(*(torch.from_numpy(a.copy()) for a in cache))
    held = (pc.wkv, pc.shift_t, pc.shift_c)
    with torch.no_grad():
        px = block(torch.from_numpy(x), cfg, pc)
    _close(px, jx)
    for got, want, t in zip((pc.wkv, pc.shift_t, pc.shift_c), jc, held):
        assert got is t
        _close(got, want)
    assert not np.allclose(pc.wkv.numpy(), cache[0])


# ---------------------------------------------------------------------------
# the config and the parameters
# ---------------------------------------------------------------------------
def test_config_copy_matches_reference():
    full = get_config(NAME)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config(NAME))
    assert full.param_count() == jax_get_config(NAME).param_count() \
        == CFG_PARAMS["full"]
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count() == CFG_PARAMS["reduced"]
    assert full.block_pattern == ("rwkv6",) and not full.tie_embeddings


def test_param_count_is_the_jax_trees():
    """The port's model holds the JAX ``init_params`` tree's parameters,
    not the reference's ``param_count()`` (which over-counts 57 x d_model
    a layer): at the reduced size by building both, at full width by the
    tree's shapes (``jax.eval_shape``, nothing allocated) and the port's
    per-layer count from one full-width block."""
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    model = init_params(cfg, seed=1, device="cpu")
    tree = jax_init_params(jcfg, jax.random.PRNGKey(1))
    n_tree = sum(a.size for a in jax.tree.leaves(tree))
    assert param_count(model) == n_tree == TREE_PARAMS["reduced"]
    assert all(isinstance(b, RwkvBlock) for b in model.blocks)
    assert model.lm_head is not None
    names = [n for n, _ in model.blocks[0].named_parameters()]
    assert sorted(names) == sorted(tree["blocks"][0])
    for n, p in model.blocks[0].named_parameters():
        assert tuple(p.shape) == tree["blocks"][0][n].shape[1:], n
    jfull = jax_get_config(NAME)
    shapes = jax.eval_shape(lambda k: jax_init_params(jfull, k),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == TREE_PARAMS["full"]
    full = get_config(NAME)
    per_layer = sum(int(np.prod(a.shape)) for a in
                    jax.tree.leaves(shapes["blocks"][0])) // full.num_layers
    block = RwkvBlock(dataclasses.replace(full, d_ff=8), torch.Generator(),
                      CPU)
    cm = 2 * full.d_model * (full.d_ff - 8)          # Wck, Wcv at d_ff 8
    assert sum(p.numel() for p in block.parameters()) + cm == per_layer


def test_params_from_jax_carries_every_rwkv_leaf():
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, 5)
    for layer, block in enumerate(model.blocks):
        for name, p in block.named_parameters():
            assert np.array_equal(p.numpy(), np.asarray(
                params["blocks"][0][name][layer])), (layer, name)
    assert np.array_equal(model.lm_head.numpy(),
                          np.asarray(params["lm_head"]))


def test_cache_is_o1_in_length():
    """``init_cache`` gives an ``RwkvCache`` a layer whose size does not
    depend on ``max_len``: at full width 24 x (32 x 64 x 64 + 2 x 2048) x
    4 bytes a request."""
    full = get_config(NAME)
    for cfg in (_reduced(get_config), full):
        sizes = {cache_bytes(init_cache(cfg, 1, n, device=CPU))
                 for n in (1, 144, 2048)}
        assert len(sizes) == 1
    caches = init_cache(full, 1, 144, device=CPU)
    assert all(isinstance(c, RwkvCache) for c in caches)
    assert cache_bytes(caches) == 12_976_128
    assert tuple(caches[0].wkv.shape) == (1, 32, 64, 64)
    assert cache_bytes(init_cache(full, 3, 9, device=CPU)) == 3 * 12_976_128


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("lengths", ["int", "per_slot"])
@pytest.mark.parametrize("prompt", [1, 50, 128])
def test_prefill_and_decode_match_jax(prompt, lengths):
    """Prefill of 2 x ``prompt`` tokens (1: the recurrent path; 50: a
    partial last chunk; 128: four chunks) and 8 greedy decode steps, the
    JAX params carried over; logits within ``TOL`` at every step, and the
    final states and carries of every layer.  ``per_slot`` passes (B,)
    lengths, which an RWKV layer ignores, as the reference does."""
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, prompt)
    jpre = jax.jit(lambda p, bt, c: jax_prefill(p, jcfg, bt, c))
    jdec = jax.jit(lambda p, t, c, n: jax_decode(p, jcfg, t, c, n))
    toks = np.random.default_rng(prompt).integers(
        0, cfg.vocab_size, (2, prompt)).astype(np.int32)
    jl, jc = jpre(params, {"tokens": jnp.asarray(toks)},
                  jax_init_cache(jcfg, 2, prompt + 9))
    pc = init_cache(cfg, 2, prompt + 9, device=CPU)
    pl, pc = prefill(model, {"tokens": torch.from_numpy(toks).long()}, pc)
    _close(pl, jl)
    for step in range(8):
        n = prompt + step
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        if lengths == "per_slot":
            jn, pn = (jnp.asarray([n, n - 1], jnp.int32),
                      torch.tensor([n, n - 1]))
        else:
            jn, pn = n, n
        jl, jc = jdec(params, jnp.asarray(nxt), jc, jn)
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc, pn)
        _close(pl, jl)
    for layer, c in enumerate(pc):
        want = jc[0]
        for got, ref in ((c.wkv, want.wkv), (c.shift_t, want.shift_t),
                         (c.shift_c, want.shift_c)):
            _close(got, np.asarray(ref)[layer])


def test_no_attention_runs_for_an_rwkv6_layer(monkeypatch):
    """Prefill, decode and encode of the rwkv6 model call neither kernel
    wrapper nor any plain attention function."""
    def refuse(*args, **kw):
        raise AssertionError("attention called for an rwkv6 layer")

    for name in ("flash_attention", "decode_attention", "decode_lengths"):
        monkeypatch.setattr(model_mod, name, refuse)
    for name in ("attend_reference", "attend_chunked", "attend_decode"):
        monkeypatch.setattr(model_mod.attn_lib, name, refuse)
    cfg = _reduced(get_config)
    model = init_params(cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 12),
                         generator=torch.Generator().manual_seed(0))
    caches = init_cache(cfg, 2, 16, device=CPU)
    logits, _ = prefill(model, {"tokens": toks}, caches)
    decode_step(model, logits.argmax(-1)[:, None], caches, 12)
    decode_step(model, toks[:, :1], caches, torch.tensor([13, 5]))
    assert encode(model, {"tokens": toks}).shape == (2, cfg.d_model)


def test_mixed_rwkv6_and_attention_pattern_matches_jax():
    """A ``("rwkv6", "attn")`` pattern over 4 layers: the model dispatches
    by kind, positions reach the attention layers only; prefill of 30
    tokens and 4 decode steps within ``TOL``, the caches a list of
    ``RwkvCache`` and ``KVCache`` in pattern order."""
    kw = dict(block_pattern=("rwkv6", "attn"), num_layers=4)
    cfg = dataclasses.replace(_reduced(get_config), **kw)
    jcfg = dataclasses.replace(_reduced(jax_get_config), **kw)
    params, model = _carried(cfg, jcfg, 9)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 30)).astype(np.int32)
    jl, jc = jax_prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                         jax_init_cache(jcfg, 2, 40))
    pc = init_cache(cfg, 2, 40, device=CPU)
    assert [type(c).__name__ for c in pc] == ["RwkvCache", "KVCache"] * 2
    pl, pc = prefill(model, {"tokens": torch.from_numpy(toks).long()}, pc)
    _close(pl, jl)
    for n in range(30, 34):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jax_decode(params, jcfg, jnp.asarray(nxt), jc, n)
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc, n)
        _close(pl, jl)


def test_encode_matches_jax():
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, 6)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 25:] = 0
    je = jax_encode(params, jcfg, {"tokens": jnp.asarray(toks),
                                   "attn_mask": jnp.asarray(mask)})
    pe = encode(model, {"tokens": torch.from_numpy(toks).long(),
                        "attn_mask": torch.from_numpy(mask)})
    _close(pe, je)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def _trace(cfg):
    """``tests/test_batching.py::test_batched_equals_sequential``'s trace:
    prompts of 9 / 14 / 5 / 11 / 7 tokens, budgets 6 / 4 / 8 / 5 / 7."""
    rng = np.random.default_rng(0)
    return [{"id": i, "prompt_tokens": rng.integers(2, cfg.vocab_size, n)
             .tolist(), "max_new_tokens": b}
            for i, (n, b) in enumerate(zip((9, 14, 5, 11, 7),
                                           (6, 4, 8, 5, 7)))]


def test_batched_equals_sequential_rwkv6_matches_the_jax_batcher():
    """The trace through 3 slots of 96 positions, so that slots are reused
    (requests 3 and 4 land in slots that held earlier requests' states),
    against the JAX batcher; tokens compared as
    ``tests/test_torch_batching.py`` compares them (a request stops at its
    lone run's first near-tie, 2 x ``TOL``; >= 90% compared)."""
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, 3)
    reqs = _trace(cfg)
    port = ContinuousBatcher(cfg, model, num_slots=3, max_len=96,
                             device="cpu").run(reqs)
    ref = JaxBatcher(jcfg, params, num_slots=3, max_len=96).run(reqs)
    assert set(port) == set(ref) == set(range(5))
    compared = total = 0
    for r in reqs:
        caches = init_cache(cfg, 1, 96, device=CPU)
        logits, _ = prefill(model, {"tokens": torch.tensor(
            [r["prompt_tokens"]])}, caches)
        total += len(ref[r["id"]])
        for t, want in enumerate(ref[r["id"]]):
            top2 = np.sort(logits[0].numpy())[-2:]
            if top2[1] - top2[0] <= 2 * TOL:
                break
            assert port[r["id"]][t] == want == int(logits[0].argmax())
            compared += 1
            logits, _ = decode_step(model, torch.tensor([[want]]), caches,
                                    len(r["prompt_tokens"]) + t)
    assert compared >= 0.9 * total, (compared, total)


def test_admit_into_a_used_slot_equals_a_fresh_prefill():
    """After ``admit`` into a slot whose state earlier requests and ticks
    advanced, the slot's row of every layer's state and carries is
    bitwise a fresh cache's after the same prefill, and the other slots'
    rows are untouched."""
    cfg = _reduced(get_config)
    model = init_params(cfg, seed=4, device="cpu")
    batcher = ContinuousBatcher(cfg, model, num_slots=2, max_len=48,
                                device="cpu")
    batcher.admit(0, list(range(3, 20)), 3)
    batcher.admit(1, list(range(5, 14)), 8)
    for _ in range(3):
        batcher.tick()                       # request 0 done: slot 0 free
    assert batcher.slots[0].free and not batcher.slots[1].free
    other = [(c.wkv[1].clone(), c.shift_t[1].clone()) for c in
             batcher.caches]
    prompt = [7, 8, 9, 10, 11]
    assert batcher.admit(2, prompt, 4) == 0
    fresh = init_cache(cfg, 1, 48, device=CPU)
    prefill(model, {"tokens": torch.tensor([prompt])}, fresh)
    for c, f, (wkv1, sh1) in zip(batcher.caches, fresh, other):
        for got, want in ((c.wkv[:1], f.wkv), (c.shift_t[:1], f.shift_t),
                          (c.shift_c[:1], f.shift_c)):
            assert torch.equal(got, want)
        assert torch.equal(c.wkv[1], wkv1) and torch.equal(c.shift_t[1], sh1)


def test_generator_model_matches_jax_generator():
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, 8)
    prompt = "what does the index store " * 3
    ref = JaxGenerator(jcfg, params, max_prompt=24).generate(prompt, 4)
    gen = GeneratorModel(cfg, model, max_prompt=24, device="cpu")
    assert gen.generate(prompt, 4) == ref


def test_serve_runs_rwkv6_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", NAME, "--device", "cpu", "--dataset", "fiqa",
                    "--records", "300", "--queries", "2"])
    text = out.getvalue()
    assert "indexed 300 chunks" in text and "TTFT edge-sim" in text
    assert "gen_tokens=16" in text


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_rwkv6_and_its_batcher_match_the_cpu(cuda):
    """The 2-layer reduced model on the card against the same weights on
    the CPU: prefill of 2 x 50 tokens and 8 steps (4 with per-slot
    lengths), logits within 1e-4 (``chip_smoke.py``'s ``GEN_TOL``: fp32
    sums in other orders on the two), no attention kernel launched; then
    the batcher trace on both, tokens equal outside the CPU's near-ties."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _reduced(get_config)
    m_cpu = init_params(cfg, seed=2, device="cpu")
    m_card = init_params(cfg, seed=2, device="cpu").to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 50),
                         generator=torch.Generator().manual_seed(2))
    c_cpu = init_cache(cfg, 2, 64, device=CPU)
    c_card = init_cache(cfg, 2, 64, device=cuda)
    f0, d0 = flash_attention.launches, decode_attention.launches
    l_cpu, _ = prefill(m_cpu, {"tokens": toks}, c_cpu)
    l_card, _ = prefill(m_card, {"tokens": toks.to(cuda)}, c_card)
    assert (l_card.cpu() - l_cpu).abs().max() <= 1e-4
    for step in range(8):
        nxt = l_cpu.argmax(-1)[:, None]
        pos = 50 + step if step < 4 else torch.tensor([50 + step, 48])
        l_cpu, _ = decode_step(m_cpu, nxt, c_cpu, pos)
        l_card, _ = decode_step(m_card, nxt.to(cuda), c_card, pos)
        assert (l_card.cpu() - l_cpu).abs().max() <= 1e-4
    assert (flash_attention.launches, decode_attention.launches) == (f0, d0)
    for c, k in zip(c_card, c_cpu):
        assert (c.wkv.cpu() - k.wkv).abs().max() <= 1e-4
    reqs = _trace(cfg)
    card = ContinuousBatcher(cfg, m_card, num_slots=3, max_len=96,
                             device=cuda).run(reqs)
    cpu = ContinuousBatcher(cfg, m_cpu, num_slots=3, max_len=96,
                            device="cpu").run(reqs)
    for r in reqs:
        caches = init_cache(cfg, 1, 96, device=CPU)
        logits, _ = prefill(m_cpu, {"tokens": torch.tensor(
            [r["prompt_tokens"]])}, caches)
        for t, want in enumerate(cpu[r["id"]]):
            top2 = np.sort(logits[0].numpy())[-2:]
            if top2[1] - top2[0] <= 2e-4:
                break
            assert card[r["id"]][t] == want
            logits, _ = decode_step(m_cpu, torch.tensor([[want]]), caches,
                                    len(r["prompt_tokens"]) + t)
