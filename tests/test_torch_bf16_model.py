"""The port's ``compute_dtype=torch.bfloat16`` against the JAX package's
``compute_dtype=jnp.bfloat16``: prefill and four decode steps for each
block kind (``"attn"`` sheared-llama-2.7b, ``"swa"`` gemma3-12b past its
window, ``"moe"`` olmoe-1b-7b, ``"mamba2"`` with ``"shared_attn"``
zamba2-2.7b, ``"rwkv6"`` rwkv6-1.6b over bf16 caches), ``encode``
(gte-base-en-v1.5), the weights in bf16 (``init_params(dtype=)``,
``params_from_jax`` of a bf16 tree) and the batcher in bf16.  Every config
is ``.reduced(d_model=128)`` at 2 layers (gemma3-12b cut to the pattern
("swa", "attn"); zamba2-2.7b at 6, one pattern), the JAX params carried
over by ``params_from_jax``; the JAX references are computed once per
module.

The reference is compiled with ``xla_allow_excess_precision`` off.  With
it on (XLA's default), XLA's CPU fusions keep f32 between bf16 ops where
the program rounds, so its "bf16" sits between bf16 and f32: the port's
bf16 logits lay ~1e-2 (relative Frobenius) from it, as far as the port's
f32 logits do, and no tolerance could tell the two precisions apart.  Off,
the reference rounds after every op, as PyTorch does, and the port follows
it op by op (``models.layers.silu`` takes XLA's own bf16 sigmoid): one
block of each kind, and the whole 2-layer attn, moe and rwkv6 models, give
the reference's bits on this CPU.

Tolerance: ``TOL`` = 6e-3 in relative Frobenius norm, per step's logits
(and per embedding batch).  bf16 keeps 8 significant bits (unit roundoff
u = 2**-8 = 3.9e-3): two programs that round at the same places differ
only where a sum of another order rounds to the other neighbour, which
then carries through the layers; measured here at most 4.05e-3 (the swa
case's decode; the attn, moe and rwkv6 prefills are bitwise).  The
precision control: the port's f32 prefill logits, held to the reference's
bf16 ones, lie 1.10e-2 (attn) to 2.09e-2 (rwkv6) away (bf16 rounds every
op by up to u) and fail ``TOL``; ``test_f32_fails_the_bf16_tolerance``
asserts it for each case, ``test_encode_matches_jax_bf16`` for encode.  Greedy
tokens are compared where the reference's top-2 margin exceeds 2 x
``TOL`` x the logits' scale; the same token is fed to both.
"""
import dataclasses
import functools

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
from repro.serving.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa
from repro_torch.models import (decode_step, encode, init_cache,  # noqa
                                init_params, prefill)
from repro_torch.serving import ContinuousBatcher  # noqa: E402

TOL = 6e-3
BF16 = torch.bfloat16
CPU = torch.device("cpu")
B, STEPS = 2, 4

# name: (config id, layers, prompt length, cache dtype); "swa" takes
# gemma3-12b's window over the pattern ("swa", "attn")
CASES = {
    "attn": ("sheared-llama-2.7b", 2, 16, "f32"),
    "swa": ("gemma3-12b", 2, 72, "f32"),         # past its 64-key window
    "moe": ("olmoe-1b-7b", 2, 16, "f32"),
    "mamba2_shared": ("zamba2-2.7b", 6, 16, "f32"),
    "rwkv6": ("rwkv6-1.6b", 2, 16, "bf16"),
}


def strict(fn):
    """``fn`` jitted and compiled, at its first call's shapes, with XLA's
    excess precision off (module docstring); later calls reuse it."""
    compiled = {}

    def call(*args):
        key = jax.tree.map(lambda a: (np.shape(a), str(np.asarray(a).dtype)
                                      if not hasattr(a, "dtype")
                                      else str(a.dtype)), args)
        key = str(key)
        if key not in compiled:
            compiled[key] = jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*args)
    return call


def fro(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def f32(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def _configs(name, layers):
    kw = dict(num_layers=layers, d_model=128)
    jcfg, cfg = (jax_get_config(name).reduced(**kw),
                 get_config(name).reduced(**kw))
    if cfg.sliding_window:
        cut = dict(num_layers=layers, block_pattern=("swa", "attn"))
        jcfg, cfg = (dataclasses.replace(c, **cut) for c in (jcfg, cfg))
    return jcfg, cfg


@functools.lru_cache(maxsize=None)
def _case(case):
    """(port cfg, port model, tokens, the reference's bf16 logits a step,
    the tokens fed)."""
    name, layers, s, cache = CASES[case]
    jcfg, cfg = _configs(name, layers)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (B, s)).astype(np.int32)
    jdt = jnp.bfloat16 if cache == "bf16" else jnp.float32
    first = strict(lambda p, b, c: jax_prefill(
        p, jcfg, b, c, compute_dtype=jnp.bfloat16))
    step = strict(lambda p, t, c, n: jax_decode(
        p, jcfg, t, c, n, compute_dtype=jnp.bfloat16))
    jc = jax_init_cache(jcfg, B, s + STEPS, dtype=jdt)
    jl, jc = first(params, {"tokens": jnp.asarray(toks)}, jc)
    logits, fed = [f32(jl)], []
    for i in range(STEPS):
        nxt = logits[-1].argmax(-1).astype(np.int32)[:, None]
        fed.append(nxt)
        jl, jc = step(params, jnp.asarray(nxt), jc, s + i)
        logits.append(f32(jl))
    return cfg, model, toks, logits, fed


def _port_run(case, compute_dtype):
    cfg, model, toks, _, fed = _case(case)
    cache = BF16 if CASES[case][3] == "bf16" else torch.float32
    c = init_cache(cfg, B, toks.shape[1] + STEPS, device=CPU, dtype=cache)
    pl, _ = prefill(model, {"tokens": torch.from_numpy(toks).long()}, c,
                    compute_dtype=compute_dtype)
    out = [pl]
    for i, nxt in enumerate(fed):
        pl, _ = decode_step(model, torch.from_numpy(nxt).long(), c,
                            toks.shape[1] + i, compute_dtype=compute_dtype)
        out.append(pl)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax_bf16(case):
    want = _case(case)[3]
    got = _port_run(case, BF16)
    checked = 0
    for step, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == BF16 and g.shape == w.shape
        err = fro(f32(g), w)
        assert err <= TOL, (case, step, err)
        for row, wrow in zip(f32(g), w):
            top2 = np.sort(wrow)[-2:]
            if top2[1] - top2[0] > 2 * TOL * np.abs(wrow).max():
                assert row.argmax() == wrow.argmax(), (case, step)
                checked += 1
    assert checked >= B * len(want) // 2, checked


@pytest.mark.parametrize("case", list(CASES))
def test_f32_fails_the_bf16_tolerance(case):
    """The precision control: the port's f32 prefill, held to the
    reference's bf16 one, misses ``TOL`` (so ``TOL`` tells the two
    precisions apart), and f32 stays the default."""
    cfg, model, toks, want, _ = _case(case)
    cache = BF16 if CASES[case][3] == "bf16" else torch.float32
    c = init_cache(cfg, B, toks.shape[1] + STEPS, device=CPU, dtype=cache)
    pl, _ = prefill(model, {"tokens": torch.from_numpy(toks).long()}, c)
    assert pl.dtype == torch.float32
    assert fro(pl.numpy(), want[0]) > TOL


def test_rwkv6_over_f32_caches_raises_before_any_work():
    """bf16 compute over f32 shift caches: the reference's layer scan
    raises ``TypeError`` (its carry would widen to f32), and so does the
    port, before any layer runs (the caches stay zero)."""
    jcfg, cfg = _configs("rwkv6-1.6b", 2)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.ones((1, 8), np.int32)
    with pytest.raises(TypeError):
        jax_prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                    jax_init_cache(jcfg, 1, 12), compute_dtype=jnp.bfloat16)
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    caches = init_cache(cfg, 1, 12, device=CPU)
    for call in (lambda: prefill(model, {"tokens": torch.from_numpy(toks)},
                                 caches, compute_dtype=BF16),
                 lambda: decode_step(model, torch.ones((1, 1), dtype=torch
                                                       .long), caches, 0,
                                     compute_dtype=BF16)):
        with pytest.raises(TypeError, match="init_cache"):
            call()
    assert all(float(t.abs().sum()) == 0 for c in caches
               for t in (c.wkv, c.shift_t, c.shift_c))


def test_f32_compute_over_bf16_caches_matches_jax():
    """f32 compute over bf16 caches, which no caller of the reference
    makes: the reference writes k and v in the caches' dtype and attends in
    f32, and so does the port on the CPU (on the card it raises:
    ``tests/test_torch_train_gpu.py``).  Both sides f32 but for the
    caches' rounding, so ``tests/test_torch_model.py``'s 2e-5."""
    jcfg, cfg = _configs("sheared-llama-2.7b", 2)
    params = jax_init_params(jcfg, jax.random.PRNGKey(0))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 12))
    jc = jax_init_cache(jcfg, 1, 16, dtype=jnp.bfloat16)
    pc = init_cache(cfg, 1, 16, device=CPU, dtype=BF16)
    jl, jc = jax.jit(lambda p, b, c: jax_prefill(p, jcfg, b, c))(
        params, {"tokens": jnp.asarray(toks, jnp.int32)}, jc)
    pl, _ = prefill(model, {"tokens": torch.from_numpy(toks)}, pc)
    nxt = np.asarray(jl).argmax(-1)[:, None]
    jl, _ = jax.jit(lambda p, t, c: jax_decode(p, jcfg, t, c, 12))(
        params, jnp.asarray(nxt, jnp.int32), jc)
    pl, _ = decode_step(model, torch.from_numpy(nxt), pc, 12)
    assert pl.dtype == torch.float32 and pc[0].k.dtype == BF16
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), rtol=0,
                               atol=2e-5)


def test_encode_matches_jax_bf16():
    jcfg, cfg = _configs("gte-base-en-v1.5", 2)
    params = jax_init_params(jcfg, jax.random.PRNGKey(2))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (3, 20)).astype(np.int32)
    mask = np.ones((3, 20), np.int32)
    mask[1, 12:] = 0
    mask[2, 5:] = 0
    want = f32(strict(lambda p, b: jax_encode(
        p, jcfg, b, compute_dtype=jnp.bfloat16))(
        params, {"tokens": jnp.asarray(toks), "attn_mask": jnp.asarray(mask)}))
    batch = {"tokens": torch.from_numpy(toks).long(),
             "attn_mask": torch.from_numpy(mask)}
    got = encode(model, batch, compute_dtype=BF16)
    assert got.dtype == BF16 and fro(f32(got), want) <= TOL
    assert fro(encode(model, batch).numpy(), want) > TOL    # the control


def test_bf16_weights_are_the_references():
    """``params_from_jax`` of the reference's ``init_params(dtype=
    jnp.bfloat16)`` tree is bitwise its leaves (a bf16 model, widened back
    by ``params_to_jax`` exactly); ``init_params(dtype=torch.bfloat16)`` is
    bitwise ``init_params()`` cast."""
    jcfg, cfg = _configs("olmoe-1b-7b", 2)
    tree = jax.tree.map(np.asarray, jax_init_params(
        jcfg, jax.random.PRNGKey(1), dtype=jnp.bfloat16))
    model = params_from_jax(tree, cfg, device="cpu")
    assert {p.dtype for p in model.parameters()} == {BF16}
    back = params_to_jax(model)
    pairs = list(zip(jax.tree.leaves(back), jax.tree.leaves(tree)))
    assert len(pairs) == len(jax.tree.leaves(tree))
    for got, want in pairs:
        assert got.dtype == np.float32
        assert np.array_equal(got, want.astype(np.float32))
    assert params_from_jax(tree, cfg, device="cpu",
                           dtype=torch.float32).embed.dtype == torch.float32
    for name in ("zamba2-2.7b", "rwkv6-1.6b"):
        small = get_config(name).reduced(num_layers=6, d_model=64)
        a = init_params(small, seed=4, device="cpu", dtype=BF16)
        b = init_params(small, seed=4, device="cpu")
        for (na, pa), (nb, pb) in zip(a.named_parameters(),
                                      b.named_parameters()):
            assert na == nb and pa.dtype == BF16
            assert torch.equal(pa, pb.to(BF16)), na


# ---------------------------------------------------------------------------
# the batcher in bf16, on tests/test_batching.py's trace
# ---------------------------------------------------------------------------
LENS, BUDGETS, SLOTS, MAX_LEN = (9, 14, 5, 11, 7), (6, 4, 8, 5, 7), 3, 96


def test_batcher_matches_the_jax_batcher_in_bf16():
    """``ContinuousBatcher(compute_dtype=bf16)`` against the reference's,
    its jitted prefill and step compiled strictly (module docstring), over
    both batchers' default f32 caches.  A request's tokens are compared
    until the first step whose reference top-2 margin is under 2 x ``TOL``
    x the logits' scale, as ``tests/test_torch_batching.py`` does.  bf16
    logits of scale ~3 lie on a grid of 2**-6, so such margins are common
    (12 of the 30 steps here, 2 of them exact ties): at least half the
    tokens must be compared, not 90% as in f32."""
    name = "sheared-llama-2.7b"
    jcfg, cfg = _configs(name, 2)
    params = jax_init_params(jcfg, jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    rng = np.random.default_rng(0)
    reqs = [{"id": i, "prompt_tokens": rng.integers(
                2, cfg.vocab_size, size=n).tolist(), "max_new_tokens": b}
            for i, (n, b) in enumerate(zip(LENS, BUDGETS))]
    port = ContinuousBatcher(cfg, model, num_slots=SLOTS, max_len=MAX_LEN,
                             compute_dtype=BF16, device="cpu")
    assert all(c.k.dtype == torch.float32 for c in port.caches)
    got = port.run(reqs)
    ref = JaxBatcher(jcfg, params, num_slots=SLOTS, max_len=MAX_LEN,
                     compute_dtype=jnp.bfloat16)
    ref._prefill1, ref._step = strict(ref._prefill_one), \
        strict(ref._decode_all)
    want = ref.run(reqs)
    assert set(got) == set(want) == set(range(len(LENS)))
    first = strict(lambda p, b, c: jax_prefill(
        p, jcfg, b, c, compute_dtype=jnp.bfloat16))
    step = strict(lambda p, t, c, n: jax_decode(
        p, jcfg, t, c, n, compute_dtype=jnp.bfloat16))
    compared = total = 0
    for r in reqs:
        rid, prompt = r["id"], r["prompt_tokens"]
        jc = jax_init_cache(jcfg, 1, MAX_LEN)
        jl, jc = first(params, {"tokens": jnp.asarray([prompt], jnp.int32)},
                       jc)
        total += len(want[rid])
        for t, tok in enumerate(want[rid]):
            row = f32(jl)[0]
            top2 = np.sort(row)[-2:]
            if top2[1] - top2[0] <= 2 * TOL * np.abs(row).max():
                break
            assert got[rid][t] == tok == row.argmax(), (rid, t)
            compared += 1
            jl, jc = step(params, jnp.asarray([[tok]], jnp.int32), jc,
                          len(prompt) + t)
    assert compared >= 0.5 * total, (compared, total)


def test_bf16_argmax_takes_the_first_of_a_tie():
    """Greedy tokens over bf16 logits tie exactly more often; the first
    index wins, as ``jnp.argmax`` picks it."""
    row = torch.tensor([0.5, 2.0, 2.0, 1.0], dtype=BF16)
    assert int(row.argmax()) == 1 == int(jnp.argmax(jnp.asarray(
        [0.5, 2.0, 2.0, 1.0], jnp.bfloat16)))
