"""The assigned architectures (``repro_torch.configs.ASSIGNED_ARCHS``)
against the JAX package: the config copies, ``apply_mrope``, embedding
inputs, ``vision_embeds`` and M-RoPE positions, and each config's prefill
and decode logits with the JAX params carried over (``params_from_jax``);
gemma3-12b's sliding-window layers over ring caches, past the window, with
scalar and per-slot lengths, at head dims 64 and 256, in the generator and
in the continuous batcher.  The two MoE configs are
``tests/test_torch_moe.py``'s, rwkv6-1.6b ``tests/test_torch_rwkv6.py``'s
and zamba2-2.7b ``tests/test_torch_mamba2.py``'s.

Sizes: ``.reduced(num_layers=2, d_model=128)``, which forces head dim 64
and turns starcoder2-7b into MHA; so GQA at head dim 128 is checked on
variants of 2 layers and d_model 256 with yi-9b's group of 8 (8:1 heads),
starcoder2-7b's group of 9 (9:1) and qwen2-vl-2b's group of 6 with its
full M-RoPE sections (6:1).  gemma3-12b runs ``.reduced()``: 6 layers (its
pattern of 5 ``"swa"`` and 1 ``"attn"``), d_model 256, 4 heads of 64,
window 64, so a 100-token prompt passes the window and its rings wrap;
its head dim 256 on a variant of 4 heads over 2.

Tolerance: 2e-5 on logits, as ``tests/test_torch_model.py`` states it
(both sides fp32 on the CPU; XLA and ATen order their sums and evaluate
exp / sin / cos / rsqrt a few ulps apart; the logits drift by ~2e-6).
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
from repro.models.layers import apply_mrope as jax_apply_mrope  # noqa: E402
from repro.serving.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from repro.serving.engine import GeneratorModel as JaxGenerator  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, encode, init_cache,  # noqa: E402
                                init_params, param_count, prefill)
from repro_torch.models.layers import (apply_mrope, apply_rope,  # noqa: E402
                                       rope_frequencies)
from repro_torch.serving import ContinuousBatcher, GeneratorModel  # noqa

TOL = 2e-5
ARCHS = ("stablelm-1.6b", "starcoder2-7b", "yi-9b", "musicgen-large",
         "qwen2-vl-2b")
GEMMA = "gemma3-12b"
MOE = ("granite-moe-3b-a800m", "olmoe-1b-7b")     # tests/test_torch_moe.py
RWKV = ("rwkv6-1.6b",)                             # tests/test_torch_rwkv6.py
HYBRID = ("zamba2-2.7b",)                          # tests/test_torch_mamba2.py
# (arch, heads, kv heads) at head dim 128, 2 layers, d_model 256
GQA = (("yi-9b", 8, 1), ("starcoder2-7b", 9, 1), ("qwen2-vl-2b", 6, 1))
CPU = torch.device("cpu")


def _reduced(get, name):
    return get(name).reduced(num_layers=2, d_model=128)


def _gqa(get, name, heads, kv):
    """2 layers, d_model 256, ``heads`` over ``kv`` kv heads of 128; the
    full config's M-RoPE sections (they sum to 128 // 2)."""
    full = get(name)
    return dataclasses.replace(
        full.reduced(num_layers=2, d_model=256), name=f"{name}-gqa",
        num_heads=heads, num_kv_heads=kv, head_dim=128,
        mrope_sections=full.mrope_sections)


def _carried(cfg, jcfg, seed=0):
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return params, model


def _jitted(jcfg):
    return (jax.jit(lambda p, b, c: jax_prefill(p, jcfg, b, c)),
            jax.jit(lambda p, t, c, n: jax_decode(p, jcfg, t, c, n)))


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def _prefill_both(cfg, jcfg, params, model, batch, max_len):
    """Prefill ``batch`` (numpy arrays) on both packages; returns
    (JAX logits, JAX caches, port logits, port caches, JAX decode)."""
    jprefill, jdecode = _jitted(jcfg)
    b = batch.get("tokens", batch.get("embeds")).shape[0]
    jc = jax_init_cache(jcfg, b, max_len)
    jl, jc = jprefill(params, {n: jnp.asarray(a) for n, a in batch.items()},
                      jc)
    pc = init_cache(cfg, b, max_len, device=CPU)
    tb = {n: torch.from_numpy(a) for n, a in batch.items()}
    if "tokens" in tb:
        tb["tokens"] = tb["tokens"].long()
    pl, pc = prefill(model, tb, pc)
    _close(pl, jl)
    return jl, jc, pl, pc, jdecode


def _decode_tokens(params, model, jdecode, jl, jc, pc, cache_len, steps):
    """``steps`` greedy steps of the JAX logits' tokens into both."""
    for _ in range(steps):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdecode(params, jnp.asarray(nxt), jc, cache_len)
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc,
                             cache_len)
        _close(pl, jl)
        cache_len += 1
    return jl, jc, pc, cache_len


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_config_copy_matches_reference(name):
    full = get_config(name)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config(name))
    assert full.param_count() == jax_get_config(name).param_count()
    cfg, jcfg = _reduced(get_config, name), _reduced(jax_get_config, name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()


def test_registry_holds_the_five_and_the_paper_models():
    assert sorted(configs.ASSIGNED_ARCHS) == sorted(ARCHS + (GEMMA,) + MOE
                                                    + RWKV + HYBRID)
    assert configs.list_configs() == sorted(ARCHS + (GEMMA,) + MOE + RWKV
                                            + HYBRID + configs.PAPER_MODELS)
    assert get_config("yi-9b").param_count() == 8_829_407_232


@pytest.mark.parametrize("name", HYBRID)
def test_unported_ids_raise_key_error(name):
    """The last assigned id to be ported resolves as the JAX package's, and
    the port's ``ASSIGNED_ARCHS`` is the JAX package's set: no assigned id
    is left unported (none raises ``KeyError``)."""
    from repro.configs import ASSIGNED_ARCHS as JAX_ASSIGNED
    assert dataclasses.asdict(get_config(name)) == dataclasses.asdict(
        jax_get_config(name))
    assert set(configs.ASSIGNED_ARCHS) == set(JAX_ASSIGNED)
    assert len(configs.ASSIGNED_ARCHS) == len(JAX_ASSIGNED) == 10
    for arch in JAX_ASSIGNED:
        get_config(arch)


@pytest.mark.parametrize("kind", ["mamba2", "shared_attn"])
def test_other_block_kinds_still_raise(kind):
    """The two kinds that once raised: a one-kind pattern of each builds on
    the CPU and holds the JAX ``init_params`` tree's parameter count (a
    ``"shared_attn"`` pattern: one block at both layers, counted once)."""
    cfg = dataclasses.replace(_reduced(get_config, "yi-9b"),
                              block_pattern=(kind,))
    jcfg = dataclasses.replace(_reduced(jax_get_config, "yi-9b"),
                               block_pattern=(kind,))
    model = init_params(cfg, device="cpu")
    tree = jax_init_params(jcfg, jax.random.PRNGKey(0))
    assert param_count(model) == sum(a.size for a in jax.tree.leaves(tree))
    assert (model.blocks[0] is model.blocks[1]) == (kind == "shared_attn")


@pytest.mark.parametrize("name", ARCHS)
def test_param_count_and_untied_head(name):
    cfg = _reduced(get_config, name)
    model = init_params(cfg, seed=1, device="cpu")
    assert param_count(model) == cfg.param_count()
    assert (model.lm_head is None) == cfg.tie_embeddings
    assert (name == "qwen2-vl-2b") == cfg.tie_embeddings


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("d,sections,theta", [(128, (16, 24, 24), 1e6),
                                              (64, (16, 8, 8), 1e4)])
def test_apply_mrope_matches_jax(d, sections, theta):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 20, 3, d)).astype(np.float32)
    pos = rng.integers(0, 4000, (3, 2, 20)).astype(np.int32)
    ref = jax_apply_mrope(jnp.asarray(x), jnp.asarray(pos), theta, sections)
    inv = torch.from_numpy(rope_frequencies(d, theta))
    got = apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), inv,
                      sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)
    with pytest.raises(ValueError, match="sum to"):
        apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), inv,
                    (16, 16, 16))


def test_apply_mrope_equal_streams_is_apply_rope_bitwise():
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((2, 33, 4, 128))
                         .astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 9000, (2, 33)))
    inv = torch.from_numpy(rope_frequencies(128, 1e6))
    assert torch.equal(apply_mrope(x, pos.expand(3, 2, 33), inv,
                                   (16, 24, 24)),
                       apply_rope(x, pos, inv))


# ---------------------------------------------------------------------------
# prefill and decode against the JAX package
# ---------------------------------------------------------------------------
def _tokens_case(cfg, jcfg, seed):
    params, model = _carried(cfg, jcfg, seed)
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (2, 24)).astype(np.int32)
    toks[:, :5] = 0                              # left padding, attended
    jl, jc, _, pc, jdecode = _prefill_both(cfg, jcfg, params, model,
                                           {"tokens": toks}, 32)
    _decode_tokens(params, model, jdecode, jl, jc, pc, 24, 4)


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_and_decode_match_jax(name):
    _tokens_case(_reduced(get_config, name), _reduced(jax_get_config, name),
                 ARCHS.index(name))


@pytest.mark.parametrize("name,heads,kv", GQA)
def test_gqa_head_dim_128_matches_jax(name, heads, kv):
    cfg, jcfg = (_gqa(get_config, name, heads, kv),
                 _gqa(jax_get_config, name, heads, kv))
    assert cfg.num_heads // cfg.num_kv_heads == heads // kv
    _tokens_case(cfg, jcfg, heads)


def test_musicgen_embeds_prefill_then_ids_and_embeds_decode():
    cfg, jcfg = (_reduced(get_config, "musicgen-large"),
                 _reduced(jax_get_config, "musicgen-large"))
    assert cfg.embedding_inputs
    params, model = _carried(cfg, jcfg, 4)
    rng = np.random.default_rng(4)
    frames = rng.standard_normal((2, 20, cfg.d_model)).astype(np.float32)
    jl, jc, _, pc, jdecode = _prefill_both(cfg, jcfg, params, model,
                                           {"embeds": frames}, 28)
    jl, jc, pc, n = _decode_tokens(params, model, jdecode, jl, jc, pc, 20, 2)
    for _ in range(2):                          # one frame embed a step
        e = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        jl, jc = jdecode(params, jnp.asarray(e), jc, n)
        pl, pc = decode_step(model, torch.from_numpy(e), pc, n)
        _close(pl, jl)
        n += 1


def _vision_batch(cfg, rng, b=2, s=24, p=6):
    """Text tokens behind a ``p``-patch image prefix, and M-RoPE positions
    whose three streams differ over the image (t fixed, h / w the patch
    grid) and continue as text after it."""
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    ve = rng.standard_normal((b, p, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
    pos[0, :, :p] = 0
    pos[1, :, :p] = np.arange(p) // 3
    pos[2, :, :p] = np.arange(p) % 3
    pos[:, :, p:] = np.arange(s - p) + 3
    pos[:, 1] += 5                                   # rows differ too
    return {"tokens": toks, "vision_embeds": ve, "positions": pos}


@pytest.mark.parametrize("variant", ["reduced", "gqa"])
def test_qwen2_vl_vision_positions_and_per_slot_decode(variant):
    if variant == "reduced":
        cfg, jcfg = (_reduced(get_config, "qwen2-vl-2b"),
                     _reduced(jax_get_config, "qwen2-vl-2b"))
    else:
        cfg, jcfg = (_gqa(get_config, "qwen2-vl-2b", 6, 1),
                     _gqa(jax_get_config, "qwen2-vl-2b", 6, 1))
    assert cfg.use_mrope
    params, model = _carried(cfg, jcfg, 5)
    rng = np.random.default_rng(5)
    batch = _vision_batch(cfg, rng)
    jl, jc, _, pc, jdecode = _prefill_both(cfg, jcfg, params, model, batch,
                                           32)
    # the image prefix and its positions both change the logits
    plain, _ = prefill(model, {"tokens": torch.from_numpy(batch["tokens"])
                               .long()}, init_cache(cfg, 2, 32, device=CPU))
    no_pos, _ = prefill(model, {
        "tokens": torch.from_numpy(batch["tokens"]).long(),
        "vision_embeds": torch.from_numpy(batch["vision_embeds"])},
        init_cache(cfg, 2, 32, device=CPU))
    got, _ = prefill(model, {n: torch.from_numpy(a) for n, a in
                             batch.items()}, init_cache(cfg, 2, 32,
                                                        device=CPU))
    assert (got - plain).abs().max() > 1e-3
    assert (got - no_pos).abs().max() > 1e-3
    # per-slot decode: slot 1 two positions behind slot 0
    lens = np.array([24, 22], np.int32)
    for _ in range(3):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdecode(params, jnp.asarray(nxt), jc, jnp.asarray(lens))
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc,
                             torch.from_numpy(lens))
        _close(pl, jl)
        lens = lens + 1


def test_positions_of_the_wrong_rank_are_refused():
    cfg = _reduced(get_config, "qwen2-vl-2b")
    model = init_params(cfg, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="positions"):
        prefill(model, {"tokens": toks, "positions": torch.zeros(
            (1, 8), dtype=torch.long)}, init_cache(cfg, 1, 8, device=CPU))
    with pytest.raises(ValueError, match="vision_embeds"):
        prefill(model, {"tokens": toks, "vision_embeds": torch.zeros(
            (1, 9, cfg.d_model))}, init_cache(cfg, 1, 8, device=CPU))


def test_encode_from_embeds_with_mrope_positions_matches_jax():
    cfg, jcfg = (_reduced(get_config, "qwen2-vl-2b"),
                 _reduced(jax_get_config, "qwen2-vl-2b"))
    params, model = _carried(cfg, jcfg, 6)
    rng = np.random.default_rng(6)
    batch = _vision_batch(cfg, rng, s=16, p=4)
    embeds = rng.standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    mask = np.ones((2, 16), np.int32)
    mask[1, 10:] = 0
    jb = {"embeds": embeds, "vision_embeds": batch["vision_embeds"],
          "positions": batch["positions"], "attn_mask": mask}
    je = jax_encode(params, jcfg, {n: jnp.asarray(a) for n, a in jb.items()})
    pe = encode(model, {n: torch.from_numpy(a) for n, a in jb.items()})
    _close(pe, je)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_generator_model_matches_jax_generator(name):
    cfg, jcfg = _reduced(get_config, name), _reduced(jax_get_config, name)
    params, model = _carried(cfg, jcfg, 8)
    prompt = "what does the index store " * 3
    ref = JaxGenerator(jcfg, params, max_prompt=24).generate(prompt, 4)
    gen = GeneratorModel(cfg, model, max_prompt=24, device="cpu")
    assert gen.generate(prompt, 4) == ref


def test_serve_runs_yi_9b_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "yi-9b", "--device", "cpu", "--dataset",
                    "fiqa", "--records", "300", "--queries", "2"])
    text = out.getvalue()
    assert "indexed 300 chunks" in text and "TTFT edge-sim" in text
    assert "gen_tokens=16" in text


# ---------------------------------------------------------------------------
# gemma3-12b: sliding-window layers over ring caches
# ---------------------------------------------------------------------------
GEMMA_LEN, GEMMA_PROMPT = 128, 100      # cache rows; a prompt past window 64


def _gemma_hd256(get):
    """``.reduced()`` with gemma3's head dim 256: 4 heads over 2 (its
    group of 2)."""
    return dataclasses.replace(get(GEMMA).reduced(), name=f"{GEMMA}-hd256",
                               num_heads=4, num_kv_heads=2, head_dim=256)


@pytest.fixture(scope="module", params=["reduced", "hd256"])
def gemma(request):
    """(port cfg, JAX cfg, JAX params, port model, JAX prefill, JAX
    decode), jitted once a module."""
    if request.param == "reduced":
        cfg, jcfg = get_config(GEMMA).reduced(), jax_get_config(
            GEMMA).reduced()
    else:
        cfg, jcfg = _gemma_hd256(get_config), _gemma_hd256(jax_get_config)
    params, model = _carried(cfg, jcfg, 11)
    return (cfg, jcfg, params, model, *_jitted(jcfg))


def test_gemma3_config_copy_and_param_count():
    full, jfull = get_config(GEMMA), jax_get_config(GEMMA)
    assert dataclasses.asdict(full) == dataclasses.asdict(jfull)
    assert full.param_count() == jfull.param_count() == 11_765_395_200
    assert (full.head_dim, full.sliding_window, full.num_layers) == (256,
                                                                     1024, 48)
    cfg = full.reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jfull.reduced())
    assert (cfg.num_layers, cfg.head_dim, cfg.sliding_window) == (6, 64, 64)
    model = init_params(cfg, seed=1, device="cpu")
    assert param_count(model) == cfg.param_count()
    assert model.lm_head is None and cfg.tie_embeddings
    assert [b.kind for b in model.blocks] == list(cfg.block_pattern)
    assert [b.window for b in model.blocks] == [64] * 5 + [0]


def _cache_rows_match(pc, jc, cfg):
    """Every port layer's cache equals the JAX stack's (pattern position
    ``i``, repeat ``r``): the ring scatter and the ring inserts."""
    width = len(cfg.block_pattern)
    for layer, c in enumerate(pc):
        r, i = divmod(layer, width)
        assert c.circular == (cfg.block_pattern[i] == "swa")
        for got, want in ((c.k, jc[i].k[r]), (c.v, jc[i].v[r])):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                       atol=TOL)


@pytest.mark.parametrize("lengths", ["int", "per_slot"])
def test_gemma3_prefill_and_decode_past_the_window_match_jax(gemma, lengths):
    """A 100-position prompt (10 of left padding, attended) past the window
    of 64, then 12 greedy steps, so the rings wrap again; per slot, slot 1
    decodes 4 positions behind slot 0."""
    cfg, jcfg, params, model, _, jdecode = gemma
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, (2, GEMMA_PROMPT)).astype(np.int32)
    toks[:, :10] = 0
    jl, jc, _, pc, _ = _prefill_both(cfg, jcfg, params, model,
                                     {"tokens": toks}, GEMMA_LEN)
    assert [c.k.shape[1] for c in pc] == [64] * 5 + [GEMMA_LEN]
    _cache_rows_match(pc, jc, cfg)
    lens = (GEMMA_PROMPT if lengths == "int"
            else np.array([GEMMA_PROMPT, GEMMA_PROMPT - 4], np.int32))
    for _ in range(12):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdecode(params, jnp.asarray(nxt), jc, jnp.asarray(lens))
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc,
                             lens if lengths == "int"
                             else torch.from_numpy(lens))
        _close(pl, jl)
        lens = lens + 1
    _cache_rows_match(pc, jc, cfg)


def test_params_from_jax_maps_each_pattern_position():
    """A two-kind pattern over 4 layers: port layer ``r * 2 + i`` holds the
    JAX stack ``i``'s repeat ``r``, and the prefill logits agree."""
    kw = dict(block_pattern=("swa", "attn"), num_layers=4)
    cfg = dataclasses.replace(get_config(GEMMA).reduced(), **kw)
    jcfg = dataclasses.replace(jax_get_config(GEMMA).reduced(), **kw)
    params, model = _carried(cfg, jcfg, 13)
    assert [b.kind for b in model.blocks] == ["swa", "attn"] * 2
    for layer, block in enumerate(model.blocks):
        stack = params["blocks"][layer % 2]
        for name in ("wq", "wo", "norm1"):
            assert np.array_equal(getattr(block, name).numpy(),
                                  np.asarray(stack[name][layer // 2]))
        assert np.array_equal(block.down.numpy(),
                              np.asarray(stack["mlp"]["down"][layer // 2]))
    toks = np.random.default_rng(13).integers(
        0, cfg.vocab_size, (1, 80)).astype(np.int32)
    _prefill_both(cfg, jcfg, params, model, {"tokens": toks}, 96)


def test_gemma3_generator_model_matches_jax_generator():
    cfg, jcfg = get_config(GEMMA).reduced(), jax_get_config(GEMMA).reduced()
    params, model = _carried(cfg, jcfg, 14)
    prompt = "what does the index store when the window cuts " * 12
    ref = JaxGenerator(jcfg, params, max_prompt=GEMMA_PROMPT).generate(
        prompt, 6)
    gen = GeneratorModel(cfg, model, max_prompt=GEMMA_PROMPT, device="cpu")
    assert gen.generate(prompt, 6) == ref


def test_serve_runs_gemma3_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", GEMMA, "--device", "cpu", "--dataset",
                    "fiqa", "--records", "300", "--queries", "2"])
    text = out.getvalue()
    assert "indexed 300 chunks" in text and "TTFT edge-sim" in text
    assert "gen_tokens=16" in text


def test_gemma3_batcher_matches_the_jax_batcher():
    """Prompts of 70, 90 and 40 tokens (two past the window of 64) with
    budgets 6, 4 and 8 through 2 slots of 112 positions: slots free and
    refill at different ticks, each over its own rings.  Tokens compared as
    ``tests/test_torch_batching.py`` compares them, against the JAX
    batcher, with the port's lone runs' margins."""
    cfg, jcfg = get_config(GEMMA).reduced(), jax_get_config(GEMMA).reduced()
    params, model = _carried(cfg, jcfg, 15)
    rng = np.random.default_rng(15)
    reqs = [{"id": i, "prompt_tokens": rng.integers(2, cfg.vocab_size, n)
             .tolist(), "max_new_tokens": b}
            for i, (n, b) in enumerate(((70, 6), (90, 4), (40, 8)))]
    port = ContinuousBatcher(cfg, model, num_slots=2, max_len=112,
                             device="cpu").run(reqs)
    ref = JaxBatcher(jcfg, params, num_slots=2, max_len=112).run(reqs)
    assert set(port) == set(ref) == {0, 1, 2}
    compared = total = 0
    for r in reqs:
        caches = init_cache(cfg, 1, 112, device=CPU)
        logits, _ = prefill(model, {"tokens": torch.tensor(
            [r["prompt_tokens"]])}, caches)
        total += len(ref[r["id"]])
        for t, want in enumerate(ref[r["id"]]):
            top2 = np.sort(logits[0].numpy())[-2:]
            if top2[1] - top2[0] <= 2 * TOL:
                break                      # a near-tie: stop this request
            assert port[r["id"]][t] == want == int(logits[0].argmax())
            compared += 1
            logits, _ = decode_step(model, torch.tensor([[want]]), caches,
                                    len(r["prompt_tokens"]) + t)
    assert compared >= 0.9 * total, (compared, total)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("name,heads,kv", GQA)
def test_card_gqa_head_dim_128_matches_the_cpu(cuda, name, heads, kv):
    """The GQA variants on the card (K5 prefill, K6 decode) against the
    same weights on the CPU; logits within 1e-4 (``chip_smoke.py``'s
    ``GEN_TOL``: fp32 matmuls summed in other orders on the two)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _gqa(get_config, name, heads, kv)
    m_cpu = init_params(cfg, seed=2, device="cpu")
    m_card = init_params(cfg, seed=2, device="cpu").to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(2))
    c_cpu = init_cache(cfg, 2, 48, device=CPU)
    c_card = init_cache(cfg, 2, 48, device=cuda)
    f0, d0 = flash_attention.launches, decode_attention.launches
    l_cpu, _ = prefill(m_cpu, {"tokens": toks}, c_cpu)
    l_card, _ = prefill(m_card, {"tokens": toks.to(cuda)}, c_card)
    assert (l_card.cpu() - l_cpu).abs().max() <= 1e-4
    for step in range(4):
        nxt = l_cpu.argmax(-1)[:, None]
        l_cpu, _ = decode_step(m_cpu, nxt, c_cpu, 40 + step)
        l_card, _ = decode_step(m_card, nxt.to(cuda), c_card, 40 + step)
        assert (l_card.cpu() - l_cpu).abs().max() <= 1e-4
    assert flash_attention.launches - f0 == cfg.num_layers
    assert decode_attention.launches - d0 == 4 * cfg.num_layers


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["reduced", "hd256"])
def test_card_gemma3_matches_the_cpu(cuda, variant):
    """gemma3 on the card (K5 with the window of 64 in its 5 ``"swa"``
    layers, causal-global in the sixth; K6 over the rings and the global
    cache) against the same weights on the CPU: a 100-position prompt past
    the window, then 8 steps, 4 of them per slot (slot 1 two behind);
    logits within 1e-4 as above; exact launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (get_config(GEMMA).reduced() if variant == "reduced"
           else _gemma_hd256(get_config))
    m_cpu = init_params(cfg, seed=3, device="cpu")
    m_card = init_params(cfg, seed=3, device="cpu").to(cuda)
    toks = torch.randint(0, cfg.vocab_size, (2, GEMMA_PROMPT),
                         generator=torch.Generator().manual_seed(3))
    c_cpu = init_cache(cfg, 2, GEMMA_LEN, device=CPU)
    c_card = init_cache(cfg, 2, GEMMA_LEN, device=cuda)
    f0, w0 = flash_attention.launches, flash_attention.launches_windowed
    d0 = decode_attention.launches
    l_cpu, _ = prefill(m_cpu, {"tokens": toks}, c_cpu)
    l_card, _ = prefill(m_card, {"tokens": toks.to(cuda)}, c_card)
    assert (l_card.cpu() - l_cpu).abs().max() <= 1e-4
    for step in range(8):
        nxt = l_cpu.argmax(-1)[:, None]
        pos = GEMMA_PROMPT + step
        if step >= 4:
            pos = torch.tensor([pos, pos - 2])
        l_cpu, _ = decode_step(m_cpu, nxt, c_cpu, pos)
        l_card, _ = decode_step(m_card, nxt.to(cuda), c_card, pos)
        assert (l_card.cpu() - l_cpu).abs().max() <= 1e-4
    assert flash_attention.launches - f0 == cfg.num_layers
    assert flash_attention.launches_windowed - w0 == 5
    assert decode_attention.launches - d0 == 8 * cfg.num_layers
