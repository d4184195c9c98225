"""The mixture-of-experts block (``repro_torch.models.moe``) and the two
MoE configs (olmoe-1b-7b, granite-moe-3b-a800m) against the JAX package.

Sizes: the block at d 16-32, 4-8 experts, 12-64 tokens; the models at
``.reduced(num_layers=2, d_model=128)`` (4 experts, top-2, capacity factor
4.0: dropless) and at ``.reduced(num_layers=2, d_model=128,
max_experts=8)`` with ``expert_capacity_factor=1.25`` over 2 x 24 prompt
tokens (capacity 15 against 12 assignments an expert on average), so
prefill drops tokens; decode stays dropless (``capacity = B * S``).

Tolerances, both sides fp32 on the CPU:
- ``TOL`` = 2e-5 on block outputs and logits, as ``tests/test_torch_archs.py``
  states it (XLA and ATen order their sums and evaluate exp / rsqrt a few
  ulps apart; the block's outputs drift by ~2e-6);
- ``AUX_TOL`` = 1e-6 on the load-balance loss (a mean of ~T products of
  probabilities, ~1; drift ~1e-7);
- ``ROUTE_TOL`` = 1e-6 on the gap between the k-th and (k+1)-th router
  probability: where a token's gap exceeds it, its top-k experts must be
  equal (the two softmaxes differ by ~1e-8).  The drops (``keep``) are
  held exactly, for every expert whose routed tokens agree, to an oracle
  that applies the reference's rule (a stable sort of the token-major
  assignments by expert, positions by running count, ``pos < C``) to the
  JAX package's own top-k.
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
from repro.models import init_cache as jax_init_cache  # noqa: E402
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models import prefill as jax_prefill  # noqa: E402
from repro.models.moe import init_moe as jax_init_moe  # noqa: E402
from repro.models.moe import moe_block as jax_moe_block  # noqa: E402
from repro.serving.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from repro.serving.engine import GeneratorModel as JaxGenerator  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (decode_step, init_cache,  # noqa: E402
                                init_params, param_count, prefill)
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.moe import (capacity_of, init_moe,  # noqa: E402
                                    moe_block, route)
from repro_torch.serving import ContinuousBatcher, GeneratorModel  # noqa

TOL, AUX_TOL, ROUTE_TOL = 2e-5, 1e-6, 1e-6
MOE = ("olmoe-1b-7b", "granite-moe-3b-a800m")
PARAM_COUNTS = {"olmoe-1b-7b": 6_919_096_320,
                "granite-moe-3b-a800m": 3_298_793_472}
CPU = torch.device("cpu")


def _jax_moe(seed, d, ff, e):
    """JAX ``init_moe`` params (numpy) and the same as port tensors."""
    params = jax.tree.map(np.asarray,
                          jax_init_moe(jax.random.PRNGKey(seed), d, ff, e))
    return params, {n: torch.from_numpy(a.copy()) for n, a in params.items()}


def _keep_oracle(expert_ids, capacity):
    """The reference's drop rule on (T, K) expert ids: (T, K) bool."""
    flat = np.asarray(expert_ids).reshape(-1)
    order = np.argsort(flat, kind="stable")
    keep = np.zeros(flat.shape, bool)
    seen = {}
    for i in order:
        seen[flat[i]] = seen.get(flat[i], 0) + 1
        keep[i] = seen[flat[i]] <= capacity
    return keep.reshape(np.asarray(expert_ids).shape)


def _jax_routing(params, x, k):
    """The JAX package's probabilities and top-k ids for x (B, S, d)."""
    xf = jnp.asarray(x).reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(xf @ jnp.asarray(params["router"]), axis=-1)
    _, ids = jax.lax.top_k(probs, k)
    return np.asarray(probs), np.asarray(ids)


# ---------------------------------------------------------------------------
# the block against the JAX block
# ---------------------------------------------------------------------------
BLOCK_CASES = {
    # name: (B, S, d, ff, E, K, capacity, factor)
    "dropless": (2, 16, 32, 48, 8, 2, 32, 1.25),
    "capacity_1": (2, 16, 32, 48, 8, 2, 1, 1.25),
    "factor": (2, 32, 32, 48, 8, 3, 0, 1.25),
    "factor_top1": (1, 64, 16, 32, 4, 1, 0, 1.0),
}


@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_moe_block_matches_jax(case):
    b, s, d, ff, e, k, cap, factor = BLOCK_CASES[case]
    params, tp = _jax_moe(len(case), d, ff, e)
    x = np.random.default_rng(len(case)).standard_normal(
        (b, s, d)).astype(np.float32)
    jo, ja = jax_moe_block(params, jnp.asarray(x), num_experts=e, top_k=k,
                           capacity_factor=factor, capacity=cap)
    po, pa = moe_block(tp, torch.from_numpy(x), num_experts=e, top_k=k,
                       capacity_factor=factor, capacity=cap)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0, atol=TOL)
    assert abs(float(pa) - float(ja)) <= AUX_TOL

    r = route(tp, torch.from_numpy(x), num_experts=e, top_k=k,
              capacity_factor=factor, capacity=cap)
    want_cap = cap if cap > 0 else capacity_of(b * s, e, k, factor)
    assert r.capacity == want_cap
    probs, jids = _jax_routing(params, x, k)
    srt = np.sort(probs, axis=1)[:, ::-1]
    clear = srt[:, k - 1] - srt[:, k] > ROUTE_TOL
    ids = r.expert_ids.numpy()
    assert np.array_equal(ids[clear], jids[clear])
    # keep, token-major, against the oracle on the JAX ids, for every
    # expert routed the same tokens on both sides
    keep = np.empty(b * s * k, bool)
    keep[r.order.numpy()] = r.keep.numpy()
    keep = keep.reshape(b * s, k)
    want = _keep_oracle(jids, want_cap)
    for ex in range(e):
        if np.array_equal(ids == ex, jids == ex):
            assert np.array_equal(keep[ids == ex], want[jids == ex]), ex
    dropped = int((~keep).sum())
    assert (dropped > 0) == (case != "dropless"), dropped


def test_moe_dropless_equals_the_dense_per_token_mix():
    """``tests/test_mixers.py::test_moe_dropless_capacity_exact`` on the
    port: with capacity >= T the block is each token's gate-weighted mix
    of its top-k experts' SwiGLU (numpy, in float64)."""
    d, ff, e, k = 16, 32, 4, 2
    params = init_moe(d, ff, e, torch.Generator().manual_seed(0), CPU)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 6, d)).astype(np.float32))
    out, aux = moe_block(params, x, num_experts=e, top_k=k, capacity=12)
    p = {n: t.double().numpy() for n, t in params.items()}
    xf = x.double().numpy().reshape(-1, d)
    logits = xf @ p["router"]
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    top = np.argsort(-probs, axis=1, kind="stable")[:, :k]
    ref = np.zeros_like(xf)
    for t in range(xf.shape[0]):
        gates = probs[t, top[t]] / probs[t, top[t]].sum()
        for j, ei in enumerate(top[t]):
            h = xf[t] @ p["gate"][ei]
            h = h / (1 + np.exp(-h)) * (xf[t] @ p["up"][ei])
            ref[t] += gates[j] * (h @ p["down"][ei])
    np.testing.assert_allclose(out.double().numpy().reshape(-1, d), ref,
                               atol=1e-4, rtol=1e-3)
    assert float(aux) > 0


def test_moe_capacity_drops_are_partial():
    """``tests/test_mixers.py::test_moe_capacity_drops_are_partial`` on the
    port: a capacity of 1 zeroes some tokens' expert output and keeps
    others' (the residual passthrough is the block's)."""
    d, ff, e, k = 8, 16, 4, 2
    params = init_moe(d, ff, e, torch.Generator().manual_seed(1), CPU)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 16, d)).astype(np.float32))
    full, _ = moe_block(params, x, num_experts=e, top_k=k, capacity=32)
    tiny, _ = moe_block(params, x, num_experts=e, top_k=k, capacity=1)
    assert float((full - tiny).abs().max()) > 1e-6
    dropped = tiny.abs().amax(-1) == 0             # every slot dropped
    assert 0 < int(dropped.sum()) < 16
    assert not bool((full.abs().amax(-1) == 0).any())


@pytest.mark.parametrize("capacity", [0, 1, 3])
def test_zero_router_ties_pick_the_lowest_experts(capacity):
    """A zero router makes every probability exactly 1 / E; the reference
    (``jax.lax.top_k``) picks experts 0..k-1 for every token, and so must
    the port, with the same drops: at capacity C only the first C tokens
    reach them."""
    d, ff, e, k, t = 16, 24, 8, 3, 10
    params, tp = _jax_moe(2, d, ff, e)
    params["router"] = np.zeros_like(params["router"])
    tp["router"] = torch.zeros_like(tp["router"])
    x = np.random.default_rng(2).standard_normal((1, t, d)).astype(
        np.float32)
    r = route(tp, torch.from_numpy(x), num_experts=e, top_k=k,
              capacity=capacity)
    assert r.expert_ids.tolist() == [list(range(k))] * t
    assert torch.equal(r.gates, torch.full((t, k), 1.0 / k))
    _, jids = _jax_routing(params, x, k)
    assert jids.tolist() == [list(range(k))] * t
    jo, _ = jax_moe_block(params, jnp.asarray(x), num_experts=e, top_k=k,
                          capacity=capacity)
    po, _ = moe_block(tp, torch.from_numpy(x), num_experts=e, top_k=k,
                      capacity=capacity)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), rtol=0, atol=TOL)
    cap = r.capacity
    assert cap == (capacity or capacity_of(t, e, k, 1.25))
    if cap < t:
        assert float(po[0, cap:].abs().max()) == 0.0
        assert float(po[0, :cap].abs().min()) > 0.0


def test_route_keeps_fixed_shapes():
    """Every output of the routing step has a shape fixed by (T, E, K, C):
    nothing depends on how many tokens an expert got."""
    params = init_moe(16, 24, 8, torch.Generator().manual_seed(3), CPU)
    for seed in range(3):
        x = torch.randn((2, 9, 16), generator=torch.Generator()
                        .manual_seed(seed))
        r = route(params, x, num_experts=8, top_k=2, capacity=2)
        assert (r.probs.shape, r.expert_ids.shape, r.gates.shape,
                r.order.shape, r.slot.shape, r.keep.shape) == (
            (18, 8), (18, 2), (18, 2), (36,), (36,), (36,))
        assert int(r.slot.max()) <= 8 * 2 and int(r.slot.min()) >= 0


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", MOE)
def test_config_copy_matches_reference(name):
    full = get_config(name)
    assert dataclasses.asdict(full) == dataclasses.asdict(
        jax_get_config(name))
    assert full.param_count() == jax_get_config(name).param_count() \
        == PARAM_COUNTS[name]
    assert full.block_pattern == ("moe",)
    cfg, jcfg = _reduced(get_config, name), _reduced(jax_get_config, name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    model = init_params(cfg, seed=1, device="cpu")
    assert param_count(model) == cfg.param_count()
    assert (model.lm_head is None) == cfg.tie_embeddings
    assert (name == "granite-moe-3b-a800m") == cfg.tie_embeddings
    names = {n for n, _ in model.named_parameters()}
    assert {"blocks.0.moe.router", "blocks.0.moe.gate", "blocks.0.moe.up",
            "blocks.0.moe.down"} <= names
    assert not any(n.startswith("blocks.0.gate") for n in names)
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    assert [tuple(model.blocks[0].moe[n].shape) for n in
            ("router", "gate", "up", "down")] == [(d, e), (e, d, ff),
                                                 (e, d, ff), (e, ff, d)]


@pytest.mark.parametrize("kind", ["moe", "swa_moe"])
def test_model_builds_the_moe_kinds(kind):
    cfg = dataclasses.replace(_reduced(get_config, "olmoe-1b-7b"),
                              block_pattern=(kind,), sliding_window=16)
    model = init_params(cfg, device="cpu")
    assert [b.window for b in model.blocks] == [16 if kind == "swa_moe"
                                                else 0] * cfg.num_layers
    assert all(b.moe is not None for b in model.blocks)


# ---------------------------------------------------------------------------
# the models against the JAX package
# ---------------------------------------------------------------------------
def _reduced(get, name, drops=False):
    if not drops:
        return get(name).reduced(num_layers=2, d_model=128)
    return dataclasses.replace(
        get(name).reduced(num_layers=2, d_model=128, max_experts=8),
        expert_capacity_factor=1.25)


def _carried(cfg, jcfg, seed):
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return params, model


def _close(port, ref):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


class _Drops:
    """Wraps the model's ``moe_block``: counts each call's dropped
    assignments and its capacity, by mode (decode: a capacity of B * S)."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(model_mod, "moe_block", self)

    def __call__(self, params, x, **kw):
        r = route(params, x, **kw)
        self.calls.append((x.shape[0] * x.shape[1], r.capacity,
                           int((~r.keep).sum())))
        return moe_block(params, x, **kw)


def _prefill_and_decode(cfg, jcfg, seed, prompt=24, steps=8, b=2,
                        max_len=40):
    params, model = _carried(cfg, jcfg, seed)
    jpre = jax.jit(lambda p, bt, c: jax_prefill(p, jcfg, bt, c))
    jdec = jax.jit(lambda p, t, c, n: jax_decode(p, jcfg, t, c, n))
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, prompt)).astype(np.int32)
    jl, jc = jpre(params, {"tokens": jnp.asarray(toks)},
                  jax_init_cache(jcfg, b, max_len))
    pc = init_cache(cfg, b, max_len, device=CPU)
    pl, pc = prefill(model, {"tokens": torch.from_numpy(toks).long()}, pc)
    _close(pl, jl)
    n = prompt
    for _ in range(steps):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = jdec(params, jnp.asarray(nxt), jc, n)
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc, n)
        _close(pl, jl)
        n += 1
    return jc, pc


@pytest.mark.parametrize("variant", ["reduced", "drops"])
@pytest.mark.parametrize("name", MOE)
def test_prefill_and_decode_match_jax(name, variant, monkeypatch):
    """Prefill of 2 x 24 tokens and 8 greedy decode steps, the JAX params
    carried over; logits within ``TOL`` at every step.  ``drops``: 8
    experts at factor 1.25, so prefill drops assignments (counted), while
    decode (capacity B * S = 2) drops none."""
    drops = variant == "drops"
    cfg, jcfg = (_reduced(get_config, name, drops),
                 _reduced(jax_get_config, name, drops))
    log = _Drops(monkeypatch)
    _prefill_and_decode(cfg, jcfg, MOE.index(name) + 2 * drops)
    prefill_calls = log.calls[:cfg.num_layers]
    decode_calls = log.calls[cfg.num_layers:]
    assert len(decode_calls) == 8 * cfg.num_layers
    assert all(cap == t == 2 and n == 0 for t, cap, n in decode_calls)
    want_cap = capacity_of(48, cfg.num_experts, cfg.num_experts_per_tok,
                           cfg.expert_capacity_factor)
    assert all(t == 48 and cap == want_cap for t, cap, _ in prefill_calls)
    dropped = sum(n for _, _, n in prefill_calls)
    assert (dropped > 0) == drops, dropped


def test_swa_moe_pattern_over_a_wrapping_ring():
    """A ``("swa_moe", "moe")`` pattern over 4 layers, window 16: a 30-token
    prompt past the window, then 8 decode steps, so the rings of the
    ``"swa_moe"`` layers wrap; logits within ``TOL`` at every step and
    every layer's cache equal to the JAX stacks."""
    kw = dict(block_pattern=("swa_moe", "moe"), num_layers=4,
              sliding_window=16)
    cfg = dataclasses.replace(_reduced(get_config, "olmoe-1b-7b"), **kw)
    jcfg = dataclasses.replace(_reduced(jax_get_config, "olmoe-1b-7b"),
                               **kw)
    jc, pc = _prefill_and_decode(cfg, jcfg, 21, prompt=30, max_len=40)
    assert [c.k.shape[1] for c in pc] == [16, 40] * 2
    assert [c.circular for c in pc] == [True, False] * 2
    for layer, c in enumerate(pc):
        r, i = divmod(layer, 2)
        for got, want in ((c.k, jc[i].k[r]), (c.v, jc[i].v[r])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=TOL)


def test_params_from_jax_carries_the_moe_leaves():
    cfg, jcfg = (_reduced(get_config, "olmoe-1b-7b"),
                 _reduced(jax_get_config, "olmoe-1b-7b"))
    params, model = _carried(cfg, jcfg, 5)
    for layer, block in enumerate(model.blocks):
        for name in ("router", "gate", "up", "down"):
            assert np.array_equal(
                block.moe[name].numpy(),
                np.asarray(params["blocks"][0]["moe"][name][layer]))


def test_decode_slots_do_not_take_each_others_capacity():
    """Decode is dropless: 3 slots fed the same token (so every slot routes
    to the same experts; the factor's capacity would be 2) give each
    slot's lone logits, within ``TOL``.  Each slot's prompt is prefilled
    alone (a prefill's capacity depends on its batch)."""
    from repro_torch.models import KVCache
    cfg = _reduced(get_config, "olmoe-1b-7b", drops=True)
    assert capacity_of(3, cfg.num_experts, cfg.num_experts_per_tok,
                       cfg.expert_capacity_factor) < 3
    model = init_params(cfg, seed=4, device="cpu")
    g = torch.Generator().manual_seed(4)
    prompts = torch.randint(0, cfg.vocab_size, (3, 12), generator=g)
    tok = torch.full((1, 1), 7, dtype=torch.long)
    lone, slots = [], []
    for i in range(3):
        c1 = init_cache(cfg, 1, 20, device=CPU)
        prefill(model, {"tokens": prompts[i:i + 1]}, c1)
        slots.append([KVCache(c.k.clone(), c.v.clone()) for c in c1])
        lone.append(decode_step(model, tok, c1, 12)[0][0])
    caches = [KVCache(torch.cat([s[j].k for s in slots]),
                      torch.cat([s[j].v for s in slots]))
              for j in range(cfg.num_layers)]
    batched, _ = decode_step(model, tok.expand(3, 1), caches, 12)
    for i in range(3):
        np.testing.assert_allclose(batched[i].numpy(), lone[i].numpy(),
                                   rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------
def test_batched_equals_sequential_olmoe_matches_the_jax_batcher():
    """``tests/test_batching.py::test_batched_equals_sequential``'s olmoe
    case through the port's ``ContinuousBatcher``, against the JAX
    batcher: prompts of 9 / 14 / 5 / 11 / 7 tokens, budgets 6 / 4 / 8 / 5
    / 7, 3 slots of 96 positions.  Every tick routes all 3 slots' tokens,
    free slots' included; decode is dropless, so the tokens must also be
    each request's lone run's.  Tokens compared as
    ``tests/test_torch_batching.py`` compares them (a request stops at its
    lone run's first near-tie, 2 x ``TOL``; >= 90% compared)."""
    name = "olmoe-1b-7b"
    cfg, jcfg = _reduced(get_config, name), _reduced(jax_get_config, name)
    params, model = _carried(cfg, jcfg, 3)
    rng = np.random.default_rng(0)
    reqs = [{"id": i, "prompt_tokens": rng.integers(2, cfg.vocab_size, n)
             .tolist(), "max_new_tokens": b}
            for i, (n, b) in enumerate(zip((9, 14, 5, 11, 7),
                                           (6, 4, 8, 5, 7)))]
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


@pytest.mark.parametrize("name", MOE)
def test_generator_model_matches_jax_generator(name):
    cfg, jcfg = _reduced(get_config, name), _reduced(jax_get_config, name)
    params, model = _carried(cfg, jcfg, 8)
    prompt = "what does the index store " * 3
    ref = JaxGenerator(jcfg, params, max_prompt=24).generate(prompt, 4)
    gen = GeneratorModel(cfg, model, max_prompt=24, device="cpu")
    assert gen.generate(prompt, 4) == ref


def test_serve_runs_olmoe_on_the_cpu():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        serve.main(["--arch", "olmoe-1b-7b", "--device", "cpu", "--dataset",
                    "fiqa", "--records", "300", "--queries", "2"])
    text = out.getvalue()
    assert "indexed 300 chunks" in text and "TTFT edge-sim" in text
    assert "gen_tokens=16" in text


# ---------------------------------------------------------------------------
# chip_smoke.py's rule for routing flips between the card and the CPU
# ---------------------------------------------------------------------------
def _chip_smoke():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cpu_col2,card_shift,flips", [
    (0.5, 0.0, 0), (0.5, 1e-6, 5), (0.1, 0.6, None)])
def test_route_flips_accepts_only_near_ties(cpu_col2, card_shift, flips):
    """``chip_smoke.py``'s ``route_flips`` on a router built to tie: with
    ``cpu_col2`` 0.5 experts 1 and 2 have equal columns, so every token's
    2nd and 3rd probabilities are equal and the stable top-2 is {0, 1}.
    The "card" side's column 2 is moved by ``card_shift``: 0 keeps the
    sets equal (no flip); 1e-6 turns each of the 5 tokens' sets to {0, 2}
    across a CPU gap of 0, near-ties, each reported.  With ``cpu_col2``
    0.1 the CPU's gap is wide, and the same flip on the card must fail."""
    cs = _chip_smoke()
    d, e = 8, 4
    x = torch.from_numpy(np.abs(np.random.default_rng(6).standard_normal(
        (1, 5, d))).astype(np.float32))
    router = torch.zeros((d, e))
    router[:, 0], router[:, 1], router[:, 2] = 1.0, 0.5, cpu_col2
    cpu_p = {"router": router, "gate": torch.zeros((e, d, 4)),
             "up": torch.zeros((e, d, 4)), "down": torch.zeros((e, 4, d))}
    card_p = dict(cpu_p, router=router.clone())
    card_p["router"][:, 2] += card_shift
    log = cs.RouteLog(moe_block, record=True)
    for p in (cpu_p, card_p):
        log(p, x, num_experts=e, top_k=2, capacity_factor=1.25, capacity=0)
    log.calls[1]["device"] = "cuda"            # the second side's entry
    if flips is None:
        with pytest.raises(AssertionError, match="outside a near-tie"):
            cs.route_flips(log.calls, 1, "tie test")
        return
    got = cs.route_flips(log.calls, 1, "tie test")
    assert len(got) == flips
    for f in got:
        assert (f["cpu"], f["card"], f["cpu_gap"]) == ([0, 1], [0, 2], 0.0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_card_moe_block_matches_the_cpu_and_is_deterministic(cuda):
    """The block at olmoe's expert count and top-k (64 of d 256, top-8,
    128 tokens at factor 1.25: capacity 20, so it drops) on the card
    against the CPU: expert ids equal where the k-th / (k+1)-th gap
    exceeds ``ROUTE_TOL``, and the drops equal for every expert routed the
    same tokens; where no token is near a tie, the output within 1e-4
    (fp32 GEMMs summed in other orders, as ``chip_smoke.py``'s
    ``GEN_TOL``); two calls on the card bitwise equal, in prefill and
    decode form."""
    torch.backends.cuda.matmul.allow_tf32 = False
    params = init_moe(256, 128, 64, torch.Generator().manual_seed(5), CPU)
    x = torch.randn((1, 128, 256), generator=torch.Generator()
                    .manual_seed(5))
    card = {n: t.to(cuda) for n, t in params.items()}
    kw = dict(num_experts=64, top_k=8, capacity_factor=1.25)
    r_cpu = route(params, x, **kw)
    srt = torch.sort(r_cpu.probs, dim=-1, descending=True).values
    clear = (srt[:, 7] - srt[:, 8] > ROUTE_TOL).numpy()
    r_card = route(card, x.to(cuda), **kw)
    ids, ids_card = r_cpu.expert_ids.numpy(), r_card.expert_ids.cpu().numpy()
    assert np.array_equal(ids_card[clear], ids[clear])

    def token_major(r):
        keep = np.empty(r.keep.numel(), bool)
        keep[r.order.cpu().numpy()] = r.keep.cpu().numpy()
        return keep.reshape(128, 8)

    keep, keep_card = token_major(r_cpu), token_major(r_card)
    for ex in range(64):
        if np.array_equal(ids == ex, ids_card == ex):
            assert np.array_equal(keep[ids == ex], keep_card[ids_card == ex])
    assert int((~keep).sum()) > 0
    o_cpu, _ = moe_block(params, x, **kw)
    o1, _ = moe_block(card, x.to(cuda), **kw)
    o2, _ = moe_block(card, x.to(cuda), **kw)
    if clear.all():
        assert float((o1.cpu() - o_cpu).abs().max()) <= 1e-4
    assert torch.equal(o1, o2)
    d1, _ = moe_block(card, x[:, :16].to(cuda).reshape(16, 1, 256),
                      capacity=16, **kw)
    d2, _ = moe_block(card, x[:, :16].to(cuda).reshape(16, 1, 256),
                      capacity=16, **kw)
    assert torch.equal(d1, d2)
