"""The port's ``ContinuousBatcher`` against the JAX package's, and against
its own lone runs.

Config: sheared-llama-2.7b ``.reduced(num_layers=2, d_model=128)`` with the
JAX params carried over (``params_from_jax``).  The trace is
``tests/test_batching.py``'s: prompts of 9 / 14 / 5 / 11 / 7 tokens,
budgets 6 / 4 / 8 / 5 / 7, 3 slots, ``max_len`` 96, so slots free and
refill at different ticks.

Tolerance: both sides compute in fp32 on the CPU, a few ulps apart per op
(XLA and ATen block their matmuls differently, and a batched step rounds
otherwise than a lone one); through two blocks the logits differ by ~2e-6
(``tests/test_torch_model.py``), so ``TOL`` = 2e-5.  A greedy token is
compared while the lone run's top-2 logit margin exceeds 2 x ``TOL``; at
the first step under it, that request stops being compared (the two runs
may then take different branches).  At least 90% of tokens must be
compared.

The slot edge cases mirror ``tests/test_batching.py``.  The one departure
from the reference, ``admit`` refusing an empty prompt, a budget under 1
and a budget that leaves the prompt no position, is tested here too.
"""
import types

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
from repro.serving.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import decode_step, init_cache, init_params  # noqa
from repro_torch.models import prefill  # noqa: E402
from repro_torch.data.tokenizer import HashingTokenizer  # noqa: E402
from repro_torch.serving import BatchJob, ContinuousBatcher  # noqa: E402
from repro_torch.serving import RAGEngine  # noqa: E402
from repro_torch.serving import batching as batching_mod  # noqa: E402

TOL = 2e-5
NAME = "sheared-llama-2.7b"
LENS, BUDGETS, SLOTS, MAX_LEN = (9, 14, 5, 11, 7), (6, 4, 8, 5, 7), 3, 96
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def carried():
    """(port cfg, JAX cfg, JAX params, port model on the CPU)."""
    cfg = get_config(NAME).reduced(num_layers=2, d_model=128)
    jcfg = jax_get_config(NAME).reduced(num_layers=2, d_model=128)
    params = jax_init_params(jcfg, jax.random.PRNGKey(3))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return cfg, jcfg, params, model


@pytest.fixture(scope="module")
def jax_steps(carried):
    """JAX prefill and decode, jitted once: eager dispatch of the layer
    scan costs seconds a step on the CPU."""
    _, jcfg, _, _ = carried
    return (jax.jit(lambda p, b, c: jax_prefill(p, jcfg, b, c)),
            jax.jit(lambda p, t, c, n: jax_decode(p, jcfg, t, c, n)))


def _trace(vocab):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, vocab, size=n).tolist() for n in LENS]
    return [{"id": i, "prompt_tokens": p, "max_new_tokens": b}
            for i, (p, b) in enumerate(zip(prompts, BUDGETS))]


def _lone_port(model, cfg, prompt, budget):
    """Greedy tokens of one request alone (prefill, then ``decode_step`` on
    a one-row cache) and the logits each token was taken from."""
    caches = init_cache(cfg, 1, MAX_LEN, device=CPU)
    logits, _ = prefill(model, {"tokens": torch.tensor([prompt])}, caches)
    toks, steps = [], []
    for i in range(budget):
        steps.append(logits[0].numpy())
        toks.append(int(logits[0].argmax()))
        logits, _ = decode_step(model, torch.tensor([[toks[-1]]]), caches,
                                len(prompt) + i)
    return toks, steps


def _lone_jax(carried, jax_steps, prompt, budget, max_len=MAX_LEN):
    """The same on the JAX package (``tests/test_batching.py``'s
    ``sequential_generate``, keeping each step's logits)."""
    _, jcfg, params, _ = carried
    first, step = jax_steps
    caches = jax_init_cache(jcfg, 1, max_len)
    logits, caches = first(params, {"tokens": jnp.asarray([prompt],
                                                          jnp.int32)}, caches)
    toks, steps = [], []
    for i in range(budget):
        steps.append(np.asarray(logits[0]))
        toks.append(int(np.argmax(steps[-1])))
        logits, caches = step(params, jnp.asarray([[toks[-1]]], jnp.int32),
                              caches, len(prompt) + i)
    return toks, steps


def _compare(got, want, steps, tol=TOL):
    """Asserts ``got == want`` token by token while ``steps``' top-2
    margin exceeds 2 x ``tol``, stopping a request at its first near-tie;
    returns (tokens compared, tokens in all)."""
    compared = total = 0
    for rid, ref in want.items():
        assert len(got[rid]) == len(ref), rid
        total += len(ref)
        for t, (a, b) in enumerate(zip(got[rid], ref)):
            top2 = np.sort(steps[rid][t])[-2:]
            if top2[1] - top2[0] <= 2 * tol:
                break
            assert a == b, (rid, t, got[rid], ref)
            compared += 1
    return compared, total


def test_trace_matches_the_jax_batcher(carried, jax_steps):
    cfg, jcfg, params, model = carried
    reqs = _trace(cfg.vocab_size)
    port = ContinuousBatcher(cfg, model, num_slots=SLOTS, max_len=MAX_LEN,
                             device="cpu").run(reqs)
    ref = JaxBatcher(jcfg, params, num_slots=SLOTS,
                     max_len=MAX_LEN).run(reqs)
    assert set(port) == set(ref) == set(range(len(LENS)))
    steps = {r["id"]: _lone_jax(carried, jax_steps, r["prompt_tokens"],
                                r["max_new_tokens"])[1] for r in reqs}
    compared, total = _compare(port, ref, steps)
    assert compared >= 0.9 * total, (compared, total)


def test_trace_matches_the_ports_lone_runs(carried):
    cfg, _, _, model = carried
    reqs = _trace(cfg.vocab_size)
    b = ContinuousBatcher(cfg, model, num_slots=SLOTS, max_len=MAX_LEN,
                          device="cpu")
    outs = b.run(reqs)
    lone = {r["id"]: _lone_port(model, cfg, r["prompt_tokens"],
                                r["max_new_tokens"]) for r in reqs}
    compared, total = _compare(outs, {i: t for i, (t, _) in lone.items()},
                               {i: s for i, (_, s) in lone.items()})
    assert compared >= 0.9 * total, (compared, total)
    assert all(s.free for s in b.slots)
    assert b.lens.dtype == np.int32 and b.next_tok.dtype == np.int32


# ---------------------------------------------------------------------------
# slot edge cases, as tests/test_batching.py
# ---------------------------------------------------------------------------
def _tiny_batcher(num_slots=2, max_len=64):
    cfg = get_config(NAME).reduced(num_layers=1, d_model=64)
    return ContinuousBatcher(cfg, init_params(cfg, seed=3, device="cpu"),
                             num_slots=num_slots, max_len=max_len,
                             device="cpu")


def test_slots_reused():
    b = _tiny_batcher(num_slots=2)
    reqs = [{"id": i, "prompt_tokens": [3, 4, 5], "max_new_tokens": 3}
            for i in range(6)]
    outs = b.run(reqs)
    assert len(outs) == 6                      # 6 requests through 2 slots
    assert all(len(v) == 3 for v in outs.values())
    # the same prompt gives the same tokens whichever slot it ran in
    assert all(v == outs[0] for v in outs.values())


def test_admit_returns_none_when_all_slots_busy():
    b = _tiny_batcher(num_slots=2)
    assert b.admit(0, [3, 4, 5], 4) is not None
    assert b.admit(1, [6, 7], 4) is not None
    # pool exhausted: admission is refused, nothing is clobbered
    assert b.admit(2, [8, 9], 4) is None
    assert sorted(s.request_id for s in b.slots) == [0, 1]
    assert 2 not in b.completed


def test_slot_freed_on_finish_then_readmitted():
    b = _tiny_batcher(num_slots=1)
    slot0 = b.admit(0, [3, 4, 5], 2)
    assert slot0 == 0 and b.admit(1, [6, 7], 2) is None
    b.tick()
    b.tick()                                   # budget of 2 reached
    assert 0 in b.completed and len(b.completed[0]) == 2
    assert b.slots[0].free                     # freed immediately
    # the freed slot is reusable and per-slot state was reset, not leaked
    slot1 = b.admit(1, [6, 7], 2)
    assert slot1 == 0
    assert b.slots[0].tokens_out == []
    assert int(b.lens[0]) == 2                 # fresh prefix, not 3+2


def test_tick_with_zero_live_slots_is_a_noop():
    b = _tiny_batcher(num_slots=2)
    lens_before = b.lens.copy()
    k_before = [c.k.clone() for c in b.caches]
    assert b.tick() == 0                       # no active slots: no decode
    assert np.array_equal(b.lens, lens_before)
    assert b.completed == {}
    assert all(torch.equal(c.k, k) for c, k in zip(b.caches, k_before))


def test_cap_at_max_len_gives_the_jax_token_count(carried, jax_steps):
    """A prompt longer than ``max_len - budget - 1`` is cut to it, and the
    slot reaches ``max_len - 1`` with its last token: as many tokens as the
    JAX batcher gives, and the same ones."""
    cfg, jcfg, params, model = carried
    rng = np.random.default_rng(1)
    max_len, budget = 32, 20
    reqs = [{"id": 0, "prompt_tokens": rng.integers(
                2, cfg.vocab_size, 30).tolist(), "max_new_tokens": budget},
            {"id": 1, "prompt_tokens": [5, 6, 7], "max_new_tokens": 4}]
    port = ContinuousBatcher(cfg, model, num_slots=2, max_len=max_len,
                             device="cpu")
    outs = port.run(reqs)
    ref = JaxBatcher(jcfg, params, num_slots=2, max_len=max_len).run(reqs)
    assert {i: len(v) for i, v in outs.items()} == \
        {i: len(v) for i, v in ref.items()} == {0: budget, 1: 4}
    assert int(port.lens[0]) == max_len - 1
    steps = {r["id"]: _lone_jax(carried, jax_steps, r["prompt_tokens"][
        :max_len - r["max_new_tokens"] - 1], r["max_new_tokens"],
        max_len)[1] for r in reqs}
    compared, total = _compare(outs, ref, steps)
    assert compared >= 0.9 * total, (compared, total)


def test_readmitted_slot_is_zero_past_its_prompt(carried):
    """After a longer occupant, and a free-slot decode that wrote at its
    length, a re-admitted slot holds its own prompt's rows (those of a lone
    prefill) and zeros from position L on, in every layer."""
    cfg, _, _, model = carried
    b = ContinuousBatcher(cfg, model, num_slots=2, max_len=40, device="cpu")
    b.admit(0, list(range(2, 22)), 2)          # 20 tokens, slot 0
    b.admit(1, [7, 8, 9], 6)                   # slot 1 outlives it
    b.tick()
    b.tick()
    assert b.slots[0].free and not b.slots[1].free
    b.tick()                                   # slot 0 decoded while free
    assert bool((b.caches[0].k[0, 22] != 0).any())
    prompt = [11, 12, 13, 14, 15]
    assert b.admit(2, prompt, 3) == 0
    lone = init_cache(cfg, 1, 40, device=CPU)
    prefill(model, {"tokens": torch.tensor([prompt])}, lone)
    for c, ref in zip(b.caches, lone):
        assert torch.equal(c.k[0, :5], ref.k[0, :5])
        assert torch.equal(c.v[0, :5], ref.v[0, :5])
        assert not bool(c.k[0, 5:].any()) and not bool(c.v[0, 5:].any())


@pytest.mark.parametrize("prompt,budget", [
    ([3, 4, 5], 31),            # max_len - budget - 1 == 0
    ([3, 4, 5], 40),            # negative: the reference decodes below 0
    ([], 4),                    # empty prompt
    ([3, 4, 5], 0),             # the reference gives 1 token and may leave
    ([3, 4, 5], -1),            # a freed slot past the cache
])
def test_admit_refuses_bad_lengths_before_any_launch(monkeypatch, prompt,
                                                     budget):
    b = _tiny_batcher(num_slots=2, max_len=32)

    def no_launch(*args, **kw):
        raise AssertionError("prefill ran")
    monkeypatch.setattr(batching_mod, "prefill", no_launch)
    with pytest.raises(ValueError, match="max_new_tokens <= max_len - 2"):
        b.admit(0, prompt, budget)
    assert all(s.free for s in b.slots) and not b.lens.any()


def test_admit_takes_the_last_budget_that_leaves_one_position():
    b = _tiny_batcher(num_slots=1, max_len=32)
    assert b.admit(0, [3, 4, 5], 30) == 0 and int(b.lens[0]) == 1


def test_stage_decode_without_a_generator_tokenizes_for_the_batcher():
    """With no generator, the engine's S4 encodes prompts with a hashing
    tokenizer of the batcher's vocabulary, cut to its ``max_len``, and
    reads each request's tokens back from the batcher's run."""
    b = _tiny_batcher(num_slots=2, max_len=24)
    prompts = ["alpha beta gamma", "delta " * 40, "epsilon zeta"]
    job = BatchJob(queries=["q"] * 3, query_embs=np.zeros((3, 4)),
                   get_chunks=None, prompts=prompts,
                   prefill_edge=[0.0] * 3)
    RAGEngine(None, max_new_tokens=4).stage_decode(job, batcher=b)
    tok = HashingTokenizer(vocab_size=b.cfg.vocab_size)
    want = _tiny_batcher(num_slots=2, max_len=24).run([
        {"id": i, "prompt_tokens": tok.encode(p, 24), "max_new_tokens": 4}
        for i, p in enumerate(prompts)])
    assert job.out_tokens == [want[i] for i in range(3)]
    assert job.decode_wall > 0


# ---------------------------------------------------------------------------
# device
# ---------------------------------------------------------------------------
def test_batcher_raises_without_cuda(monkeypatch):
    cfg = get_config(NAME).reduced(num_layers=1, d_model=64)
    model = init_params(cfg, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ContinuousBatcher(cfg, model)
    assert ContinuousBatcher(cfg, model, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("params_on,device,takes", [
    ("cuda:0", None, True),         # what init_params / params_from_jax give
    ("cuda:0", "cuda", True),
    ("cuda", "cuda:0", True),
    ("cuda:0", "cuda:1", False),
    ("cpu", None, False),
    ("cuda:0", "cpu", False),
])
def test_params_device_against_the_batcher(monkeypatch, params_on, device,
                                           takes):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(batching_mod, "init_cache",
                        lambda *args, **kw: [])   # no cache on a mocked card
    cfg = get_config(NAME).reduced(num_layers=1, d_model=64)
    params = types.SimpleNamespace(device=torch.device(params_on))
    if takes:
        assert ContinuousBatcher(cfg, params, device=device).params is params
    else:
        with pytest.raises(ValueError, match="params are on"):
            ContinuousBatcher(cfg, params, device=device)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# Logits of this model on the card and the CPU: fp32 matmuls summed in
# other orders and the kernels against the plain attention, a few ulps
# apart per op (tests/test_torch_kernels.py's MODEL_TOL).
CARD_TOL = 1e-4


def _logged_run(monkeypatch, batcher, requests):
    """``batcher.run(requests)`` keeping, per request, the logits of its
    admission and of every tick it was active in, on the host: row t gave
    its token t."""
    prefill_fn, decode_fn = batching_mod.prefill, batching_mod.decode_step
    admit, rows, last = batcher.admit, {}, {}

    def prefill_(*args, **kw):
        out = prefill_fn(*args, **kw)
        last["row"] = out[0][0].cpu()
        return out

    def decode_(*args, **kw):
        out = decode_fn(*args, **kw)
        host = out[0].cpu()
        for i, s in enumerate(batcher.slots):
            if not s.free:
                rows[s.request_id].append(host[i])
        return out

    def admit_(rid, *args):
        slot = admit(rid, *args)
        if slot is not None:
            rows[rid] = [last.pop("row")]
        return slot
    with monkeypatch.context() as m:
        m.setattr(batching_mod, "prefill", prefill_)
        m.setattr(batching_mod, "decode_step", decode_)
        m.setattr(batcher, "admit", admit_)
        outs = batcher.run(requests)
    return outs, rows


@pytest.mark.gpu
def test_card_tokens_match_the_cpu(cuda, carried, monkeypatch):
    """The trace on the card (K5 in every admission, K6 in every tick)
    against the CPU batcher: while both have fed a request the same
    tokens, every step's logits agree within ``CARD_TOL`` and the tokens
    are equal wherever the CPU's top-2 margin exceeds 2 x ``CARD_TOL``
    (a near-tie where they differ ends the request's comparison)."""
    import copy
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    cfg, _, _, model = carried
    reqs = _trace(cfg.vocab_size)
    card = ContinuousBatcher(cfg, copy.deepcopy(model).to(cuda),
                             num_slots=SLOTS, max_len=MAX_LEN)
    f0, d0 = flash_attention.launches, decode_attention.launches
    got, rows_card = _logged_run(monkeypatch, card, reqs)
    assert flash_attention.launches - f0 == cfg.num_layers * len(reqs)
    assert decode_attention.launches > d0
    want, rows_cpu = _logged_run(monkeypatch, ContinuousBatcher(
        cfg, model, num_slots=SLOTS, max_len=MAX_LEN, device="cpu"), reqs)
    compared = total = 0
    for r in reqs:
        rid, budget = r["id"], r["max_new_tokens"]
        total += budget
        assert len(got[rid]) == len(want[rid]) == budget
        assert len(rows_card[rid]) == len(rows_cpu[rid]) == budget + 1
        for t, (lk, lc) in enumerate(zip(rows_card[rid], rows_cpu[rid])):
            if t and got[rid][t - 1] != want[rid][t - 1]:
                break                           # the inputs differ from here
            assert float((lk - lc).abs().max()) <= CARD_TOL, (rid, t)
            if t == budget:
                break
            top2 = torch.topk(lc, 2).values
            if float(top2[0] - top2[1]) > 2 * CARD_TOL:
                assert got[rid][t] == want[rid][t], (rid, t)
                compared += 1
    assert compared >= 0.9 * total, (compared, total)


# bf16 logits of this model on the card and the CPU: each side rounds every
# op to bf16 (unit roundoff 2**-8) after f32 sums of other orders, so they
# differ where such a sum rounds to the other neighbour, and that carries
# through the layers (the port against the JAX package on the CPU: at most
# 4.05e-3, tests/test_torch_bf16_model.py).  Relative Frobenius a row.
CARD_BF16_TOL = 1e-2


@pytest.mark.gpu
def test_card_bf16_tokens_match_the_cpu(cuda, carried, monkeypatch):
    """The trace through ``ContinuousBatcher(compute_dtype=bf16)`` on the
    card (K5's bf16 entry in every admission; in every tick K6's f32 entry
    on q widened, over the batcher's f32 caches) against the same on the
    CPU: while both have fed a request the same tokens, every step's
    logits agree within ``CARD_BF16_TOL`` and the tokens are equal wherever
    the CPU's top-2 margin exceeds 2 x ``CARD_BF16_TOL`` x the row's scale
    (half the tokens must be compared: bf16 logits tie often)."""
    import copy
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    cfg, _, _, model = carried
    reqs = _trace(cfg.vocab_size)
    bf16 = torch.bfloat16
    card = ContinuousBatcher(cfg, copy.deepcopy(model).to(cuda),
                             num_slots=SLOTS, max_len=MAX_LEN,
                             compute_dtype=bf16)
    f0 = dict(flash_attention.launches_by_dtype)
    d0 = dict(decode_attention.launches_by_dtype)
    got, rows_card = _logged_run(monkeypatch, card, reqs)
    assert flash_attention.launches_by_dtype["bfloat16"] - f0["bfloat16"] \
        == cfg.num_layers * len(reqs)
    assert flash_attention.launches_by_dtype["float32"] == f0["float32"]
    assert decode_attention.launches_by_dtype["float32"] > d0["float32"]
    assert decode_attention.launches_by_dtype["bfloat16"] == d0["bfloat16"]
    want, rows_cpu = _logged_run(monkeypatch, ContinuousBatcher(
        cfg, model, num_slots=SLOTS, max_len=MAX_LEN, device="cpu",
        compute_dtype=bf16), reqs)
    compared = total = 0
    for r in reqs:
        rid, budget = r["id"], r["max_new_tokens"]
        total += budget
        assert len(got[rid]) == len(want[rid]) == budget
        for t, (lk, lc) in enumerate(zip(rows_card[rid], rows_cpu[rid])):
            if t and got[rid][t - 1] != want[rid][t - 1]:
                break                           # the inputs differ from here
            assert lk.dtype == lc.dtype == bf16
            lk, lc = lk.float(), lc.float()
            err = float(torch.linalg.norm(lk - lc) / torch.linalg.norm(lc))
            assert err <= CARD_BF16_TOL, (rid, t, err)
            if t == budget:
                break
            top2 = torch.topk(lc, 2).values
            if float(top2[0] - top2[1]) > 2 * CARD_BF16_TOL * float(
                    lc.abs().max()):
                assert got[rid][t] == want[rid][t], (rid, t)
                compared += 1
    assert compared >= 0.5 * total, (compared, total)
