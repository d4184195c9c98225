"""The Mamba2 block (``repro_torch.models.mamba2``), the shared attention
block and zamba2-2.7b against the JAX package: ``ssd_chunked`` /
``ssd_reference`` at ``tests/test_mixers.py``'s cases and under the
strongest decay the init allows, a chunked prefill continued by recurrent
steps, ``_causal_conv`` and ``mamba2_mixer`` from a non-zero cache, the
config copy, the parameter tree (one set for the shared block),
``params_from_jax``, cache bytes, prefill and decode logits and states,
``encode``, the batcher, the generator and ``serve``.

Sizes: the SSD functions at (B 2, nh 3, hd 8, N 16) as
``tests/test_mixers.py`` has them; the model at ``.reduced(num_layers=12)``
(two applications of the pattern: 10 ``"mamba2"`` layers and the shared
block at layers 5 and 11; d_model 256, 4 heads of 64, d_ff 512, 16 SSM
heads of 32, state 16, vocab 512).

Tolerances, both sides fp32 on the CPU:
- ``TOL`` = 2e-5 on block outputs, states and logits, as
  ``tests/test_torch_archs.py`` states it (XLA and ATen order their sums,
  and evaluate exp / log1p / rsqrt, a few ulps apart; the logits drift by
  ~2e-6 here).  The port's recurrence against the JAX package's is held
  to it absolute and relative: SSD outputs and states are sums over the
  sequence and grow with it.
- ``SSD_TOL`` = 1e-4 (absolute and relative) between the chunked and the
  recurrent forms of one package, ``tests/test_mixers.py``'s: the two sum
  the same terms in other orders, the chunked form's decays differences of
  cumulative sums.  The port's chunked form against the JAX package's is
  held to it too: at a 128-token chunk the chunked form of either package
  lies ~2e-5 (relative to 1 + |y|) off the recurrence (cumulative log
  decays of ~50, whose fp32 ulp is 4e-6), and the two chunked forms
  differ by as much (2.3e-5 measured), their contractions summed in other
  orders.  At the model's chunk of 64 they agree within ``TOL``.
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
from repro.models import mamba2 as jax_mamba2  # noqa: E402
from repro.serving.batching import (  # noqa: E402
    ContinuousBatcher as JaxBatcher)
from repro.serving.engine import GeneratorModel as JaxGenerator  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import (KVCache, cache_bytes,  # noqa: E402
                                decode_step, encode, init_cache,
                                init_params, param_count, prefill)
from repro_torch.models.mamba2 import (MambaCache, _causal_conv,  # noqa
                                       init_mamba_cache, mamba2_mixer,
                                       ssd_chunked, ssd_reference)
from repro_torch.models import mamba2 as mamba2_mod  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.model import AttnBlock, MambaBlock  # noqa: E402
from repro_torch.serving import ContinuousBatcher, GeneratorModel  # noqa

TOL, SSD_TOL = 2e-5, 1e-4
NAME = "zamba2-2.7b"
# the JAX init_params tree's leaves (the reference's param_count() misses
# conv_x, conv_b, conv_c and dt_bias: 21,072 a Mamba2 layer at full width,
# 2,192 reduced; ROADMAP's caveats of the reference)
TREE_PARAMS = {"full": 1_981_519_920, "reduced": 4_872_160}
CFG_PARAMS = {"full": 1_980_571_680, "reduced": 4_850_240}
SHARED_PARAMS = 104_862_720             # the shared block at full width
STATE_BYTES = {144: 88_358_400, 2048: 439_303_680}   # a request, full width
CPU = torch.device("cpu")


def _reduced(get):
    return get(NAME).reduced(num_layers=12)


# jitted once for the module: a test's shapes compile once across tests
_JPRE = jax.jit(jax_prefill, static_argnums=(1,))
_JDEC = jax.jit(jax_decode, static_argnums=(1,))
_JENC = jax.jit(jax_encode, static_argnums=(1,))
_JMIX = jax.jit(jax_mamba2.mamba2_mixer, static_argnums=(2,))


def _carried(cfg, jcfg, seed):
    params = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    model = params_from_jax(jax.tree.map(np.asarray, params), cfg,
                            device="cpu")
    return params, model


def _close(port, ref, rtol=0.0):
    np.testing.assert_allclose(port.numpy(), np.asarray(ref), rtol=rtol,
                               atol=TOL)


def _ssd_inputs(seed, b, s, nh, hd, n, log_a=None):
    """``tests/test_mixers.py``'s inputs: x, b, c N(0, 1); log_a -|N(0,
    0.5)| unless given; state0 N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    r = lambda shape, scale=1.0: (scale * rng.standard_normal(shape)).astype(
        np.float32)
    x = r((b, s, nh, hd))
    la = (-np.abs(r((b, s, nh), 0.5)) if log_a is None
          else np.full((b, s, nh), log_a, np.float32))
    return x, la, r((b, s, n)), r((b, s, n)), r((b, nh, hd, n), 0.1)


def _both(fn, jfn, args, **kw):
    """``fn`` on tensors and ``jfn`` on jax arrays of the numpy ``args``."""
    py, ps = fn(*(torch.from_numpy(a) for a in args), **kw)
    jy, js = jfn(*(jnp.asarray(a) for a in args), **kw)
    return py, ps, np.asarray(jy), np.asarray(js)


# ---------------------------------------------------------------------------
# the SSD functions
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s,chunk", [(64, 16), (100, 32), (17, 64),
                                     (128, 128)])
def test_ssd_chunked_and_reference_match_jax(s, chunk):
    args = _ssd_inputs(s + chunk, 2, s, 3, 8, 16)
    py, ps, jy, js = _both(ssd_chunked, jax_mamba2.ssd_chunked, args,
                           chunk=chunk)
    tol = TOL if chunk <= 64 else SSD_TOL
    for got, want in ((py, jy), (ps, js)):
        np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)
    ry, rs, jry, jrs = _both(ssd_reference, jax_mamba2.ssd_reference, args)
    _close(ry, jry, TOL)
    _close(rs, jrs, TOL)
    np.testing.assert_allclose(py.numpy(), ry.numpy(), atol=SSD_TOL,
                               rtol=SSD_TOL)
    np.testing.assert_allclose(ps.numpy(), rs.numpy(), atol=SSD_TOL,
                               rtol=SSD_TOL)


def test_ssd_state_handoff_decode_matches_jax():
    """``tests/test_mixers.py::test_ssd_state_handoff_decode``'s case: a
    32-token chunked prefill (chunk 16) carried on by 8 one-token
    recurrent steps equals the 40-token recurrence of the port and of the
    JAX package, from a zero state."""
    x, la, b, c, _ = _ssd_inputs(3, 1, 40, 2, 4, 8)
    s0 = np.zeros((1, 2, 4, 8), np.float32)
    t = [torch.from_numpy(a) for a in (x, la, b, c)]
    y_pre, state = ssd_chunked(*(a[:, :32] for a in t), torch.from_numpy(s0),
                               chunk=16)
    outs = [y_pre]
    for i in range(32, 40):
        y_t, state = ssd_reference(*(a[:, i:i + 1] for a in t), state)
        outs.append(y_t)
    ry, rs = ssd_reference(*t, torch.from_numpy(s0))
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), ry.numpy(),
                               atol=SSD_TOL, rtol=SSD_TOL)
    np.testing.assert_allclose(state.numpy(), rs.numpy(), atol=SSD_TOL,
                               rtol=SSD_TOL)
    jy, js = jax_mamba2.ssd_reference(*(jnp.asarray(a) for a in (x, la, b,
                                                                   c, s0)))
    _close(ry, jy, TOL)
    _close(rs, js, TOL)


def test_ssd_strongest_decay_stays_finite():
    """The strongest decay the init allows: ``A`` = -16 (``A_log``'s last,
    log 16) with ``dt`` = exp(3.5 - 4.6), the largest the ``dt_bias`` init
    gives at a zero input: log_a = -5.33 a token, so ``exp(cs)``
    underflows to 0 within a chunk (cs < -104 past 20 tokens).  Both forms
    stay finite and equal each other and the JAX package's."""
    args = _ssd_inputs(5, 2, 100, 3, 8, 16, log_a=-16.0 * np.exp(-1.1))
    py, ps, jy, js = _both(ssd_chunked, jax_mamba2.ssd_chunked, args,
                           chunk=64)
    ry, rs, _, _ = _both(ssd_reference, jax_mamba2.ssd_reference, args)
    for t in (py, ps, ry, rs):
        assert torch.isfinite(t).all()
    _close(py, jy, TOL)
    _close(ps, js, TOL)
    np.testing.assert_allclose(py.numpy(), ry.numpy(), atol=SSD_TOL,
                               rtol=SSD_TOL)
    np.testing.assert_allclose(ps.numpy(), rs.numpy(), atol=SSD_TOL,
                               rtol=SSD_TOL)


# ---------------------------------------------------------------------------
# the conv and the mixer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("s", [1, 2, 50, 100, 128])
def test_causal_conv_from_a_non_zero_carry(s):
    """Out and new carry against the JAX ``_causal_conv`` from a random
    carry: at S < W - 1 (1, 2) the new carry mixes old carry rows with the
    inputs; the sum is the reference's, term by term, so bitwise."""
    rng = np.random.default_rng(s)
    x, w, carry = (rng.standard_normal(shape).astype(np.float32) for shape
                   in ((2, s, 24), (4, 24), (2, 3, 24)))
    out, new = _causal_conv(*(torch.from_numpy(a) for a in (x, w, carry)))
    jout, jnew = jax_mamba2._causal_conv(*(jnp.asarray(a) for a in (x, w,
                                                                      carry)))
    _close(out, jout)
    np.testing.assert_array_equal(new.numpy(), np.asarray(jnew))
    want = np.concatenate([carry, x], axis=1)[:, -3:]
    np.testing.assert_array_equal(new.numpy(), want)


@pytest.mark.parametrize("s", [1, 2, 50, 100, 128])
def test_mixer_matches_jax_from_a_non_zero_cache(s):
    """``mamba2_mixer`` holding the JAX ``init_mamba2`` params (the gate
    norm, ``D`` and ``dt_bias`` moved off their constants) against the JAX
    mixer, from a random SSM state and conv carry: the output and the new
    cache within ``TOL``, written in place into the given cache's
    tensors (S = 1: the recurrence; 2: under the conv's width; 50 / 100: a
    partial last chunk; 128: two chunks)."""
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    rng = np.random.default_rng(s)
    params = jax.tree.map(np.asarray, jax_mamba2.init_mamba2(
        jax.random.PRNGKey(s), jcfg))
    for name in ("gate_norm", "D", "dt_bias"):
        params[name] = (params[name] + 0.1 * rng.standard_normal(
            params[name].shape)).astype(np.float32)
    b = 2
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    ssm = (0.1 * rng.standard_normal((b, cfg.ssm_num_heads, cfg.ssm_head_dim,
                                      cfg.ssm_state_size))).astype(np.float32)
    conv = rng.standard_normal(
        (b, cfg.ssm_conv_width - 1, jax_mamba2.conv_dim(jcfg))).astype(
            np.float32)
    jp = {n: jnp.asarray(a) for n, a in params.items()}
    pp = {n: torch.from_numpy(np.array(a)) for n, a in params.items()}
    jy, jc = _JMIX(jp, jnp.asarray(x), jcfg, jax_mamba2.MambaCache(
        jnp.asarray(ssm), jnp.asarray(conv)))
    pc = MambaCache(torch.from_numpy(ssm.copy()), torch.from_numpy(
        conv.copy()))
    held = (pc.ssm, pc.conv)
    py, got = mamba2_mixer(pp, torch.from_numpy(x), cfg, pc)
    _close(py, jy, TOL)
    assert got is pc and pc.ssm is held[0] and pc.conv is held[1]
    _close(pc.ssm, jc.ssm, TOL)
    _close(pc.conv, jc.conv)
    assert not np.allclose(pc.ssm.numpy(), ssm)
    # no cache: a new one, from zeros, as the JAX mixer without one
    py0, new = mamba2_mixer(pp, torch.from_numpy(x), cfg)
    jy0, jc0 = _JMIX(jp, jnp.asarray(x), jcfg)
    _close(py0, jy0, TOL)
    _close(new.ssm, jc0.ssm, TOL)


def test_fresh_row_writes_through():
    """``MambaCache.fresh_row`` zeroes one slot's row and returns views of
    it: a mixer call on the row writes the batched cache's row and leaves
    the other slots' rows alone."""
    cfg = _reduced(get_config)
    cache = init_mamba_cache(cfg, 3, device=CPU)
    cache.ssm.normal_(generator=torch.Generator().manual_seed(0))
    cache.conv.normal_(generator=torch.Generator().manual_seed(1))
    before = (cache.ssm.clone(), cache.conv.clone())
    row = cache.fresh_row(1)
    assert row.ssm.data_ptr() == cache.ssm[1].data_ptr()
    assert not cache.ssm[1].any() and not cache.conv[1].any()
    block = MambaBlock(cfg, torch.Generator().manual_seed(2), CPU)
    x = torch.randn((1, 7, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        block(x, cfg, row)
    fresh = init_mamba_cache(cfg, 1, device=CPU)
    with torch.no_grad():
        block(x, cfg, fresh)
    assert torch.equal(cache.ssm[1:2], fresh.ssm)
    assert torch.equal(cache.conv[1:2], fresh.conv)
    for i in (0, 2):
        assert torch.equal(cache.ssm[i], before[0][i])
        assert torch.equal(cache.conv[i], before[1][i])
    assert row.nbytes * 3 == cache.nbytes


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
    assert full.block_pattern == ("mamba2",) * 5 + ("shared_attn",)
    assert (full.num_layers, full.ssm_num_heads, full.ssm_inner_dim) == (
        54, 80, 5120)


def test_param_count_is_the_jax_trees(monkeypatch):
    """The port's model holds the JAX ``init_params`` tree's parameters,
    the shared block once (not the reference's ``param_count()``, which
    misses the convs and ``dt_bias``): at the reduced size by building
    both, at full width by the tree's shapes (``jax.eval_shape``, nothing
    allocated) and the port's counts of one full-width Mamba2 block and
    one shared block, their matrices left undrawn (``dense_init``
    stubbed by ``torch.empty``: the shapes are the function's, the
    values unused)."""
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    model = init_params(cfg, seed=1, device="cpu")
    tree = jax_init_params(jcfg, jax.random.PRNGKey(1))
    n_tree = sum(a.size for a in jax.tree.leaves(tree))
    assert param_count(model) == n_tree == TREE_PARAMS["reduced"]
    mamba = model.blocks[0]
    assert sorted(n for n, _ in mamba.named_parameters()) == sorted(
        ["norm1"] + [f"mixer.{n}" for n in tree["blocks"][0]["mixer"]])
    for n, p in mamba.named_parameters():
        want = (tree["blocks"][0]["norm1"] if n == "norm1" else
                tree["blocks"][0]["mixer"][n.split(".")[1]])
        assert tuple(p.shape) == want.shape[1:], n
    assert tree["blocks"][5] is None and "shared" in tree
    jfull = jax_get_config(NAME)
    shapes = jax.eval_shape(lambda k: jax_init_params(jfull, k),
                            jax.random.PRNGKey(0))
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes)) \
        == TREE_PARAMS["full"]
    assert sum(int(np.prod(a.shape)) for a in jax.tree.leaves(
        shapes["shared"])) == SHARED_PARAMS
    undrawn = lambda shape, *args, **kw: torch.empty(shape)
    monkeypatch.setattr(mamba2_mod, "dense_init", undrawn)
    monkeypatch.setattr(model_mod, "dense_init", undrawn)
    full, g = get_config(NAME), torch.Generator()
    per_mamba = sum(p.numel() for p in MambaBlock(full, g, CPU).parameters())
    shared = sum(p.numel() for p in AttnBlock(full, g, CPU, "shared_attn")
                 .parameters())
    n_mamba = full.num_layers // 6 * 5
    assert shared == SHARED_PARAMS
    assert (full.vocab_size * full.d_model + full.d_model
            + n_mamba * per_mamba + shared) == TREE_PARAMS["full"]
    assert TREE_PARAMS["full"] - CFG_PARAMS["full"] == n_mamba * 21_072


def test_shared_block_is_one_parameter_set():
    """One :class:`AttnBlock` stands at layers 5 and 11: ``parameters()``
    and ``named_parameters()`` see it once (``state_dict()`` repeats its
    keys), a write through one layer is the other's, and the two
    applications get distinct KV caches."""
    cfg = _reduced(get_config)
    model = init_params(cfg, seed=2, device="cpu")
    a, b = model.blocks[5], model.blocks[11]
    assert a is b and isinstance(a, AttnBlock) and a.kind == "shared_attn"
    assert a.wq.data_ptr() == b.wq.data_ptr()
    assert all(isinstance(model.blocks[i], MambaBlock)
               for i in range(12) if i % 6 != 5)
    names = [n for n, _ in model.named_parameters()]
    assert len(names) == len(set(names))
    assert sum(n.startswith("blocks.5.") for n in names) == 9
    assert not any(n.startswith("blocks.11.") for n in names)
    assert sum(k.startswith("blocks.11.") for k in model.state_dict()) == 9
    caches = init_cache(cfg, 1, 20, device=CPU)
    assert isinstance(caches[5], KVCache) and isinstance(caches[11],
                                                         KVCache)
    assert caches[5].k.data_ptr() != caches[11].k.data_ptr()
    assert caches[5].k.shape[1] == 20 and not caches[5].circular
    assert model.attends


def test_params_from_jax_carries_every_leaf():
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, 5)
    for layer, block in enumerate(model.blocks):
        if layer % 6 == 5:
            for name, p in block.named_parameters():
                src = params["shared"]
                src = (src["mlp"][name] if name in ("gate", "up", "down")
                       else src[name])
                assert np.array_equal(p.numpy(), np.asarray(src)), name
            continue
        stacked = params["blocks"][layer % 6]
        for name, p in block.named_parameters():
            src = (stacked["norm1"] if name == "norm1"
                   else stacked["mixer"][name.split(".")[1]])
            assert np.array_equal(p.numpy(), np.asarray(src[layer // 6])), (
                layer, name)
    assert model.lm_head is None
    assert np.array_equal(model.embed.numpy(), np.asarray(params["embed"]))


def test_cache_bytes():
    """``init_cache`` gives each Mamba2 layer a ``MambaCache`` (O(1) in
    ``max_len``) and each shared application a full ``KVCache``: at full
    width 45 x (80 x 64 x 64 + 3 x 5,248) x 4 + 9 x 2 x rows x 32 x 80 x 4
    bytes a request (on the meta device: nothing allocated); the JAX
    cache's bytes at the reduced size."""
    full = get_config(NAME)
    meta = torch.device("meta")
    for rows, want in STATE_BYTES.items():
        assert cache_bytes(init_cache(full, 1, rows, device=meta)) == want
        per = 45 * (80 * 64 * 64 + 3 * 5248) * 4 + 9 * 2 * rows * 32 * 80 * 4
        assert per == want
    caches = init_cache(full, 2, 144, device=meta)
    assert cache_bytes(caches) == 2 * STATE_BYTES[144]
    assert [type(c).__name__ for c in caches[:6]] == ["MambaCache"] * 5 + [
        "KVCache"]
    assert tuple(caches[0].ssm.shape) == (2, 80, 64, 64)
    assert tuple(caches[0].conv.shape) == (2, 3, 5248)
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    jc = jax_init_cache(jcfg, 2, 40)
    jbytes = sum(a.size * a.dtype.itemsize for a in jax.tree.leaves(jc))
    assert cache_bytes(init_cache(cfg, 2, 40, device=CPU)) == jbytes


# ---------------------------------------------------------------------------
# the model against the JAX package
# ---------------------------------------------------------------------------
def _check_caches(pc, jc):
    for layer, c in enumerate(pc):
        want = jc[layer % 6]
        r = layer // 6
        if isinstance(c, MambaCache):
            _close(c.ssm, np.asarray(want.ssm)[r], TOL)
            _close(c.conv, np.asarray(want.conv)[r])
        else:
            _close(c.k, np.asarray(want.k)[r])
            _close(c.v, np.asarray(want.v)[r])


@pytest.mark.parametrize("lengths", ["int", "per_slot"])
@pytest.mark.parametrize("prompt", [1, 50, 128])
def test_prefill_and_decode_match_jax(prompt, lengths):
    """Prefill of 2 x ``prompt`` tokens (1: the recurrence; 50: a partial
    chunk; 128: two chunks) and 8 greedy decode steps, the JAX params
    carried over; logits within ``TOL`` at every step, and every layer's
    SSM state, conv carry and KV cache after prefill and at the end.
    ``per_slot`` passes (B,) lengths (slot 1 a step behind), which reach
    the two shared applications only."""
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, prompt)
    toks = np.random.default_rng(prompt).integers(
        0, cfg.vocab_size, (2, prompt)).astype(np.int32)
    jl, jc = _JPRE(params, jcfg, {"tokens": jnp.asarray(toks)},
                   jax_init_cache(jcfg, 2, prompt + 9))
    pc = init_cache(cfg, 2, prompt + 9, device=CPU)
    pl, pc = prefill(model, {"tokens": torch.from_numpy(toks).long()}, pc)
    _close(pl, jl)
    _check_caches(pc, jc)
    for step in range(8):
        n = prompt + step
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        if lengths == "per_slot":
            jn, pn = (jnp.asarray([n, n - 1], jnp.int32),
                      torch.tensor([n, n - 1]))
        else:
            jn, pn = n, n
        jl, jc = _JDEC(params, jcfg, jnp.asarray(nxt), jc, jn)
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc, pn)
        _close(pl, jl)
    _check_caches(pc, jc)


def test_mixed_mamba2_and_attention_pattern_matches_jax():
    """A ``("mamba2", "attn")`` pattern over 4 layers: the model dispatches
    by block type, positions reach the attention layers only; prefill of
    30 tokens and 4 decode steps within ``TOL``, the caches a list of
    ``MambaCache`` and ``KVCache`` in pattern order."""
    kw = dict(block_pattern=("mamba2", "attn"), num_layers=4)
    cfg = dataclasses.replace(_reduced(get_config), **kw)
    jcfg = dataclasses.replace(_reduced(jax_get_config), **kw)
    params, model = _carried(cfg, jcfg, 9)
    toks = np.random.default_rng(9).integers(
        0, cfg.vocab_size, (2, 30)).astype(np.int32)
    jl, jc = _JPRE(params, jcfg, {"tokens": jnp.asarray(toks)},
                   jax_init_cache(jcfg, 2, 40))
    pc = init_cache(cfg, 2, 40, device=CPU)
    assert [type(c).__name__ for c in pc] == ["MambaCache", "KVCache"] * 2
    pl, pc = prefill(model, {"tokens": torch.from_numpy(toks).long()}, pc)
    _close(pl, jl)
    for n in range(30, 34):
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)[:, None]
        jl, jc = _JDEC(params, jcfg, jnp.asarray(nxt), jc, n)
        pl, pc = decode_step(model, torch.from_numpy(nxt).long(), pc, n)
        _close(pl, jl)


def test_encode_matches_jax():
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, 6)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)).astype(np.int32)
    mask = np.ones((2, 40), np.int32)
    mask[1, 25:] = 0
    je = _JENC(params, jcfg, {"tokens": jnp.asarray(toks),
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


def test_batched_equals_sequential_zamba2_matches_the_jax_batcher():
    """The trace through 3 slots of 48 positions, so that slots are reused
    (requests 3 and 4 land in slots that held earlier requests' states and
    KV rows), against the JAX batcher; tokens compared as
    ``tests/test_torch_batching.py`` compares them (a request stops at its
    lone run's first near-tie, 2 x ``TOL``; >= 90% compared)."""
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, 3)
    reqs = _trace(cfg)
    port = ContinuousBatcher(cfg, model, num_slots=3, max_len=48,
                             device="cpu").run(reqs)
    ref = JaxBatcher(jcfg, params, num_slots=3, max_len=48).run(reqs)
    assert set(port) == set(ref) == set(range(5))
    compared = total = 0
    for r in reqs:
        caches = init_cache(cfg, 1, 48, device=CPU)
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
    """After ``admit`` into a slot whose state, carry and KV rows earlier
    requests and ticks advanced, the slot's row of every layer's cache is
    bitwise a fresh cache's after the same prefill (KV rows past the
    prompt zero), and the other slot's rows are untouched."""
    cfg = _reduced(get_config)
    model = init_params(cfg, seed=4, device="cpu")
    batcher = ContinuousBatcher(cfg, model, num_slots=2, max_len=32,
                                device="cpu")
    batcher.admit(0, list(range(3, 20)), 3)
    batcher.admit(1, list(range(5, 14)), 8)
    for _ in range(3):
        batcher.tick()                       # request 0 done: slot 0 free
    assert batcher.slots[0].free and not batcher.slots[1].free
    tensors = lambda c: ((c.ssm, c.conv) if isinstance(c, MambaCache)
                         else (c.k, c.v))
    other = [[t[1].clone() for t in tensors(c)] for c in batcher.caches]
    prompt = [7, 8, 9, 10, 11]
    assert batcher.admit(2, prompt, 4) == 0
    fresh = init_cache(cfg, 1, 32, device=CPU)
    prefill(model, {"tokens": torch.tensor([prompt])}, fresh)
    for c, f, kept in zip(batcher.caches, fresh, other):
        for got, want in zip(tensors(c), tensors(f)):
            assert torch.equal(got[:1], want)
        for got, want in zip(tensors(c), kept):
            assert torch.equal(got[1], want)


def test_generator_model_matches_jax_generator():
    cfg, jcfg = _reduced(get_config), _reduced(jax_get_config)
    params, model = _carried(cfg, jcfg, 8)
    prompt = "what does the index store " * 3
    ref = JaxGenerator(jcfg, params, max_prompt=24).generate(prompt, 4)
    gen = GeneratorModel(cfg, model, max_prompt=24, device="cpu")
    assert gen.generate(prompt, 4) == ref


def test_serve_runs_zamba2_on_the_cpu():
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
def test_card_ssd_forms_and_reduced_model_match_the_cpu(cuda):
    """``ssd_chunked`` against ``ssd_reference`` on the card at zamba2's
    full-width SSD shape (1, 128, 80, 64), N 64, under a model-like decay
    and the strongest the init allows (``A`` 16, ``dt`` exp(-1.1)): within
    ``SSD_TOL`` relative to 1 + |reference|, finite.  Then the reduced
    model on the card against the same weights on the CPU: prefill of 2 x
    50 tokens and 8 steps (4 with per-slot lengths), logits within 1e-4
    (``chip_smoke.py``'s ``GEN_TOL``), 2 K5 and 16 K6 launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda).manual_seed(0)
    n = lambda *shape: torch.randn(shape, generator=g, device=cuda)
    x, b, c, s0 = n(1, 128, 80, 64), n(1, 128, 64), n(1, 128, 64), \
        0.1 * n(1, 80, 64, 64)
    for log_a in (-0.5 * n(1, 128, 80).abs(),
                  torch.full((1, 128, 80), -16.0 * float(np.exp(-1.1)),
                             device=cuda)):
        yc, sc = ssd_chunked(x, log_a, b, c, s0)
        yr, sr = ssd_reference(x, log_a, b, c, s0)
        for got, ref in ((yc, yr), (sc, sr)):
            assert torch.isfinite(got).all()
            assert float(((got - ref).abs() / (1 + ref.abs())).max()) \
                <= SSD_TOL
    cfg = _reduced(get_config)
    m_cpu = init_params(cfg, seed=2, device="cpu")
    m_card = init_params(cfg, seed=2, device="cpu").to(cuda)
    assert m_card.blocks[5] is m_card.blocks[11]
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
    assert (flash_attention.launches - f0, decode_attention.launches - d0) \
        == (2, 16)
