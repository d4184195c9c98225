"""Training in bf16 (``compute_dtype=torch.bfloat16``) against the JAX
package's ``compute_dtype=jnp.bfloat16``: ``forward``'s logits, ``loss_fn``
and every parameter's gradient (attn with a loss mask, moe, rwkv6, mamba2
with shared attention), two steps of ``make_train_step``, and the plain
version of K5's gradient in bf16 (``flash_attention_bwd_ref``, the CUDA
kernel's reference) against ``jax.vjp`` of the reference's attention on
bf16 inputs.  Configs ``.reduced(num_layers=2, d_model=128)`` (zamba2-2.7b
at 6 layers, one pattern), the JAX params carried over by
``params_from_jax``; the reference compiled with XLA's excess precision
off (``tests/test_torch_bf16_model.py``'s ``strict``, and why).  The
parameters stay f32 and are cast per product, so every gradient is f32.

Tolerances:
- The forward logits within ``TOL`` = 6e-3 relative Frobenius
  (``tests/test_torch_bf16_model.py``'s), measured ~1.7e-3 here; the
  precision control at the same model and batch: the port's f32 logits
  fail it.
- ``LOSS_TOL`` = 5e-4 relative on the loss and ``ce`` (measured at most
  9.1e-5) and ``AUX_TOL`` = 1e-4 absolute on ``aux``: a mean over all
  positions moves little when ~10% of the bf16 logits sit one ulp apart.
- ``GRAD_TOL`` = 3e-2 relative Frobenius on each parameter's gradient
  (measured at most 2.2e-2, zamba2-2.7b's ``A_log``).  The backward of a
  bf16 op rounds where autograd's formula rounds, not where XLA's vjp does,
  so the two packages' bf16 gradients lie about as far apart as bf16 lies
  from f32 (the port's f32 gradients: 1.6e-2 to 1.3e-1 from the
  reference's bf16 ones).  ``GRAD_TOL`` is therefore no check of
  precision, and neither are ``NORM_TOL`` and ``UPDATE_TOL`` below.
- The backward's precision control is at one block
  (``test_one_block_gradient_tells_bf16_from_f32``: block 0 of the attn,
  moe and rwkv6 cases on a bf16 input and cotangent, against ``jax.vjp``
  of the reference's ``apply_block``).  Its input gradient cannot tell the
  precisions apart either (bf16 5.1e-3 to 8.8e-3 from the reference, f32
  1.06e-2 to 1.28e-2), nor can most weights'.  The weights of the
  products nearest the output can: the SwiGLU's ``up`` and ``down`` (the
  experts' in moe) and rwkv6's ``Wo``, ``Wck`` and ``Wcv``, whose
  gradients are products of forward activations with the cotangent
  through at most a few ops, rounded to bf16 at the product as the
  reference rounds them.  ``LAST_GRAD_TOL`` = 1e-3 relative Frobenius
  holds them (measured 2.4e-4 to 5.1e-4), and the port's f32 block on the
  widened input and cotangent fails it (9.2e-3 to 1.3e-2: bf16 rounds
  each activation by up to u = 2**-8).
- Two steps at peak_lr 0.3 (``tests/test_torch_train.py``'s): the metrics
  within ``LOSS_TOL`` and ``NORM_TOL`` = 3e-2 (the gradients'), each
  parameter's change within ``UPDATE_TOL`` = 0.15 relative Frobenius.
  AdamW's first step moves an element by ~lr x the sign of its gradient,
  so an element whose gradient the two roundings put on either side of 0
  moves 2 lr apart: measured 3e-3 to 1.7e-2 for the blocks' and the head's
  weights, 0.10 for the embedding, whose gradient is the few rows the batch
  uses, summed from bf16 cotangents, many of its elements near 0.
- K5's gradient, against two forms of the reference.  ``BWD_TOL`` = 2e-4
  relative Frobenius on dq, dk and dv against ``jax.vjp`` of the
  reference's attention on the widened f32 inputs, rounded once to bf16
  (the function the kernel computes: its header comment).  Both sides then
  differ only where a sum of another order rounds to the other neighbour:
  measured 0 to 2.5e-5.  Di comes from the f32 output, as the reference's
  does; FlashAttention-2's Di, from the bf16 output, is measured here too,
  ~1.7e-3 to 2.0e-3 off in dq and dk (``FA2_TOL`` = 2.5e-3 holds it, for
  the record), which is why the kernel does not take it.  The control: the
  port's f32 gradients of the unrounded f32 inputs lie 2.8e-3 or more away
  (the inputs' own bf16 rounding) and fail both.  Against ``jax.vjp`` on
  the bf16 inputs themselves: dq within ``BWD_TOL``, and dk, dv too without
  GQA; under GQA the reference repeats k and v over the query heads before
  its f32 cast, so its dk and dv are bf16 sums of per-head gradients each
  rounded to bf16, where the port sums in f32 and rounds once:
  ``BWD_GQA_TOL`` = 6e-3, two roundings (measured 3.4e-3 to 3.6e-3).
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_attention)
from repro.launch.train import (  # noqa: E402
    synthetic_lm_batch as jax_synthetic_lm_batch)
from repro.models import init_params as jax_init_params  # noqa: E402
from repro.models.model import _default_positions  # noqa: E402
from repro.models.model import apply_block as jax_apply_block  # noqa: E402
from repro.models.model import forward as jax_forward  # noqa: E402
from repro.models.model import loss_fn as jax_loss_fn  # noqa: E402
from repro.train.train_step import (  # noqa: E402
    make_train_step as jax_make_train_step,
    train_state_init as jax_train_state_init)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax, params_to_jax  # noqa
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)
from repro_torch.launch.train import synthetic_lm_batch  # noqa: E402
from repro_torch.models import forward, loss_fn  # noqa: E402
from repro_torch.models.model import AttnBlock  # noqa: E402
from repro_torch.train import make_train_step, train_state_init  # noqa

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_bf16_model import TOL, f32, fro, strict  # noqa: E402

LOSS_TOL, AUX_TOL, GRAD_TOL, LAST_GRAD_TOL = 5e-4, 1e-4, 3e-2, 1e-3
NORM_TOL, UPDATE_TOL = 3e-2, 0.15
BWD_TOL, FA2_TOL, BWD_GQA_TOL = 2e-4, 2.5e-3, 6e-3
BF16 = torch.bfloat16
B, S = 2, 32

# name: (config id, layers, loss mask)
CASES = {"attn": ("stablelm-1.6b", 2, True),
         "moe": ("olmoe-1b-7b", 2, False),
         "rwkv6": ("rwkv6-1.6b", 2, False),
         "mamba2_shared": ("zamba2-2.7b", 6, False)}


@pytest.fixture(autouse=True)
def one_thread():
    """Each test's torch ops on one thread, restored after (the models are
    tiny; a parallel run's workers would contend for the cores)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(name, layers):
    kw = dict(num_layers=layers, d_model=128)
    return (jax_get_config(name).reduced(**kw),
            get_config(name).reduced(**kw))


def _batch(cfg, seed, mask):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, size=(B, S + 1))
    b = {"tokens": toks[:, :-1].astype(np.int32),
         "labels": toks[:, 1:].astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


@pytest.mark.parametrize("case", list(CASES))
def test_loss_and_every_gradient_match_jax_bf16(case):
    name, layers, mask = CASES[case]
    jc, tc = _pair(name, layers)
    params = jax_init_params(jc, jax.random.PRNGKey(0))
    nb = _batch(jc, 0, mask)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    (jl, jparts), jg = strict(lambda p, b: jax.value_and_grad(
        jax_loss_fn, has_aux=True)(p, jc, b, compute_dtype=jnp.bfloat16))(
        params, jb)
    jlogits = f32(strict(lambda p, b: jax_forward(
        p, jc, b, compute_dtype=jnp.bfloat16)[0])(params, jb))
    model = params_from_jax(jax.tree.map(np.asarray, params), tc,
                            device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    with torch.no_grad():
        logits = forward(model, tb, compute_dtype=BF16)[0]
        assert logits.dtype == BF16 and fro(f32(logits), jlogits) <= TOL
        assert fro(f32(forward(model, tb)[0]), jlogits) > TOL   # control
    model.requires_grad_(True)
    loss, parts = loss_fn(model, tb, compute_dtype=BF16)
    assert loss.dtype == torch.float32
    assert abs(float(loss.detach()) - float(jl)) <= LOSS_TOL * float(jl)
    assert abs(float(parts["ce"].detach()) - float(jparts["ce"])) <= \
        LOSS_TOL * float(jparts["ce"])
    assert abs(float(parts["aux"].detach()) - float(jparts["aux"])) <= \
        AUX_TOL
    grads = torch.autograd.grad(loss, list(model.parameters()),
                                materialize_grads=True)
    want = dict(params_from_jax(jax.tree.map(np.asarray, jg), tc,
                                device="cpu").named_parameters())
    for (pname, p), g in zip(model.named_parameters(), grads):
        assert p.dtype == g.dtype == torch.float32, pname
        assert fro(g.numpy(), want[pname].detach().numpy()) <= GRAD_TOL, \
            pname


# each block kind's weights of the products nearest its output (docstring)
LAST_PRODUCTS = {"attn": ("up", "down"), "moe": ("moe.up", "moe.down"),
                 "rwkv6": ("Wo", "Wck", "Wcv")}


@pytest.mark.parametrize("case", list(LAST_PRODUCTS))
def test_one_block_gradient_tells_bf16_from_f32(case):
    name, layers, _ = CASES[case]
    jc, tc = _pair(name, layers)
    params = jax_init_params(jc, jax.random.PRNGKey(0))
    kind = jc.block_pattern[0]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, jc.vocab_size, (B, S))
    x = np.asarray(params["embed"])[toks]           # the embedded stream
    g = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    xb, gb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (x, g))
    pos = _default_positions(jc, B, S)
    block = lambda p, x: jax_apply_block(
        kind, p, x, jc, positions=pos, causal=True, mode="train",
        cache=None, cache_len=0, window_mode=False, attn_impl="auto")[0]
    jgp, jgx = strict(lambda p, x, g: jax.vjp(block, p, x)[1](g))(
        jax.tree.map(lambda a: a[0], params["blocks"][0]), xb, gb)
    # the reference's block-0 gradients under the port's parameter names
    tree = jax.tree.map(np.zeros_like, jax.tree.map(np.asarray, params))
    tree["blocks"] = (jax.tree.map(
        lambda z, a: np.concatenate([f32(a)[None], z[1:]]),
        tree["blocks"][0], jgp),) + tree["blocks"][1:]
    want = dict(params_from_jax(tree, tc, device="cpu")
                .blocks[0].named_parameters())
    model = params_from_jax(jax.tree.map(np.asarray, params), tc,
                            device="cpu")
    blk = model.blocks[0].requires_grad_(True)

    def grads(dtype):
        xt = torch.tensor(f32(xb)).to(dtype).requires_grad_(True)
        if isinstance(blk, AttnBlock):
            out = blk(xt, tc, positions=model.positions(B, S),
                      inv_freq=model.inv_freq, causal=True, mode="train",
                      cache=None, cache_len=0, lengths=1,
                      attn_impl="auto")[0]
        else:
            out = blk(xt, tc, None)
        names = [n for n, _ in blk.named_parameters()]
        got = torch.autograd.grad(
            out, [xt, *blk.parameters()], torch.tensor(f32(gb)).to(
                dtype), materialize_grads=True)
        return f32(got[0]), dict(zip(names, (f32(t) for t in got[1:])))

    (bx, bf16), (_, full) = grads(BF16), grads(torch.float32)
    assert fro(bx, f32(jgx)) <= GRAD_TOL
    for pname, w in want.items():
        w = w.detach().numpy()
        assert fro(bf16[pname], w) <= GRAD_TOL, pname
        if pname in LAST_PRODUCTS[case]:
            assert fro(bf16[pname], w) <= LAST_GRAD_TOL, pname
            assert fro(full[pname], w) > LAST_GRAD_TOL, pname  # control


def test_two_train_steps_match_jax_bf16():
    jc, tc = _pair("stablelm-1.6b", 2)
    params = jax_init_params(jc, jax.random.PRNGKey(0))
    start = [np.asarray(a) for a in jax.tree.leaves(params)]
    jstep = strict(jax_make_train_step(jc, peak_lr=0.3, total_steps=60,
                                       compute_dtype=jnp.bfloat16))
    jstate = jax_train_state_init(params)
    tstate = train_state_init(params_from_jax(
        jax.tree.map(np.asarray, params), tc, device="cpu"))
    tstep = make_train_step(tc, peak_lr=0.3, total_steps=60,
                            compute_dtype=BF16)
    jrng, trng = np.random.default_rng(3), np.random.default_rng(3)
    for step in range(2):
        jstate, jm = jstep(jstate, jax_synthetic_lm_batch(jrng, jc, 2, 25))
        tstate, tm = tstep(tstate, synthetic_lm_batch(trng, tc, 2, 25,
                                                      device="cpu"))
        jm = {k: float(v) for k, v in jm.items()}
        assert tm["lr"] == jm["lr"]
        for k in ("loss", "ce"):
            assert abs(tm[k] - jm[k]) <= LOSS_TOL * abs(jm[k]), (step, k)
        assert abs(tm["grad_norm"] - jm["grad_norm"]) <= \
            NORM_TOL * jm["grad_norm"], step
    assert {p.dtype for p in tstate.model.parameters()} == {torch.float32}
    got = [np.asarray(a) for a in jax.tree.leaves(params_to_jax(
        tstate.model))]
    want = [np.asarray(a) for a in jax.tree.leaves(jstate.params)]
    for g, w, s in zip(got, want, start):
        moved = np.linalg.norm(w - s)
        assert moved > 0
        assert np.linalg.norm((g - s) - (w - s)) <= UPDATE_TOL * moved


# ---------------------------------------------------------------------------
# K5's gradient in bf16: the plain version against jax.vjp
# ---------------------------------------------------------------------------
# (B, Sq, Skv, H, KH, D, causal, window)
BWD_CASES = {"gqa": (1, 40, 40, 8, 2, 128, True, 0),
             "windowed": (1, 70, 70, 4, 4, 64, True, 16),
             "ragged": (1, 77, 77, 8, 2, 64, True, 0)}


@pytest.mark.parametrize("case", list(BWD_CASES))
def test_bwd_ref_bf16_matches_jax_grad(case):
    b, sq, skv, h, kh, d, causal, window = BWD_CASES[case]
    kw = dict(causal=causal, window=window)
    rng = np.random.default_rng(5)
    draw = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    q, k, v, g = (draw(b, h, sq, d), draw(b, kh, skv, d),
                  draw(b, kh, skv, d), draw(b, h, sq, d))
    bf = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    attention = lambda q, k, v: jax_attention(q, k, v, **kw)
    _, vjp = jax.vjp(attention, bf(q), bf(k), bf(v))
    on_bf16 = [f32(t) for t in vjp(bf(g))]
    widened = [jnp.asarray(f32(bf(a))) for a in (q, k, v, g)]
    _, vjp = jax.vjp(attention, *widened[:3])
    once = [f32(bf(t)) for t in vjp(widened[3])]
    tq, tk, tv, tg = (torch.from_numpy(a).to(BF16) for a in (q, k, v, g))
    # the f32 output (before its rounding), as the kernel's path passes it
    out = flash_attention_ref(*(t.float() for t in (tq, tk, tv)), **kw)
    lse = flash_attention_lse_ref(tq, tk, **kw)
    assert torch.equal(out.to(BF16), flash_attention_ref(tq, tk, tv, **kw))
    got = flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, **kw)
    # FlashAttention-2's Di, from the bf16 output: further off (docstring)
    fa2 = flash_attention_bwd_ref(tq, tk, tv, out.to(BF16), lse, tg, **kw)
    # the control: the f32 gradients of the unrounded inputs
    fq, fk, fv, fg = (torch.from_numpy(a) for a in (q, k, v, g))
    ctl = flash_attention_bwd_ref(
        fq, fk, fv, flash_attention_ref(fq, fk, fv, **kw),
        flash_attention_lse_ref(fq, fk, **kw), fg, **kw)
    for name, a, a2, c, w, w16 in zip("qkv", got, fa2, ctl, once,
                                       on_bf16):
        assert a.dtype == BF16 and a.shape == w.shape
        assert fro(f32(a), w) <= BWD_TOL, name
        assert fro(f32(a2), w) <= FA2_TOL, name
        assert fro(c.numpy(), w) > max(BWD_TOL, FA2_TOL), name
        tol = BWD_TOL if name == "q" or h == kh else BWD_GQA_TOL
        assert fro(f32(a), w16) <= tol, name
