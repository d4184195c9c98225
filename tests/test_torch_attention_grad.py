"""The gradient of the prefill attention (K5) in the port against the JAX
package: ``flash_attention_bwd_ref`` (the explicit formula, the plain
version of ``csrc/flash_attention_bwd.cu``) and the CPU route of the
``torch.autograd.Function`` behind ``flash_attention``, each against
``jax.vjp`` of ``repro.kernels.flash_attention.ref.flash_attention_ref``
(the Pallas kernel has no autodiff rule, and the JAX model differentiates
plain ``jnp``).  Cases: causal, windowed, GQA, non-causal, ragged lengths,
and rows whose every key is masked (Sq > Skv under a window: the forward
gives them the mean of V, so their P is uniform and their dS zero).

Inputs are drawn with numpy from a seed, q, k, v ~ N(0, 1) and the
output's cotangent ~ N(0, 1), f32 on both sides.  Tolerance ``TOL`` =
2e-5 relative to 1 + |ref|: both sides sum the same f32 products in other
orders (XLA's and ATen's einsums; the port's explicit dS against JAX's
softmax VJP, which forms the same Di = rowsum(dO o O) differently),
measured within ~2e-6 here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_ref as jax_ref)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_lse_ref, flash_attention_ref)

TOL = 2e-5

# (B, Sq, Skv, H, KH, D, causal, window)
CASES = {
    "causal": (2, 48, 48, 4, 4, 64, True, 0),
    "windowed": (1, 70, 70, 4, 2, 64, True, 16),
    "gqa": (1, 40, 40, 8, 2, 128, True, 0),
    "non_causal": (2, 33, 33, 3, 3, 80, False, 0),
    "ragged": (1, 77, 77, 8, 2, 64, True, 0),
    "masked_rows": (1, 60, 20, 4, 2, 64, True, 8),
    "masked_rows_non_causal": (1, 50, 20, 2, 1, 64, False, 6),
}


def _inputs(case, seed=0):
    b, sq, skv, h, kh, d, causal, window = CASES[case]
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, kh, skv, d)).astype(np.float32)
    v = rng.standard_normal((b, kh, skv, d)).astype(np.float32)
    g = rng.standard_normal((b, h, sq, d)).astype(np.float32)
    return (q, k, v, g), dict(causal=causal, window=window)


def _jax_grads(q, k, v, g, kw):
    out, vjp = jax.vjp(lambda q, k, v: jax_ref(q, k, v, **kw),
                       jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return np.asarray(out), [np.asarray(t) for t in vjp(jnp.asarray(g))]


def _close(got, want):
    err = np.abs(np.asarray(got) - want) / (1 + np.abs(want))
    assert float(err.max()) <= TOL, float(err.max())


def _dead_rows(case):
    b, sq, skv, h, kh, d, causal, window = CASES[case]
    return max(0, sq - (skv + window - 1)) if window else 0


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_ref_matches_jax_vjp(case):
    (q, k, v, g), kw = _inputs(case)
    out_j, (dq_j, dk_j, dv_j) = _jax_grads(q, k, v, g, kw)
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    out = flash_attention_ref(tq, tk, tv, **kw)
    lse = flash_attention_lse_ref(tq, tk, **kw)
    _close(out, out_j)
    dq, dk, dv = flash_attention_bwd_ref(tq, tk, tv, out, lse,
                                         torch.from_numpy(g), **kw)
    for got, want in ((dq, dq_j), (dk, dk_j), (dv, dv_j)):
        assert got.shape == want.shape and got.dtype == torch.float32
        _close(got, want)
    dead = _dead_rows(case)
    assert (dead > 0) == ("masked_rows" in case)
    if dead:                       # uniform P, no gradient into the scores
        assert float(dq[:, :, -dead:].abs().max()) == 0.0
        assert float(np.abs(dv_j).max()) > 0


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_function_on_the_cpu_matches_jax_vjp(case):
    """``flash_attention`` in the model's layout under grad mode: the
    ``autograd.Function``'s CPU route (the plain forward, its lse, and
    ``flash_attention_bwd_ref``), launching no kernel."""
    (q, k, v, g), kw = _inputs(case, seed=1)
    out_j, grads_j = _jax_grads(q, k, v, g, kw)
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2).contiguous()
                  .requires_grad_() for a in (q, k, v))
    before = flash_attention_bwd.launches
    out = flash_attention(tq, tk, tv, **kw)
    assert out.grad_fn is not None
    _close(out.detach().transpose(1, 2), out_j)
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.from_numpy(g).transpose(1, 2))
    for got, want in zip(grads, grads_j):
        _close(got.transpose(1, 2), want)
    assert flash_attention_bwd.launches == before


def test_without_grad_the_op_is_unchanged():
    """Under ``no_grad``, or with no input requiring grad, the op takes
    today's route (no ``autograd.Function``) and gives the plain
    version's bits."""
    (q, k, v, _), kw = _inputs("windowed")
    tq, tk, tv = (torch.from_numpy(a).transpose(1, 2) for a in (q, k, v))
    want = flash_attention_ref(*(t.transpose(1, 2) for t in (tq, tk, tv)),
                               **kw).transpose(1, 2)
    plain = flash_attention(tq, tk, tv, **kw)
    assert plain.grad_fn is None and torch.equal(plain, want)
    with torch.no_grad():
        out = flash_attention(tq.requires_grad_(), tk, tv, **kw)
    assert out.grad_fn is None and torch.equal(out, want)


def test_bf16_gradient_raises():
    q = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16, requires_grad=True)
    k = torch.zeros((1, 8, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="compute_dtype"):
        flash_attention(q, k, k)
    with pytest.raises(NotImplementedError, match="f32 only"):
        flash_attention_bwd(q.detach(), k, k, q.detach(),
                            torch.zeros((1, 2, 8)), q.detach())
    with torch.no_grad():                     # serving takes bf16 as before
        assert flash_attention(q, k, k).dtype == torch.bfloat16


def test_cpu_bwd_wrapper_is_the_plain_version_in_model_layout():
    (q, k, v, g), kw = _inputs("gqa", seed=2)
    tq, tk, tv, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    out = flash_attention_ref(tq, tk, tv, **kw)
    lse = flash_attention_lse_ref(tq, tk, **kw)
    want = flash_attention_bwd_ref(tq, tk, tv, out, lse, tg, **kw)
    got = flash_attention_bwd(*(t.transpose(1, 2) for t in (tq, tk, tv,
                                                              out)),
                              lse, tg.transpose(1, 2), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a.transpose(1, 2), b)
