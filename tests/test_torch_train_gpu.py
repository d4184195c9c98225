"""The training path on the card (``gpu``-marked; each skips without a
CUDA device): the hand-written backward of the prefill attention
(``csrc/flash_attention_bwd.cu``) against its plain version
``flash_attention_bwd_ref`` on the card, and reduced stablelm-1.6b's
``train_step`` on the card against the CPU.  No JAX here: the CPU
references are the port's own plain versions (``tests/test_torch_loss.py``
and ``tests/test_torch_attention_grad.py`` hold those to the JAX package).

    PYTHONPATH=src python3 -m pytest -q -m gpu tests/test_torch_train_gpu.py

Tolerances (f32 on both sides, TF32 off):
- ``GRAD_TOL`` = 1e-4 in relative Frobenius norm on dq, dk and dv: the
  kernel sums the same f32 products as the plain version in other orders
  (on the tensor cores in 3xTF32, tiles of 8 to 64 rows), measured at
  ~1e-6; and the
  rows' log-sum-exp within ``LSE_TOL`` = 1e-5 x max(1, D / 64) of the
  plain one (scores of |s| < ~5 summed over D products, a few ulps of f32
  apart; measured 8.1e-6 at D = 256).
- ``BWD_BF16_TOL`` = 1e-3 relative Frobenius on the bf16 entries' dq, dk
  and dv (the comment above it says why); they must also be bitwise the
  f32 entry's on the widened inputs, rounded.
- ``STEP_TOL`` = 1e-5 relative on the loss and 1e-4 on the gradient
  norm (the card's fp32 GEMMs and attention kernels against the CPU's
  plain PyTorch, as ``chip_smoke.py``'s ``GEN_TOL`` reasons), and
  ``UPDATE_TOL`` = 1e-3 in relative Frobenius norm on each parameter's
  change over three steps, as ``tests/test_torch_train.py`` holds the
  port to the JAX package: AdamW's first steps divide each gradient by
  its own magnitude, so an element whose gradient is near 0 may move by
  up to ~lr differently on the two devices; the change as a whole may
  not.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref,
    flash_attention_lse_ref)
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.train import make_train_step, train_state_init  # noqa

GRAD_TOL, LSE_TOL, STEP_TOL, UPDATE_TOL = 1e-4, 1e-5, 1e-5, 1e-3

# (B, Sq, Skv, H, KH, D, causal, window)
BWD_CASES = [(1, 300, 300, 8, 8, 64, True, 0),
             (1, 200, 200, 8, 2, 128, True, 0),
             (1, 160, 160, 4, 2, 256, True, 64),
             (2, 100, 100, 4, 4, 80, False, 0),
             (1, 77, 77, 8, 2, 64, True, 0),
             (1, 96, 40, 4, 2, 64, True, 16),
             # the edges of the kernel's tiles: the dK / dV pass takes
             # keys x q rows of 64 x 32 at D = 64 and 80, 32 x 16 at 128
             # and 32 x 8 at 256; the dQ pass q rows x keys of 64 x 32 at
             # D <= 128 and 32 x 16 at 256
             (1, 65, 65, 4, 2, 64, True, 0),
             (1, 129, 129, 4, 4, 80, True, 0),
             (1, 129, 129, 4, 2, 128, True, 0),
             (2, 100, 37, 4, 2, 64, False, 0),    # non-causal, Sq > Skv
             (1, 33, 150, 4, 4, 128, False, 0),   # non-causal, Sq < Skv
             (1, 129, 129, 8, 1, 80, True, 0),    # GQA 8 over one kv head
             (1, 129, 65, 4, 2, 256, False, 0),
             (1, 150, 40, 4, 2, 256, True, 16)]   # rows with no valid key


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float(torch.linalg.norm(got - want)) / max(
        float(torch.linalg.norm(want)), 1e-30)


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES)
def test_card_bwd_matches_the_plain_version(cuda, case):
    b, sq, skv, h, kh, d, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn((b, sq, h, d), device=cuda, generator=g)
    k, v = (torch.randn((b, skv, kh, d), device=cuda, generator=g)
            for _ in range(2))
    dout = torch.randn((b, sq, h, d), device=cuda, generator=g)
    out0, _ = fa_ops._launch(q, k, v, causal, window)
    out, lse = fa_ops._launch(q, k, v, causal, window, with_lse=True)
    assert torch.equal(out, out0)          # the lse leaves the output's bits
    heads = lambda *ts: [t.transpose(1, 2) for t in ts]
    want_lse = flash_attention_lse_ref(*heads(q, k), causal=causal,
                                       window=window)
    live = want_lse > -1e29                # rows with a valid key
    assert float((lse - want_lse)[live].abs().max()) <= \
        LSE_TOL * max(1, d / 64)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                              window=window)
    assert flash_attention_bwd.launches == before + 1
    want = heads(*flash_attention_bwd_ref(*heads(q, k, v, out), lse,
                                          *heads(dout), causal=causal,
                                          window=window))
    for a, w in zip(got, want):
        assert a.shape == w.shape and _rel(a, w) <= GRAD_TOL
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                window=window)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(3, 129, 129, 4, 2, 64, True, 0),
                                  (2, 100, 70, 4, 4, 80, False, 0),
                                  (2, 90, 40, 4, 2, 256, True, 16)])
def test_card_bwd_batch_equals_its_elements(cuda, case):
    """A batch's dq, dk and dv are bitwise those of each element run
    alone: every sum runs in an order fixed by the element's own rows."""
    b, sq, skv, h, kh, d, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(sq)
    q = torch.randn((b, sq, h, d), device=cuda, generator=g)
    k, v = (torch.randn((b, skv, kh, d), device=cuda, generator=g)
            for _ in range(2))
    dout = torch.randn((b, sq, h, d), device=cuda, generator=g)
    out, lse = fa_ops._launch(q, k, v, causal, window, with_lse=True)
    inputs = (q, k, v, out, lse, dout)
    whole = flash_attention_bwd(*inputs, causal=causal, window=window)
    for e in range(b):
        one = flash_attention_bwd(*(t[e:e + 1] for t in inputs),
                                  causal=causal, window=window)
        assert all(torch.equal(w[e:e + 1], o) for w, o in zip(whole, one))


# bf16 (K5's and K5′'s bf16 entries): the kernel's f32 sums differ from the
# plain version's by ~1e-6, so the two gradients, each rounded once to bf16,
# differ by one bf16 ulp (2**-7 relative) only where such a sum falls on
# the other side of a rounding boundary: a fraction ~1e-6 / 2**-8 of the
# elements.  1e-3 relative Frobenius bounds that with room; a kernel whose
# every element missed by a rounding would lie ~2e-3 off.
BWD_BF16_TOL = 1e-3


def _bf16_inputs(cuda, case):
    b, sq, skv, h, kh, d, causal, window = case
    g = torch.Generator(device=cuda).manual_seed(sq + 1)
    q = torch.randn((b, sq, h, d), device=cuda, generator=g)
    k, v = (torch.randn((b, skv, kh, d), device=cuda, generator=g)
            for _ in range(2))
    dout = torch.randn((b, sq, h, d), device=cuda, generator=g)
    return tuple(t.to(torch.bfloat16) for t in (q, k, v, dout))


@pytest.mark.gpu
@pytest.mark.parametrize("case", BWD_CASES)
def test_card_bwd_bf16_matches_the_plain_version(cuda, case):
    """K5 asked for its lse on bf16 operands writes the f32 output, which
    its serving entry rounds (bitwise); the lse as for f32; K5′'s bf16
    entry within ``BWD_BF16_TOL`` of the plain version, bitwise the f32
    entry on the widened inputs rounded to bf16 (the skipped products of
    bf16 operands add exact zeros), and bitwise from call to call."""
    b, sq, skv, h, kh, d, causal, window = case
    q, k, v, dout = _bf16_inputs(cuda, case)
    out0, _ = fa_ops._launch(q, k, v, causal, window)
    out, lse = fa_ops._launch(q, k, v, causal, window, with_lse=True)
    assert out0.dtype == torch.bfloat16 and out.dtype == torch.float32
    assert torch.equal(out.to(torch.bfloat16), out0)
    heads = lambda *ts: [t.transpose(1, 2) for t in ts]
    want_lse = flash_attention_lse_ref(*heads(q, k), causal=causal,
                                       window=window)
    live = want_lse > -1e29
    assert float((lse - want_lse)[live].abs().max()) <= \
        LSE_TOL * max(1, d / 64)
    before = dict(flash_attention_bwd.launches_by_dtype)
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                              window=window)
    assert flash_attention_bwd.launches_by_dtype["bfloat16"] == \
        before["bfloat16"] + 1
    want = heads(*flash_attention_bwd_ref(*heads(q, k, v), out.transpose(
        1, 2), lse, *heads(dout), causal=causal, window=window))
    wide = flash_attention_bwd(q.float(), k.float(), v.float(), out, lse,
                               dout.float(), causal=causal, window=window)
    for a, w, f in zip(got, want, wide):
        assert a.dtype == torch.bfloat16 and a.shape == w.shape
        assert _rel(a.float(), w.float()) <= BWD_BF16_TOL
        assert torch.equal(a, f.to(torch.bfloat16))
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                window=window)
    assert all(torch.equal(x, y) for x, y in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("case", [(3, 129, 129, 4, 2, 64, True, 0),
                                  (2, 90, 40, 4, 2, 256, True, 16)])
def test_card_bwd_bf16_batch_equals_its_elements(cuda, case):
    b, sq, skv, h, kh, d, causal, window = case
    q, k, v, dout = _bf16_inputs(cuda, case)
    out, lse = fa_ops._launch(q, k, v, causal, window, with_lse=True)
    inputs = (q, k, v, out, lse, dout)
    whole = flash_attention_bwd(*inputs, causal=causal, window=window)
    for e in range(b):
        one = flash_attention_bwd(*(t[e:e + 1] for t in inputs),
                                  causal=causal, window=window)
        assert all(torch.equal(w[e:e + 1], o) for w, o in zip(whole, one))


@pytest.mark.gpu
def test_card_decode_refuses_an_f32_q_over_a_bf16_cache(cuda):
    """No caller of the reference decodes an f32 q over a bf16 cache, and
    K6 has no entry for it: on the card the step raises before any launch
    (the CPU runs the plain function: tests/test_torch_bf16_model.py)."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.models import decode_step, init_cache
    cfg = get_config("sheared-llama-2.7b").reduced(num_layers=1, d_model=128)
    model = init_params(cfg, seed=0, device=cuda)
    caches = init_cache(cfg, 1, 8, device=cuda, dtype=torch.bfloat16)
    before = decode_attention.launches
    with pytest.raises(NotImplementedError, match="no kernel entry"):
        decode_step(model, torch.ones((1, 1), dtype=torch.long,
                                      device=cuda), caches, 0)
    assert decode_attention.launches == before


@pytest.mark.gpu
def test_card_train_step_matches_the_cpu(cuda):
    cfg = get_config("stablelm-1.6b").reduced(num_layers=2, d_model=128)
    cpu = train_state_init(init_params(cfg, seed=0, device="cpu"))
    card = train_state_init(init_params(cfg, seed=0, device="cpu").to(cuda))
    start = [p.detach().clone() for p in cpu.model.parameters()]
    step = make_train_step(cfg, peak_lr=0.3, total_steps=60)
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 65))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
             "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
    on_card = {k: t.to(cuda) for k, t in batch.items()}
    fwd0 = flash_attention.launches
    bwd0 = flash_attention_bwd.launches
    for _ in range(3):
        cpu, m_cpu = step(cpu, batch)
        card, m_card = step(card, on_card)
        assert m_card["lr"] == m_cpu["lr"]
        for key in ("loss", "ce"):
            assert abs(m_card[key] - m_cpu[key]) <= STEP_TOL * m_cpu[key]
        assert abs(m_card["grad_norm"] - m_cpu["grad_norm"]) <= \
            1e-4 * m_cpu["grad_norm"]
    # 3 steps x 2 layers: a forward and its recompute, and one backward
    assert flash_attention.launches - fwd0 == 3 * 2 * 2
    assert flash_attention_bwd.launches - bwd0 == 3 * 2
    for s, p, q in zip(start, card.model.parameters(),
                       cpu.model.parameters()):
        moved = q.detach() - s
        assert float(torch.linalg.norm(moved)) > 0
        assert _rel(p.detach().cpu() - s, moved) <= UPDATE_TOL
