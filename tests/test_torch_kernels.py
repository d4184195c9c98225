"""Port kernels against the JAX package: the plain PyTorch versions of
``ivf_topk`` and ``slab_topk`` (fp32, fp16, int8 and pq modes) against
``repro.kernels.*.ref`` and the Pallas kernels in interpret mode, the
padding contracts, integer-valued tie inputs (bitwise), and batch ==
sequential inside the port (bitwise).  The CUDA kernels against the plain
versions run only on the card (``gpu``).

Tolerance: two fp32 sums of the same D products in different orders differ
by at most 2 * D * 2**-24 * sum(|q_i e_i|) (each is within gamma_D of the
exact sum); :func:`_tol` takes the largest such bound over the batch.  For
int8 slabs the products are those of the widened int8 values, and the
bound is multiplied by the largest scale.  PQ scores are gathers and adds
in one fixed order on both sides, so they are compared bitwise.

The attention kernels (``flash_attention``, ``decode_attention`` and the
int8-cache ``decode_attention_q8``) are held against their plain versions
here only on the card; their CPU parity with the JAX package is
``tests/test_torch_attention.py`` and ``tests/test_torch_quantization.py``.
Their tolerance is :func:`_attn_ratio`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.ivf_topk.kernel import topk_ip_pallas  # noqa: E402
from repro.kernels.ivf_topk.ref import topk_ip_ref as jax_topk_ref  # noqa: E402
from repro.kernels.slab_topk.kernel import slab_topk_pallas  # noqa: E402
from repro.kernels.slab_topk.ref import lex_topk as jax_lex_topk  # noqa: E402
from repro.kernels.slab_topk.ref import slab_topk_ref as jax_slab_ref  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention  # noqa: E402
from repro_torch.kernels.decode_attention import decode_lengths  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_ref  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_q8  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_q8_ref  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_ref  # noqa: E402
from repro_torch.kernels.ivf_topk import topk_ip  # noqa: E402
from repro_torch.kernels.slab_topk import NOT_PROBED, ROW_PAD, slab_topk  # noqa: E402
from repro_torch.kernels.slab_topk.ref import lex_topk  # noqa: E402
from repro_torch.kernels.slab_topk.ref import slab_topk_ref  # noqa: E402
from repro_torch.models import (decode_step, encode, init_cache,  # noqa: E402
                                init_params, prefill)
from repro_torch.models.quantization import dequantize_kv, quantize_kv  # noqa: E402


def _tol(e: np.ndarray, q: np.ndarray) -> float:
    d = e.shape[1]
    return float(2 * d * 2.0 ** -24 * (np.abs(q) @ np.abs(e).T).max())


def _virt(sizes, probes):
    """(Q, N) virt of a slab packing clusters of ``sizes`` in order, for
    per-query probe lists ``probes`` (as SlabLayout.query_layout does)."""
    offs = np.concatenate([[0], np.cumsum(sizes)])
    virt = np.full((len(probes), offs[-1]), NOT_PROBED, np.int32)
    for qi, probed in enumerate(probes):
        base = 0
        for c in probed:
            virt[qi, offs[c]:offs[c + 1]] = np.arange(base, base + sizes[c])
            base += sizes[c]
    return virt


def _slab_case(seed, n_clusters=12, d=48, nq=5, nprobe=4, integer=False):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(3, 40, n_clusters)
    n = int(sizes.sum())
    if integer:
        emb = rng.integers(-3, 4, (n, d)).astype(np.float32)
        q = rng.integers(-2, 3, (nq, d)).astype(np.float32)
    else:
        emb = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((nq, d)).astype(np.float32)
    probes = [list(rng.permutation(n_clusters)[:nprobe]) for _ in range(nq)]
    return emb, q, _virt(sizes, probes)


def _assert_topk_close(vals, ids, ref_vals, ref_ids, full_ref, tol):
    """Scores within ``tol``; ids equal at every lane whose score is more
    than 2*tol away from both neighbours in the full sorted score list."""
    np.testing.assert_allclose(vals, ref_vals, rtol=0, atol=tol)
    srt = -np.sort(-full_ref, axis=1)
    k = vals.shape[1]
    for qi in range(vals.shape[0]):
        s = srt[qi]
        for i in range(k):
            lo = s[i] - s[i + 1] if i + 1 < len(s) else np.inf
            hi = s[i - 1] - s[i] if i > 0 else np.inf
            if min(lo, hi) > 2 * tol:
                assert ids[qi, i] == ref_ids[qi, i], (qi, i)


# ---------------------------------------------------------------------------
# ivf_topk
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n,d,nq,k", [(1000, 64, 3, 10), (130, 128, 1, 100),
                                      (77, 32, 5, 8), (300, 768, 4, 16)])
def test_topk_ip_plain_matches_jax_ref_and_pallas(n, d, nq, k):
    rng = np.random.default_rng(n + d)
    e = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((nq, d)).astype(np.float32)
    vals, idx = topk_ip(torch.from_numpy(e), torch.from_numpy(q), k)
    vals, idx = vals.numpy(), idx.numpy()
    tol = _tol(e, q)
    full = q.astype(np.float64) @ e.T.astype(np.float64)
    rv, ri = jax_topk_ref(jnp.asarray(e), jnp.asarray(q), k)
    _assert_topk_close(vals, idx, np.asarray(rv), np.asarray(ri), full, tol)
    pv, pi = topk_ip_pallas(jnp.asarray(e), jnp.asarray(q), k,
                            interpret=True)
    _assert_topk_close(vals, idx, np.asarray(pv), np.asarray(pi), full, tol)


def test_topk_ip_pads_when_k_exceeds_n():
    rng = np.random.default_rng(0)
    e = torch.from_numpy(rng.standard_normal((5, 16)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 16)).astype(np.float32))
    vals, idx = topk_ip(e, q, 9)
    assert vals.shape == (2, 9) and idx.dtype == torch.int32
    assert (idx[:, 5:] == -1).all() and torch.isinf(vals[:, 5:]).all()
    assert sorted(idx[0, :5].tolist()) == list(range(5))


def test_topk_ip_integer_ties_bitwise():
    """Integer-valued inputs: every sum is exact in any order, so the port
    must equal the JAX reference and the Pallas kernel bit for bit, ties
    (to the lower index) included."""
    rng = np.random.default_rng(3)
    e = rng.integers(-2, 3, (200, 24)).astype(np.float32)
    e[50:60] = e[10]                                  # exact duplicates
    q = rng.integers(-2, 3, (6, 24)).astype(np.float32)
    vals, idx = topk_ip(torch.from_numpy(e), torch.from_numpy(q), 20)
    rv, ri = jax_topk_ref(jnp.asarray(e), jnp.asarray(q), 20)
    pv, pi = topk_ip_pallas(jnp.asarray(e), jnp.asarray(q), 20,
                            interpret=True)
    for v, i in ((rv, ri), (pv, pi)):
        assert np.array_equal(vals.numpy(), np.asarray(v))
        assert np.array_equal(idx.numpy(), np.asarray(i))


def test_topk_ip_batch_equals_sequential_bitwise():
    rng = np.random.default_rng(4)
    e = torch.from_numpy(rng.standard_normal((700, 96)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((9, 96)).astype(np.float32))
    vals, idx = topk_ip(e, q, 12)
    for qi in range(9):
        v1, i1 = topk_ip(e, q[qi:qi + 1], 12)
        assert torch.equal(v1[0], vals[qi]) and torch.equal(i1[0], idx[qi])


# ---------------------------------------------------------------------------
# slab_topk (fp32)
# ---------------------------------------------------------------------------
def _valid_lanes(virt, k):
    n_valid = (virt < NOT_PROBED).sum(1)
    return np.arange(k)[None, :] < n_valid[:, None]


@pytest.mark.parametrize("seed,k", [(0, 10), (1, 25), (2, 1)])
def test_slab_topk_plain_matches_jax_ref_and_pallas(seed, k):
    emb, q, virt = _slab_case(seed)
    vals, rows = slab_topk(torch.from_numpy(emb), torch.from_numpy(q),
                           torch.from_numpy(virt), k)
    vals, rows = vals.numpy(), rows.numpy()
    valid = _valid_lanes(virt, k)
    tol = _tol(emb, q)
    full = np.where(virt < NOT_PROBED,
                    q.astype(np.float64) @ emb.T.astype(np.float64), -1e30)
    for fn in (lambda: jax_slab_ref(jnp.asarray(emb), jnp.asarray(q),
                                    jnp.asarray(virt), k),
               lambda: slab_topk_pallas(jnp.asarray(emb), jnp.asarray(q),
                                        jnp.asarray(virt), k,
                                        block_n=128, interpret=True)):
        rv, rr = (np.asarray(a) for a in fn())
        np.testing.assert_allclose(vals[valid], rv[valid], rtol=0, atol=tol)
        _assert_topk_close(np.where(valid, vals, -1e30),
                           np.where(valid, rows, -1),
                           np.where(valid, rv, -1e30),
                           np.where(valid, rr, -1), full, tol)


def test_slab_topk_integer_ties_bitwise():
    emb, q, virt = _slab_case(5, integer=True)
    k = 30
    vals, rows = slab_topk(torch.from_numpy(emb), torch.from_numpy(q),
                           torch.from_numpy(virt), k)
    valid = _valid_lanes(virt, k)
    for rv, rr in (jax_slab_ref(jnp.asarray(emb), jnp.asarray(q),
                                jnp.asarray(virt), k),
                   slab_topk_pallas(jnp.asarray(emb), jnp.asarray(q),
                                    jnp.asarray(virt), k, block_n=64,
                                    interpret=True)):
        assert np.array_equal(vals.numpy()[valid], np.asarray(rv)[valid])
        assert np.array_equal(rows.numpy()[valid], np.asarray(rr)[valid])


def test_slab_topk_all_tie_rows_resolve_by_virt():
    """Every member scores the same: the order is virt ascending."""
    emb = np.ones((40, 8), np.float32)
    q = np.ones((3, 8), np.float32)
    virt = _virt([10, 10, 10, 10], [[2, 0], [3, 1, 0], [1]])
    vals, rows = slab_topk(torch.from_numpy(emb), torch.from_numpy(q),
                           torch.from_numpy(virt), 12)
    rv, rr = jax_slab_ref(jnp.asarray(emb), jnp.asarray(q),
                          jnp.asarray(virt), 12)
    valid = _valid_lanes(virt, 12)
    assert np.array_equal(rows.numpy()[valid], np.asarray(rr)[valid])
    assert rows[0, :10].tolist() == list(range(20, 30))
    assert (vals.numpy()[valid] == 8.0).all()


def test_lex_topk_signed_zero_ties_by_tie_key():
    """+0.0 and -0.0 tie and resolve by the tie key, and the returned
    values keep their sign bits — as the JAX ``lex_topk``."""
    masked = np.array([[0.0, -0.0, 1.0, -0.0, 0.0, -1e30],
                       [-0.0, 0.0, -0.0, 0.0, -1.0, 2.0]], np.float32)
    tie = np.array([[4, 1, 9, 0, 2, NOT_PROBED],
                    [3, 2, 1, 0, 5, 7]], np.int32)
    vals, cols = lex_topk(torch.from_numpy(masked), torch.from_numpy(tie), 5)
    rv, rc = jax_lex_topk(jnp.asarray(masked), jnp.asarray(tie), 5)
    assert np.array_equal(cols.numpy(), np.asarray(rc))
    assert np.array_equal(np.signbit(vals.numpy()), np.signbit(np.asarray(rv)))
    assert cols[0].tolist() == [2, 3, 1, 4, 0]


def test_slab_topk_empty_slab_and_k_over_n():
    q = torch.zeros((3, 8))
    vals, rows = slab_topk(torch.zeros((0, 8)), q,
                           torch.zeros((3, 0), dtype=torch.int32), 4)
    assert vals.shape == (3, 4) and torch.isinf(vals).all()
    assert (rows == ROW_PAD).all()
    emb, qn, virt = _slab_case(6, n_clusters=2, nq=3, nprobe=1)
    n = emb.shape[0]
    vals, rows = slab_topk(torch.from_numpy(emb), torch.from_numpy(qn),
                           torch.from_numpy(virt), n + 3)
    assert (rows[:, n:] == ROW_PAD).all() and torch.isinf(vals[:, n:]).all()
    assert ((rows[:, :n] >= 0) & (rows[:, :n] < n)).all()


def test_slab_topk_rejects_quantized_slabs():
    """A quantized slab without its operand, or with one that does not
    belong to its dtype, raises instead of being scored."""
    q, virt = torch.zeros((1, 8)), torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="scales"):
        slab_topk(torch.zeros((4, 8), dtype=torch.int8), q, virt, 2)
    with pytest.raises(ValueError, match="scales"):
        slab_topk(torch.zeros((4, 8), dtype=torch.float16), q, virt, 2,
                  scales=torch.ones((4, 1)))
    with pytest.raises(ValueError, match="luts"):
        slab_topk(torch.zeros((4, 8), dtype=torch.uint8), q, virt, 2)


def test_slab_topk_batch_equals_sequential_bitwise():
    emb, q, virt = _slab_case(7, n_clusters=20, nq=8, nprobe=6)
    e, qt, vt = (torch.from_numpy(a) for a in (emb, q, virt))
    vals, rows = slab_topk(e, qt, vt, 10)
    for qi in range(q.shape[0]):
        v1, r1 = slab_topk(e, qt[qi:qi + 1], vt[qi:qi + 1], 10)
        assert torch.equal(v1[0], vals[qi]) and torch.equal(r1[0], rows[qi])


# ---------------------------------------------------------------------------
# the CUDA kernels (only on the card)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("integer", [False, True])
def test_cuda_topk_ip_matches_plain(cuda, integer):
    rng = np.random.default_rng(11)
    if integer:
        e = rng.integers(-3, 4, (1300, 768)).astype(np.float32)
        q = rng.integers(-2, 3, (16, 768)).astype(np.float32)
    else:
        e = rng.standard_normal((1300, 768)).astype(np.float32)
        q = rng.standard_normal((16, 768)).astype(np.float32)
    kv, ki = topk_ip(torch.from_numpy(e).to(cuda), torch.from_numpy(q).to(cuda), 8)
    pv, pi = topk_ip(torch.from_numpy(e), torch.from_numpy(q), 8)
    if integer:
        assert torch.equal(kv.cpu(), pv) and torch.equal(ki.cpu(), pi)
    else:
        full = q.astype(np.float64) @ e.T.astype(np.float64)
        _assert_topk_close(kv.cpu().numpy(), ki.cpu().numpy(), pv.numpy(),
                           pi.numpy(), full, _tol(e, q))


@pytest.mark.gpu
@pytest.mark.parametrize("integer", [False, True])
def test_cuda_slab_topk_matches_plain(cuda, integer):
    emb, q, virt = _slab_case(12, n_clusters=60, d=768, nq=16, nprobe=8,
                              integer=integer)
    args = [torch.from_numpy(a) for a in (emb, q, virt)]
    kv, kr = slab_topk(*[a.to(cuda) for a in args], 10)
    pv, pr = slab_topk(*args, 10)
    if integer:
        assert torch.equal(kv.cpu(), pv) and torch.equal(kr.cpu(), pr)
    else:
        np.testing.assert_allclose(kv.cpu().numpy(), pv.numpy(), rtol=0,
                                   atol=_tol(emb, q))


# ivf_topk and slab_topk in every mode share one kernel
# (csrc/topk_tiled.cuh): row tiles of 16 (N <= 2,048) or 64 rows, query
# tiles of 16, the merge in the same launch.  The cases below cross each of
# those edges in every mode ("slab" is fp32).
TILED_KINDS = ["ivf", "slab", "fp16", "int8", "pq"]
_KIND_MODE = {"slab": "fp32", "fp16": "fp16", "int8": "int8", "pq": "pq"}


def _tiled_case(kind, n, d, nq, seed, integer):
    """(emb, queries, virt or None, extra): random clusters of 1-39 rows,
    each probed by about 40% of the queries, for the slab modes; fp16 and
    int8 rows from the f32 ones (int8: row scales, powers of two when
    ``integer``), pq codes of m = d subspaces with (Q, m, 256) tables."""
    rng = np.random.default_rng(seed)
    if integer:
        e = rng.integers(-3, 4, (n, d)).astype(np.float32)
        q = rng.integers(-2, 3, (nq, d)).astype(np.float32)
    else:
        e = rng.standard_normal((n, d)).astype(np.float32)
        q = rng.standard_normal((nq, d)).astype(np.float32)
    extra = {}
    if kind == "fp16":
        e = e.astype(np.float16)
    elif kind == "int8":
        if integer:
            extra["scales"] = (2.0 ** rng.integers(-4, 5, (n, 1))).astype(
                np.float32)
            e = e.astype(np.int8)
        else:
            scales = (np.abs(e).max(1, keepdims=True) / 127.0).astype(
                np.float32)
            e = np.round(e / scales).astype(np.int8)
            extra["scales"] = scales
    elif kind == "pq":
        e = rng.integers(0, 256, (n, d)).astype(np.uint8)
        extra["luts"] = (rng.integers(-8, 9, (nq, d, 256)) if integer else
                         rng.standard_normal((nq, d, 256))).astype(np.float32)
    if kind == "ivf":
        return e, q, None, extra
    sizes = []
    while sum(sizes) < n:
        sizes.append(int(min(rng.integers(1, 40), n - sum(sizes))))
    probes = [list(np.flatnonzero(rng.random(len(sizes)) < 0.4))
              for _ in range(nq)]
    return e, q, _virt(sizes, probes), extra


def _tiled(kind, e, q, virt, k, dev, extra=None):
    """The port's op on ``dev`` -> numpy (vals, ids)."""
    args = [torch.from_numpy(a).to(dev) for a in (e, q)]
    if kind == "ivf":
        out = topk_ip(*args, k)
    else:
        kw = {n: torch.from_numpy(a).to(dev) for n, a in (extra or {}).items()}
        out = slab_topk(*args, torch.from_numpy(virt).to(dev), k, **kw)
    return tuple(t.cpu().numpy() for t in out)


def _hold_tiled(kind, e, q, virt, k, cuda, integer, extra=None):
    """The kernel against the plain version: bitwise on integer inputs and
    in pq, else scores within the mode's tolerance and ids equal away from
    near-ties (slab modes: on the lanes within each query's member
    count)."""
    kv, ki = _tiled(kind, e, q, virt, k, cuda, extra)
    pv, pi = _tiled(kind, e, q, virt, k, "cpu", extra)
    if integer or kind == "pq":
        assert np.array_equal(kv, pv) and np.array_equal(ki, pi)
        return
    mode = _KIND_MODE.get(kind, "fp32")
    full = _scores64(mode, e, q, extra or {})
    if kind != "ivf":
        valid = _valid_lanes(virt, k)
        full = np.where(virt < NOT_PROBED, full, -1e30)
        kv, ki = np.where(valid, kv, -1e30), np.where(valid, ki, -1)
        pv, pi = np.where(valid, pv, -1e30), np.where(valid, pi, -1)
    _assert_topk_close(kv, ki, pv, pi, full, _mode_tol(mode, e, q,
                                                       extra or {}))


def _shifted(t, cuda):
    """A copy of ``t`` one element past its buffer's start: off a 16-byte
    boundary whatever its dtype."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


TILED_NK = [(n, k) for n in (1, 63, 64, 65, 125, 4097)
            for k in sorted({1, 10, 64, n}) if k <= n]


@pytest.mark.gpu
@pytest.mark.parametrize("kind", TILED_KINDS)
@pytest.mark.parametrize("nq", [1, 16, 17, 40])
@pytest.mark.parametrize("n,k", TILED_NK)
def test_cuda_tiled_topk_tile_edges(cuda, kind, nq, n, k):
    for integer in (False, True):
        e, q, virt, extra = _tiled_case(kind, n, 64, nq, n + nq + k, integer)
        _hold_tiled(kind, e, q, virt, k, cuda, integer, extra)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", TILED_KINDS)
@pytest.mark.parametrize("d", [3, 17, 64, 768, 4096])
def test_cuda_tiled_topk_any_d(cuda, kind, d):
    """No limit on D or m (4,096 a query), D off the 16-byte path (D % 4,
    8 or 16 != 0: plain loads), and operands off a 16-byte boundary give
    the aligned bits."""
    for integer in (False, True):
        e, q, virt, extra = _tiled_case(kind, 1300, d, 16, d, integer)
        _hold_tiled(kind, e, q, virt, 10, cuda, integer, extra)
    et, qt = torch.from_numpy(e).to(cuda), torch.from_numpy(q).to(cuda)
    if kind == "ivf":
        a, b = topk_ip(et, qt, 10), topk_ip(_shifted(et, cuda),
                                            _shifted(qt, cuda), 10)
    else:
        vt = torch.from_numpy(virt).to(cuda)
        kw = {n: torch.from_numpy(x).to(cuda) for n, x in extra.items()}
        moved = {n: _shifted(x, cuda) for n, x in kw.items()}
        a = slab_topk(et, qt, vt, 10, **kw)
        b = slab_topk(_shifted(et, cuda), _shifted(qt, cuda), vt, 10,
                      **moved)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.gpu
def test_cuda_slab_topk_fp32_queries_and_tiles_without_members(cuda):
    """A query that probes nothing, a 64-row tile no query probes, and a
    whole query tile (queries 16..) with no member anywhere: the member
    lanes and the NEG_INF lanes (lowest non-member rows) equal the plain
    version bitwise."""
    e, q, virt, _ = _tiled_case("slab", 4097, 64, 20, 5, integer=True)
    virt[:, :64] = NOT_PROBED
    virt[3] = NOT_PROBED
    virt[16:] = NOT_PROBED
    for k in (1, 10, 100):
        _hold_tiled("slab", e, q, virt, k, cuda, integer=True)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fp16", "int8", "pq"])
def test_cuda_slab_topk_quantized_queries_and_tiles_without_members(cuda,
                                                                     kind):
    """The fp32 case above in the fp16, int8 and pq modes: bitwise on the
    member lanes and on the NEG_INF lanes."""
    e, q, virt, extra = _tiled_case(kind, 4097, 64, 20, 5, integer=True)
    virt[:, :64] = NOT_PROBED
    virt[3] = NOT_PROBED
    virt[16:] = NOT_PROBED
    for k in (1, 10, 100):
        _hold_tiled(kind, e, q, virt, k, cuda, True, extra)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", TILED_KINDS)
@pytest.mark.parametrize("k", [5, 20])
def test_cuda_tiled_topk_merge_paths_on_ties(cuda, kind, k):
    """Every score equal on 2,100 rows (33 tiles of 64): the merge keeps
    every candidate past its threshold -- 165 a query at k = 5 (k rounds
    over them in shared memory), 660 at k = 20 (k rounds over scratch) --
    and the ties resolve as the plain version's, bitwise."""
    e, q, virt, extra = _tiled_case(kind, 2100, 16, 3, 7, integer=True)
    e = np.zeros_like(e) if kind == "pq" else np.ones_like(e)
    q = np.ones_like(q)
    if kind == "pq":
        extra = {"luts": np.ones_like(extra["luts"])}
    elif kind == "int8":
        extra = {"scales": np.ones_like(extra["scales"])}
    if virt is not None:
        virt = np.tile(np.arange(e.shape[0], dtype=np.int32), (3, 1))
        virt[1, ::3] = NOT_PROBED
    _hold_tiled(kind, e, q, virt, k, cuda, True, extra)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", TILED_KINDS)
def test_cuda_tiled_topk_batch_equals_sequential(cuda, kind):
    e, q, virt, extra = _tiled_case(kind, 4097, 768, 40, 9, integer=False)
    vals, ids = _tiled(kind, e, q, virt, 10, cuda, extra)
    for i in range(q.shape[0]):
        one = {n: (a[i:i + 1] if n == "luts" else a) for n, a in extra.items()}
        v1, i1 = _tiled(kind, e, q[i:i + 1],
                        None if virt is None else virt[i:i + 1], 10, cuda,
                        one)
        assert np.array_equal(v1[0], vals[i]) and np.array_equal(i1[0], ids[i])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", TILED_KINDS)
def test_cuda_tiled_topk_repeats_and_second_stream(cuda, kind):
    """The merge's ticket counters are zero again after every launch: calls
    in a row, and calls on a second stream, give the same bits, one launch
    each."""
    e, q, virt, extra = _tiled_case(kind, 4097, 768, 40, 10, integer=False)
    op = topk_ip if kind == "ivf" else slab_topk
    first = _tiled(kind, e, q, virt, 10, cuda, extra)
    before = op.launches
    for _ in range(3):
        again = _tiled(kind, e, q, virt, 10, cuda, extra)
        assert all(np.array_equal(a, b) for a, b in zip(first, again))
    assert op.launches == before + 3
    side = torch.cuda.Stream(cuda)
    with torch.cuda.stream(side):
        for _ in range(2):
            again = _tiled(kind, e, q, virt, 10, cuda, extra)
            assert all(np.array_equal(a, b) for a, b in zip(first, again))
    again = _tiled(kind, e, q, virt, 10, cuda, extra)
    assert all(np.array_equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", TILED_KINDS)
def test_cuda_tiled_topk_runs_on_every_card(cuda, kind):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second NVIDIA GPU")
    e, q, virt, extra = _tiled_case(kind, 4097, 768, 17, 11, integer=True)
    want = _tiled(kind, e, q, virt, 10, "cpu", extra)
    for i in range(torch.cuda.device_count()):
        for _ in range(2):
            got = _tiled(kind, e, q, virt, 10, torch.device("cuda", i),
                         extra)
            assert all(np.array_equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["fp16", "int8"])
@pytest.mark.parametrize("d,nq", [(17, 16), (768, 16), (768, 40)])
def test_cuda_slab_topk_compact_gives_fp32_bits_on_the_widened_slab(
        cuda, kind, d, nq):
    """fp16 rows, and int8 rows with unit scales, give the fp32 mode's bits
    on the widened slab: the same fixed-order FMAs after an exact
    widening (D = 17 on the plain-load path)."""
    e, q, virt, _ = _tiled_case(kind, 4097, d, nq, d + nq, integer=False)
    et, qt, vt = (torch.from_numpy(a).to(cuda) for a in (e, q, virt))
    kw = ({"scales": torch.ones((e.shape[0], 1), device=cuda)}
          if kind == "int8" else {})
    for k in (1, 10, 64):
        a = slab_topk(et, qt, vt, k, **kw)
        b = slab_topk(et.float(), qt, vt, k)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# slab_topk: fp16, int8 (scaled) and pq modes
# ---------------------------------------------------------------------------
def _quantized_case(mode, seed, integer=False, pq_m=8, **kw):
    """(slab, queries, virt, extra) of one mode: the fp32 case of
    :func:`_slab_case` narrowed to fp16, or row-quantized to int8 with f32
    scales (powers of two when ``integer``), or turned into uint8 codes
    with (Q, m, 256) tables (small integers when ``integer``)."""
    emb, q, virt = _slab_case(seed, integer=integer, **kw)
    rng = np.random.default_rng(seed + 100)
    if mode == "fp16":
        return emb.astype(np.float16), q, virt, {}
    if mode == "int8":
        if integer:
            scales = 2.0 ** rng.integers(-4, 5, (len(emb), 1))
            return emb.astype(np.int8), q, virt, {
                "scales": scales.astype(np.float32)}
        amax = np.abs(emb).max(1, keepdims=True)
        scales = (amax / 127.0).astype(np.float32)
        return (np.round(emb / scales).astype(np.int8), q, virt,
                {"scales": scales})
    m = pq_m
    codes = rng.integers(0, 256, (len(emb), m)).astype(np.uint8)
    luts = (rng.integers(-8, 9, (len(q), m, 256)) if integer
            else rng.standard_normal((len(q), m, 256))).astype(np.float32)
    return codes, q, virt, {"luts": luts}


def _scores64(mode, emb, q, extra):
    """Exact (float64) scores of every (query, row) pair."""
    if mode == "pq":
        luts = extra["luts"].astype(np.float64)
        m = emb.shape[1]
        return sum(luts[:, j, emb[:, j]] for j in range(m))
    s = q.astype(np.float64) @ emb.astype(np.float64).T
    return s * extra["scales"][:, 0][None, :] if mode == "int8" else s


def _mode_tol(mode, emb, q, extra):
    if mode == "pq":
        return 0.0
    tol = _tol(emb.astype(np.float32), q)
    return tol * float(np.abs(extra["scales"]).max()) if mode == "int8" \
        else tol


def _port(emb, q, virt, k, extra, dev="cpu"):
    kw = {n: torch.from_numpy(a).to(dev) for n, a in extra.items()}
    vals, rows = slab_topk(*(torch.from_numpy(a).to(dev)
                             for a in (emb, q, virt)), k, **kw)
    return vals.cpu().numpy(), rows.cpu().numpy()


def _jax(fn, emb, q, virt, k, extra, **kw):
    jx = {n: jnp.asarray(a) for n, a in extra.items()}
    rv, rr = fn(jnp.asarray(emb), jnp.asarray(q), jnp.asarray(virt), k,
                jx.get("scales"), jx.get("luts"), **kw)
    return np.asarray(rv), np.asarray(rr)


QUANT_MODES = ["fp16", "int8", "pq"]


@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("seed,k", [(0, 10), (1, 25)])
def test_slab_topk_quantized_plain_matches_jax_ref_and_pallas(mode, seed, k):
    emb, q, virt, extra = _quantized_case(mode, seed)
    vals, rows = _port(emb, q, virt, k, extra)
    valid = _valid_lanes(virt, k)
    tol = _mode_tol(mode, emb, q, extra)
    full = np.where(virt < NOT_PROBED, _scores64(mode, emb, q, extra), -1e30)
    for rv, rr in (_jax(jax_slab_ref, emb, q, virt, k, extra),
                   _jax(slab_topk_pallas, emb, q, virt, k, extra,
                        block_n=128, interpret=True)):
        if mode == "pq":        # same gathers and adds, in the same order
            assert np.array_equal(vals[valid], rv[valid])
            assert np.array_equal(rows[valid], rr[valid])
            continue
        np.testing.assert_allclose(vals[valid], rv[valid], rtol=0, atol=tol)
        _assert_topk_close(np.where(valid, vals, -1e30),
                           np.where(valid, rows, -1),
                           np.where(valid, rv, -1e30),
                           np.where(valid, rr, -1), full, tol)


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_slab_topk_quantized_integer_inputs_bitwise(mode):
    """Small integers in fp16, int8 with power-of-two scales, pq tables of
    small integers: every score is exact in any order, so the port equals
    the JAX reference and the Pallas kernel bit for bit, ties included."""
    emb, q, virt, extra = _quantized_case(mode, 5, integer=True)
    k = 30
    vals, rows = _port(emb, q, virt, k, extra)
    valid = _valid_lanes(virt, k)
    for rv, rr in (_jax(jax_slab_ref, emb, q, virt, k, extra),
                   _jax(slab_topk_pallas, emb, q, virt, k, extra,
                        block_n=64, interpret=True)):
        assert np.array_equal(vals[valid], rv[valid])
        assert np.array_equal(rows[valid], rr[valid])


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_slab_topk_quantized_batch_equals_sequential_bitwise(mode):
    emb, q, virt, extra = _quantized_case(mode, 7, n_clusters=20, nq=8,
                                          nprobe=6)
    vals, rows = _port(emb, q, virt, 10, extra)
    for qi in range(q.shape[0]):
        one = {n: (a[qi:qi + 1] if n == "luts" else a)
               for n, a in extra.items()}
        v1, r1 = _port(emb, q[qi:qi + 1], virt[qi:qi + 1], 10, one)
        assert np.array_equal(v1[0], vals[qi]) and np.array_equal(r1[0],
                                                                  rows[qi])


@pytest.mark.parametrize("mode", QUANT_MODES)
def test_slab_topk_quantized_empty_k_over_n_and_all_ties(mode):
    emb, q, virt, extra = _quantized_case(mode, 6, n_clusters=2, nq=3,
                                          nprobe=1)
    n = emb.shape[0]
    vals, rows = _port(emb[:0], q, virt[:, :0], 4,
                       {n_: (a[:0] if n_ == "scales" else a)
                        for n_, a in extra.items()})
    assert np.isinf(vals).all() and (rows == ROW_PAD).all()
    vals, rows = _port(emb, q, virt, n + 3, extra)
    assert (rows[:, n:] == ROW_PAD).all() and np.isinf(vals[:, n:]).all()
    # every member scores the same: the order is virt ascending
    tie = np.full((40, emb.shape[1]), 0 if mode == "pq" else 1, emb.dtype)
    if mode == "pq":
        extra = {"luts": np.ones((3, emb.shape[1], 256), np.float32)}
    elif mode == "int8":
        extra = {"scales": np.full((40, 1), 0.5, np.float32)}
    virt = _virt([10, 10, 10, 10], [[2, 0], [3, 1, 0], [1]])
    q = np.ones((3, q.shape[1]), np.float32)
    vals, rows = _port(tie, q, virt, 12, extra)
    rv, rr = slab_topk_ref(*(torch.from_numpy(a) for a in (tie, q, virt)),
                           12, **{n_: torch.from_numpy(a)
                                  for n_, a in extra.items()})
    valid = _valid_lanes(virt, 12)
    assert np.array_equal(rows[valid], rr.numpy()[valid])
    assert rows[0, :10].tolist() == list(range(20, 30))


@pytest.mark.parametrize("mode", ["fp16", "int8"])
def test_slab_topk_plain_compact_equals_fp32_on_the_widened_slab(mode):
    """The plain version's fp16 top-k, and its int8 top-k with unit scales,
    equal its fp32 top-k on the widened slab bitwise: the contract the CUDA
    kernel shares."""
    emb, q, virt, extra = _quantized_case(mode, 8, n_clusters=20, nq=8,
                                          nprobe=6)
    if mode == "int8":
        extra = {"scales": np.ones_like(extra["scales"])}
    vals, rows = _port(emb, q, virt, 10, extra)
    wv, wr = _port(emb.astype(np.float32), q, virt, 10, {})
    assert np.array_equal(vals, wv) and np.array_equal(rows, wr)


@pytest.mark.parametrize("bad", ["scales_shape", "scales_dtype", "luts_shape",
                                 "luts_queries", "slab_dtype",
                                 "queries_dtype"])
def test_slab_topk_rejects_malformed_operands(bad):
    emb, q, virt, extra = _quantized_case("int8", 0)
    codes, _, _, pq = _quantized_case("pq", 0)
    t = torch.from_numpy
    args = dict(emb=t(emb), queries=t(q), virt=t(virt),
                scales=t(extra["scales"]))
    if bad == "scales_shape":
        args["scales"] = args["scales"][:-1]
    elif bad == "scales_dtype":
        args["scales"] = args["scales"].half()
    elif bad in ("luts_shape", "luts_queries"):
        luts = t(pq["luts"])
        args.update(emb=t(codes), scales=None,
                    luts=luts[:, :-1] if bad == "luts_shape" else luts[:-1])
    elif bad == "slab_dtype":
        args.update(emb=t(emb).double(), scales=None)
    else:
        args["queries"] = t(q).half()
    with pytest.raises((TypeError, ValueError)):
        slab_topk(args.pop("emb"), args.pop("queries"), args.pop("virt"), 5,
                  **args)


@pytest.mark.gpu
@pytest.mark.parametrize("m", [47, 96, 224, 300, 1024])
def test_cuda_slab_topk_pq_wide_tables(cuda, m):
    """Tables of any width -- past the default 48 KB of shared memory (m >
    46) and past the two-launch path's old limit (m > 224) -- launch and
    equal the plain version bitwise: the kernel stages them a slice of
    subspaces at a time."""
    emb, q, virt, extra = _quantized_case("pq", 13, pq_m=m, n_clusters=40,
                                          d=64, nq=8, nprobe=6)
    pv, pr = _port(emb, q, virt, 10, extra)
    kv, kr = _port(emb, q, virt, 10, extra, dev=cuda)
    assert np.array_equal(kv, pv) and np.array_equal(kr, pr)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["fp16", "int8"])
@pytest.mark.parametrize("integer", [False, True])
def test_cuda_slab_topk_compact_wide_rows(cuda, mode, integer):
    """fp16 / int8 rows of D = 60,000 (past the two-launch path's old
    57,573): within the mode's tolerance of the plain version, bitwise on
    integer inputs."""
    emb, q, virt, extra = _quantized_case(mode, 14, integer=integer,
                                          n_clusters=12, d=60_000, nq=5,
                                          nprobe=4)
    kv, kr = _port(emb, q, virt, 10, extra, dev=cuda)
    pv, pr = _port(emb, q, virt, 10, extra)
    valid = _valid_lanes(virt, 10)
    if integer:
        assert np.array_equal(kv, pv) and np.array_equal(kr, pr)
    else:
        np.testing.assert_allclose(kv[valid], pv[valid], rtol=0,
                                   atol=_mode_tol(mode, emb, q, extra))


@pytest.mark.gpu
@pytest.mark.parametrize("mode", QUANT_MODES)
@pytest.mark.parametrize("integer", [False, True])
def test_cuda_slab_topk_quantized_matches_plain(cuda, mode, integer):
    emb, q, virt, extra = _quantized_case(mode, 12, integer=integer,
                                          n_clusters=60, d=768, nq=16,
                                          nprobe=8)
    before = slab_topk.launches_by_mode[mode]
    kv, kr = _port(emb, q, virt, 10, extra, dev=cuda)
    assert slab_topk.launches_by_mode[mode] == before + 1
    pv, pr = _port(emb, q, virt, 10, extra)
    if integer or mode == "pq":
        assert np.array_equal(kv, pv) and np.array_equal(kr, pr)
    else:
        np.testing.assert_allclose(kv, pv, rtol=0,
                                   atol=_mode_tol(mode, emb, q, extra))


# ---------------------------------------------------------------------------
# attention kernels (only on the card)
# ---------------------------------------------------------------------------
def _attn_ratio(got, ref):
    """The largest |got - ref| over its allowance: 2e-5 * max(1, D / 64),
    the JAX package's bound for its attention kernels against their
    references (``tests/test_kernels.py``), scaled with the head dim; bf16
    outputs, each rounded once from f32, may also land one bf16 ulp of the
    plain element apart.  The checks hold when it is <= 1."""
    diff = (got.float() - ref.float()).abs()
    allow = torch.full_like(diff, 2e-5 * max(1.0, got.shape[-1] / 64))
    if got.dtype == torch.bfloat16:
        r = ref.float()
        _, e = torch.frexp(r)
        allow = allow + torch.where(r == 0, 0.0, torch.ldexp(
            torch.ones_like(r), e - 8))
    return float((diff / allow).max())


def _flash_plain(q, k, v, causal, window):
    return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window).transpose(1, 2)


def _qkv(dev, b, sq, skv, h, kh, d, dtype=torch.float32, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s, n: torch.from_numpy(rng.standard_normal(
        (b, s, n, d)).astype(np.float32)).to(device=dev, dtype=dtype)
    return mk(sq, h), mk(skv, kh), mk(skv, kh)


# b, sq, skv, h, kh, d, causal, window, dtype: the model's prefill and
# encode shapes, GQA with a window, ragged lengths (Sq != Skv, rows with no
# valid key under the window), D = 128 (past 48 KB of shared memory), bf16;
# windows that leave rows q >= Skv + window - 1 no valid key, causal and
# not, in bf16 and f32; GQA 4 at each head dim; head dim 256 (gemma3-12b's,
# q in shared memory): its prefill (2,048 positions, 16 heads over 8, the
# 1,024-key window) in f32 and bf16, causal without a window, ragged
# non-causal, and a non-causal window in bf16
FLASH_CASES = [
    (1, 128, 128, 32, 32, 80, True, 0, torch.float32),
    (4, 128, 128, 12, 12, 64, False, 0, torch.float32),
    (2, 96, 96, 8, 2, 64, True, 40, torch.float32),
    (2, 77, 150, 4, 1, 80, True, 0, torch.float32),
    (1, 150, 77, 4, 2, 80, False, 20, torch.float32),
    (1, 130, 130, 4, 4, 128, True, 0, torch.float32),
    (2, 128, 128, 4, 2, 64, True, 0, torch.bfloat16),
    (2, 130, 64, 4, 4, 64, True, 16, torch.bfloat16),
    (2, 130, 64, 4, 4, 64, True, 16, torch.float32),
    (1, 200, 70, 8, 2, 80, False, 9, torch.bfloat16),
    (1, 200, 70, 8, 2, 128, False, 9, torch.float32),
    (2, 100, 100, 16, 4, 64, True, 0, torch.bfloat16),
    (2, 129, 129, 16, 4, 80, False, 0, torch.float32),
    (1, 65, 65, 16, 4, 128, True, 33, torch.float32),
    (1, 2048, 2048, 16, 8, 256, True, 1024, torch.float32),
    (1, 2048, 2048, 16, 8, 256, True, 1024, torch.bfloat16),
    (1, 300, 300, 4, 2, 256, True, 0, torch.float32),
    (2, 150, 77, 4, 2, 256, False, 0, torch.float32),
    (2, 130, 130, 4, 4, 256, False, 20, torch.bfloat16),
]
# lengths on either side of a warp's 16 query rows, the block's 64 and the
# 32- or 64-row K / V tile
EDGE_LENS = (1, 15, 16, 17, 63, 64, 65, 129)


@pytest.mark.gpu
@pytest.mark.parametrize("b,sq,skv,h,kh,d,causal,window,dtype", FLASH_CASES)
def test_cuda_flash_attention_matches_plain(cuda, b, sq, skv, h, kh, d,
                                            causal, window, dtype):
    q, k, v = _qkv(cuda, b, sq, skv, h, kh, d, dtype)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert flash_attention.launches == before + 1
    ref = _flash_plain(q, k, v, causal, window)
    assert out.shape == ref.shape and out.dtype == dtype
    assert _attn_ratio(out, ref) <= 1


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_flash_attention_tile_edges(cuda, d, causal):
    for sq in EDGE_LENS:
        for skv in EDGE_LENS:
            q, k, v = _qkv(cuda, 1, sq, skv, 4, 2, d, seed=1000 * sq + skv)
            out = flash_attention(q, k, v, causal=causal)
            ref = _flash_plain(q, k, v, causal, 0)
            assert out.shape == ref.shape
            assert _attn_ratio(out, ref) <= 1, (sq, skv)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_unaligned_kv_gives_the_same_bits(cuda, dtype):
    """K and V off a 16-byte boundary are staged by plain loads, into the
    same tiles as the asynchronous copies of aligned ones."""
    q, k, v = _qkv(cuda, 2, 70, 70, 4, 2, 80, dtype)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, dtype=dtype, device=cuda)
        out = buf[1:].view(t.shape)
        out.copy_(t)
        return out

    ku, vu = shifted(k), shifted(v)
    assert ku.data_ptr() % 16 and vu.data_ptr() % 16
    for causal in (True, False):
        assert torch.equal(flash_attention(q, ku, vu, causal=causal),
                           flash_attention(q, k, v, causal=causal))


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 80, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 30)])
def test_cuda_flash_attention_batch_equals_sequential(cuda, causal, window,
                                                      d):
    q, k, v = _qkv(cuda, 5, 100, 100, 8, 2, d)
    out = flash_attention(q, k, v, causal=causal, window=window)
    for i in range(5):
        one = flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                              causal=causal, window=window)
        assert torch.equal(one[0], out[i]), i


@pytest.mark.gpu
def test_cuda_flash_attention_runs_on_every_card(cuda):
    """Entries past 48 KB of shared memory (f32 causal D = 80, f32 D = 128)
    opt in on each card they launch on, not only on the first."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second NVIDIA GPU")
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        for d, causal in ((80, True), (128, False)):
            q, k, v = _qkv(dev, 1, 128, 128, 8, 8, d)
            out = flash_attention(q, k, v, causal=causal)
            assert out.device == dev
            assert _attn_ratio(out, _flash_plain(q, k, v, causal, 0)) <= 1


def _decode_case(dev, b, smax, h, kh, d, dtype=torch.float32, seed=1):
    q, k, v = _qkv(dev, b, 1, smax, h, kh, d, dtype, seed)
    return q, k, v


# b, smax, h, kh, d, lengths, window: the main path's decode shape, mixed
# per-slot lengths with GQA, a window, a length >= Smax, a window that
# leaves no valid position (the mean of V), D = 128, bf16, D = 32; then the
# split of the cache into chunks (csrc/decode_attention.cu: 32 rows while
# Smax <= 1,024, else 64): lengths C - 1, C, C + 1 and 2C + 1 at both chunk
# sizes, a 4,096-row cache, a window across a chunk boundary, a window that
# leaves one slot nothing valid beside a slot within one chunk, GQA groups 2
# and 4 served from one staged chunk (f32 and bf16), and group 16 (two
# passes of 8 heads over it); then 8 and 9 chunks (Smax 256 and 288), and
# windows whose valid chunks start past the first (Smax 1,100: chunks 6-9
# and 12-17 of 18); head dim 256 (gemma3-12b's, 16 query heads over 8: GQA
# 2): a 1,024-row ring (every row valid), a 2,064-row global cache at the
# engine's lengths, a window, and a ring in bf16
DECODE_CASES = [
    (1, 144, 32, 32, 80, [129], 0, torch.float32),
    (4, 144, 8, 2, 80, [1, 77, 144, 130], 0, torch.float32),
    (3, 200, 4, 1, 64, [50, 200, 9], 16, torch.float32),
    (2, 64, 4, 4, 64, [1000, 64], 0, torch.float32),
    (2, 64, 4, 2, 64, [1000, 70], 5, torch.float32),
    (3, 96, 8, 4, 128, [96, 3, 40], 0, torch.float32),
    (2, 128, 4, 2, 64, [128, 31], 8, torch.bfloat16),
    (2, 128, 8, 8, 32, [128, 60], 0, torch.float32),
    (4, 144, 8, 8, 80, [31, 32, 33, 65], 0, torch.float32),
    (4, 1100, 4, 2, 64, [63, 64, 65, 129], 0, torch.float32),
    (1, 4096, 32, 32, 80, [4096], 0, torch.float32),
    (2, 144, 8, 8, 80, [100, 140], 40, torch.float32),
    (2, 200, 4, 4, 80, [1000, 5], 3, torch.float32),
    (2, 300, 8, 4, 128, [300, 170], 0, torch.float32),
    (3, 160, 16, 4, 64, [160, 97, 33], 50, torch.bfloat16),
    (2, 100, 32, 2, 32, [100, 37], 0, torch.float32),
    (2, 256, 8, 2, 80, [256, 200], 0, torch.float32),
    (3, 288, 8, 8, 80, [288, 250, 257], 0, torch.float32),
    (3, 1100, 8, 4, 64, [600, 1100, 1030], 200, torch.float32),
    (1, 1024, 16, 8, 256, [2064], 0, torch.float32),
    (2, 2064, 16, 8, 256, [2049, 2064], 0, torch.float32),
    (3, 300, 8, 4, 256, [300, 17, 200], 40, torch.float32),
    (2, 1024, 16, 8, 256, [1024, 500], 0, torch.bfloat16),
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,smax,h,kh,d,lens,window,dtype", DECODE_CASES)
def test_cuda_decode_attention_matches_plain(cuda, b, smax, h, kh, d, lens,
                                             window, dtype):
    q, k, v = _decode_case(cuda, b, smax, h, kh, d, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = decode_attention.launches
    out = decode_attention(q, k, v, lengths, window=window)
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(q[:, 0], k, v, lengths, window=window)[:, None]
    assert out.shape == ref.shape and out.dtype == dtype
    assert _attn_ratio(out, ref) <= 1
    if len(set(lens)) == 1:       # one int for every slot: the same result
        assert torch.equal(decode_attention(q, k, v, lens[0], window=window),
                           out)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 24])
def test_cuda_decode_attention_batch_equals_sequential(cuda, window):
    q, k, v = _decode_case(cuda, 6, 160, 16, 4, 80)
    lengths = torch.tensor([160, 1, 33, 97, 150, 64], dtype=torch.int32,
                           device=cuda)
    out = decode_attention(q, k, v, lengths, window=window)
    for i in range(6):
        one = decode_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                               lengths[i:i + 1], window=window)
        assert torch.equal(one[0], out[i]), i


@pytest.mark.gpu
def test_cuda_decode_lengths_checked_once_give_the_same_result(cuda):
    q, k, v = _decode_case(cuda, 4, 144, 8, 2, 80)
    lens = torch.tensor([1, 77, 144, 130], dtype=torch.int32)
    checked = decode_lengths(lens, 4, cuda)
    assert checked.lengths.device.type == "cuda"
    assert checked.lengths.dtype == torch.int32
    assert torch.equal(decode_attention(q, k, v, checked),
                       decode_attention(q, k, v, lens.to(cuda)))
    with pytest.raises(ValueError, match=">= 1"):
        decode_lengths(torch.tensor([3, 0, 1, 1], device=cuda), 4, cuda)


def _padded(t):
    """``t``'s values with a head dim pad sliced off: the same shape, row
    strides off 16 bytes."""
    buf = t.new_zeros((*t.shape[:-1], t.shape[-1] + 1))
    buf[..., :-1] = t
    return buf[..., :-1]


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_decode_attention_unaligned_cache_gives_the_same_bits(
        cuda, q8, dtype):
    """A cache whose row strides are not multiples of 16 bytes is staged by
    plain loads into the same rows as the cp.async copies of an aligned
    one (K6: a cache of q's dtype; K7: int8 codes, q in ``dtype``)."""
    q, k, v = _decode_case(cuda, 3, 144, 8, 4, 80, dtype, seed=5)
    lengths = torch.tensor([144, 33, 70], dtype=torch.int32, device=cuda)
    if q8:
        qk, qv = quantize_kv(k.float()), quantize_kv(v.float())
        aligned = (qk.q, qk.scale, qv.q, qv.scale)
        moved = (_padded(qk.q), qk.scale, _padded(qv.q), qv.scale)
        op = decode_attention_q8
    else:
        aligned, moved, op = (k, v), (_padded(k), _padded(v)), \
            decode_attention
    assert moved[0].stride(2) * moved[0].element_size() % 16
    for window in (0, 40):
        assert torch.equal(op(q, *moved, lengths, window=window),
                           op(q, *aligned, lengths, window=window))


@pytest.mark.gpu
@pytest.mark.parametrize("q8", [False, True])
def test_cuda_decode_attention_repeats_and_second_stream(cuda, q8):
    """The merge's ticket counters are zero again after every launch: calls
    in a row, and calls on a second stream, give the same bits, one launch
    each (slots of 1 to 18 chunks)."""
    q, k, v = _decode_case(cuda, 3, 1100, 8, 4, 80)
    lengths = torch.tensor([1100, 700, 65], dtype=torch.int32, device=cuda)
    if q8:
        qk, qv = quantize_kv(k), quantize_kv(v)
        op = decode_attention_q8
        run = lambda: op(q, qk.q, qk.scale, qv.q, qv.scale, lengths)
    else:
        op = decode_attention
        run = lambda: op(q, k, v, lengths)
    first = run()
    before = op.launches
    for _ in range(3):
        assert torch.equal(run(), first)
    assert op.launches == before + 3
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        for _ in range(2):
            assert torch.equal(run(), first)
    torch.cuda.current_stream(cuda).wait_stream(side)
    assert torch.equal(run(), first)
    assert op.launches == before + 6


@pytest.mark.gpu
def test_cuda_decode_attention_runs_on_every_card(cuda):
    """The launch goes to each tensor's card, with its own counters and
    scratch, and an entry past 48 KB of shared memory (f32, D = 128,
    64-row chunks) opts in on each card, not only on the first."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs a second NVIDIA GPU")
    q, k, v = _decode_case("cpu", 2, 1100, 8, 2, 128)
    lengths = torch.tensor([1100, 200], dtype=torch.int32)
    want = None
    for i in range(torch.cuda.device_count()):
        dev = torch.device("cuda", i)
        args = [t.to(dev) for t in (q, k, v, lengths)]
        for _ in range(2):
            got = decode_attention(*args)
            assert got.device == dev
            assert _attn_ratio(got, decode_attention_ref(
                args[0][:, 0], *args[1:])[:, None]) <= 1
            want = got.cpu() if want is None else want
            assert torch.equal(got.cpu(), want)


# Logits of a tiny model (|x| < ~1) on the card and the CPU: fp32 matmuls
# of at most 256 terms, summed in other orders, a few ulps apart per op.
MODEL_TOL = 1e-4


@pytest.mark.gpu
def test_cuda_model_attention_runs_the_kernels_and_matches_the_cpu(cuda):
    """A head-dim-80 model: prefill, decode with per-slot lengths and
    encode on the card launch K5 / K6 in every layer and agree with the
    same weights on the CPU."""
    cfg = dataclasses.replace(get_config("sheared-llama-2.7b"), num_layers=2,
                              d_model=160, num_heads=2, num_kv_heads=2,
                              head_dim=80, d_ff=256, vocab_size=512)
    m_cpu = init_params(cfg, seed=0, device="cpu")
    m_card = init_params(cfg, seed=0, device="cpu").to(cuda)
    toks = torch.randint(0, 512, (3, 12),
                         generator=torch.Generator().manual_seed(1))
    c_cpu = init_cache(cfg, 3, 24, device=torch.device("cpu"))
    c_card = init_cache(cfg, 3, 24, device=cuda)
    f0, d0 = flash_attention.launches, decode_attention.launches
    l_cpu, _ = prefill(m_cpu, {"tokens": toks}, c_cpu)
    l_card, _ = prefill(m_card, {"tokens": toks.to(cuda)}, c_card)
    assert float((l_card.cpu() - l_cpu).abs().max()) <= MODEL_TOL
    lens = torch.tensor([12, 7, 3])
    for _ in range(3):
        nxt = l_cpu.argmax(-1, keepdim=True)
        l_cpu, _ = decode_step(m_cpu, nxt, c_cpu, lens)
        l_card, _ = decode_step(m_card, nxt.to(cuda), c_card, lens.to(cuda))
        assert float((l_card.cpu() - l_cpu).abs().max()) <= MODEL_TOL
        lens = lens + torch.tensor([1, 2, 1])
    e_cpu = encode(m_cpu, {"tokens": toks})
    e_card = encode(m_card, {"tokens": toks.to(cuda)})
    assert float((e_card.cpu() - e_cpu).abs().max()) <= MODEL_TOL
    assert flash_attention.launches - f0 == 2 * cfg.num_layers
    assert decode_attention.launches - d0 == 3 * cfg.num_layers


@pytest.mark.gpu
def test_cuda_attention_refusals_raise_and_the_next_launch_runs(cuda):
    q, k, v = _qkv(cuda, 1, 16, 16, 4, 4, 96)
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(q, k, v)
    with pytest.raises(ValueError, match="head dims"):
        decode_attention(q[:, :1], k, v, 16)
    q, k, v = _qkv(cuda, 2, 16, 16, 4, 4, 64)
    with pytest.raises(ValueError, match=">= 1"):
        decode_attention(q[:, :1], k, v, 0)
    with pytest.raises(ValueError, match=">= 1"):
        decode_attention(q[:, :1], k, v, torch.tensor([3, 0], device=cuda))
    # the model on the card refuses a logit softcap (no kernel has one)
    cfg = dataclasses.replace(get_config("sheared-llama-2.7b").reduced(
        num_layers=1, d_model=128), attn_logit_softcap=30.0)
    toks = torch.zeros((1, 8), dtype=torch.long, device=cuda)
    with pytest.raises(NotImplementedError, match="softcap"):
        prefill(init_params(cfg, device=cuda), {"tokens": toks},
                init_cache(cfg, 1, 8, device=cuda))
    out = flash_attention(q, k, v)
    assert torch.equal(out, flash_attention(q, k, v))
    assert _attn_ratio(out, _flash_plain(q, k, v, True, 0)) <= 1
    one = decode_attention(q[:, :1], k, v, 16)
    assert _attn_ratio(one, decode_attention_ref(q[:, 0], k, v, 16)[:, None]
                       ) <= 1


# ---------------------------------------------------------------------------
# the int8-cache decode kernel (K7), only on the card
# ---------------------------------------------------------------------------
def _q8_case(dev, b, smax, h, kh, d, dtype=torch.float32, seed=2):
    q, k, v = _qkv(dev, b, 1, smax, h, kh, d, torch.float32, seed)
    return q.to(dtype), quantize_kv(k), quantize_kv(v)


@pytest.mark.gpu
@pytest.mark.parametrize("b,smax,h,kh,d,lens,window,dtype", DECODE_CASES)
def test_cuda_decode_attention_q8_matches_plain_and_k6_on_dequant(
        cuda, b, smax, h, kh, d, lens, window, dtype):
    """K7 against its plain version, and against K6 on the dequantized
    cache (the JAX package's contract, ``tests/test_quantization.py``)."""
    q, qk, qv = _q8_case(cuda, b, smax, h, kh, d, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    before = decode_attention_q8.launches
    out = decode_attention_q8(q, qk.q, qk.scale, qv.q, qv.scale, lengths,
                              window=window)
    assert decode_attention_q8.launches == before + 1
    ref = decode_attention_q8_ref(q[:, 0], qk.q, qk.scale, qv.q, qv.scale,
                                  lengths, window=window)[:, None]
    assert out.shape == ref.shape and out.dtype == dtype
    assert _attn_ratio(out, ref) <= 1
    if dtype == torch.float32:     # K6 takes a cache of q's dtype
        k6 = decode_attention(q, dequantize_kv(qk), dequantize_kv(qv),
                              lengths, window=window)
        assert _attn_ratio(out, k6) <= 1
    if len(set(lens)) == 1:
        assert torch.equal(decode_attention_q8(
            q, qk.q, qk.scale, qv.q, qv.scale, lens[0], window=window), out)


@pytest.mark.gpu
@pytest.mark.parametrize("window", [0, 24])
def test_cuda_decode_attention_q8_batch_equals_sequential(cuda, window):
    q, qk, qv = _q8_case(cuda, 6, 160, 16, 4, 80)
    lengths = torch.tensor([160, 1, 33, 97, 150, 64], dtype=torch.int32,
                           device=cuda)
    out = decode_attention_q8(q, qk.q, qk.scale, qv.q, qv.scale, lengths,
                              window=window)
    for i in range(6):
        s = slice(i, i + 1)
        one = decode_attention_q8(q[s], qk.q[s], qk.scale[s], qv.q[s],
                                  qv.scale[s], lengths[s], window=window)
        assert torch.equal(one[0], out[i]), i


@pytest.mark.gpu
@pytest.mark.parametrize("b,smax,h,kh,d,lens,window,dtype",
                         [c for c in DECODE_CASES if c[-1] == torch.float32])
def test_cuda_decode_attention_q8_gives_k6_bits_on_the_dequantized_cache(
        cuda, b, smax, h, kh, d, lens, window, dtype):
    """K7 widens each element as float(k_q) * scale before K6's arithmetic,
    in K6's split of the cache, so the two agree bitwise."""
    q, qk, qv = _q8_case(cuda, b, smax, h, kh, d, dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    assert torch.equal(
        decode_attention_q8(q, qk.q, qk.scale, qv.q, qv.scale, lengths,
                            window=window),
        decode_attention(q, dequantize_kv(qk), dequantize_kv(qv), lengths,
                         window=window))


@pytest.mark.gpu
def test_cuda_quantize_kv_equals_the_cpu_bitwise(cuda):
    """Scales and codes on the card equal the CPU's (and so the JAX
    package's, ``tests/test_torch_quantization.py``)."""
    x = _qkv("cpu", 2, 1, 300, 1, 32, 80, seed=4)[1] * 2.5
    card, cpu = quantize_kv(x.to(cuda)), quantize_kv(x)
    assert torch.equal(card.scale.cpu(), cpu.scale)
    assert torch.equal(card.q.cpu(), cpu.q)


@pytest.mark.gpu
def test_cuda_decode_attention_q8_refusals_raise_and_the_next_launch_runs(
        cuda):
    q, qk, qv = _q8_case(cuda, 2, 64, 4, 2, 64)
    lens = torch.tensor([64, 9], dtype=torch.int32, device=cuda)
    good = decode_attention_q8(q, qk.q, qk.scale, qv.q, qv.scale, lens)
    bad = [
        (TypeError, (q, qk.q.float(), qk.scale, qv.q.float(), qv.scale, 8)),
        (TypeError, (q, qk.q, qk.scale.half(), qv.q, qv.scale.half(), 8)),
        (ValueError, (q, qk.q, qk.scale[:, :, :1], qv.q, qv.scale, 8)),
        (ValueError, (q, qk.q, qk.scale[..., 0], qv.q, qv.scale, 8)),
        (ValueError, (q, qk.q, qk.scale, qv.q, qv.scale, 0)),
        (ValueError, (q, qk.q, qk.scale, qv.q, qv.scale,
                      torch.tensor([3, 0], device=cuda))),
    ]
    for exc, args in bad:
        with pytest.raises(exc):
            decode_attention_q8(*args)
        assert torch.equal(decode_attention_q8(q, qk.q, qk.scale, qv.q,
                                               qv.scale, lens), good)
    q96, k96, v96 = _q8_case(cuda, 1, 16, 4, 4, 96)
    with pytest.raises(ValueError, match="head dims"):
        decode_attention_q8(q96, k96.q, k96.scale, v96.q, v96.scale, 16)
