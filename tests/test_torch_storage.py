"""The port's storage tier (``repro_torch.core.storage``, with
``repro_torch.models.quantization``) against the JAX package.

* ``quantize_rows`` / ``dequantize_rows`` are numpy on both sides: bitwise.
* Every codec (fp32 / fp16 / int8 / pq) in every mode (memory / disk /
  memmap) round-trips, and a port backend decodes exactly what a JAX
  backend decodes from the same rows (PQ on one carried-over codebook).
* A root written by one package reads back in the other, the PQ codebook
  file (``pq_codebook.npz``) and each blob's ``cbv`` stamp included.
* A stale ``cbv`` is quarantined without retries.
* ``(tenant, cid)`` keys in every mode, the shared byte budget and
  ``TenantStorageView`` behave as the JAX package's, and a root holding
  several tenants' blobs reads back in the other package.
* Byte accounting equals the JAX package's for the same payloads, and the
  memmap mode keeps the reference's lifecycle contract (views, no leaked
  handles, nothing left behind).
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import pq as jpq  # noqa: E402
from repro.core.storage import StorageBackend as JaxStorage  # noqa: E402
from repro.models.quantization import dequantize_rows as jax_dequant  # noqa: E402
from repro.models.quantization import quantize_rows as jax_quant  # noqa: E402
from repro_torch.convert import pq_codebook_from_numpy  # noqa: E402
from repro_torch.core.faults import IOOutcome  # noqa: E402
from repro_torch.core.storage import (StaleCodebookError,  # noqa: E402
                                      StorageBackend, TenantStorageView)
from repro_torch.models.quantization import dequantize_rows, quantize_rows  # noqa: E402

CODECS = ["fp32", "fp16", "int8", "pq"]
MODES = ["memory", "disk", "memmap"]
M = 4


def _emb(n, d, seed):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(
        np.float32)


@pytest.mark.parametrize("case", ["normal", "tiny", "huge", "zeros",
                                  "one_column"])
def test_quantize_rows_bitwise_equal_to_jax(case):
    x = _emb(33, 20, 1)
    if case == "tiny":
        x = x * 1e-9                     # scales clamp at fp16's min normal
    elif case == "huge":
        x = x * 1e8                      # ... and at fp16's max
    elif case == "zeros":
        x = np.zeros_like(x)
    elif case == "one_column":
        x = x[:, :1]
    q, s = quantize_rows(x)
    jq, js = jax_quant(x)
    assert q.dtype == jq.dtype == np.int8 and s.dtype == js.dtype == np.float16
    assert np.array_equal(q, jq) and np.array_equal(s, js)
    assert np.array_equal(dequantize_rows(q, s), jax_dequant(jq, js))


def _pair(codec, mode, tmp_path, n=40, d=12):
    """A port and a JAX backend of one codec and mode, on separate roots,
    sharing one (JAX-trained) PQ codebook."""
    roots = ({side: str(tmp_path / side) for side in ("port", "jax")}
             if mode != "memory" else {})
    port = StorageBackend(mode, root=roots.get("port"), codec=codec,
                          pq_m=M, device="cpu")
    ref = JaxStorage(mode, root=roots.get("jax"), codec=codec, pq_m=M)
    if codec == "pq":
        jcb = ref.train_pq(_emb(300, d, 9), iters=4)
        port.install_pq(pq_codebook_from_numpy(
            np.asarray(jcb.codebooks), jcb.dim, jcb.version))
    return port, ref


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("codec", CODECS)
def test_codec_mode_round_trip_equals_jax(codec, mode, tmp_path):
    port, ref = _pair(codec, mode, tmp_path)
    x = _emb(40, 12, 2)
    assert port.put(5, x) == ref.put(5, x) > 0          # byte accounting
    assert port.stored_bytes(5) == ref.stored_bytes(5)
    got = port.get(5)
    assert got.dtype == np.float32 and got.shape == x.shape
    assert np.array_equal(got, ref.get(5))
    raw, jraw = port.get_many_raw([5, 6]), ref.get_many_raw([5, 6])
    assert raw[1] is None and jraw[1] is None
    assert raw[0].keys() == jraw[0].keys()
    for name in raw[0]:
        assert raw[0][name].dtype == jraw[0][name].dtype
        assert np.array_equal(raw[0][name], jraw[0][name])
        if mode == "memmap":
            assert isinstance(raw[0][name], np.memmap)
    assert port.payload_rows(raw[0]) == 40
    assert np.array_equal(port.decode(raw[0]), got)
    if codec == "fp32":
        assert np.array_equal(got, x)
    port.delete(5)
    assert 5 not in port and port.total_bytes() == 0


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("mode", ["disk", "memmap"])
def test_disk_root_written_by_one_package_reads_in_the_other(
        codec, writer, mode, tmp_path):
    root = str(tmp_path / "root")
    x = _emb(25, 12, 3)
    if writer == "port":
        w = StorageBackend(mode, root=root, codec=codec, pq_m=M,
                           device="cpu")
    else:
        w = JaxStorage(mode, root=root, codec=codec, pq_m=M)
    for key in (1, 4):
        w.put(key, x[key:])
    expect = {key: w.get(key) for key in (1, 4)}
    nbytes = w.total_bytes()
    del w                                        # the writer's claim ends
    if writer == "port":
        r = JaxStorage(mode, root=root, codec=codec, pq_m=M)
    else:
        r = StorageBackend(mode, root=root, codec=codec, pq_m=M,
                           device="cpu")
    assert sorted(r.keys()) == [1, 4] and r.total_bytes() == nbytes
    if codec == "pq":                            # restored from the root
        assert r.pq is not None and r.pq.version == 0
        assert os.path.exists(os.path.join(root, "pq_codebook.npz"))
    for key in (1, 4):
        assert np.array_equal(r.get(key), expect[key])
    assert r.io_stats["verified"] == 2 and r.io_stats["corrupt_dropped"] == 0


@pytest.mark.parametrize("mode", MODES)
def test_stale_codebook_blob_is_quarantined_without_retries(mode, tmp_path):
    st = StorageBackend(mode, root=str(tmp_path) if mode != "memory"
                        else None, codec="pq", pq_m=M, device="cpu")
    x = _emb(60, 12, 4)
    st.train_pq(x, iters=2)
    st.put(3, x)
    st.train_pq(x, iters=2, seed=1)              # version 0 -> 1
    assert st.pq.version == 1
    with pytest.raises(StaleCodebookError):
        st._read_once(3, IOOutcome(3))
    assert st.get_many([3]) == [None]
    assert st.io_stats["corrupt_dropped"] == 1
    assert st.io_stats["retries"] == 0 and st.io_stats["exhausted"] == 1
    assert 3 not in st
    st.put(3, x)                                 # re-encoded under v1
    assert int(np.asarray(st.get_many_raw([3])[0]["cbv"])[0]) == 1


def test_stale_blob_matches_jax_reader(tmp_path):
    """A blob the JAX package stamped with an old version is stale to a
    port reader on the retrained root too."""
    root = str(tmp_path)
    ref = JaxStorage("disk", root=root, codec="pq", pq_m=M)
    x = _emb(60, 12, 5)
    ref.put(2, x)                                # lazily trains v0
    ref.train_pq(x, iters=2)                     # v1 on disk
    del ref
    port = StorageBackend("disk", root=root, codec="pq", pq_m=M,
                          device="cpu")
    assert port.pq.version == 1
    assert port.get_many([2]) == [None]
    assert port.io_stats["corrupt_dropped"] == 1 and 2 not in port


@pytest.mark.parametrize("codec", CODECS)
def test_byte_accounting_equals_jax_and_reads_no_payload(codec, tmp_path):
    port, ref = _pair(codec, "memmap", tmp_path)
    for key in range(4):
        x = _emb(10 + 7 * key, 12, key)
        assert port.put(key, x) == ref.put(key, x)
    assert port.total_bytes() == ref.total_bytes()
    # a fresh reader counts the same bytes from os.stat alone
    fresh = StorageBackend("memmap", root=port.root, codec=codec, pq_m=M,
                           device="cpu")
    assert fresh.total_bytes() == port.total_bytes()
    assert fresh.io_stats["reads"] == 0
    mem_port, mem_ref = _pair(codec, "memory", tmp_path / "m")
    x = _emb(30, 12, 6)
    assert mem_port.put(0, x) == mem_ref.put(0, x)
    assert mem_port.total_bytes() == mem_ref.total_bytes()


@pytest.mark.parametrize("n,d", [(5, 8), (30, 15), (64, 33)])
def test_memmap_lifecycle(tmp_path, n, d):
    """The reference's memmap contract: reads are views, repeated reads
    leak no file handle, delete and clear leave no blob behind."""
    s = StorageBackend("memmap", root=str(tmp_path), codec="pq", pq_m=M,
                       device="cpu")
    x = _emb(n, d, n + d)
    nbytes = s.put(3, x)
    assert s.total_bytes() == nbytes == s.stored_bytes(3)
    raw = s.get_many_raw([3])[0]
    assert isinstance(raw["codes"], np.memmap)
    assert not raw["codes"].flags.writeable
    before = len(os.listdir("/proc/self/fd"))
    for _ in range(8):
        got = s.get_many_raw([3])[0]["codes"]
        assert got.shape == (n, s.pq.m)
        del got
    assert len(os.listdir("/proc/self/fd")) <= before + 1
    s.delete(3)
    assert 3 not in s and s.total_bytes() == 0
    s.put(4, x)
    s.clear()
    assert s.total_bytes() == 0
    assert [f for f in os.listdir(str(tmp_path)) if f.endswith(".npz")] == []
    assert s.pq is not None                     # kept in memory for rebuilds


@pytest.mark.parametrize("kw", [dict(codec="fp64"), dict(mode="mmap")])
def test_unknown_codec_or_mode_raises(kw):
    with pytest.raises(ValueError):
        StorageBackend(**kw)


# ----------------------------------------------------------------------
# multi-tenancy: (tenant, cid) keys, the shared budget, tenant views
# ----------------------------------------------------------------------
def _both(mode, tmp_path, **kw):
    """A port and a JAX backend of one mode, on separate roots."""
    roots = ({side: str(tmp_path / side) for side in ("port", "jax")}
             if mode != "memory" else {})
    return (StorageBackend(mode, root=roots.get("port"), device="cpu", **kw),
            JaxStorage(mode, root=roots.get("jax"), **kw))


@pytest.mark.parametrize("mode", MODES)
def test_tuple_keys_namespace_tenants(mode, tmp_path):
    """(tenant, cid) keys coexist with bare-int keys, as in the JAX
    package: on disk they land in tenant_<name>/ subdirectories and
    ``keys()`` lists both forms; the same cid of two tenants is two
    blobs."""
    a, b = _emb(6, 12, 1), _emb(7, 12, 2)
    for s in _both(mode, tmp_path):
        s.put(3, _emb(5, 12, 0))
        s.put(("alice", 3), a)
        s.put(("bob", 3), b)                 # same cid, different tenant
        assert set(s.keys()) == {3, ("alice", 3), ("bob", 3)}
        assert np.array_equal(s.get(("alice", 3)), a)
        assert np.array_equal(s.get(("bob", 3)), b)
        if mode != "memory":
            assert os.path.exists(
                os.path.join(s.root, "tenant_alice", "cluster_3.npz"))
        s.delete(("alice", 3))
        assert ("alice", 3) not in s and ("bob", 3) in s and 3 in s
    port, ref = _both(mode, tmp_path / "bytes")
    for s in (port, ref):
        s.put(("alice", 1), a)
        s.put(("bob", 1), b)
    assert port.tenant_bytes("alice") == ref.tenant_bytes("alice") > 0
    assert port.total_bytes() == ref.total_bytes()


def test_shared_budget_refuses_put():
    """``budget_bytes`` is one quota over every tenant's keys: an
    over-budget put stores nothing, returns 0 and counts in
    ``put_rejected``; re-putting a key charges only the difference."""
    emb = _emb(10, 64, 3)                    # 2560 B fp32
    out = []
    for s in _both("memory", None, budget_bytes=3 * emb.nbytes):
        got = [s.put(("a", 0), emb), s.put(("a", 1), emb),
               s.put(("b", 0), emb), s.put(("b", 1), emb)]
        assert got == [emb.nbytes] * 3 + [0]
        assert ("b", 1) not in s and s.io_stats["put_rejected"] == 1
        assert s.total_bytes() == 3 * emb.nbytes
        assert s.put(("a", 0), emb) == emb.nbytes
        assert s.total_bytes() == 3 * emb.nbytes
        out.append((got, dict(s.io_stats), s.tenant_bytes("a")))
    assert out[0] == out[1]


@pytest.mark.parametrize("mode", MODES)
def test_tenant_view_scopes_keys_and_clear(mode, tmp_path):
    """A view rewrites ids to its tenant's keys and scopes ``keys`` /
    ``clear`` / ``total_bytes`` to them; the backend's ``mode``, ``codec``,
    ``root``, ``device``, ``io_stats`` and ``faults`` show through."""
    shared = StorageBackend(mode, root=str(tmp_path) if mode != "memory"
                            else None, device="cpu")
    va, vb = TenantStorageView(shared, "a"), TenantStorageView(shared, "b")
    ea, eb = _emb(4, 12, 1), _emb(9, 12, 2)
    va.put(0, ea)
    va.put(1, ea)
    vb.put(0, eb)
    assert sorted(va.keys()) == [0, 1] and vb.keys() == [0]
    assert np.array_equal(vb.get(0), eb)          # no cross-tenant bleed
    sa, sb = shared.stored_bytes(("a", 0)), shared.stored_bytes(("b", 0))
    assert sa >= ea.nbytes and sb >= eb.nbytes
    assert va.total_bytes() == 2 * sa and vb.total_bytes() == sb
    assert va.stored_bytes(1) == sa
    with pytest.raises(KeyError):
        vb.get(1)                                 # a's cid 1 is invisible
    out = vb.get_many([0, 1])
    assert np.array_equal(out[0], eb) and out[1] is None
    raw = vb.get_many_raw([0])[0]
    assert vb.payload_rows(raw) == 9 and np.array_equal(vb.decode(raw), eb)
    assert (va.mode, va.codec, va.root, va.device, va.io_stats) == \
        (shared.mode, shared.codec, shared.root, shared.device,
         shared.io_stats)
    va.faults = "injector"
    assert shared.faults == "injector"
    shared.faults = None
    va.clear()                                    # scoped: b untouched
    assert va.keys() == [] and vb.keys() == [0]
    assert shared.tenant_bytes("a") == 0 and shared.tenant_bytes("b") == sb


@pytest.mark.parametrize("codec", ["fp32", "pq"])
@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("mode", ["disk", "memmap"])
def test_tenant_root_written_by_one_package_reads_in_the_other(
        codec, writer, mode, tmp_path):
    """Two tenants' blobs (colliding cids) written under one root by one
    package read back, key for key and byte for byte, in the other, whose
    ``clear`` then sweeps the crashed puts' temp files in the tenant
    directories."""
    root = str(tmp_path / "root")
    x = _emb(25, 12, 3)
    if writer == "port":
        w = StorageBackend(mode, root=root, codec=codec, pq_m=M,
                           device="cpu")
    else:
        w = JaxStorage(mode, root=root, codec=codec, pq_m=M)
    for i, key in enumerate((1, ("a", 1), ("a", 4), ("b", 1))):
        w.put(key, x[i:])
    expect = {key: w.get(key) for key in w.keys()}
    per = {t: w.tenant_bytes(t) for t in ("a", "b")}
    del w                                        # the writer's claim ends
    if writer == "port":
        r = JaxStorage(mode, root=root, codec=codec, pq_m=M)
    else:
        r = StorageBackend(mode, root=root, codec=codec, pq_m=M,
                           device="cpu")
    assert sorted(r.keys(), key=str) == sorted(expect, key=str)
    assert {t: r.tenant_bytes(t) for t in ("a", "b")} == per
    for key, want in expect.items():
        assert np.array_equal(r.get(key), want)
    stale = tmp_path / "root" / "tenant_b" / "cluster_9.npz.tmp"
    stale.write_bytes(b"torn")
    r.clear()
    assert r.keys() == [] and not stale.exists()
