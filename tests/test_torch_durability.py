"""The port's crash-consistent durability (``repro_torch.core.durability``)
against the JAX package's, at ``tests/test_durability_properties.py``'s
size (dim 16, 60 records, nlist 5).

Bytes: ``pack_record`` and the WAL frames are byte-equal to the JAX
package's for the same records, and a torn tail or one flipped bit (the
reference's five flips) truncates the log to its valid prefix.

Cross-package recovery, both ways: one package's index with a durability
handle runs a seeded op stream on a disk root (dropped, or cut by a
``CrashInjector``), and the other package recovers it (the port with
``device="cpu"``).  The recovered state (membership, cluster fields,
centroids, chunk maps, the Alg. 3 threshold, the blob manifest) is bitwise
the dropped writer's; the ``RecoveryReport`` equals the writer package's
own recovery of a copy of the root field for field (``wall_s`` aside); the
two recovered roots hold byte-equal files; search ids agree outside
near-ties, scores within ``TOL``.  The same for a router root written by
the JAX package.  States are compared, never two separately trained
k-means runs.

Inside the port: the crash grid (every ``CRASH_POINTS`` entry x fp32 /
fp16 / int8 / pq on disk and fp32 memmap, ``at=2``, seed 11, and the
first-occurrence case) lands on the crashed op's pre- or post-op prefix,
held by state and by search against memory-mode indexes that ran that
prefix with no crash, at the same batch shape; replay is idempotent; a
checkpoint bumps no generation and compacts the WAL; ``RecoveryError``
with nothing durable; ``recover_router`` restores every tenant and refuses
a missing spec; the resolver's self-heal writes one record that recovery
then trusts.  The Hypothesis properties run with ``database=None``, so
nothing is written to ``.hypothesis/``.  On the card (``gpu``): a
CPU-written root recovered onto the card.
"""
import gc
import os
import shutil
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import CrashInjector as JaxCrash  # noqa: E402
from repro.core import Durability as JaxDurability  # noqa: E402
from repro.core import EdgeRAGIndex as JaxIndex  # noqa: E402
from repro.core import SimulatedCrash as JaxSimulatedCrash  # noqa: E402
from repro.core import TenantRouter as JaxRouter  # noqa: E402
from repro.core import WriteAheadLog as JaxWAL  # noqa: E402
from repro.core import recover as jax_recover  # noqa: E402
from repro.core import recover_router as jax_recover_router  # noqa: E402
from repro.core import durability as jax_durability  # noqa: E402
from repro_torch.core import (CRASH_POINTS, OP_CHECKPOINT,  # noqa: E402
                              CrashInjector, Durability, EdgeRAGIndex,
                              RecoveryError, SimulatedCrash, TenantRouter,
                              WriteAheadLog, recover, recover_router)
from repro_torch.core.durability import (IndexSnapshot,  # noqa: E402
                                         _replay_record, pack_record,
                                         unpack_record)
from repro_torch.data import generate_dataset  # noqa: E402

try:
    from hypothesis import Phase, given, settings, strategies as st
    HAVE_HYPOTHESIS = True
except ImportError:                     # pragma: no cover
    HAVE_HYPOTHESIS = False

DIM, NLIST, SLO, SPLIT = 16, 5, 0.004, 4000
DS = generate_dataset(n_records=60, dim=DIM, n_topics=4, n_queries=4,
                      seed=7)
# the application's chunk store, which get_chunks reads: an op's text
# (NEW_TEXTS) is written to it as the op runs
TEXTS = {int(i): t for i, t in zip(DS.chunk_ids, DS.texts)}
_ORIG_TEXTS = dict(TEXTS)
NEW_TEXTS = {}
# every index of the file on the same knobs: a low SLO stores most
# clusters, a low split bound lets fat inserts split
KW = dict(slo_s=SLO, split_max_chars=SPLIT, maintenance="sync")
# A dropped index (the crashed process) is ``del``-ed and collected before
# its root is recovered: the index <-> scheduler cycle pins the root's
# process-wide writer claim until the collector runs.


def embed_fn(ts):
    """Deterministic in the text alone (crc32 seeds), in every process."""
    out = np.zeros((len(ts), DIM), np.float32)
    for j, t in enumerate(ts):
        out[j] = np.random.default_rng(
            zlib.crc32(t.encode())).standard_normal(DIM)
    return out / np.linalg.norm(out, axis=1, keepdims=True)


def get_chunks(ids):
    return [TEXTS[int(i)] for i in ids]


CORPUS_EMB = embed_fn(list(DS.texts))
QUERIES = embed_fn(["durable query one", "durable query two"])
# two fp32 sums of the same D products in different orders differ by at
# most 2 * D * 2**-24 * sum|q_i e_i| (test_torch_kernels._tol); unit rows
TOL = 2 * DIM * 2.0 ** -24 * float(np.abs(QUERIES).sum(axis=1).max())


def make_ops(n_insert, n_remove, n_update, seed):
    """The reference's deterministic mutation sequence (its draws): the
    inserted and updated texts go to NEW_TEXTS, and TEXTS is reset to the
    corpus.  Inserted texts are fat enough that some ops cross the store
    / split bounds."""
    NEW_TEXTS.clear()
    rng = np.random.default_rng(seed)
    ops = []
    for j in range(n_insert):
        nid = 50_000 + seed * 1000 + j
        NEW_TEXTS[nid] = (f"inserted chunk {seed}/{j} "
                          * int(rng.integers(5, 40)))
        ops.append(("ins", nid))
    for i in rng.choice(DS.chunk_ids, size=n_remove, replace=False):
        ops.append(("rm", int(i)))
    for i in rng.choice(DS.chunk_ids[n_remove:], size=n_update,
                        replace=False):
        NEW_TEXTS[int(i)] = (f"updated text {seed} "
                             * int(rng.integers(5, 30)))
        ops.append(("up", int(i)))
    rng.shuffle(ops)
    set_texts([], 0)
    return [tuple(op) for op in ops]


def set_texts(ops, j):
    """TEXTS as the store holds them after ``ops[:j]``."""
    TEXTS.clear()
    TEXTS.update(_ORIG_TEXTS)
    TEXTS.update((i, NEW_TEXTS[i]) for kind, i in ops[:j] if kind != "rm")


def apply_op(ix, op):
    """Writes the op's text to the store, then runs the op; returns the
    op's result (None: it found no chunk and logged nothing)."""
    kind, i = op
    if kind == "rm":
        return ix.remove(i)
    TEXTS[i] = NEW_TEXTS[i]
    return (ix.insert if kind == "ins" else ix.update)(i, TEXTS[i])


def build(pkg="port", codec="fp32", mode="disk", root=None, **kw):
    kw = {**KW, **kw}
    if pkg == "jax":
        ix = JaxIndex(DIM, embed_fn, get_chunks, storage_mode=mode,
                      storage_root=root, storage_codec=codec, **kw)
    else:
        ix = EdgeRAGIndex(DIM, embed_fn, get_chunks, storage_mode=mode,
                          storage_root=root, storage_codec=codec,
                          device="cpu", **kw)
    ix.build(DS.chunk_ids, DS.texts, nlist=NLIST, embeddings=CORPUS_EMB)
    return ix


def state(ix):
    """Everything durable, exactly: cluster fields, centroids, chunk maps,
    the Alg. 3 threshold, the blob manifest and the codec."""
    thr = ix.threshold
    return {
        "clusters": [(np.asarray(c.ids, np.int64).tobytes(), c.char_count,
                      c.gen_latency_est, c.stored, c.active, c.generation,
                      c.content_generation, c.stored_generation)
                     for c in ix.clusters],
        "centroids": np.asarray(ix.centroids, np.float32).tobytes(),
        "chunk_cluster": sorted(ix._chunk_cluster.items()),
        "chunk_chars": sorted(ix._chunk_chars.items()),
        "threshold": (thr.threshold, thr.step_s, thr.alpha,
                      thr.moving_avg_latency, thr._initialized),
        "manifest": {cid: ix.storage.payload_crc(cid)
                     for cid, c in enumerate(ix.clusters) if c.stored},
        "codec": ix.storage.codec,
        "pq_version": (None if ix.storage.pq is None
                       else int(ix.storage.pq.version)),
    }


def content_sig(ix):
    """Content identity and search at one batch shape.  ``generation``
    and ``stored_generation`` (storage-event stamps) stay out: recovery's
    self-heal bumps them when it regenerates a lost blob, content aside."""
    ids, vals, _ = ix.search_batch(QUERIES, 6, 3)
    return (
        tuple((np.asarray(c.ids, np.int64).tobytes(), c.char_count,
               c.gen_latency_est, c.stored, c.active, c.content_generation)
              for c in ix.clusters),
        np.asarray(ix.centroids, np.float32).tobytes(),
        tuple(sorted(ix._chunk_cluster.items())),
        tuple(sorted(ix._chunk_chars.items())),
        np.asarray(ids).tobytes(), np.asarray(vals).tobytes())


def report_fields(rep):
    return {k: v for k, v in rep.as_dict().items() if k != "wall_s"}


def tree_bytes(root):
    """Every file under ``root`` by relative path."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_near(p_ids, p_vals, r_ids, r_vals):
    """Scores within TOL; an id may differ only beside a score within
    2 x TOL."""
    p_ids, p_vals = np.asarray(p_ids), np.asarray(p_vals)
    r_ids, r_vals = np.asarray(r_ids), np.asarray(r_vals)
    np.testing.assert_allclose(p_vals, r_vals, rtol=0, atol=TOL)
    for qi, lane in zip(*np.nonzero(p_ids != r_ids)):
        v = p_vals[qi]
        assert any(abs(v[lane] - v[j]) <= 2 * TOL
                   for j in (lane - 1, lane + 1) if 0 <= j < len(v)), \
            (qi, lane)


# ----------------------------------------------------------------------
# bytes: records, frames, truncation
# ----------------------------------------------------------------------
RECORDS = [
    {"lsn": 3, "op": "x", "s": "text", "none": None,
     "a": np.arange(12, dtype=np.float32).reshape(3, 4) / 7,
     "nested": {"ids": np.array([5, -2], np.int64),
                "deep": [np.float32(0.1), np.int64(7), None,
                         {"z": np.zeros((0, 2), np.float32)}]}},
    {"lsn": 1, "op": "insert", "nlist": 5, "gone": [], "pq_version": None,
     "clusters": [{"cid": 2, "ids": np.array([1, 9], np.int64),
                   "centroid": np.float32([0.5, -1e-30, 3.4e38]),
                   "gen_latency_est": 0.1 + 0.2, "stored": True,
                   "blob_crc": None}]},
    {"lsn": 2, "op": "remove", "gone": [4, 8], "pq_version": 3,
     "clusters": [], "neg": -0.0, "big": 2 ** 53 + 1},
]


@pytest.mark.parametrize("j", range(len(RECORDS)))
def test_pack_record_bytes_equal_reference(j):
    rec = RECORDS[j]
    body = pack_record(rec)
    assert body == jax_durability.pack_record(rec)
    out = unpack_record(body)
    ref = jax_durability.unpack_record(body)
    assert pack_record(out) == pack_record(ref) == body
    if "a" in rec:
        assert out["a"].dtype == np.float32
        assert np.array_equal(out["a"], rec["a"])
        assert np.array_equal(out["nested"]["ids"], rec["nested"]["ids"])
        assert out["none"] is None and out["s"] == "text"


def test_no_tensor_is_serialized():
    """Durable state is host numpy: a torch tensor in a record is refused
    rather than written in some other form."""
    with pytest.raises(TypeError):
        pack_record({"lsn": 1, "centroid": torch.zeros(3)})


def _wal_bodies(seed):
    rng = np.random.default_rng(seed)
    return [pack_record({"lsn": j, "op": "t", "nlist": 0, "gone": [],
                         "pq_version": None, "clusters": [],
                         "pad": rng.integers(0, 9, 4).tolist()})
            for j in range(1, 6)]


def test_wal_files_byte_identical(tmp_path):
    bodies = _wal_bodies(0)
    port, ref = (WriteAheadLog(str(tmp_path / "port.log")),
                 JaxWAL(str(tmp_path / "jax.log")))
    for b in bodies:
        assert port.append(b) == ref.append(b)
    assert (tmp_path / "port.log").read_bytes() \
        == (tmp_path / "jax.log").read_bytes()
    assert port.nbytes() == ref.nbytes() and port.frames()[0] == bodies
    port.rewrite(bodies[2:])
    ref.rewrite(bodies[2:])
    assert (tmp_path / "port.log").read_bytes() \
        == (tmp_path / "jax.log").read_bytes()
    assert [r["lsn"] for r in port.records()[0]] == [3, 4, 5]


def test_torn_tail_truncates(tmp_path):
    """A crash mid-append leaves a seeded prefix of the frame; reading
    stops before it, the cut drops exactly the torn bytes, as in the JAX
    package."""
    sizes = []
    for pkg, wal_cls, crash_cls in (("port", WriteAheadLog, CrashInjector),
                                    ("jax", JaxWAL, JaxCrash)):
        wal = wal_cls(str(tmp_path / f"{pkg}.log"))
        crash = crash_cls("wal_torn_append", at=4, seed=5)
        bodies = _wal_bodies(1)
        for b in bodies[:3]:
            wal.append(b, crash=crash)
        with pytest.raises((SimulatedCrash, JaxSimulatedCrash)):
            wal.append(bodies[3], crash=crash)
        frames, _, torn = wal.frames()
        assert torn and frames == bodies[:3]
        sizes.append((wal.nbytes(), wal.truncate_torn_tail(), wal.nbytes()))
        assert wal.frames() == (bodies[:3], wal.nbytes(), False)
        assert wal.truncate_torn_tail() == 0
    assert sizes[0] == sizes[1] and sizes[0][1] > 0


@pytest.mark.parametrize("frac,bit,seed", [(0.02, 0, 0), (0.3, 3, 1),
                                           (0.55, 7, 2), (0.85, 4, 3),
                                           (0.999, 1, 4)])
def test_bit_flip_truncates(tmp_path, frac, bit, seed):
    check_bit_flip(str(tmp_path), frac, bit, seed)


def check_bit_flip(root, frac, bit, seed):
    """One flipped bit past the magic fails exactly one frame's CRC; both
    packages read the same valid prefix and cut the same bytes."""
    cut = []
    for pkg, wal_cls in (("port", WriteAheadLog), ("jax", JaxWAL)):
        wal = wal_cls(os.path.join(root, f"{pkg}_flip.log"))
        if os.path.exists(wal.path):
            os.remove(wal.path)
        bodies = _wal_bodies(seed)
        for b in bodies:
            wal.append(b)
        data = bytearray(open(wal.path, "rb").read())
        pos = min(8 + int(frac * (len(data) - 8)), len(data) - 1)
        data[pos] ^= 1 << bit
        with open(wal.path, "wb") as f:
            f.write(bytes(data))
        frames, off, torn = wal.frames()
        assert torn and len(frames) < 5
        assert frames == bodies[:len(frames)]
        dropped = wal.truncate_torn_tail()
        assert dropped > 0 and wal.frames() == (frames, off, False)
        assert wal.truncate_torn_tail() == 0
        cut.append((len(frames), off, dropped))
    assert cut[0] == cut[1]


# ----------------------------------------------------------------------
# cross-package recovery
# ----------------------------------------------------------------------
def _write_root(pkg, root, point, seed=4):
    """``pkg``'s index with a durability handle runs make_ops(5, 3, 2)
    on ``root``, cut at the second ``point`` when one is given.  Returns
    the dropped writer's state when no crash cut it, else None."""
    dur_cls, crash_cls = ((JaxDurability, JaxCrash) if pkg == "jax"
                          else (Durability, CrashInjector))
    ops = make_ops(5, 3, 2, seed)
    ix = build(pkg, root=root)
    crash = None if point is None else crash_cls(point, at=2, seed=seed)
    ix.attach_durability(dur_cls(root, checkpoint_every=3, crash=crash))
    crashed = False
    for op in ops:
        try:
            apply_op(ix, op)
        except (SimulatedCrash, JaxSimulatedCrash):
            crashed = True
            break
    assert crashed == (point is not None)
    writer = None if crashed else state(ix)
    del ix
    gc.collect()
    return writer


def _recover(pkg, root):
    if pkg == "jax":
        return jax_recover(root, embed_fn, get_chunks, **KW)
    return recover(root, embed_fn, get_chunks, device="cpu", **KW)


@pytest.mark.parametrize("point", [None, "wal_pre_append",
                                   "wal_torn_append", "snap_pre_rename"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_root_recovers_in_the_other_package(tmp_path, writer, point):
    reader = "port" if writer == "jax" else "jax"
    root, copy = str(tmp_path / "root"), str(tmp_path / "copy")
    written = _write_root(writer, root, point)
    shutil.copytree(root, copy)
    got, rep = _recover(reader, root)
    own, own_rep = _recover(writer, copy)
    assert state(got) == state(own)
    if written is not None:
        assert state(got) == written
    assert report_fields(rep) == report_fields(own_rep)
    assert rep.tenant is None and rep.wall_s > 0
    assert tree_bytes(root) == tree_bytes(copy)
    (g_ids, g_vals, _), (o_ids, o_vals, _) = (got.search_batch(QUERIES, 6, 3),
                                              own.search_batch(QUERIES, 6, 3))
    assert_near(g_ids, g_vals, o_ids, o_vals)
    assert got.durability is not None and own.durability is not None
    del got, own
    gc.collect()


def _router(pkg, root):
    """Two tenants on one disk root, built and made durable."""
    if pkg == "jax":
        r = JaxRouter(DIM, slo_s=SLO, storage_mode="disk", storage_root=root)
    else:
        r = TenantRouter(DIM, slo_s=SLO, storage_mode="disk",
                         storage_root=root, device="cpu")
    for t in ("alpha", "beta"):
        r.create_tenant(t, embed_fn, get_chunks, **KW).build(
            DS.chunk_ids, DS.texts, nlist=NLIST, embeddings=CORPUS_EMB)
    r.enable_durability(checkpoint_every=4)
    for t, base in (("alpha", 80_000), ("beta", 90_000)):
        ix = r.tenants[t]
        for j in range(5):
            TEXTS[base + j] = f"tenant {t} chunk {j} " * 15
            ix.insert(base + j, TEXTS[base + j])
        ix.remove(int(DS.chunk_ids[0 if t == "alpha" else 1]))
    return r


def test_jax_router_root_recovers_in_the_port(tmp_path):
    make_ops(0, 0, 0, 0)
    root, copy = str(tmp_path / "root"), str(tmp_path / "copy")
    jr = _router("jax", root)
    written = {t: state(ix) for t, ix in jr.tenants.items()}
    del jr
    gc.collect()
    shutil.copytree(root, copy)
    specs = {t: (embed_fn, get_chunks) for t in written}
    pr, reps = recover_router(root, specs, router_kwargs={"device": "cpu"},
                              tenant_kwargs=KW)
    jr2, jreps = jax_recover_router(copy, specs, tenant_kwargs=KW)
    assert sorted(pr.tenants) == sorted(written) == ["alpha", "beta"]
    for t in written:
        assert state(pr.tenant(t)) == written[t] == state(jr2.tenant(t))
        assert report_fields(reps[t]) == report_fields(jreps[t])
        assert reps[t].tenant == t
        p = pr.tenant(t).search_batch(QUERIES, 6, 3)
        j = jr2.tenant(t).search_batch(QUERIES, 6, 3)
        assert_near(p[0], p[1], j[0], j[1])
    assert pr.device == torch.device("cpu")
    assert tree_bytes(root) == tree_bytes(copy)
    del pr, jr2
    gc.collect()


# ----------------------------------------------------------------------
# the port's crash grid
# ----------------------------------------------------------------------
_REF_CACHE = {}


def reference_sigs(ops, codec, seed):
    """content_sig of a memory-mode index after every prefix of ``ops``
    (same codec, same put sequence, so payloads quantize identically),
    and the WAL records a durable index would have logged by then."""
    key = (seed, codec, len(ops))
    if key not in _REF_CACHE:
        sigs, lsns = [], []
        for j in range(len(ops) + 1):
            set_texts(ops, 0)
            ix = build(codec=codec, mode="memory")
            took = [apply_op(ix, op) is not None for op in ops[:j]]
            sigs.append(content_sig(ix))
            lsns.append(sum(took))
            del ix
            gc.collect()
        _REF_CACHE[key] = sigs, lsns
    return _REF_CACHE[key]


def durable_lsn(root):
    """The LSN the durable files under ``root`` hold: the newest valid
    snapshot's or the last valid WAL record's past it (None without a
    valid snapshot)."""
    d = os.path.join(root, "durability")
    found = IndexSnapshot.newest_valid(d)
    if found is None:
        return None
    records = WriteAheadLog(os.path.join(d, "wal.log")).records()[0]
    return max([found[0]] + [int(r["lsn"]) for r in records])


def check_crash_atomicity(root, point, codec, mode, at, seed,
                          must_crash=True):
    """Crash at occurrence ``at`` of ``point``: recovery equals the prefix
    before or after the op that died, never a hybrid (the whole stream
    when the stream never reaches that occurrence).  Returns the
    ``RecoveryReport``, None when the crash killed the baseline.
    ``must_crash``: the stream does reach the occurrence.

    The store's texts follow the durable state: before recovery they are
    set to those of the prefix the durable files hold, as an application
    whose chunk store commits with the index's WAL record would hold
    them.  (A store that kept the text of an op whose record never landed
    would feed it to recovery's heal, and to every later regeneration,
    under the pre-op state: a hybrid the index cannot see.)"""
    ops = make_ops(5, 3, 2, seed)
    refs, lsns = reference_sigs(ops, codec, seed)
    set_texts(ops, 0)
    os.makedirs(root, exist_ok=True)
    crash = CrashInjector(point, at=at, seed=seed)
    ix = build(codec=codec, mode=mode, root=root)
    crashed_at, attach_crashed = None, False
    try:
        # a snap_* crash at occurrence 1 dies inside the baseline
        # checkpoint, before any op ran
        ix.attach_durability(Durability(root, checkpoint_every=3,
                                        crash=crash))
    except SimulatedCrash:
        attach_crashed = True
    if not attach_crashed:
        for j, op in enumerate(ops):
            try:
                apply_op(ix, op)
            except SimulatedCrash:
                crashed_at = j
                break
    assert crash.crashed or not must_crash
    del ix
    gc.collect()
    lsn = durable_lsn(root)
    if lsn is None:
        # only when the crash killed the baseline: nothing durable landed
        assert attach_crashed, f"{point}/{codec}/{mode}: no snapshot"
        with pytest.raises(RecoveryError):
            recover(root, embed_fn, get_chunks, storage_mode=mode,
                    device="cpu", **KW)
        return None
    held = [j for j, n in enumerate(lsns) if n == lsn]
    # the op that died leaves its pre- or post-op state; a baseline that
    # landed before its crash, the build; no crash, the whole stream
    if attach_crashed:
        want = {0}
    elif crashed_at is None:
        want = {len(ops)}
    else:
        want = {crashed_at, crashed_at + 1}
    assert want & set(held), \
        f"{point}/{codec}/{mode}: LSN {lsn} is no prefix in {sorted(want)}"
    set_texts(ops, held[0])
    ix2, rep = recover(root, embed_fn, get_chunks, storage_mode=mode,
                       device="cpu", **KW)
    assert rep.snapshot_lsn + rep.replayed_records == lsn
    assert content_sig(ix2) == refs[held[0]], \
        (f"{point}/{codec}/{mode}: a hybrid (not prefix {held[0]}; crashed "
         f"at op {crashed_at})")
    # the storage-event stamps move only on the clusters recovery healed
    set_texts(ops, 0)
    ref = build(codec=codec, mode="memory")
    for op in ops[:held[0]]:
        apply_op(ref, op)
    moved = [cid for cid, (a, b) in enumerate(zip(ix2.clusters,
                                                   ref.clusters))
             if (a.generation, a.stored_generation)
             != (b.generation, b.stored_generation)]
    assert len(moved) <= rep.healed, (moved, rep)
    del ix2, ref
    gc.collect()
    return rep


CODEC_ARMS = [("fp32", "disk"), ("fp16", "disk"), ("int8", "disk"),
              ("pq", "disk"), ("fp32", "memmap")]


@pytest.mark.parametrize("point", CRASH_POINTS)
@pytest.mark.parametrize("codec,mode", CODEC_ARMS)
def test_crashpoint_grid(tmp_path, point, codec, mode):
    rep = check_crash_atomicity(str(tmp_path), point, codec, mode, at=2,
                                seed=11)
    assert rep is not None
    if point == "wal_torn_append":
        assert rep.torn_bytes > 0


@pytest.mark.parametrize("point,recovers", [
    ("wal_pre_append", True), ("wal_torn_append", True),
    ("wal_post_append", True), ("snap_pre_tmp", False),
    ("snap_post_rename", True)])
def test_crashpoint_first_occurrence(tmp_path, point, recovers):
    """At occurrence 1 the wal_* points die in the first op (recovery
    lands on the build or that op's post-op state); the snap_* points die
    inside the baseline snapshot: before its rename recovery refuses
    rather than fabricate state, after it recovery lands on the build."""
    rep = check_crash_atomicity(str(tmp_path), point, "fp32", "disk", at=1,
                                seed=3)
    assert (rep is not None) == recovers


def test_recover_without_durable_state_raises(tmp_path):
    with pytest.raises(RecoveryError):
        recover(str(tmp_path), embed_fn, get_chunks, device="cpu")
    with pytest.raises(RecoveryError):
        recover_router(str(tmp_path), {}, router_kwargs={"device": "cpu"})


def check_replay_idempotent(root, seed):
    """The WAL suffix applied twice equals it applied once, and both the
    live state before the drop."""
    make_ops(0, 0, 0, 0)
    ix = build(root=root)
    dur = ix.attach_durability(Durability(root, checkpoint_every=10 ** 6))
    for op in make_ops(4, 2, 1, seed):
        apply_op(ix, op)
    records, _, torn = dur.wal.records()
    found = IndexSnapshot.newest_valid(dur.dir)
    assert records and not torn and found is not None
    pre = state(ix)
    del ix
    gc.collect()

    def replay(times):
        jx = EdgeRAGIndex(DIM, embed_fn, get_chunks, storage_mode="disk",
                          storage_root=root, device="cpu", **KW)
        applied, manifest = IndexSnapshot.apply(jx, found[1])
        for _ in range(times):
            cursor = applied
            for rec in records:
                if int(rec["lsn"]) <= cursor:
                    continue            # the idempotence mechanism
                _replay_record(jx, rec, manifest)
                cursor = int(rec["lsn"])
            applied = cursor
        out = {**state(jx), "manifest": manifest}
        del jx
        gc.collect()
        return out

    once, twice = replay(1), replay(2)
    assert once == twice == pre


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wal_replay_idempotent(tmp_path, seed):
    check_replay_idempotent(str(tmp_path), seed)


def test_checkpoint_bumps_no_generation_and_compacts(tmp_path):
    root = str(tmp_path)
    make_ops(0, 0, 0, 0)
    ix = build(root=root, maintenance="deferred")
    dur = ix.attach_durability(Durability(root, checkpoint_every=4))
    for op in make_ops(5, 2, 0, seed=5):
        apply_op(ix, op)
    assert any(op.kind == OP_CHECKPOINT for op in ix.maintenance.pending)
    snaps = dur.snapshots_total
    ix.maintenance.drain(None)
    assert dur.snapshots_total > snaps
    dur.records_since_snapshot = dur.checkpoint_every      # force one
    ix.maintenance.enqueue(OP_CHECKPOINT, -1)
    stamps = [(c.generation, c.content_generation) for c in ix.clusters]
    rep = ix.maintenance.drain(None)
    assert rep.executed == [(OP_CHECKPOINT, -1)] and rep.edge_s > 0.0
    assert stamps == [(c.generation, c.content_generation)
                      for c in ix.clusters]
    records, _, _ = dur.wal.records()
    assert records == [] and dur.records_since_snapshot == 0
    assert IndexSnapshot.lsns(dur.dir)[-1] == dur.next_lsn - 1
    assert len(IndexSnapshot.lsns(dur.dir)) == dur.keep_snapshots
    del ix
    gc.collect()


def test_recover_router_restores_every_tenant(tmp_path):
    make_ops(0, 0, 0, 0)
    root = str(tmp_path)
    r = _router("port", root)
    assert all(ix.durability.tenant == t for t, ix in r.tenants.items())
    assert os.path.isdir(os.path.join(root, "durability", "tenant_beta"))
    written = {t: state(ix) for t, ix in r.tenants.items()}
    pre = {t: ix.search_batch(QUERIES, 6, 3)[:2]
           for t, ix in r.tenants.items()}
    del r
    gc.collect()
    specs = {t: (embed_fn, get_chunks) for t in written}
    with pytest.raises(ValueError, match="spec"):
        recover_router(root, {"alpha": specs["alpha"]},
                       router_kwargs={"device": "cpu"})
    r2, reps = recover_router(root, specs, router_kwargs={"device": "cpu"},
                              tenant_kwargs=KW)
    assert set(reps) == set(written)
    for t in written:
        ix = r2.tenant(t)
        assert reps[t].tenant == t and ix.durability is not None
        assert state(ix)["clusters"] == written[t]["clusters"]
        assert state(ix)["manifest"] == written[t]["manifest"]
        ids, vals, _ = ix.search_batch(QUERIES, 6, 3)
        assert np.array_equal(ids, pre[t][0])
        assert np.array_equal(vals, pre[t][1])
    del r2
    gc.collect()


def test_self_heal_writes_one_record_and_recovery_uses_it(tmp_path):
    """A stored blob deleted behind the index: the next search regenerates
    and re-persists it as ONE ``self_heal`` record (its fsync charged to
    the owning query), and recovery then trusts that blob: nothing
    healed, nothing collected."""
    root = str(tmp_path)
    make_ops(0, 0, 0, 0)
    ix = build(root=root)
    dur = ix.attach_durability(Durability(root, checkpoint_every=64))
    probed = set().union(*ix._probe(QUERIES, 3))
    cid = min(c for c in probed if ix.clusters[c].stored)
    os.remove(ix.storage._path(cid))
    n0 = dur.records_total
    ids, vals, lats = ix.search_batch(QUERIES, 6, 3)
    records, _, _ = dur.wal.records()
    assert dur.records_total == n0 + 1
    assert [r["op"] for r in records] == ["self_heal"]
    assert [e["cid"] for e in records[0]["clusters"]] == [cid]
    crc = ix.storage.payload_crc(cid)
    assert records[0]["clusters"][0]["blob_crc"] == crc
    assert sum(lat.wal_fsync_s > 0 for lat in lats) == 1
    written = state(ix)
    del ix
    gc.collect()
    ix2, rep = recover(root, embed_fn, get_chunks, device="cpu", **KW)
    assert (rep.replayed_records, rep.healed, rep.orphans_gc) == (1, 0, 0)
    assert state(ix2) == {**written, "threshold": state(ix2)["threshold"]}
    assert ix2.durability.manifest[cid] == crc
    ids2, vals2, _ = ix2.search_batch(QUERIES, 6, 3)
    assert np.array_equal(ids, ids2) and np.array_equal(vals, vals2)
    del ix2
    gc.collect()


# ----------------------------------------------------------------------
# Hypothesis properties (database=None: nothing under .hypothesis/)
# ----------------------------------------------------------------------
if HAVE_HYPOTHESIS:
    # derandomized, so every run draws the same examples; no shrinking: a
    # failing example is reported as drawn (shrinking a crash-and-recover
    # example takes minutes)
    SETTINGS = dict(max_examples=4, deadline=None, database=None,
                    derandomize=True,
                    phases=(Phase.explicit, Phase.generate))

    @settings(**SETTINGS)
    @given(point=st.sampled_from(CRASH_POINTS),
           codec=st.sampled_from(["fp32", "fp16", "int8", "pq"]),
           at=st.integers(min_value=1, max_value=6),
           seed=st.integers(min_value=0, max_value=50))
    def test_hyp_crashpoint_atomicity(tmp_path_factory, point, codec, at,
                                      seed):
        root = str(tmp_path_factory.mktemp("hyp_crash"))
        check_crash_atomicity(root, point, codec, "disk", at, seed,
                              must_crash=False)

    @settings(**{**SETTINGS, "max_examples": 3})
    @given(seed=st.integers(min_value=0, max_value=100))
    def test_hyp_replay_idempotent(tmp_path_factory, seed):
        check_replay_idempotent(str(tmp_path_factory.mktemp("hyp_idem")),
                                seed)

    @settings(**{**SETTINGS, "max_examples": 15})
    @given(frac=st.floats(min_value=0.0, max_value=1.0),
           bit=st.integers(min_value=0, max_value=7),
           seed=st.integers(min_value=0, max_value=100))
    def test_hyp_bit_flip_truncates(tmp_path_factory, frac, bit, seed):
        check_bit_flip(str(tmp_path_factory.mktemp("hyp_flip")), frac, bit,
                       seed)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cpu_root_recovers_onto_the_card(cuda, tmp_path):
    """A root written by a CPU index recovers onto the card: state bitwise
    the writer's, search through K1 and K2 on the card against the CPU
    writer, ids outside near-ties and scores within TOL."""
    from repro_torch.kernels.ivf_topk import topk_ip
    from repro_torch.kernels.slab_topk import slab_topk
    root = str(tmp_path)
    ix = build(root=root)
    ix.attach_durability(Durability(root, checkpoint_every=3))
    for op in make_ops(5, 3, 2, 4):
        apply_op(ix, op)
    written = state(ix)
    c_ids, c_vals, _ = ix.search_batch(QUERIES, 6, 3)
    del ix
    gc.collect()
    card, rep = recover(root, embed_fn, get_chunks, device=cuda, **KW)
    assert card.device.type == "cuda" and rep.snapshot_lsn >= 0
    assert state(card) == written
    k1, k2 = topk_ip.launches, slab_topk.launches
    ids, vals, _ = card.search_batch(QUERIES, 6, 3)
    assert topk_ip.launches - k1 == 1 and slab_topk.launches - k2 >= 1
    assert_near(ids, vals, c_ids, c_vals)
    del card
    gc.collect()
