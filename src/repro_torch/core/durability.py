"""Crash-consistent index durability: snapshot + write-ahead log.

Port of ``repro.core.durability``, byte for byte in what it writes: the
same WAL frames, record JSON and snapshot members, so a root written by
either package recovers in the other.  Durable state is host numpy (the
index keeps its centroids and cluster table on the host); no torch tensor
is ever serialized.  Recovery builds the index on ``device`` passed through
``index_kwargs`` / ``router_kwargs`` (the card unless ``device="cpu"``).

EdgeRAG's premise is an *online-indexed* edge deployment, yet everything
the index builds online — centroids, cluster membership, generation
stamps, tombstones, the Alg. 3 threshold, which clusters hold storage
blobs — lives in process memory: a power loss (routine on edge devices)
forces the worst-case recovery, a full corpus re-embed.  This module makes
index STATE durable next to the embedding blobs ``StorageBackend``
already persists, so recovery replays metadata and reuses the on-disk
embeddings instead of re-embedding.

THE THREE PIECES

:class:`WriteAheadLog` — an append-only log of CRC-framed records.  Every
finished index mutation (insert / remove / update / split / merge /
restore / drop / retrain_pq — plus the resolver's Alg. 1 self-heal
re-persist) emits ONE record carrying the *absolute post-op state* of
every cluster the op touched.  Frame format::

    file   := magic "EDGEWAL1" , frame*
    frame  := header , body
    header := <u32 body_len> <u32 crc32(body)>      (little-endian)
    body   := canonical JSON (sorted keys; ndarrays as
              {"__nd__": [dtype, shape, base64(raw bytes)]} — float32
              centroids round-trip bit-exactly)

Torn-tail detection: reading stops at the first bad frame (short header,
implausible length, CRC mismatch) and :meth:`~WriteAheadLog.records`
reports the valid prefix; the open-for-recovery path physically truncates
the file there.  A single bit flip anywhere in a frame fails its CRC and
truncates the log at that frame.  Each append is charged
``EdgeCostModel.wal_fsync_latency`` modeled edge seconds (surfaced as the
``LatencyBreakdown.wal_fsync_s`` field on the retrieval path, and folded
into maintenance ``edge_s`` on the drain path).

:class:`IndexSnapshot` — atomic (tmp + ``os.replace``) serialization of
the FULL index state into ``snapshot_<lsn>.npz`` next to the storage
root, self-validated by the same payload CRC the blob store uses.
Snapshots are taken incrementally via the ``OP_CHECKPOINT`` maintenance
kind (core/maintenance.py): after ``checkpoint_every`` WAL records a
checkpoint op is enqueued and rides idle gaps / pipeline S2-S3 bubbles
exactly like split / merge — a checkpoint bumps NO generation stamp, so
in-flight plans never go stale behind one.  After a snapshot lands, the
WAL is compacted (records at or below the snapshot LSN dropped).

:func:`recover` — newest valid snapshot + idempotent WAL-suffix replay
(records carry monotonically increasing LSNs; replay skips anything at or
below the applied LSN, so replaying twice equals replaying once), then a
reconciliation pass of the storage blobs against the recovered manifest:

  * a blob for a cluster the manifest doesn't claim → ORPHAN GC (a put
    that landed before its WAL record did; deleting it lands the index
    exactly on the pre-op state);
  * a manifest-claimed blob that is missing or whose stored CRC disagrees
    with the manifest's recorded CRC → SELF-HEAL regen (the one place
    recovery re-embeds — a single cluster, not the corpus).

THE ATOMICITY CONTRACT.  With a
:class:`~repro_torch.core.faults.CrashInjector` cutting the process at any
durability write boundary (:data:`~repro_torch.core.faults.CRASH_POINTS`),
recovery always lands
bit-identical to the pre-op or the post-op index — never a torn hybrid.
The mechanism: blobs are written before their WAL record, so a lost
record orphans (GC → pre-op) and a torn record truncates (→ pre-op),
while a landed record pins the exact post-op state including each stored
blob's CRC (mismatch → heal → post-op content).
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import re
import struct
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.costs import EdgeCostModel, WallTimer
from repro_torch.core.faults import CrashInjector
from repro_torch.core.maintenance import OP_MERGE, OP_RESTORE, OP_SPLIT

WAL_MAGIC = b"EDGEWAL1"
_WAL_HEADER = struct.Struct("<II")
_SNAPSHOT_FILE = re.compile(r"^snapshot_(\d+)\.npz$")
_META_KEY = "meta_json"
_CRC_KEY = "crc"


class RecoveryError(Exception):
    """No recoverable durable state under the given root."""


# ---------------------------------------------------------------------------
# record codec: canonical JSON with ndarray members
# ---------------------------------------------------------------------------
def _enc(obj):
    if isinstance(obj, np.ndarray):
        a = np.ascontiguousarray(obj)
        return {"__nd__": [a.dtype.str, list(a.shape),
                           base64.b64encode(a.tobytes()).decode("ascii")]}
    if isinstance(obj, dict):
        return {k: _enc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_enc(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return obj


def _dec(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            dtype, shape, data = obj["__nd__"]
            a = np.frombuffer(base64.b64decode(data), np.dtype(dtype))
            return a.reshape(shape).copy()
        return {k: _dec(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_dec(v) for v in obj]
    return obj


def pack_record(record: Dict) -> bytes:
    """Canonical (sorted-key) JSON bytes of one WAL record."""
    return json.dumps(_enc(record), sort_keys=True,
                      separators=(",", ":")).encode("utf-8")


def unpack_record(body: bytes) -> Dict:
    return _dec(json.loads(body.decode("utf-8")))


# ---------------------------------------------------------------------------
# write-ahead log
# ---------------------------------------------------------------------------
class WriteAheadLog:
    """Append-only CRC-framed byte log (see module docstring for the frame
    format).  This layer is pure bytes; :class:`Durability` owns record
    semantics (LSNs, compaction policy)."""

    def __init__(self, path: str):
        self.path = path
        self.records_appended = 0        # frames appended by THIS handle
        self.bytes_appended = 0

    # -- writing -----------------------------------------------------------
    def append(self, body: bytes,
               crash: Optional[CrashInjector] = None) -> int:
        """Append one frame (+ fsync); returns bytes written.  Crash
        boundaries: ``wal_pre_append`` (nothing lands), ``wal_torn_append``
        (a seeded prefix of the frame lands — recovery must truncate),
        ``wal_post_append`` (the frame is durable)."""
        if crash is not None:
            crash.hit("wal_pre_append")
        frame = _WAL_HEADER.pack(len(body), zlib.crc32(body)) + body
        fresh = not os.path.exists(self.path)
        if crash is not None and crash.take("wal_torn_append"):
            torn = frame[:crash.torn_length(len(frame))]
            with open(self.path, "ab") as f:
                if fresh:
                    f.write(WAL_MAGIC)
                f.write(torn)
                f.flush()
                os.fsync(f.fileno())
            crash.die("wal_torn_append")
        with open(self.path, "ab") as f:
            if fresh:
                f.write(WAL_MAGIC)
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        if crash is not None:
            crash.hit("wal_post_append")
        self.records_appended += 1
        self.bytes_appended += len(frame)
        return len(frame)

    # -- reading -----------------------------------------------------------
    def frames(self) -> Tuple[List[bytes], int, bool]:
        """Every valid frame body in order, stopping at the first bad one.
        Returns ``(bodies, valid_end_offset, torn)`` — ``torn`` is True iff
        trailing bytes past the valid prefix exist (short/bad header, body
        overrunning the file, or CRC mismatch)."""
        if not os.path.exists(self.path):
            return [], 0, False
        with open(self.path, "rb") as f:
            data = f.read()
        if data[:len(WAL_MAGIC)] != WAL_MAGIC:
            return [], 0, len(data) > 0
        bodies: List[bytes] = []
        off = len(WAL_MAGIC)
        while off < len(data):
            if off + _WAL_HEADER.size > len(data):
                return bodies, off, True
            length, crc = _WAL_HEADER.unpack_from(data, off)
            start = off + _WAL_HEADER.size
            if start + length > len(data):
                return bodies, off, True
            body = data[start:start + length]
            if zlib.crc32(body) != crc:
                return bodies, off, True
            bodies.append(body)
            off = start + length
        return bodies, off, False

    def records(self) -> Tuple[List[Dict], int, bool]:
        """Decoded records of the valid frame prefix.  A frame whose CRC
        passes but whose body does not parse (cannot happen without a
        matching-CRC corruption, i.e. a software bug) also truncates."""
        bodies, off, torn = self.frames()
        out: List[Dict] = []
        end = len(WAL_MAGIC)
        for body in bodies:
            try:
                out.append(unpack_record(body))
            except Exception:
                return out, end, True
            end += _WAL_HEADER.size + len(body)
        return out, off, torn

    def truncate_torn_tail(self) -> int:
        """Physically cut the file back to its valid prefix; returns the
        number of torn bytes dropped."""
        if not os.path.exists(self.path):
            return 0
        _, valid_end, torn = self.frames()
        size = os.path.getsize(self.path)
        if not torn or size <= valid_end:
            return 0
        with open(self.path, "r+b") as f:
            f.truncate(valid_end)
        return size - valid_end

    def rewrite(self, bodies: Sequence[bytes]):
        """Atomic compaction: a fresh log holding only ``bodies``."""
        tmp = self.path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                f.write(WAL_MAGIC)
                for body in bodies:
                    f.write(_WAL_HEADER.pack(len(body), zlib.crc32(body)))
                    f.write(body)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def nbytes(self) -> int:
        return os.path.getsize(self.path) if os.path.exists(self.path) else 0


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------
class IndexSnapshot:
    """Atomic full-state serialization of an ``EdgeRAGIndex``.

    Payload members: a JSON meta string (lsn, dim, codec, pq version, the
    Alg. 3 threshold state), the centroid matrix, concatenated per-cluster
    chunk ids + per-chunk char counts with offsets, the per-cluster scalar
    columns (char_count, gen_latency_est, flags, generation stamps), and
    the blob-CRC manifest column (-1 = no stored blob).  A trailing
    ``crc`` member self-validates the file — recovery walks snapshots
    newest-first and uses the first one that verifies."""

    @staticmethod
    def capture(index, manifest: Dict[int, int],
                lsn: int) -> Dict[str, np.ndarray]:
        cls = index.clusters
        n = len(cls)
        ids_concat = (np.concatenate([c.ids for c in cls])
                      if n else np.zeros((0,), np.int64)).astype(np.int64)
        offsets = np.zeros((n + 1,), np.int64)
        for i, c in enumerate(cls):
            offsets[i + 1] = offsets[i] + c.size
        chars_concat = np.array(
            [index._chunk_chars.get(int(i), 0) for i in ids_concat],
            np.int64)
        thr = index.threshold
        meta = {
            "lsn": int(lsn),
            "dim": int(index.dim),
            "codec": index.storage.codec,
            "pq_version": (None if index.storage.pq is None
                           else int(index.storage.pq.version)),
            "threshold": {
                "threshold": float(thr.threshold),
                "step_s": float(thr.step_s),
                "alpha": float(thr.alpha),
                "moving_avg_latency": float(thr.moving_avg_latency),
                "initialized": bool(thr._initialized),
            },
        }
        payload = {
            _META_KEY: np.frombuffer(
                json.dumps(meta, sort_keys=True).encode("utf-8"), np.uint8),
            "centroids": (np.ascontiguousarray(index.centroids, np.float32)
                          if index.centroids is not None
                          else np.zeros((0, index.dim), np.float32)),
            "ids_concat": ids_concat,
            "offsets": offsets,
            "chars_concat": chars_concat,
            "char_count": np.array([c.char_count for c in cls], np.int64),
            "gen_latency_est": np.array([c.gen_latency_est for c in cls],
                                        np.float64),
            "stored": np.array([c.stored for c in cls], np.uint8),
            "active": np.array([c.active for c in cls], np.uint8),
            "generation": np.array([c.generation for c in cls], np.int64),
            "content_generation": np.array(
                [c.content_generation for c in cls], np.int64),
            "stored_generation": np.array(
                [c.stored_generation for c in cls], np.int64),
            "blob_crc": np.array(
                [manifest.get(cid, -1) for cid in range(n)], np.int64),
        }
        return payload

    @staticmethod
    def apply(index, payload: Dict[str, np.ndarray]
              ) -> Tuple[int, Dict[int, int]]:
        """Overwrite ``index``'s state from a verified snapshot payload.
        Returns ``(applied_lsn, blob-CRC manifest)``."""
        from repro_torch.core.cache_policy import \
            MinLatencyThresholdController
        from repro_torch.core.edgerag import EdgeCluster
        meta = json.loads(bytes(payload[_META_KEY]).decode("utf-8"))
        if int(meta["dim"]) != index.dim:
            raise ValueError(
                f"snapshot dim {meta['dim']} != index dim {index.dim}")
        tm = meta["threshold"]
        thr = MinLatencyThresholdController(tm["step_s"], tm["alpha"])
        thr.threshold = tm["threshold"]
        thr.moving_avg_latency = tm["moving_avg_latency"]
        thr._initialized = tm["initialized"]
        index.threshold = thr
        index.centroids = np.ascontiguousarray(payload["centroids"],
                                               np.float32)
        offsets = payload["offsets"]
        n = len(offsets) - 1
        index.clusters = []
        index._chunk_cluster = {}
        index._chunk_chars = {}
        manifest: Dict[int, int] = {}
        for cid in range(n):
            lo, hi = int(offsets[cid]), int(offsets[cid + 1])
            ids = payload["ids_concat"][lo:hi].astype(np.int64)
            cl = EdgeCluster(
                ids=ids,
                char_count=int(payload["char_count"][cid]),
                gen_latency_est=float(payload["gen_latency_est"][cid]),
                stored=bool(payload["stored"][cid]),
                active=bool(payload["active"][cid]),
                generation=int(payload["generation"][cid]),
                content_generation=int(payload["content_generation"][cid]),
                stored_generation=int(payload["stored_generation"][cid]))
            index.clusters.append(cl)
            for i, ch in zip(ids, payload["chars_concat"][lo:hi]):
                index._chunk_cluster[int(i)] = cid
                index._chunk_chars[int(i)] = int(ch)
            crc = int(payload["blob_crc"][cid])
            if crc >= 0:
                manifest[cid] = crc
        return int(meta["lsn"]), manifest

    # -- files -------------------------------------------------------------
    @staticmethod
    def path(dirpath: str, lsn: int) -> str:
        return os.path.join(dirpath, f"snapshot_{lsn}.npz")

    @staticmethod
    def write(dirpath: str, lsn: int, payload: Dict[str, np.ndarray],
              crash: Optional[CrashInjector] = None) -> str:
        """Atomic tmp + ``os.replace`` with the four snapshot crash
        boundaries.  A crash before the rename leaves (at most) a torn tmp
        that recovery ignores and a later ``StorageBackend.clear`` sweeps;
        a crash after the rename leaves a fully valid snapshot."""
        from repro_torch.core.storage import payload_checksum
        stored = dict(payload)
        stored[_CRC_KEY] = np.array([payload_checksum(payload)], np.uint32)
        path = IndexSnapshot.path(dirpath, lsn)
        tmp = path + ".tmp"
        if crash is not None:
            crash.hit("snap_pre_tmp")
        if crash is not None and crash.take("snap_torn_tmp"):
            import io
            buf = io.BytesIO()
            np.savez(buf, **stored)
            blob = buf.getvalue()
            with open(tmp, "wb") as f:
                f.write(blob[:crash.torn_length(len(blob))])
                f.flush()
                os.fsync(f.fileno())
            crash.die("snap_torn_tmp")
        with open(tmp, "wb") as f:
            np.savez(f, **stored)
            f.flush()
            os.fsync(f.fileno())
        if crash is not None:
            crash.hit("snap_pre_rename")
        os.replace(tmp, path)
        if crash is not None:
            crash.hit("snap_post_rename")
        return path

    @staticmethod
    def lsns(dirpath: str) -> List[int]:
        if not os.path.isdir(dirpath):
            return []
        out = [int(m.group(1)) for m in
               (_SNAPSHOT_FILE.match(f) for f in os.listdir(dirpath)) if m]
        return sorted(out)

    @staticmethod
    def load_valid(dirpath: str, lsn: int
                   ) -> Optional[Dict[str, np.ndarray]]:
        """The snapshot's payload iff its container parses and its CRC
        verifies; None otherwise."""
        from repro_torch.core.storage import payload_checksum
        try:
            with np.load(IndexSnapshot.path(dirpath, lsn)) as z:
                stored = {name: z[name] for name in z.files}
        except Exception:
            return None
        crc = stored.pop(_CRC_KEY, None)
        if crc is None:
            return None
        if payload_checksum(stored) != int(np.asarray(crc).reshape(-1)[0]):
            return None
        return stored

    @staticmethod
    def newest_valid(dirpath: str
                     ) -> Optional[Tuple[int, Dict[str, np.ndarray]]]:
        for lsn in reversed(IndexSnapshot.lsns(dirpath)):
            payload = IndexSnapshot.load_valid(dirpath, lsn)
            if payload is not None:
                return lsn, payload
        return None

    @staticmethod
    def prune(dirpath: str, keep: int):
        """Drop all but the newest ``keep`` snapshots (older ones are
        recovery fallbacks for a torn newest — keep ≥ 1)."""
        lsns = IndexSnapshot.lsns(dirpath)
        for lsn in lsns[:-keep] if keep else lsns:
            try:
                os.remove(IndexSnapshot.path(dirpath, lsn))
            except OSError:
                pass


# ---------------------------------------------------------------------------
# the durability handle
# ---------------------------------------------------------------------------
class Durability:
    """Per-index durability handle: owns one WAL + snapshot directory.

    ``root`` is the storage root the blobs live under; durable state goes
    in ``<root>/durability/`` (``<root>/durability/tenant_<t>/`` for a
    tenant of a shared backend — per-tenant WALs under the shared root).
    Attach with :meth:`EdgeRAGIndex.attach_durability`; every finished
    mutation then emits one WAL record, and after ``checkpoint_every``
    records a snapshot is taken — inline in sync-maintenance mode, or as
    an ``OP_CHECKPOINT`` op that rides the deferred queue into idle gaps
    and pipeline bubbles.  ``crash`` injects simulated process death at
    the write boundaries (tests / benchmarks only)."""

    def __init__(self, root: str, *, tenant: Optional[str] = None,
                 cost_model: Optional[EdgeCostModel] = None,
                 checkpoint_every: int = 64, keep_snapshots: int = 2,
                 crash: Optional[CrashInjector] = None):
        if checkpoint_every < 1 or keep_snapshots < 1:
            raise ValueError(
                f"checkpoint_every ({checkpoint_every}) and keep_snapshots "
                f"({keep_snapshots}) must be >= 1")
        self.root = root
        self.tenant = tenant
        self.dir = os.path.join(root, "durability",
                                *([f"tenant_{tenant}"] if tenant else []))
        os.makedirs(self.dir, exist_ok=True)
        self.wal = WriteAheadLog(os.path.join(self.dir, "wal.log"))
        self.cost = cost_model or EdgeCostModel()
        self.checkpoint_every = checkpoint_every
        self.keep_snapshots = keep_snapshots
        self.crash = crash
        self.next_lsn = 1       # LSN 0 = "no records": a baseline snapshot
        # taken before any record carries lsn 0 and replay skips lsn <= 0
        self.records_since_snapshot = 0
        # blob manifest: cid -> payload CRC the durable state expects for
        # that cluster's stored blob (recovery reconciles against it)
        self.manifest: Dict[int, int] = {}
        # counters (serving/metrics.py collectors)
        self.records_total = 0
        self.snapshots_total = 0
        self.compactions_total = 0
        self.fsync_edge_s_total = 0.0
        self.last_recovery_s: Optional[float] = None

    # -- record capture ----------------------------------------------------
    def _capture_cluster(self, index, cid: int) -> Dict:
        cl = index.clusters[cid]
        entry = {
            "cid": int(cid),
            "ids": np.asarray(cl.ids, np.int64),
            "chars": np.array([index._chunk_chars.get(int(i), 0)
                               for i in cl.ids], np.int64),
            "char_count": int(cl.char_count),
            "gen_latency_est": float(cl.gen_latency_est),
            "stored": bool(cl.stored),
            "active": bool(cl.active),
            "generation": int(cl.generation),
            "content_generation": int(cl.content_generation),
            "stored_generation": int(cl.stored_generation),
            "centroid": np.ascontiguousarray(index.centroids[cid],
                                             np.float32),
            "blob_crc": None,
        }
        if cl.stored:
            try:
                entry["blob_crc"] = int(index.storage.payload_crc(cid))
            except KeyError:
                entry["blob_crc"] = None
        return entry

    def log_mutation(self, index, op: str, cids: Sequence[int],
                     gone: Sequence[int]) -> float:
        """Append one record with the absolute post-op state of the
        touched clusters; returns modeled fsync edge seconds.  Updates the
        blob manifest and arms a checkpoint when the record budget is
        spent."""
        record = {
            "lsn": self.next_lsn,
            "op": op,
            "nlist": len(index.clusters),
            "gone": [int(i) for i in gone],
            "pq_version": (None if index.storage.pq is None
                           else int(index.storage.pq.version)),
            "clusters": [self._capture_cluster(index, cid) for cid in cids],
        }
        n = self.wal.append(pack_record(record), crash=self.crash)
        # the append landed: only now may the in-memory bookkeeping move
        self.next_lsn += 1
        self.records_total += 1
        self.records_since_snapshot += 1
        for entry in record["clusters"]:
            if entry["stored"] and entry["blob_crc"] is not None:
                self.manifest[entry["cid"]] = entry["blob_crc"]
            else:
                self.manifest.pop(entry["cid"], None)
        fsync_s = self.cost.wal_fsync_latency(n)
        self.fsync_edge_s_total += fsync_s
        if self.should_checkpoint():
            from repro_torch.core.maintenance import (CHECKPOINT_CID,
                                                      OP_CHECKPOINT)
            if index.maintenance_mode == "sync":
                self.checkpoint(index)
            else:
                index.maintenance.enqueue(OP_CHECKPOINT, CHECKPOINT_CID)
        return fsync_s

    def should_checkpoint(self) -> bool:
        return self.records_since_snapshot >= self.checkpoint_every

    @property
    def dirty_records(self) -> int:
        return self.records_since_snapshot

    # -- checkpoint --------------------------------------------------------
    def checkpoint_cost_s(self, index) -> float:
        """Drain-time estimate of one checkpoint: the serialized state
        streamed through one fsync'd write (+ the rename barrier)."""
        n_ids = sum(c.size for c in index.clusters)
        nbytes = (0 if index.centroids is None else index.centroids.nbytes)
        nbytes += n_ids * 16 + len(index.clusters) * 64 + 512
        return self.cost.wal_fsync_latency(nbytes) + self.cost.storage_seek_s

    def checkpoint(self, index) -> float:
        """Serialize the full index state to ``snapshot_<lsn>.npz``
        (atomic), then COMPACT the WAL — records at or below the snapshot
        LSN are dead weight (replay skips them by LSN anyway).  Returns
        modeled edge seconds."""
        snap_lsn = self.next_lsn - 1
        payload = IndexSnapshot.capture(index, self.manifest, snap_lsn)
        nbytes = sum(a.nbytes for a in payload.values())
        IndexSnapshot.write(self.dir, snap_lsn, payload, crash=self.crash)
        self.snapshots_total += 1
        keep = [pack_record(rec) for rec in self.wal.records()[0]
                if int(rec["lsn"]) > snap_lsn]
        self.wal.rewrite(keep)
        self.compactions_total += 1
        self.records_since_snapshot = len(keep)
        IndexSnapshot.prune(self.dir, self.keep_snapshots)
        edge_s = (self.cost.wal_fsync_latency(nbytes)
                  + self.cost.storage_seek_s)
        self.fsync_edge_s_total += edge_s
        return edge_s

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> Dict[str, object]:
        return {
            "wal_records_total": self.records_total,
            "wal_bytes": self.wal.nbytes(),
            "wal_records_since_snapshot": self.records_since_snapshot,
            "snapshots_total": self.snapshots_total,
            "wal_compactions_total": self.compactions_total,
            "fsync_edge_s_total": self.fsync_edge_s_total,
            "last_recovery_s": self.last_recovery_s,
        }


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RecoveryReport:
    """What one :func:`recover` did and what it cost (modeled edge
    seconds + real wall seconds)."""
    tenant: Optional[str] = None
    snapshot_lsn: int = -1
    replayed_records: int = 0
    torn_bytes: int = 0          # bytes cut off the WAL's torn tail
    orphans_gc: int = 0          # blobs the manifest didn't claim, deleted
    healed: int = 0              # manifest-claimed blobs regenerated
    requeued_ops: int = 0        # split/merge hygiene re-derived post-replay
    edge_s: float = 0.0
    wall_s: float = 0.0

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def _replay_record(index, rec: Dict, manifest: Dict[int, int]):
    """Apply one WAL record: absolute post-op cluster states, chunk-map
    updates, blob-manifest updates.  Caller enforces LSN monotonicity."""
    from repro_torch.core.edgerag import EdgeCluster
    nlist = int(rec["nlist"])
    while len(index.clusters) < nlist:      # split appended new slots
        index.clusters.append(EdgeCluster(
            ids=np.zeros((0,), np.int64), char_count=0,
            gen_latency_est=0.0, active=False))
    if index.centroids is None:
        index.centroids = np.zeros((0, index.dim), np.float32)
    if len(index.centroids) < nlist:
        pad = np.tile(-np.ones((1, index.dim), np.float32)
                      / np.sqrt(index.dim),
                      (nlist - len(index.centroids), 1))
        index.centroids = np.concatenate([index.centroids, pad])
    for entry in rec["clusters"]:
        cid = int(entry["cid"])
        ids = np.asarray(entry["ids"], np.int64)
        index.clusters[cid] = EdgeCluster(
            ids=ids,
            char_count=int(entry["char_count"]),
            gen_latency_est=float(entry["gen_latency_est"]),
            stored=bool(entry["stored"]),
            active=bool(entry["active"]),
            generation=int(entry["generation"]),
            content_generation=int(entry["content_generation"]),
            stored_generation=int(entry["stored_generation"]))
        index.centroids[cid] = np.asarray(entry["centroid"], np.float32)
        for i, ch in zip(ids, np.asarray(entry["chars"], np.int64)):
            index._chunk_cluster[int(i)] = cid
            index._chunk_chars[int(i)] = int(ch)
        if entry["stored"] and entry.get("blob_crc") is not None:
            manifest[cid] = int(entry["blob_crc"])
        else:
            manifest.pop(cid, None)
    for i in rec.get("gone", []):
        index._chunk_cluster.pop(int(i), None)
        index._chunk_chars.pop(int(i), None)


def recover_index(index, dur: Durability, *,
                  report: Optional[RecoveryReport] = None) -> RecoveryReport:
    """Recover a constructed-but-unbuilt index in place from ``dur``'s
    directory: newest valid snapshot, idempotent WAL-suffix replay, then
    blob reconciliation (orphan GC + missing/mismatched-blob self-heal —
    the only re-embedding recovery ever does) and split/merge hygiene
    re-derivation for the deferred queue the crash threw away.  Attaches
    ``dur`` to the index and finishes with a fresh checkpoint."""
    rep = report or RecoveryReport(tenant=dur.tenant)
    with WallTimer() as t:
        rep.torn_bytes = dur.wal.truncate_torn_tail()
        found = IndexSnapshot.newest_valid(dur.dir)
        if found is None:
            raise RecoveryError(
                f"no valid snapshot under {dur.dir!r} — nothing durable to "
                f"recover (build with a Durability handle attached first)")
        snap_lsn, payload = found
        applied, manifest = IndexSnapshot.apply(index, payload)
        rep.snapshot_lsn = snap_lsn
        rep.edge_s += dur.cost.storage_load_latency(
            os.path.getsize(IndexSnapshot.path(dur.dir, snap_lsn)))
        records, _, _ = dur.wal.records()
        rep.edge_s += dur.cost.storage_load_latency(dur.wal.nbytes())
        for rec in records:
            if int(rec["lsn"]) <= applied:
                continue            # idempotent replay: at-most-once by LSN
            _replay_record(index, rec, manifest)
            applied = int(rec["lsn"])
            rep.replayed_records += 1
        dur.next_lsn = applied + 1
        dur.manifest = manifest
        dur.records_since_snapshot = sum(
            1 for rec in records if int(rec["lsn"]) > snap_lsn)
        index.attach_durability(dur, checkpoint=False)
        # ---- blob reconciliation against the recovered manifest ----
        present = set(index.storage.keys())
        claimed = set()
        for cid, cl in enumerate(index.clusters):
            if not (cl.active and cl.stored):
                continue
            claimed.add(cid)
            ok = False
            if cid in present:
                rep.edge_s += dur.cost.storage_seek_s   # CRC-member peek
                try:
                    ok = (index.storage.payload_crc(cid)
                          == manifest.get(cid))
                except KeyError:
                    ok = False
            if not ok:
                # missing or replaced mid-op before its record landed:
                # self-heal — regenerate THIS cluster and re-persist
                rep.edge_s += dur.cost.embed_latency(cl.char_count)
                rep.edge_s += dur.cost.wal_fsync_latency(
                    cl.size * index.dim * 4)
                index._restore_cluster(cid)
                index._wal_commit("recover_heal")
                rep.healed += 1
        for cid in sorted(present - claimed):
            # a blob nothing durable claims: a put that landed before its
            # WAL record (or a dropped cluster's leftover) — GC it so the
            # recovered index is exactly the durable state, never a hybrid
            index.storage.delete(cid)
            rep.orphans_gc += 1
            rep.edge_s += dur.cost.storage_seek_s
        # ---- re-derive the maintenance the crash threw away ----
        for cid, cl in enumerate(index.clusters):
            if not cl.active or cl.size == 0:
                continue
            if cl.char_count > index.split_max_chars and cl.size >= 2:
                index.maintenance.enqueue(OP_SPLIT, cid)
                rep.requeued_ops += 1
            elif 0 < cl.size < index.merge_min_size:
                index.maintenance.enqueue(OP_MERGE, cid)
                rep.requeued_ops += 1
            elif (index.store_heavy and cl.gen_latency_est > index.slo_s
                    and not cl.storage_fresh):
                index.maintenance.enqueue(OP_RESTORE, cid)
                rep.requeued_ops += 1
        rep.edge_s += dur.checkpoint(index)
    rep.wall_s = t.elapsed
    dur.last_recovery_s = rep.wall_s
    return rep


def recover(root: str, embed_fn, get_chunks,
            cost_model: Optional[EdgeCostModel] = None, *,
            storage_mode: str = "disk", tenant: Optional[str] = None,
            checkpoint_every: int = 64,
            crash: Optional[CrashInjector] = None,
            **index_kwargs):
    """Recover a single-tenant
    :class:`~repro_torch.core.edgerag.EdgeRAGIndex` from ``root`` (the
    storage root the crashed index wrote blobs and durable state under).
    The codec and dimensionality come from the snapshot itself;
    ``index_kwargs`` reach the index (``device=`` among them).  Returns
    ``(index, RecoveryReport)``.

    The crashed process must actually be dead (or its backend object
    garbage-collected): the recovered backend becomes the root's writer.
    """
    from repro_torch.core.edgerag import EdgeRAGIndex
    dur = Durability(root, tenant=tenant, cost_model=cost_model,
                     checkpoint_every=checkpoint_every, crash=crash)
    found = IndexSnapshot.newest_valid(dur.dir)
    if found is None:
        raise RecoveryError(
            f"no valid snapshot under {dur.dir!r} — nothing durable to "
            f"recover (build with a Durability handle attached first)")
    meta = json.loads(bytes(found[1][_META_KEY]).decode("utf-8"))
    index = EdgeRAGIndex(
        int(meta["dim"]), embed_fn, get_chunks, cost_model,
        storage_mode=storage_mode, storage_codec=meta["codec"],
        storage_root=root, **index_kwargs)
    report = recover_index(index, dur)
    return index, report


def recover_router(root: str, tenant_specs: Dict[str, Tuple],
                   cost_model: Optional[EdgeCostModel] = None, *,
                   storage_mode: str = "disk", checkpoint_every: int = 64,
                   router_kwargs: Optional[Dict] = None,
                   tenant_kwargs: Optional[Dict] = None):
    """Recover EVERY tenant of a crashed multi-tenant deployment from the
    shared ``root``.  ``tenant_specs`` maps tenant id ->
    ``(embed_fn, get_chunks)``; tenants are discovered from their
    per-tenant durability directories (``<root>/durability/tenant_<t>/``)
    and each one must have a spec.  ``router_kwargs`` reach the router
    (``device=`` among them).  Returns ``(TenantRouter,
    {tenant: RecoveryReport})``."""
    from repro_torch.core.tenant import TenantRouter
    base = os.path.join(root, "durability")
    discovered = sorted(
        m.group(1) for m in
        (re.match(r"^tenant_([A-Za-z0-9._-]+)$", e)
         for e in (os.listdir(base) if os.path.isdir(base) else []))
        if m)
    if not discovered:
        raise RecoveryError(f"no per-tenant durable state under {base!r}")
    missing = [t for t in discovered if t not in tenant_specs]
    if missing:
        raise ValueError(f"no (embed_fn, get_chunks) spec for {missing}")
    # the shared backend's codec / dim come from the first tenant snapshot
    meta = None
    for t in discovered:
        found = IndexSnapshot.newest_valid(os.path.join(base, f"tenant_{t}"))
        if found is not None:
            meta = json.loads(bytes(found[1][_META_KEY]).decode("utf-8"))
            break
    if meta is None:
        raise RecoveryError(f"no valid tenant snapshot under {base!r}")
    router = TenantRouter(int(meta["dim"]), cost_model,
                          storage_mode=storage_mode,
                          storage_codec=meta["codec"], storage_root=root,
                          **(router_kwargs or {}))
    reports: Dict[str, RecoveryReport] = {}
    for t in discovered:
        embed_fn, get_chunks = tenant_specs[t]
        ix = router.create_tenant(t, embed_fn, get_chunks,
                                  **(tenant_kwargs or {}))
        dur = Durability(root, tenant=t, cost_model=cost_model,
                         checkpoint_every=checkpoint_every)
        reports[t] = recover_index(ix, dur)
    return router, reports
