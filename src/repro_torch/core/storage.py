"""Second-level embedding storage backend (fp32 codec).

Port of ``repro.core.storage`` for the first slice: the ``memory`` and
``disk`` modes with the bit-exact ``fp32`` codec.  The ``fp16``, ``int8``
and ``pq`` codecs and the ``memmap`` mode come with the storage-codec slice
of the port and raise :class:`NotImplementedError` until then; per-tenant
keys come with the tenancy slice.

Models the paper's split between DRAM (first-level centroids, cache) and
SD-card storage (precomputed heavy-cluster embeddings).  The ``disk`` mode
writes .npz files so persistence is real; the ``memory`` mode keeps payloads
in a dict.  Either way the *edge* latency of a load comes from the cost
model, not this machine's disk.

``get``/``get_many`` return contiguous f32 matrices; ``get_many_raw``
returns each payload dict as stored (``{"emb": f32}``, read-only), with a
missing key yielding ``None``.  ``stored_bytes``/``total_bytes`` report the
payload size in memory mode and the ``os.stat`` size on disk, and never read
payload data.

FAILURE MODEL (core/faults.py): every ``put`` stores a CRC-32 checksum
beside the payload (a ``"crc"`` member, stripped before any payload reaches
a caller and left out of byte accounting) and every load verifies it.
Failed reads are retried up to ``retry_limit`` times with exponential
backoff (modeled edge seconds, no sleep), recorded in the caller's
:class:`~repro_torch.core.faults.IOOutcome` list.  A read that exhausts its
retries degrades to a missing key, and a checksum failure that survives
every retry quarantine-drops the blob so the resolver regenerates and
re-persists it.  ``self.faults`` takes a
:class:`~repro_torch.core.faults.FaultInjector`.  Disk ``put`` writes a temp
file and ``os.replace``s it, so a crash never tears a blob.  The first disk
``put`` claims its ``(root, namespace)`` slot; a second live writer on the
same slot raises instead of interleaving blobs.
"""
from __future__ import annotations

import os
import re
import tempfile
import weakref
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.faults import (CorruptPayloadError, FaultInjector,
                                     InjectedFault, IOOutcome)

CODECS = ("fp32",)
MODES = ("memory", "disk")
_LATER = {"fp16": "codec", "int8": "codec", "pq": "codec", "memmap": "mode"}
_CLUSTER_FILE = re.compile(r"^cluster_(\d+)\.npz$")
_STALE_TMP = re.compile(r"^cluster_\d+\.npz\.tmp$")
_NAMESPACE_RE = re.compile(r"^[A-Za-z0-9._-]*$")
_CHECKSUM_KEY = "crc"


def payload_checksum(payload: Dict[str, np.ndarray]) -> int:
    """CRC-32 over the payload's arrays (name, dtype, shape, data) — any
    single bit flip or truncation changes it."""
    crc = 0
    for name in sorted(payload):
        a = np.ascontiguousarray(payload[name])
        crc = zlib.crc32(f"{name}:{a.dtype.str}:{a.shape}".encode(), crc)
        crc = zlib.crc32(a.view(np.uint8).reshape(-1), crc)
    return crc


class StorageBackend:
    """Keyed blob store for per-cluster embedding matrices."""

    # live disk WRITERS by (realpath(root), namespace); weakrefs so a
    # garbage-collected writer releases its claim
    _disk_claims: Dict[Tuple[str, str], "weakref.ref[StorageBackend]"] = {}

    def __init__(self, mode: str = "memory", root: Optional[str] = None,
                 codec: str = "fp32", *, retry_limit: int = 3,
                 backoff_base_s: float = 0.002, namespace: str = "",
                 budget_bytes: Optional[int] = None):
        for value in (mode, codec):
            if value in _LATER:
                raise NotImplementedError(
                    f"storage {_LATER[value]} {value!r} comes with the "
                    f"storage-codec slice of the port")
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode}")
        if codec not in CODECS:
            raise ValueError(f"codec must be one of {CODECS}, got {codec}")
        if not _NAMESPACE_RE.match(namespace):
            raise ValueError(
                f"namespace must match [A-Za-z0-9._-]*, got {namespace!r}")
        self.mode = mode
        self.codec = codec
        self.namespace = namespace
        self.budget_bytes = budget_bytes
        self._mem: Dict[int, Dict[str, np.ndarray]] = {}
        self._nbytes: Dict[int, int] = {}           # stored payload bytes
        self.root: Optional[str] = None
        self._base: Optional[str] = None            # root[/namespace]
        if mode == "disk":
            self.root = root or tempfile.mkdtemp(prefix="edgerag_store_")
            self._base = (os.path.join(self.root, namespace) if namespace
                          else self.root)
            os.makedirs(self._base, exist_ok=True)
        self.faults: Optional[FaultInjector] = None
        self.retry_limit = retry_limit
        self.backoff_base_s = backoff_base_s
        self.io_stats: Dict[str, float] = {
            "reads": 0, "verified": 0, "failed_attempts": 0, "retries": 0,
            "exhausted": 0, "corrupt_dropped": 0, "backoff_s": 0.0,
            "stall_s": 0.0, "put_rejected": 0}

    # ---- codec ----------------------------------------------------------
    @staticmethod
    def _encode(emb: np.ndarray) -> Dict[str, np.ndarray]:
        return {"emb": np.ascontiguousarray(emb, np.float32)}

    @staticmethod
    def decode(payload: Dict[str, np.ndarray]) -> np.ndarray:
        """Decode a raw payload (from ``get_many_raw``) to f32 (n, d)."""
        return np.ascontiguousarray(payload["emb"], np.float32)

    @staticmethod
    def payload_rows(payload: Dict[str, np.ndarray]) -> int:
        """Row count of a raw payload without decoding it."""
        return len(payload["emb"])

    # ---- filesystem (disk mode only) ------------------------------------
    def _path(self, key: int) -> str:
        if self.root is None:
            raise RuntimeError(
                "memory-mode StorageBackend has no filesystem root")
        return os.path.join(self._base, f"cluster_{key}.npz")

    def _claim_root(self):
        """First write claims the ``(root, namespace)`` slot; a second LIVE
        writer on the same slot is a collision, not a merge."""
        slot = (os.path.realpath(self.root), self.namespace)
        ref = StorageBackend._disk_claims.get(slot)
        owner = ref() if ref is not None else None
        if owner is not None and owner is not self:
            raise RuntimeError(
                f"storage root collision: another live StorageBackend is "
                f"already writing to root={self.root!r} "
                f"namespace={self.namespace!r}; give each writer its own "
                f"namespace= (or root)")
        StorageBackend._disk_claims[slot] = weakref.ref(self)

    def _load(self, key: int) -> Optional[Dict[str, np.ndarray]]:
        """Raw physical read (checksum member included).  An unreadable
        disk blob raises :class:`CorruptPayloadError`."""
        if self.mode == "memory":
            return self._mem.get(key)
        path = self._path(key)
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                return {name: z[name] for name in z.files}
        except Exception as e:
            raise CorruptPayloadError(f"unreadable blob for key {key}: {e}")

    # ---- verified / retried reads ----------------------------------------
    def _read_once(self, key: int, outcome: IOOutcome
                   ) -> Optional[Dict[str, np.ndarray]]:
        """One read attempt: physical load, injected faults, checksum
        verification.  Returns the CRC-stripped payload, ``None`` for a
        genuinely absent key, or raises the attempt's failure."""
        payload = self._load(key)
        if payload is None:
            return None
        if self.faults is not None:
            payload = self.faults.perturb(key, payload, outcome)
        crc = payload.get(_CHECKSUM_KEY)
        if crc is None:                 # legacy blob: unverifiable
            return payload
        body = {k: v for k, v in payload.items() if k != _CHECKSUM_KEY}
        if payload_checksum(body) != int(np.asarray(crc).reshape(-1)[0]):
            raise CorruptPayloadError(key)
        self.io_stats["verified"] += 1
        return body

    def _load_checked(self, key: int, outcome: IOOutcome
                      ) -> Optional[Dict[str, np.ndarray]]:
        """Bounded retry-with-exponential-backoff around :meth:`_read_once`.
        Backoff is MODELED edge seconds recorded on ``outcome``."""
        self.io_stats["reads"] += 1
        last_err: Optional[str] = None
        for attempt in range(self.retry_limit + 1):
            if attempt:
                backoff = self.backoff_base_s * (2 ** (attempt - 1))
                outcome.retries += 1
                outcome.backoff_s += backoff
                self.io_stats["retries"] += 1
                self.io_stats["backoff_s"] += backoff
            try:
                payload = self._read_once(key, outcome)
            except CorruptPayloadError:
                last_err = "corrupt"
            except InjectedFault as e:
                last_err = "io" if isinstance(e, IOError) else "missing"
            else:
                if payload is not None:
                    self.io_stats["stall_s"] += outcome.stall_s
                    return payload
                # genuinely absent: retrying cannot help
                outcome.ok = False
                outcome.error = "missing"
                self.io_stats["stall_s"] += outcome.stall_s
                return None
            self.io_stats["failed_attempts"] += 1
        outcome.ok = False
        outcome.error = last_err
        self.io_stats["exhausted"] += 1
        self.io_stats["stall_s"] += outcome.stall_s
        if last_err == "corrupt":
            # quarantine-drop the rotten blob: the caller regenerates and
            # the resolver's Alg. 1 self-heal re-persists a fresh copy
            self.io_stats["corrupt_dropped"] += 1
            self.delete(key)
        return None

    # ---- public API ------------------------------------------------------
    def put(self, key: int, embeddings: np.ndarray) -> int:
        """Returns the stored byte size (payload bytes in memory mode, the
        file size on disk), or 0 if ``budget_bytes`` refused the write
        (nothing stored; the caller keeps the cluster on the regen path)."""
        payload = self._encode(embeddings)
        nbytes = sum(a.nbytes for a in payload.values())
        if self.budget_bytes is not None:
            used = sum(self._nbytes.values()) - self._nbytes.get(key, 0)
            if used + nbytes > self.budget_bytes:
                self.io_stats["put_rejected"] += 1
                return 0
        stored = dict(payload)
        stored[_CHECKSUM_KEY] = np.array([payload_checksum(payload)],
                                         np.uint32)
        if self.mode == "memory":
            self._mem[key] = stored
        else:
            self._claim_root()
            path = self._path(key)
            tmp = path + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    np.savez(f, **stored)
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.remove(tmp)
                raise
            nbytes = os.stat(path).st_size
        self._nbytes[key] = nbytes
        return nbytes

    def get(self, key: int) -> np.ndarray:
        payload = self._load_checked(key, IOOutcome(key))
        if payload is None:
            raise KeyError(key)
        return self.decode(payload)

    def get_many(self, keys: Sequence[int],
                 outcomes: Optional[List[IOOutcome]] = None
                 ) -> List[Optional[np.ndarray]]:
        """Batched load in ``keys`` order; a missing or exhausted key yields
        ``None``.  ``outcomes`` collects one :class:`IOOutcome` per key."""
        return [None if p is None else self.decode(p)
                for p in self.get_many_raw(keys, outcomes)]

    def get_many_raw(self, keys: Sequence[int],
                     outcomes: Optional[List[IOOutcome]] = None
                     ) -> List[Optional[Dict[str, np.ndarray]]]:
        """Batched load of the payload dicts as stored (read-only), in
        ``keys`` order; a missing or exhausted key yields ``None``."""
        out: List[Optional[Dict[str, np.ndarray]]] = []
        for key in keys:
            o = IOOutcome(key)
            out.append(self._load_checked(key, o))
            if outcomes is not None:
                outcomes.append(o)
        return out

    def delete(self, key: int):
        self._nbytes.pop(key, None)
        if self.mode == "memory":
            self._mem.pop(key, None)
            return
        path = self._path(key)
        for p in (path, path + ".tmp"):
            if os.path.exists(p):
                os.remove(p)

    def clear(self):
        """Drop every stored cluster (index rebuilds), plus on disk any
        stale ``.tmp`` file a crashed put left behind."""
        for key in self.keys():
            self.delete(key)
        self._nbytes.clear()
        if self.mode == "disk":
            for f in os.listdir(self._base):
                if _STALE_TMP.match(f):
                    os.remove(os.path.join(self._base, f))

    def __contains__(self, key: int) -> bool:
        if self.mode == "memory":
            return key in self._mem
        return os.path.exists(self._path(key))

    def keys(self) -> List[int]:
        if self.mode == "memory":
            return list(self._mem)
        # only our cluster_<n>.npz blobs: foreign files are not ours
        return [int(m.group(1)) for m in
                (_CLUSTER_FILE.match(f) for f in os.listdir(self._base)) if m]

    def stored_bytes(self, key: int) -> int:
        """Stored bytes of one cluster (what a load streams)."""
        if key not in self._nbytes:       # e.g. fresh instance on an old root
            if self.mode == "memory":
                if key not in self._mem:
                    raise KeyError(key)
                self._nbytes[key] = sum(
                    a.nbytes for name, a in self._mem[key].items()
                    if name != _CHECKSUM_KEY)
            else:
                try:
                    self._nbytes[key] = os.stat(self._path(key)).st_size
                except OSError:
                    raise KeyError(key)
        return self._nbytes[key]

    def total_bytes(self) -> int:
        return sum(self.stored_bytes(k) for k in self.keys())
