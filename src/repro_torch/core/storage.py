"""Second-level embedding storage backend with quantized codecs.

Port of ``repro.core.storage``.  Models the paper's split between DRAM
(first-level centroids, cache) and SD-card storage (precomputed
heavy-cluster embeddings).  The ``disk`` mode writes .npz files so
persistence is real; the ``memory`` mode keeps payloads in a dict.  Either
way the *edge* latency of a load comes from the cost model, not this
machine's disk.  Both packages write the same files, so a root written by
one reads back in the other.

Codecs — the stored payload can be narrowed below fp32:

  fp32   bit-exact roundtrip (default)
  fp16   half-precision embeddings                       (2x fewer bytes)
  int8   per-row symmetric int8 + fp16 scales
         (``models/quantization.py``)                    (~3.9x fewer bytes)
  pq     product quantization (core/pq.py): one uint8 code per subspace
         against a backend-held codebook                 (8-32x fewer bytes)

PQ CODEC: payloads are ``{"codes": uint8 (n, m), "cbv": version}``; the
codebook lives on the backend (``self.pq``), trained once at index build
(``train_pq``, Lloyd steps on ``device``) and persisted next to on-disk
roots as ``pq_codebook.npz`` so a reopened root still decodes.  ``cbv`` pins
each blob to the codebook version that encoded it; after a retrain (version
bump) a stale blob fails its read like a corrupt one
(:class:`StaleCodebookError`) and is quarantine-dropped WITHOUT retries
(the mismatch is deterministic), so the resolver regenerates and self-heals
a fresh copy under the new codebook.  A ``put`` with no codebook yet trains
one on that put's rows; the index trains on the full corpus before its
first put.

MODES: ``memory`` (dict), ``disk`` (.npz files), and ``memmap`` — the disk
layout and atomic writes, but reads return read-only ``np.memmap`` views
into the uncompressed npz members instead of loading arrays, so payloads
are never resident: ``get_many_raw`` hands the slab packer memmap-backed
payloads.  Checksum verification still touches every byte.

``get``/``get_many`` return contiguous f32 matrices (decode on load);
``get_many_raw`` returns each payload dict as stored (``{"emb": f32|f16}``,
``{"q": int8, "scale": f16}`` or ``{"codes": uint8, "cbv": int32}``,
read-only), with a missing key yielding ``None``.  ``stored_bytes`` /
``total_bytes`` report the payload size in memory mode and the ``os.stat``
size in disk/memmap modes, and never read payload data.

FAILURE MODEL (core/faults.py): every ``put`` stores a CRC-32 checksum
beside the payload (a ``"crc"`` member, stripped before any payload reaches
a caller and left out of byte accounting) and every load verifies it.
Failed reads are retried up to ``retry_limit`` times with exponential
backoff (modeled edge seconds, no sleep), recorded in the caller's
:class:`~repro_torch.core.faults.IOOutcome` list.  A read that exhausts its
retries degrades to a missing key, and a checksum failure that survives
every retry quarantine-drops the blob so the resolver regenerates and
re-persists it.  ``payload_crc`` reads back only that member (cached per
key from ``put``), which crash recovery (core/durability.py) compares
against its manifest.  ``self.faults`` takes a
:class:`~repro_torch.core.faults.FaultInjector`.  On-disk ``put`` writes a
temp file and ``os.replace``s it, so a crash never tears a blob.  The first
on-disk write claims its ``(root, namespace)`` slot; a second live writer on
the same slot raises instead of interleaving blobs.

MULTI-TENANCY: a key is a bare cluster id or a ``(tenant, cid)`` tuple.
Tuple keys land in ``tenant_<name>/cluster_<cid>.npz`` under the root on
disk and are plain dict keys in memory; ``keys()`` lists both forms.
:class:`TenantStorageView` gives one tenant an int-keyed facade over a
shared backend (a :class:`~repro_torch.core.tenant.TenantRouter` holds one
backend and hands each tenant a view, so one root keeps one writer).
``budget_bytes`` is one quota over every key of the backend, all tenants
together: a ``put`` past it stores nothing, returns 0 and counts in
``io_stats["put_rejected"]``.
"""
from __future__ import annotations

import os
import re
import struct
import tempfile
import weakref
import zipfile
import zlib
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.faults import (CorruptPayloadError, FaultInjector,
                                     InjectedFault, IOOutcome)
from repro_torch.core.pq import (PQCodebook, codebook_from_payload,
                                 codebook_to_payload, pq_decode, pq_encode,
                                 train_pq)
from repro_torch.device import DeviceLike
from repro_torch.models.quantization import dequantize_rows, quantize_rows

CODECS = ("fp32", "fp16", "int8", "pq")
MODES = ("memory", "disk", "memmap")
_CODEBOOK_FILE = "pq_codebook.npz"
_CLUSTER_FILE = re.compile(r"^cluster_(\d+)\.npz$")
_TENANT_DIR = re.compile(r"^tenant_([A-Za-z0-9._-]+)$")
# tmp files our writers leave behind when a put/train dies mid-write — the
# only .tmp names clear() sweeps (foreign files stay)
_STALE_TMP = re.compile(r"^(cluster_\d+\.npz|pq_codebook\.npz)\.tmp$")
_NAMESPACE_RE = re.compile(r"^[A-Za-z0-9._-]*$")
_CHECKSUM_KEY = "crc"

#: blob key: a bare cluster id, or ``(tenant, cid)`` on a shared backend
StorageKey = Union[int, Tuple[str, int]]


def payload_checksum(payload: Dict[str, np.ndarray]) -> int:
    """CRC-32 over the payload's arrays (name, dtype, shape, data) — any
    single bit flip or truncation changes it."""
    crc = 0
    for name in sorted(payload):
        a = np.ascontiguousarray(payload[name])
        crc = zlib.crc32(f"{name}:{a.dtype.str}:{a.shape}".encode(), crc)
        crc = zlib.crc32(a.view(np.uint8).reshape(-1), crc)
    return crc


class StaleCodebookError(CorruptPayloadError):
    """PQ payload encoded under an older codebook version.  Deterministic —
    retrying the read cannot help — so reads skip the backoff ladder and
    quarantine-drop at once, putting the cluster on the regen + re-encode
    self-heal path."""


class StorageBackend:
    """Keyed blob store for per-cluster embedding matrices."""

    # live disk WRITERS by (realpath(root), namespace); weakrefs so a
    # garbage-collected writer releases its claim
    _disk_claims: Dict[Tuple[str, str], "weakref.ref[StorageBackend]"] = {}

    def __init__(self, mode: str = "memory", root: Optional[str] = None,
                 codec: str = "fp32", *, retry_limit: int = 3,
                 backoff_base_s: float = 0.002, namespace: str = "",
                 budget_bytes: Optional[int] = None, pq_m: int = 8,
                 device: DeviceLike = None):
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
        self.pq_m = pq_m
        self.pq: Optional[PQCodebook] = None
        self.device = device            # where train_pq runs its Lloyd steps
        self._mem: Dict[StorageKey, Dict[str, np.ndarray]] = {}
        self._nbytes: Dict[StorageKey, int] = {}    # stored payload bytes
        self._crcs: Dict[StorageKey, int] = {}      # payload CRC at put time
        self.root: Optional[str] = None
        self._base: Optional[str] = None            # root[/namespace]
        if mode != "memory":
            self.root = root or tempfile.mkdtemp(prefix="edgerag_store_")
            self._base = (os.path.join(self.root, namespace) if namespace
                          else self.root)
            os.makedirs(self._base, exist_ok=True)
            cb_path = os.path.join(self._base, _CODEBOOK_FILE)
            if os.path.exists(cb_path):      # reopened root: restore codebook
                with np.load(cb_path) as z:
                    self.pq = codebook_from_payload(
                        {name: z[name] for name in z.files})
        self.faults: Optional[FaultInjector] = None
        self.retry_limit = retry_limit
        self.backoff_base_s = backoff_base_s
        self.io_stats: Dict[str, float] = {
            "reads": 0, "verified": 0, "failed_attempts": 0, "retries": 0,
            "exhausted": 0, "corrupt_dropped": 0, "backoff_s": 0.0,
            "stall_s": 0.0, "put_rejected": 0}

    # ---- codec ----------------------------------------------------------
    def _encode(self, emb: np.ndarray) -> Dict[str, np.ndarray]:
        emb = np.ascontiguousarray(emb, np.float32)
        if self.codec == "fp32":
            return {"emb": emb}
        if self.codec == "fp16":
            return {"emb": emb.astype(np.float16)}
        if self.codec == "pq":
            if self.pq is None:      # standalone-backend convenience: the
                self.train_pq(emb)   # index trains on the corpus at build
            return {"codes": pq_encode(self.pq, emb),
                    "cbv": np.array([self.pq.version], np.int32)}
        q, scale = quantize_rows(emb)
        return {"q": q, "scale": scale}

    def decode(self, payload: Dict[str, np.ndarray]) -> np.ndarray:
        """Decode a raw payload (from ``get_many_raw``) to f32 (n, d)."""
        if "q" in payload:
            return dequantize_rows(payload["q"], payload["scale"])
        if "codes" in payload:
            if self.pq is None:
                raise CorruptPayloadError(
                    "pq payload but no codebook on this backend")
            return pq_decode(self.pq, payload["codes"])
        return np.ascontiguousarray(payload["emb"], np.float32)

    @staticmethod
    def payload_rows(payload: Dict[str, np.ndarray]) -> int:
        """Row count of a raw payload without decoding it."""
        for name in ("q", "codes", "emb"):
            if name in payload:
                return len(payload[name])
        raise KeyError("payload holds none of q / codes / emb")

    # ---- PQ codebook lifecycle ------------------------------------------
    def train_pq(self, embeddings: np.ndarray, *, iters: int = 12,
                 seed: int = 0) -> PQCodebook:
        """(Re)train the product-quantization codebook on ``embeddings``.

        First call -> version 0; later calls (drift retrains) bump the
        version, which invalidates every blob encoded under the old one:
        their next read raises :class:`StaleCodebookError`, quarantine-
        drops, and the resolver self-heals a fresh copy."""
        version = 0 if self.pq is None else self.pq.version + 1
        return self.install_pq(train_pq(
            embeddings, m=self.pq_m, iters=iters, seed=seed,
            version=version, device=self.device))

    def install_pq(self, cb: PQCodebook) -> PQCodebook:
        """Adopt ``cb`` as this backend's codebook (a trained or carried-over
        one); on-disk modes persist it next to the root so reopens decode."""
        self.pq = cb
        if self.mode != "memory":
            self._claim_root()
            self._atomic_savez(os.path.join(self._base, _CODEBOOK_FILE),
                               codebook_to_payload(cb))
        return cb

    # ---- filesystem (disk and memmap modes) ------------------------------------
    def _path(self, key: StorageKey) -> str:
        if self.root is None:
            raise RuntimeError(
                "memory-mode StorageBackend has no filesystem root")
        if isinstance(key, tuple):
            tenant, cid = key
            return os.path.join(self._base, f"tenant_{tenant}",
                                f"cluster_{cid}.npz")
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

    @staticmethod
    def _atomic_savez(path: str, arrays: Dict[str, np.ndarray]) -> None:
        """Temp file + ``os.replace``: a crash never tears the file."""
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise

    def _load(self, key: StorageKey) -> Optional[Dict[str, np.ndarray]]:
        """Raw physical read (checksum member included).  An unreadable
        disk blob raises :class:`CorruptPayloadError`."""
        if self.mode == "memory":
            return self._mem.get(key)
        path = self._path(key)
        if not os.path.exists(path):
            return None
        if self.mode == "memmap":
            return self._load_memmap(path, key)
        try:
            with np.load(path) as z:
                return {name: z[name] for name in z.files}
        except Exception as e:
            raise CorruptPayloadError(f"unreadable blob for key {key}: {e}")

    @staticmethod
    def _load_memmap(path: str, key: StorageKey) -> Dict[str, np.ndarray]:
        """Open an npz as read-only ``np.memmap`` views, one per member.

        ``np.savez`` stores members uncompressed (ZIP_STORED), so each
        array's data is a contiguous byte range of the container file:
        local-file-header offset + 30 + name/extra lengths + the .npy
        header.  Mapping that range gives a zero-copy view; nothing is read
        until a consumer touches pages."""
        try:
            out: Dict[str, np.ndarray] = {}
            with zipfile.ZipFile(path) as z, open(path, "rb") as raw:
                for info in z.infolist():
                    name = info.filename
                    if name.endswith(".npy"):
                        name = name[:-4]
                    with z.open(info) as f:
                        version = np.lib.format.read_magic(f)
                        read_header = getattr(
                            np.lib.format,
                            "read_array_header_%d_%d" % version)
                        shape, fortran, dtype = read_header(f)
                        header_len = f.tell()
                    if info.compress_type != zipfile.ZIP_STORED or fortran:
                        raise ValueError(
                            f"member {name} is not memmap-able")
                    # the central directory's header_offset points at the
                    # local file header: 30 fixed bytes, then name + extra
                    raw.seek(info.header_offset + 26)
                    n_name, n_extra = struct.unpack("<HH", raw.read(4))
                    offset = (info.header_offset + 30 + n_name + n_extra
                              + header_len)
                    if int(np.prod(shape, dtype=np.int64)) == 0:
                        out[name] = np.empty(shape, dtype)
                    else:
                        out[name] = np.memmap(path, mode="r", dtype=dtype,
                                              shape=tuple(shape),
                                              offset=offset)
            return out
        except Exception as e:
            raise CorruptPayloadError(f"unreadable blob for key {key}: {e}")

    # ---- verified / retried reads ----------------------------------------
    def _read_once(self, key: StorageKey, outcome: IOOutcome
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
        if "codes" in body and self.pq is not None:
            cbv = int(np.asarray(body.get("cbv", -1)).reshape(-1)[0])
            if cbv != self.pq.version:
                raise StaleCodebookError(key)
        self.io_stats["verified"] += 1
        return body

    def _load_checked(self, key: StorageKey, outcome: IOOutcome
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
            except StaleCodebookError:
                # deterministic mismatch: retries cannot help, fall through
                # to the quarantine-drop below without burning backoff
                last_err = "corrupt"
                self.io_stats["failed_attempts"] += 1
                break
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
    def put(self, key: StorageKey, embeddings: np.ndarray) -> int:
        """Returns the stored byte size (payload bytes in memory mode, the
        file size in disk/memmap modes), or 0 if ``budget_bytes`` refused the write
        (nothing stored; the caller keeps the cluster on the regen path)."""
        payload = self._encode(embeddings)
        nbytes = sum(a.nbytes for a in payload.values())
        if self.budget_bytes is not None:
            used = sum(self._nbytes.values()) - self._nbytes.get(key, 0)
            if used + nbytes > self.budget_bytes:
                self.io_stats["put_rejected"] += 1
                return 0
        crc = payload_checksum(payload)
        stored = dict(payload)
        stored[_CHECKSUM_KEY] = np.array([crc], np.uint32)
        if self.mode == "memory":
            self._mem[key] = stored
        else:
            self._claim_root()
            path = self._path(key)
            os.makedirs(os.path.dirname(path), exist_ok=True)
            self._atomic_savez(path, stored)
            nbytes = os.stat(path).st_size
        self._nbytes[key] = nbytes
        self._crcs[key] = crc
        return nbytes

    def get(self, key: StorageKey) -> np.ndarray:
        payload = self._load_checked(key, IOOutcome(key))
        if payload is None:
            raise KeyError(key)
        return self.decode(payload)

    def get_many(self, keys: Sequence[StorageKey],
                 outcomes: Optional[List[IOOutcome]] = None
                 ) -> List[Optional[np.ndarray]]:
        """Batched load in ``keys`` order; a missing or exhausted key yields
        ``None``.  ``outcomes`` collects one :class:`IOOutcome` per key."""
        return [None if p is None else self.decode(p)
                for p in self.get_many_raw(keys, outcomes)]

    def get_many_raw(self, keys: Sequence[StorageKey],
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

    def payload_crc(self, key: StorageKey) -> int:
        """CRC-32 of the stored payload, read from its ``"crc"`` member and
        not from the payload data: cached per key from ``put``, or read
        lazily from the container on a reopened root.  Raises ``KeyError``
        for an absent or unreadable blob.  Crash recovery
        (core/durability.py) compares it against the manifest's checksum to
        find a blob replaced mid-op before its WAL record landed."""
        if key in self._crcs:
            return self._crcs[key]
        if self.mode == "memory":
            if key not in self._mem:
                raise KeyError(key)
            crc = int(np.asarray(
                self._mem[key][_CHECKSUM_KEY]).reshape(-1)[0])
        else:
            try:
                with np.load(self._path(key)) as z:
                    crc = int(np.asarray(z[_CHECKSUM_KEY]).reshape(-1)[0])
            except Exception:
                raise KeyError(key)
        self._crcs[key] = crc
        return crc

    def delete(self, key: StorageKey):
        self._nbytes.pop(key, None)
        self._crcs.pop(key, None)
        if self.mode == "memory":
            self._mem.pop(key, None)
            return
        path = self._path(key)
        for p in (path, path + ".tmp"):
            if os.path.exists(p):
                os.remove(p)

    def clear(self):
        """Drop every stored cluster (index rebuilds), plus on disk roots
        the persisted PQ codebook file and any stale ``.tmp`` file a crashed
        put left behind.  The in-memory codebook is kept: a rebuild's
        ``train_pq`` bumps its version, so stale blobs stay detectable."""
        for key in self.keys():
            self.delete(key)
        self._nbytes.clear()
        self._crcs.clear()
        if self.mode != "memory":
            cb_path = os.path.join(self._base, _CODEBOOK_FILE)
            if os.path.exists(cb_path):
                os.remove(cb_path)
            for d in [self._base] + self._tenant_dirs():
                for f in os.listdir(d):
                    if _STALE_TMP.match(f):
                        os.remove(os.path.join(d, f))

    def __contains__(self, key: StorageKey) -> bool:
        if self.mode == "memory":
            return key in self._mem
        return os.path.exists(self._path(key))

    def _tenant_dirs(self) -> List[str]:
        """The ``tenant_<name>/`` subdirectories of the base directory."""
        return [os.path.join(self._base, e) for e in os.listdir(self._base)
                if _TENANT_DIR.match(e)
                and os.path.isdir(os.path.join(self._base, e))]

    def keys(self) -> List[StorageKey]:
        if self.mode == "memory":
            return list(self._mem)
        # only our cluster_<n>.npz blobs, at the top and in tenant_<name>/
        # subdirectories: foreign files are not ours
        out: List[StorageKey] = [
            int(m.group(1)) for m in
            (_CLUSTER_FILE.match(f) for f in os.listdir(self._base)) if m]
        for d in self._tenant_dirs():
            tenant = _TENANT_DIR.match(os.path.basename(d)).group(1)
            out += [(tenant, int(m.group(1))) for m in
                    (_CLUSTER_FILE.match(f) for f in os.listdir(d)) if m]
        return out

    def stored_bytes(self, key: StorageKey) -> int:
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

    def tenant_bytes(self, tenant: str) -> int:
        """Stored bytes under one tenant's ``(tenant, cid)`` keys."""
        return sum(self.stored_bytes(k) for k in self.keys()
                   if isinstance(k, tuple) and k[0] == tenant)


class TenantStorageView:
    """One tenant's int-keyed facade over a SHARED :class:`StorageBackend`.

    Every cluster id becomes ``(tenant, cid)`` before it reaches the
    backend, so an :class:`~repro_torch.core.edgerag.EdgeRAGIndex` holding
    a view does not see its neighbours while all tenants' blobs share the
    backend's one ``budget_bytes``.  ``keys`` / ``clear`` / ``stored_bytes``
    / ``total_bytes`` are scoped to the tenant; ``mode``, ``codec``,
    ``root``, ``device``, ``io_stats``, ``faults`` and the PQ codebook are
    the backend's (one storage medium: faults, IO accounting and the
    codebook are physical, not per tenant)."""

    def __init__(self, backend: StorageBackend, tenant: str):
        self.backend = backend
        self.tenant = str(tenant)

    def _k(self, cid: int) -> Tuple[str, int]:
        return (self.tenant, int(cid))

    # shared physical properties ------------------------------------------
    @property
    def mode(self) -> str:
        return self.backend.mode

    @property
    def codec(self) -> str:
        return self.backend.codec

    @property
    def root(self) -> Optional[str]:
        return self.backend.root

    @property
    def device(self) -> DeviceLike:
        return self.backend.device

    @property
    def io_stats(self) -> Dict[str, float]:
        return self.backend.io_stats

    @property
    def faults(self) -> Optional[FaultInjector]:
        return self.backend.faults

    @faults.setter
    def faults(self, injector: Optional[FaultInjector]):
        self.backend.faults = injector

    @property
    def pq(self) -> Optional[PQCodebook]:
        """The SHARED product-quantization codebook."""
        return self.backend.pq

    def train_pq(self, embeddings: np.ndarray, **kw) -> PQCodebook:
        return self.backend.train_pq(embeddings, **kw)

    def install_pq(self, cb: PQCodebook) -> PQCodebook:
        return self.backend.install_pq(cb)

    # key-mapped blob API --------------------------------------------------
    def put(self, cid: int, embeddings: np.ndarray) -> int:
        return self.backend.put(self._k(cid), embeddings)

    def get(self, cid: int) -> np.ndarray:
        try:
            return self.backend.get(self._k(cid))
        except KeyError:
            raise KeyError(cid)

    def get_many(self, cids: Sequence[int],
                 outcomes: Optional[List[IOOutcome]] = None
                 ) -> List[Optional[np.ndarray]]:
        return self.backend.get_many([self._k(c) for c in cids], outcomes)

    def get_many_raw(self, cids: Sequence[int],
                     outcomes: Optional[List[IOOutcome]] = None
                     ) -> List[Optional[Dict[str, np.ndarray]]]:
        return self.backend.get_many_raw([self._k(c) for c in cids],
                                         outcomes)

    def delete(self, cid: int):
        self.backend.delete(self._k(cid))

    def __contains__(self, cid: int) -> bool:
        return self._k(cid) in self.backend

    def keys(self) -> List[int]:
        return [k[1] for k in self.backend.keys()
                if isinstance(k, tuple) and k[0] == self.tenant]

    def clear(self):
        """Drop THIS tenant's blobs only (its index rebuilds)."""
        for cid in self.keys():
            self.delete(cid)

    def stored_bytes(self, cid: int) -> int:
        try:
            return self.backend.stored_bytes(self._k(cid))
        except KeyError:
            raise KeyError(cid)

    def payload_crc(self, cid: int) -> int:
        try:
            return self.backend.payload_crc(self._k(cid))
        except KeyError:
            raise KeyError(cid)

    def total_bytes(self) -> int:
        return self.backend.tenant_bytes(self.tenant)

    def decode(self, payload: Dict[str, np.ndarray]) -> np.ndarray:
        return self.backend.decode(payload)

    @staticmethod
    def payload_rows(payload: Dict[str, np.ndarray]) -> int:
        return StorageBackend.payload_rows(payload)
