"""Deterministic fault injection + deadline-aware graceful degradation.

The whole retrieve path (StorageBackend -> ClusterResolver -> slab scoring
-> RAGEngine) used to assume I/O never fails and every request can afford
full-fidelity resolution.  The paper's premise is flash-backed edge storage,
where slow / torn / corrupt SD reads are the norm, not the exception; this
module gives the stack an explicit failure model and a degradation ladder.

FAULT TAXONOMY (:class:`FaultInjector`, seeded and deterministic given the
same configuration and call order):

  missing    the key transiently reads as absent (flaky directory entry)
  flip       one bit of the payload (any array, any byte) is flipped
  truncate   the payload loses its trailing row (a torn write surfacing
             on read)
  io         the read raises a transient ``IOError``
  stall      the read completes but its latency spikes — stall seconds are
             drawn from a configurable log-normal tail distribution and
             charged into the request's :class:`LatencyBreakdown`
             (``l2_stall_s``), riding the same edge-cost accounting as the
             modeled storage bandwidth

The injector perturbs a COPY of each payload: the underlying store is never
damaged by injection, so a retry can observe a clean read.  ``flip`` and
``truncate`` are caught by the per-key checksum ``StorageBackend`` verifies
on every load; ``missing`` / ``io`` surface as the corresponding read
failures.  ``StorageBackend`` retries failed reads with bounded exponential
backoff (modeled edge seconds, never a real sleep); a read that exhausts
its retries degrades to the regeneration fallback upstream instead of
raising, and a checksum failure that survives every retry quarantine-drops
the blob so the resolver's self-heal re-persists a fresh copy.

DEGRADATION LADDER (:class:`DegradationPolicy`): each request may carry a
deadline budget (modeled edge seconds).  Under pressure the resolver sheds
work in a defined order rather than blowing the deadline:

  1. shrink effective nprobe — trailing probed clusters (never below
     ``min_nprobe``) are dropped while the estimated resolution cost
     exceeds the remaining budget;
  2. skip regeneration of the largest unstored tail clusters — an owner
     whose queued regenerations cannot fit the remaining budget sheds the
     most expensive ones first (they resolve to zero rows);
  3. serve cached-but-stale payloads flagged stale — a payload whose
     generation moved since plan time (or a stale storage copy) is scored
     anyway when regeneration would blow the deadline and the row count
     still aligns, instead of being regenerated.

Every shed step is recorded: ``LatencyBreakdown.degraded_clusters`` counts
rung-1/rung-2 sheds, ``stale_served`` counts rung-3 serves, ``retries``
counts storage read retries; :class:`~repro_torch.serving.engine.RAGResponse`
surfaces them plus an ``outcome`` ("ok" / "degraded" / "missed").

With no injector attached and no deadlines passed, every code path in this
module is bypassed and fp32 results stay bit-identical to the fault-free
pipeline (the Table-4 parity tests run unmodified).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = ("missing", "flip", "truncate", "io")

# Durability write boundaries where a :class:`CrashInjector` can cut the
# process (core/durability.py calls ``crash.hit(point)`` at each one).
# WAL append:
#   wal_pre_append    before any frame byte reaches the log (op lost whole)
#   wal_torn_append   mid-append — a seeded prefix of the frame is written,
#                     then the "power" goes: the torn tail recovery must
#                     truncate
#   wal_post_append   frame fully written + fsynced
# Snapshot (atomic tmp + ``os.replace``):
#   snap_pre_tmp      before the tmp file is opened
#   snap_torn_tmp     mid-tmp-write — a truncated tmp is left behind
#   snap_pre_rename   tmp complete, rename not issued
#   snap_post_rename  snapshot durable (crash before WAL compaction)
CRASH_POINTS = ("wal_pre_append", "wal_torn_append", "wal_post_append",
                "snap_pre_tmp", "snap_torn_tmp", "snap_pre_rename",
                "snap_post_rename")


class InjectedFault(Exception):
    """Base of the injector-raised read failures."""


class InjectedMissing(InjectedFault):
    """The key transiently reads as absent."""


class TransientIOError(InjectedFault, IOError):
    """The read raised a transient I/O error."""


class CorruptPayloadError(Exception):
    """Checksum mismatch (real torn/bit-rotted blob or injected corruption)
    — or an unreadable .npz container."""


class SimulatedCrash(BaseException):
    """Raised by :class:`CrashInjector` at a durability write boundary.

    Deliberately a ``BaseException``: a crash is not an error the write
    path may catch and clean up after — torn tmp files and half-written
    frames must stay on disk exactly as a power loss would leave them, so
    recovery code (not writer cleanup) is what gets exercised."""

    def __init__(self, point: str):
        super().__init__(point)
        self.point = point


class CrashInjector:
    """Seeded process-death injection at durability write boundaries.

    Crashes on the ``at``-th time execution reaches crashpoint ``point``
    (one of :data:`CRASH_POINTS`); every other boundary passes through
    untouched.  For the torn-write points (``wal_torn_append`` /
    ``snap_torn_tmp``) the writer asks :meth:`torn_length` how many bytes
    of the frame / tmp payload to emit before dying — drawn from the
    injector's seeded generator, so the same (point, at, seed) triple
    reproduces the identical torn file."""

    def __init__(self, point: str, at: int = 1, seed: int = 0):
        assert point in CRASH_POINTS, point
        assert at >= 1, at
        self.point = point
        self.at = int(at)
        self.rng = np.random.default_rng(seed)
        self.hits: Dict[str, int] = {p: 0 for p in CRASH_POINTS}
        self.crashed = False

    def hit(self, point: str) -> None:
        """Register reaching one boundary; raises :class:`SimulatedCrash`
        when this is the configured occurrence."""
        assert point in CRASH_POINTS, point
        self.hits[point] += 1
        if (not self.crashed and point == self.point
                and self.hits[point] == self.at):
            self.die(point)

    def take(self, point: str) -> bool:
        """Register reaching a TWO-PHASE (torn-write) boundary; True iff
        this occurrence is the configured crash.  The writer then emits
        its :meth:`torn_length` partial bytes and calls :meth:`die` — the
        crash must land *after* the torn prefix hits disk, so this cannot
        raise the way :meth:`hit` does."""
        assert point in CRASH_POINTS, point
        self.hits[point] += 1
        return (not self.crashed and point == self.point
                and self.hits[point] == self.at)

    def die(self, point: str) -> None:
        self.crashed = True
        raise SimulatedCrash(point)

    def torn_length(self, n_bytes: int) -> int:
        """How many of a frame's ``n_bytes`` land before the torn crash:
        uniform over [1, n_bytes) — never zero (that's the pre-append
        point) and never complete (that's post-append)."""
        if n_bytes <= 1:
            return 0
        return int(self.rng.integers(1, n_bytes))


@dataclasses.dataclass
class IOOutcome:
    """What one keyed read cost and how it ended (one per requested key)."""
    key: int
    ok: bool = True
    retries: int = 0             # failed attempts that were retried
    stall_s: float = 0.0         # injected stall seconds (edge)
    backoff_s: float = 0.0       # modeled retry backoff seconds (edge)
    error: Optional[str] = None  # terminal: "missing" | "corrupt" | "io"


class FaultInjector:
    """Seeded fault source wrapped around ``StorageBackend`` reads.

    ``fault_rate`` is the per-read-attempt probability of one injected
    fault, split across ``kind_weights`` (default: uniform over
    missing / flip / truncate / io).  ``stall_rate`` independently spikes a
    read's latency by ``stall_scale_s * lognormal(0, stall_sigma)`` modeled
    seconds.  All draws come from one ``numpy`` generator seeded at
    construction: the same configuration replayed over the same read
    sequence injects the identical faults.
    """

    def __init__(self, seed: int = 0, fault_rate: float = 0.0,
                 kind_weights: Optional[Dict[str, float]] = None,
                 stall_rate: float = 0.0, stall_scale_s: float = 0.05,
                 stall_sigma: float = 1.0):
        weights = dict(kind_weights or {k: 1.0 for k in FAULT_KINDS})
        assert all(k in FAULT_KINDS for k in weights), weights
        total = sum(weights.values())
        self.kinds = sorted(weights)
        self.probs = np.array([weights[k] / total for k in self.kinds])
        self.fault_rate = float(fault_rate)
        self.stall_rate = float(stall_rate)
        self.stall_scale_s = float(stall_scale_s)
        self.stall_sigma = float(stall_sigma)
        self.rng = np.random.default_rng(seed)
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.stalls = 0
        self.stall_s_total = 0.0

    @property
    def injected_total(self) -> int:
        """Injected read FAULTS (stalls excluded: a stalled read still
        returns good data, it just pays for it)."""
        return sum(self.injected.values())

    def stats(self) -> Dict[str, object]:
        return {"injected": dict(self.injected),
                "injected_total": self.injected_total,
                "stalls": self.stalls,
                "stall_s_total": self.stall_s_total}

    # ------------------------------------------------------------------
    def perturb(self, key: int, payload: Dict[str, np.ndarray],
                outcome: Optional[IOOutcome] = None
                ) -> Dict[str, np.ndarray]:
        """One read attempt over ``payload``: maybe stall, maybe inject one
        fault.  Returns the payload (possibly a corrupted COPY — the stored
        arrays are never touched) or raises the injected failure."""
        if self.stall_rate and self.rng.random() < self.stall_rate:
            s = self.stall_scale_s * float(
                self.rng.lognormal(0.0, self.stall_sigma))
            self.stalls += 1
            self.stall_s_total += s
            if outcome is not None:
                outcome.stall_s += s
        if self.fault_rate and self.rng.random() < self.fault_rate:
            kind = self.kinds[int(self.rng.choice(len(self.kinds),
                                                  p=self.probs))]
            self.injected[kind] += 1
            if kind == "missing":
                raise InjectedMissing(key)
            if kind == "io":
                raise TransientIOError(key)
            return self._corrupt(payload, kind)
        return payload

    def _corrupt(self, payload: Dict[str, np.ndarray], kind: str
                 ) -> Dict[str, np.ndarray]:
        out = dict(payload)
        if kind == "truncate":
            # drop the trailing row of the widest array (a torn write);
            # degenerate payloads fall through to a bit flip
            name = max(payload, key=lambda n: payload[n].nbytes)
            a = payload[name]
            if a.ndim >= 1 and len(a) >= 1:
                out[name] = np.array(a[:-1], copy=True)
                return out
        name = max(payload, key=lambda n: payload[n].nbytes)
        b = np.array(payload[name], copy=True)
        flat = b.reshape(-1).view(np.uint8)
        if flat.size == 0:                  # nothing to flip: read as absent
            raise InjectedMissing("empty payload")
        i = int(self.rng.integers(flat.size))
        flat[i] ^= np.uint8(1 << int(self.rng.integers(8)))
        out[name] = b
        return out


@dataclasses.dataclass
class DegradationPolicy:
    """Deadline-pressure shedding knobs (see module docstring for the
    ladder).  ``prefill_reserve_frac`` is the fraction of a TTFT deadline
    the serving engine reserves for prefill when deriving the retrieval
    budget it hands to ``search_batch``."""
    min_nprobe: int = 2          # rung 1 never shrinks the probe set below
    shed_probes: bool = True     # rung 1: shrink effective nprobe
    shed_regen: bool = True      # rung 2: skip largest unaffordable regens
    serve_stale: bool = True     # rung 3: score stale payloads, flagged
    prefill_reserve_frac: float = 0.3

    # ------------------------------------------------------------------
    def resolve_estimate(self, index, cid: int) -> float:
        """Cheap plan-time estimate of resolving one cluster (edge s)."""
        cl = index.clusters[cid]
        if cl.storage_fresh and cid in index.storage:
            try:
                nbytes = index.storage.stored_bytes(cid)
            except KeyError:
                nbytes = cl.size * index.dim * 4
            return index.cost.storage_load_latency(nbytes)
        if cid in index.cache:       # peek only — no Alg. 2 counter bump
            return index.cost.mem_load_latency(cl.size * index.dim * 4)
        return cl.gen_latency_est

    def trim_probes(self, index,
                    probed_per_q: Sequence[Sequence[int]],
                    deadlines: Sequence[Optional[float]],
                    base_s: Sequence[float]
                    ) -> Tuple[List[List[int]], List[int]]:
        """Rung 1: per query, walk the probe list in probe order and drop
        trailing clusters (never below ``min_nprobe``) while the estimated
        cumulative resolution cost exceeds the remaining deadline budget.
        ``base_s`` is each query's already-committed edge seconds (query
        embed + centroid search).  Returns (trimmed lists, shed counts)."""
        trimmed: List[List[int]] = []
        shed: List[int] = []
        for qi, probed in enumerate(probed_per_q):
            deadline = deadlines[qi]
            if deadline is None or not self.shed_probes:
                trimmed.append(list(probed))
                shed.append(0)
                continue
            budget = deadline - base_s[qi]
            keep: List[int] = []
            total = 0.0
            for pos, cid in enumerate(probed):
                est = self.resolve_estimate(index, cid)
                if pos < self.min_nprobe or total + est <= budget:
                    keep.append(cid)
                    total += est
            trimmed.append(keep)
            shed.append(len(probed) - len(keep))
        return trimmed, shed
