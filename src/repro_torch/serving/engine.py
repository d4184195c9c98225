"""RAG serving engine: retrieve → assemble context → prefill → decode.

Port of ``repro.serving.engine``.  Retrieval runs on the index's device and
generation on the generator's (the card unless ``device="cpu"``).  Decode
goes through a :class:`~repro_torch.serving.batching.ContinuousBatcher`
when ``answer_batch`` is given one (``batcher=``), else through
:class:`GeneratorModel` one request at a time, as in the JAX engine.  The
engine may front a :class:`~repro_torch.core.tenant.TenantRouter`
(``tenants=``): retrieval then fuses the mixed batch through the router.

Ties the EdgeRAG index to the generation model.  TTFT = retrieval latency +
prefill latency (paper §3.1); decode is measured but excluded from the
paper's headline metric (it is not optimized by EdgeRAG).

The engine runs the REAL pipeline end to end while accounting edge latency
through the cost model — both are reported on every response.

STAGED SERVING (serving/pipeline.py): ``answer_batch`` is internally four
explicit stages over a :class:`BatchJob` —

  ``stage_plan``    S1  probe + plan           (``index.search_begin``)
  ``stage_fetch``   S2  storage fetch / regen  (``index.search_fetch``)
  ``stage_score``   S3  slab pack + score + prompt assembly
                        (``index.search_finish``)
  ``stage_decode``  S4  prefill + decode (generator)

Run back-to-back they are ``answer_batch``.  Each stage records its modeled
service time in ``BatchJob.stage_edge_s``.

Deferred-maintenance drain ownership is explicit: with
``maintenance_owner="engine"`` (default) ``answer_batch`` drains the
index's queue after decode; ``"external"`` means some other component owns
draining and the engine never touches the queue.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.costs import EdgeCostModel, LatencyBreakdown
from repro_torch.core.faults import DegradationPolicy
from repro_torch.data.tokenizer import HashingTokenizer
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import decode_step, init_cache, init_params, prefill


@dataclasses.dataclass
class RAGResponse:
    query: str
    chunk_ids: List[int]
    context: List[str]
    output_tokens: List[int]
    retrieval: LatencyBreakdown
    prefill_edge_s: float
    ttft_edge_s: float
    ttft_wall_s: float
    decode_wall_s: float = 0.0
    decode_edge_s: float = 0.0       # modeled decode ticks for the batch
    prefetch_saved_s: float = 0.0    # edge seconds hidden by prefetch overlap
    maintenance_s: float = 0.0       # deferred-maintenance edge seconds the
    #                                  batch drained after decode (amortized;
    #                                  off the TTFT critical path)
    queue_wait_s: float = 0.0        # modeled wait in stage queues before S1
    #                                  fired (staged pipeline; 0 here)
    # failure model / degradation ladder (core/faults.py):
    deadline_s: Optional[float] = None   # TTFT deadline this request carried
    #                                  (queue wait already subtracted when it
    #                                  came through the staged pipeline)
    outcome: str = "ok"              # "ok" | "degraded" | "missed"
    retries: int = 0                 # storage read attempts retried
    degraded_clusters: int = 0       # probes / regens shed under deadline
    stale_served: int = 0            # stale payloads scored, flagged


@dataclasses.dataclass
class BatchJob:
    """One batch of queries moving through the staged serving pipeline.

    Created by :meth:`RAGEngine.make_job`; each ``stage_*`` method consumes
    the fields of the previous stage and fills its own.  ``stage_edge_s``
    maps stage name ("s1".."s4") to that stage's modeled service time for
    this batch — unique work, not per-query accounting: the fused centroid
    top-k counts once per batch, shared-cluster resolutions once per owner
    (per-query ``LatencyBreakdown`` attribution is unchanged).
    """
    queries: List[str]
    query_embs: np.ndarray
    get_chunks: Optional[Callable[[Sequence[int]], List[str]]]
    deadlines: Optional[List[Optional[float]]] = None
    policy: Optional[DegradationPolicy] = None
    prefetch: bool = False
    # stage products:
    state: Any = None                       # BatchSearchState (S1 → S3)
    ids: Optional[np.ndarray] = None        # (Q, k) chunk ids (S3)
    lats: Optional[List[LatencyBreakdown]] = None
    id_lists: Optional[List[List[int]]] = None
    contexts: Optional[List[List[str]]] = None
    prompts: Optional[List[str]] = None
    prefill_edge: Optional[List[float]] = None
    out_tokens: Optional[List[List[int]]] = None
    decode_wall: float = 0.0
    retrieval_wall: float = 0.0
    maintenance_s: float = 0.0
    tenants: Optional[List[str]] = None     # per-query tenant ids when the
    #                                         engine fronts a TenantRouter
    queue_wait_s: float = 0.0               # set by a pipeline at S1 fire
    replans: int = 0                        # stale-plan S1 re-entries
    stage_edge_s: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def nq(self) -> int:
        return len(self.queries)


class RAGEngine:
    """index + generator behind one ``answer()`` call."""

    def __init__(self, index, generator=None, *,
                 cost_model: Optional[EdgeCostModel] = None,
                 k: int = 10, nprobe: int = 8, max_new_tokens: int = 16,
                 maintenance_budget_s: Optional[float] = None,
                 maintenance_owner: str = "engine"):
        assert maintenance_owner in ("engine", "external"), maintenance_owner
        self.index = index
        self.generator = generator        # GeneratorModel or None (sim-only)
        self.cost = cost_model or EdgeCostModel()
        self.k = k
        self.nprobe = nprobe
        self.max_new_tokens = max_new_tokens
        # per-step budget for draining the index's deferred-maintenance
        # queue after decode (None = the scheduler's own default)
        self.maintenance_budget_s = maintenance_budget_s
        # who drains the index's deferred-maintenance queue: "engine" =
        # answer_batch drains after decode (the default); "external" = a
        # scheduler hook or the staged pipeline owns draining and the
        # engine never touches the queue.  Exactly one component drains.
        self.maintenance_owner = maintenance_owner

    def answer_batch(self, queries: Sequence[str], query_embs: np.ndarray,
                     get_chunks: Optional[Callable[[Sequence[int]],
                                                   List[str]]] = None,
                     *, batcher=None, prefetch: bool = False,
                     deadlines: Optional[Sequence[Optional[float]]] = None,
                     policy: Optional[DegradationPolicy] = None,
                     tenants: Optional[Sequence[str]] = None
                     ) -> List[RAGResponse]:
        """Batched serving path: one ``search_batch`` drives retrieval for
        the whole batch (cross-query cluster dedup + a single coalesced
        embed call), then decode either goes through a
        :class:`~repro_torch.serving.batching.ContinuousBatcher`
        (``batcher=``, prompts admitted into decode slots so retrieval
        batching and decode batching compose) or falls back to the
        per-query generator.  Wall-clock figures are amortized uniformly
        over the batch.

        ``prefetch=True``: plan the batch first (``index.plan_batch``) and
        issue the plan's storage loads ahead of execution, so in edge
        accounting the storage I/O overlaps the rest of retrieval — each
        query's effective retrieval time is ``max(io, compute)`` instead of
        their sum (``prefetch_saved_s`` reports the hidden seconds).
        Retrieved ids/contexts are identical either way.

        ``deadlines``: per-request TTFT deadline budgets (edge seconds,
        None entries = no deadline).  A fraction of each deadline
        (``DegradationPolicy.prefill_reserve_frac``) is reserved for
        prefill; the rest becomes the retrieval budget handed to
        ``search_batch``, which sheds work down the degradation ladder
        (core/faults.py) instead of blowing it.  Each response reports its
        ``outcome`` ("ok" / "degraded" / "missed") plus the shed counters.

        ``tenants``: one tenant id per query (or a single id broadcast)
        when ``index`` is a :class:`~repro_torch.core.tenant.TenantRouter`
        — retrieval fuses the mixed batch through the router's shared slab
        engine and ``get_chunks`` may be omitted (contexts route to each
        query's own tenant corpus).
        """
        if not len(queries):
            return []
        job = self.make_job(queries, query_embs, get_chunks,
                            deadlines=deadlines, policy=policy,
                            prefetch=prefetch, tenants=tenants)
        self.stage_plan(job)
        self.stage_fetch(job)
        self.stage_score(job)
        self.stage_decode(job, batcher=batcher)
        # deferred index maintenance drains AFTER decode — split / merge /
        # restore work queued by online inserts/removes runs between serving
        # steps instead of inside a query's TTFT window.  Only when the
        # engine OWNS draining (never both with an external drainer).
        sched = getattr(self.index, "maintenance", None)
        if (self.maintenance_owner == "engine" and sched is not None
                and len(sched)):
            job.maintenance_s = sched.drain(self.maintenance_budget_s).edge_s
        return self.finalize(job)

    # ------------------------------------------------------------------
    # the staged path: make_job + stage_plan/fetch/score/decode + finalize
    # ------------------------------------------------------------------
    def make_job(self, queries: Sequence[str], query_embs: np.ndarray,
                 get_chunks: Optional[Callable[[Sequence[int]],
                                               List[str]]] = None,
                 *, deadlines: Optional[Sequence[Optional[float]]] = None,
                 policy: Optional[DegradationPolicy] = None,
                 prefetch: bool = False,
                 tenants: Optional[Sequence[str]] = None) -> BatchJob:
        """Wrap one batch as a :class:`BatchJob` for the staged path."""
        query_embs = np.atleast_2d(np.asarray(query_embs, np.float32))
        if deadlines is not None:
            assert len(deadlines) == len(queries), \
                f"{len(deadlines)} deadlines for {len(queries)} queries"
            policy = policy or DegradationPolicy()
        if tenants is not None:
            if isinstance(tenants, str):
                tenants = [tenants] * len(queries)
            tenants = [str(t) for t in tenants]
            assert len(tenants) == len(queries), \
                f"{len(tenants)} tenant ids for {len(queries)} queries"
        else:
            assert get_chunks is not None, \
                "get_chunks is required without tenants"
        return BatchJob(queries=list(queries), query_embs=query_embs,
                        get_chunks=get_chunks,
                        deadlines=None if deadlines is None
                        else list(deadlines),
                        policy=policy,
                        prefetch=prefetch
                        and (tenants is not None
                             or hasattr(self.index, "plan_batch")),
                        tenants=tenants)

    def stage_plan(self, job: BatchJob) -> BatchJob:
        """S1 — probe + plan: fused centroid top-k, tier planning, rung-1
        probe trimming under the job's (queue-wait-adjusted) deadlines.
        Service time: per-query embed charges + ONE fused centroid search
        (it runs once per batch, not once per query)."""
        t0 = time.perf_counter()
        kw = {}
        retrieval_deadlines = None
        if job.deadlines is not None:
            retrieval_deadlines = [
                None if d is None
                else d * (1.0 - job.policy.prefill_reserve_frac)
                for d in job.deadlines]
            kw["deadlines"] = retrieval_deadlines
            kw["policy"] = job.policy
        if job.tenants is not None:
            # TenantRouter path: the router plans per tenant (handling
            # prefetch itself) and merges into one cross-tenant plan
            job.state = self.index.search_begin(
                job.query_embs, self.k, self.nprobe,
                query_chars=[len(q) for q in job.queries],
                tenants=job.tenants, deadlines=retrieval_deadlines,
                policy=job.policy, prefetch=job.prefetch)
        else:
            if job.prefetch:
                kw["plan"] = self.index.plan_batch(
                    job.query_embs, self.nprobe, prefetch_storage=True,
                    deadlines=retrieval_deadlines, policy=job.policy,
                    query_chars=[len(q) for q in job.queries])
                kw.pop("deadlines", None)    # the plan carries them already
                kw.pop("policy", None)
            job.state = self.index.search_begin(
                job.query_embs, self.k, self.nprobe,
                query_chars=[len(q) for q in job.queries], **kw)
        job.retrieval_wall += time.perf_counter() - t0
        lats = job.state.lats
        # one fused centroid launch per index in the batch: one for a
        # standalone index, one PER TENANT through a router
        job.stage_edge_s["s1"] = (
            sum(lat.embed_query_s for lat in lats)
            + job.state.centroid_total_s)
        return job

    def stage_fetch(self, job: BatchJob, *,
                    extra_wait_s: float = 0.0) -> BatchJob:
        """S2 — storage fetch / regen: raw payload resolution (batched
        ``get_many_raw``, cache, coalesced regeneration, fault retries /
        stalls) with degradation rungs 2-3 against the plan's budgets.
        ``extra_wait_s``: modeled seconds this batch sat in the S2 queue —
        shrinks the plan's remaining retrieval budgets so the ladder sees
        queue wait, not just execution time.  Service time: the owner
        charges (each unique cluster is resolved exactly once)."""
        t0 = time.perf_counter()
        job.state.shrink_deadlines(extra_wait_s)
        self.index.search_fetch(job.state)
        job.retrieval_wall += time.perf_counter() - t0
        job.stage_edge_s["s2"] = sum(lat.stage_s("fetch")
                                     for lat in job.state.lats)
        return job

    def stage_score(self, job: BatchJob) -> BatchJob:
        """S3 — slab pack + multi-query top-k scoring, then context fetch
        and prompt assembly.  Service time: the score-group charges (pack
        copies, fused dequant, shared-hit DRAM re-reads, fused top-k)."""
        t0 = time.perf_counter()
        job.ids, _, job.lats = self.index.search_finish(job.state)
        nq = job.nq
        job.id_lists = [[int(i) for i in job.ids[qi] if i >= 0]
                        for qi in range(nq)]
        if job.tenants is not None:
            job.contexts = [self.index.get_chunks(t, idl)
                            for t, idl in zip(job.tenants, job.id_lists)]
        else:
            job.contexts = [job.get_chunks(idl) for idl in job.id_lists]
        job.prompts = [" ".join(ctx + [q])
                       for ctx, q in zip(job.contexts, job.queries)]
        job.prefill_edge = [
            self.cost.prefill_latency(max(1, len(p) // 3))
            for p in job.prompts]
        job.retrieval_wall += time.perf_counter() - t0
        job.stage_edge_s["s3"] = sum(lat.stage_s("score")
                                     for lat in job.lats)
        return job

    def stage_decode(self, job: BatchJob, *, batcher=None) -> BatchJob:
        """S4 — prefill + decode ticks, through a
        :class:`~repro_torch.serving.batching.ContinuousBatcher`
        (``batcher=``) or the per-query generator.  Service time: summed
        per-query prefill + ONE decode pass (continuous-batching ticks
        advance every live slot, so batch decode is per-token, not
        per-(token, slot))."""
        nq = job.nq
        job.out_tokens = [[] for _ in range(nq)]
        job.decode_wall = 0.0
        if batcher is not None:
            tokenizer = (self.generator.tokenizer if self.generator
                         is not None else HashingTokenizer(
                             vocab_size=batcher.cfg.vocab_size))
            t1 = time.perf_counter()
            completed = batcher.run(
                [{"id": qi,
                  "prompt_tokens": tokenizer.encode(p, batcher.max_len),
                  "max_new_tokens": self.max_new_tokens}
                 for qi, p in enumerate(job.prompts)])
            job.decode_wall = (time.perf_counter() - t1) / nq
            for qi in range(nq):
                job.out_tokens[qi] = completed.get(qi, [])
        elif self.generator is not None:
            t1 = time.perf_counter()
            for qi, p in enumerate(job.prompts):
                job.out_tokens[qi] = self.generator.generate(
                    p, self.max_new_tokens)
            job.decode_wall = (time.perf_counter() - t1) / nq
        job.stage_edge_s["s4"] = (
            sum(job.prefill_edge)
            + self.cost.decode_latency(self.max_new_tokens))
        return job

    def finalize(self, job: BatchJob) -> List[RAGResponse]:
        """Assemble one :class:`RAGResponse` per query from the finished
        job (pure accounting — no index or model work)."""
        nq = job.nq
        decode_edge = self.cost.decode_latency(self.max_new_tokens)
        responses = []
        for qi in range(nq):
            prefill_edge = job.prefill_edge[qi]
            lat = job.lats[qi]
            retrieval_edge = lat.retrieval_s
            saved = 0.0
            if job.prefetch:
                # storage I/O was issued at plan time: it runs under the
                # rest of this query's retrieval work instead of before it
                # (an injected stall is I/O-side, so it overlaps too)
                io = lat.l2_storage_load_s + lat.l2_stall_s
                saved = min(io, retrieval_edge - io)
            ttft_edge = retrieval_edge - saved + prefill_edge
            deadline = (None if job.deadlines is None
                        else job.deadlines[qi])
            degraded = bool(lat.degraded_clusters or lat.stale_served)
            outcome = "ok"
            if deadline is not None and ttft_edge > deadline:
                outcome = "missed"
            elif degraded:
                outcome = "degraded"
            responses.append(RAGResponse(
                query=job.queries[qi], chunk_ids=job.id_lists[qi],
                context=job.contexts[qi], output_tokens=job.out_tokens[qi],
                retrieval=lat, prefill_edge_s=prefill_edge,
                ttft_edge_s=ttft_edge,
                ttft_wall_s=job.retrieval_wall / nq,
                decode_wall_s=job.decode_wall,
                decode_edge_s=decode_edge,
                prefetch_saved_s=saved,
                maintenance_s=job.maintenance_s / nq,
                queue_wait_s=job.queue_wait_s,
                deadline_s=deadline, outcome=outcome,
                retries=lat.retries,
                degraded_clusters=lat.degraded_clusters,
                stale_served=lat.stale_served))
        return responses

    def answer(self, query: str, query_emb: np.ndarray,
               get_chunks: Optional[Callable[[Sequence[int]],
                                             List[str]]] = None,
               *, prefetch: bool = False,
               deadline_s: Optional[float] = None,
               policy: Optional[DegradationPolicy] = None,
               tenant: Optional[str] = None) -> RAGResponse:
        """Single query — a batch of one through :meth:`answer_batch`
        (mirroring ``EdgeRAGIndex.search`` → ``search_batch``)."""
        query_embs = np.atleast_2d(np.asarray(query_emb, np.float32))
        assert query_embs.shape[0] == 1
        return self.answer_batch(
            [query], query_embs, get_chunks, prefetch=prefetch,
            deadlines=None if deadline_s is None else [deadline_s],
            policy=policy,
            tenants=None if tenant is None else [tenant])[0]


class GeneratorModel:
    """The generation model on PyTorch: Sheared-LLaMA by default, or any
    registered config (``configs.ASSIGNED_ARCHS``; musicgen-large takes
    codec ids and qwen2-vl-2b text positions on its three M-RoPE streams,
    as in the JAX engine; gemma3-12b's sliding-window layers decode over
    ring caches of the window's rows; olmoe-1b-7b's and
    granite-moe-3b-a800m's mixture-of-experts layers route each token to
    its top-k experts, at the config's capacity factor in prefill and
    dropless in decode; rwkv6-1.6b carries a recurrent state of a fixed
    size in place of a KV cache and launches no attention kernel;
    zamba2-2.7b carries a Mamba2 state a layer and one KV cache for each
    application of its one shared attention block, the prompt's left
    padding run through the SSM and the conv, unmasked, as in the JAX
    engine).

    Prompts are left-padded with token 0 to ``max_prompt`` tokens (no
    attention mask: pad tokens are attended, as in the JAX engine) and
    decoded greedily (``argmax``: the first index wins a tie).
    ``prefill_wall_s`` / ``decode_wall_s`` accumulate the host-clock time
    of the two phases over every ``generate`` call (each ends in a device
    sync, so the times cover the device work)."""

    def __init__(self, cfg=None, params=None, *, seed: int = 0,
                 reduced: bool = True, max_prompt: int = 128,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if cfg is None:
            cfg = get_config("sheared-llama-2.7b")
            if reduced:
                cfg = cfg.reduced(num_layers=2, d_model=256)
        self.cfg = cfg
        if params is None:
            params = init_params(cfg, seed=seed, device=self.device)
        self.params = params
        self.tokenizer = HashingTokenizer(vocab_size=cfg.vocab_size)
        self.max_prompt = max_prompt
        self.prefill_wall_s = 0.0
        self.decode_wall_s = 0.0

    def generate(self, prompt: str, max_new_tokens: int = 16) -> List[int]:
        ids = self.tokenizer.encode(prompt, self.max_prompt)
        pad = self.max_prompt - len(ids)
        toks = torch.tensor([[0] * pad + ids], dtype=torch.long,
                            device=self.device)           # left-pad
        caches = init_cache(self.cfg, 1, self.max_prompt + max_new_tokens,
                            device=self.device)
        t0 = time.perf_counter()
        logits, caches = prefill(self.params, {"tokens": toks}, caches)
        tok = logits.argmax(-1)[:, None]
        out = [int(tok[0, 0])][:max_new_tokens]           # device sync
        t1 = time.perf_counter()
        cache_len = self.max_prompt
        for i in range(max_new_tokens):
            logits, caches = decode_step(self.params, tok, caches, cache_len)
            tok = logits.argmax(-1)[:, None]
            cache_len += 1
            if i + 1 < max_new_tokens:
                out.append(int(tok[0, 0]))
        tok.cpu()                       # the last step's result is unused,
        t2 = time.perf_counter()        # but its time is the decode's
        self.prefill_wall_s += t1 - t0
        self.decode_wall_s += t2 - t1
        return out
