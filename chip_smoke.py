#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA card

Phases, one JSON line each:

  env              card (``nvidia-smi`` name and power limit), torch / CUDA
                   versions, and the build of every kernel from
                   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at
                   once, into the git-ignored ``build/kernels/``), with
                   ``ptxas``'s registers and spills per kernel entry; every
                   ``flash_attention`` entry (head dims 64, 80, 128, f32 and
                   bf16, both layouts), every entry of the one-launch
                   top-k kernel (``topk_tiled_ptxas``: ivf_topk, and
                   slab_topk in fp32, fp16, int8 and pq, at 16- and 64-row
                   tiles: 10 entries) and every
                   ``decode_fwd`` entry (``decode_attention_ptxas``: K6 and
                   K7, f32 and bf16, head dims 32, 64, 80, 128) must spill
                   nothing.
  main_path        the port's request path at full size: a fiqa-sized corpus
                   (25,000 chunks, dim 768) indexed by ``EdgeRAGIndex.build``
                   (nlist 125), then batches of 16 requests through
                   ``RAGEngine.answer_batch`` (k 10, nprobe 8) with the
                   full-width sheared-llama-2.7b generator (fp32, random
                   weights from a seed) decoding 16 greedy tokens each.  The
                   kernels' launch counts are zeroed just before and read
                   just after.  The retrieved ids are held against the
                   port's own CPU run on the same data and tier decisions.
                   Every attention layer of every prefill runs the prefill
                   attention kernel (``flash_attention``, causal) and of
                   every decode step the decode kernel (``decode_attention``);
                   their launches must be exactly layers x requests and
                   layers x new tokens x requests.
  generator_parity the full-width generator cut to 2 layers (head dim 80, 32
                   heads, vocab 32000), one set of weights drawn on the CPU
                   from the seed and copied to the card: prefill of 128
                   tokens and 16 decode steps on the card (the kernels) and
                   on the CPU (plain), the same tokens fed to both; the
                   logits of every step agree within ``GEN_TOL`` and the
                   greedy tokens are equal wherever the top-2 margin exceeds
                   2 x ``GEN_TOL``.  Then one decode step of 4 slots at
                   different (B,) lengths, on both.  Every decode call of
                   the card run is recorded (q and the K / V row the model
                   has just inserted; the prompt's rows after prefill).
  kv_int8          the int8 KV cache of ``models.quantization`` decoded
                   through ``decode_attention_q8`` (K7), on the recorded
                   K / V and q of ``generator_parity``: per layer a
                   ``QuantKV`` from ``init_quant_cache``, the 128 prompt
                   rows ``quant_insert``-ed at 0, then per step the step's
                   row at 128 + step and K7 at length 129 + step; then the
                   4-slot step with (B,) positions and lengths.  K7's
                   launches must be exactly layers x (steps + 1); every
                   call within ``attn_tol`` of the plain version and of K6
                   on the dequantized cache, and within ``int8_bound`` of
                   K6 on the model's fp32 cache; K7 with every scale 1 must
                   miss the bound; the 4-slot batch equals its slots run
                   one at a time, bitwise; ``quantize_kv`` on the card
                   equals the CPU's; plus D = 32, GQA, window and bf16
                   cases against the plain version.  Every K7 call gives
                   K6's bits on the dequantized cache.
  continuous_batching
                   ``ContinuousBatcher`` on the main path's generator
                   (full-width sheared-llama-2.7b, 32 layers): 16 slots of
                   145 positions (``BATCHER_LEN``), its KV cache ~1.52 GB.
                   (a) a seeded trace of 32 requests in one ``run``
                   (prompts of 16-128 tokens, budgets of 1-16), so slots
                   free and refill at different ticks; (b) one batch of 16
                   of the main path's queries through
                   ``RAGEngine.answer_batch(..., batcher=)``, 16 new
                   tokens; (c) the generator cut to 2 layers at full width,
                   one set of weights drawn on the CPU and copied to the
                   card, the trace's first 8 requests through a 4-slot
                   batcher on each.  Counts zeroed before (a) and before
                   (b), read after each.  Checks: every request of (a) and
                   (b) completes with its budget of tokens in [0, vocab);
                   an admission of (a) came after its first tick and a
                   tick saw 4 or more distinct lengths among its active
                   slots; K5 causal = layers x admissions, non-causal 0,
                   K6 = layers x ticks with an active slot (512 / 512 in
                   (b)); each request of (a) and (b) alone on the card at
                   full depth (prefill, then ``decode_step`` on a one-row
                   cache) gives the batcher's tokens wherever its top-2
                   margin exceeds 2 x ``GEN_TOL`` (a request stops being
                   compared at its first near-tie; 90% of tokens must be
                   compared); in (c) the card's tokens equal the CPU's
                   outside the CPU's near-ties and every step's logits
                   agree within ``GEN_TOL``; one recorded K6 call of (a) at
                   the batcher's shape and one K5 call at an odd prompt
                   length equal their plain versions within
                   :func:`attn_tol`.  Prints the walls, ticks and
                   admissions, (b)'s decode wall per query beside the main
                   path's, the distinct lengths per tick and the
                   near-ties.
  encode           gte-base-en-v1.5 at full width (12 layers, d_model 768,
                   12 heads of 64; random weights from the seed): ``encode``
                   of 256 chunk texts of the corpus at 128 tokens on the card
                   (12 non-causal ``flash_attention`` launches), unit norm,
                   the first 8 rows within ``ENC_TOL`` of the CPU's.
  online_index     EdgeRAG with the real encoder as ``embed_fn``: one
                   ``ModelEmbedder(reduced=False)`` (gte-base-en-v1.5 at
                   full width, random weights from the seed; 256-text
                   micro-batches at 128 tokens) and an ``EdgeRAGIndex`` on
                   the main path's corpus, built with no ``embeddings=``,
                   so the build embeds all 25,000 chunks on the card.  Query
                   q is the text of one chunk of topic ``query_topic[q]``,
                   drawn with the seed, embedded by the same embedder.  4
                   batches of 16 through ``search_batch``'s three stages
                   (timed apart), then one through ``RAGEngine.answer_batch``
                   on the main path's generator with 2 new tokens.  Counts
                   zeroed before the build, read after ``answer_batch``.
                   Checks: every tier ran; non-causal ``flash_attention``
                   launches are exactly layers x the embedder's
                   micro-batches, causal ones 0 before ``answer_batch`` and
                   then layers x requests; every regenerated row, and every
                   query row, is bitwise the row the build embedded for
                   that chunk; a query's source chunk is at rank 1 wherever
                   its cluster was probed; ids equal a CPU index (the
                   card's centroids, assignment and build rows, a
                   ``TableEmbedder`` over those rows, the same query rows)
                   outside near-ties, with the same tier decisions; 8 build
                   rows within ``ENC_TOL`` of the same weights on the CPU,
                   and bitwise those of a second embedder given the card's
                   weights as ``params``.  Prints the build's and each
                   batch's embed and tokenize seconds (the embedder's own
                   counter), rows and micro-batches, each
                   batch's stage seconds, and the last batch twice more
                   under ``torch.profiler``, with the cache as it stands
                   and emptied (device busy share, K5 and copy events).
  staged_pipeline  ``StagedPipeline`` (``serving/pipeline.py``) on
                   ``online_index``'s embedder, build rows, clustering and
                   queries, with the main path's generator and a 16-slot
                   ``ContinuousBatcher`` of ``BATCHER_LEN`` positions.  Twin
                   indexes A and B (fp32, ``maintenance="deferred"``,
                   ``cache_bytes=0``, so every batch's S2 regenerates through
                   gte-base) on the build rows; on both, one chunk each of up
                   to two clusters that no query probes on the card is
                   rewritten in place, long enough that the cluster goes
                   over its storage SLO (a deferred restore each).  (a) 4
                   batches of 16, all arriving at 0, through the pipeline on
                   A (its engine ``maintenance_owner="external"``, S4 through
                   the batcher), then the same batches in order through
                   ``answer_batch(..., batcher=)`` on B (the engine
                   drains).  Counts zeroed before A's run, read after it.
                   Checks: ids, scores and tokens bitwise B's; maintenance
                   ran in bubbles (ops > 0), both queues empty after, every
                   rewritten cluster ``storage_fresh``; the hidden fraction
                   > 0; each stage fired once a batch (S1, S2 also once a
                   replan); ``ivf_topk`` once an S1 fire, fp32 ``slab_topk``
                   once an S3 fire, K5 non-causal = encoder layers x the
                   embedder's micro-batches, causal = 32 x admissions, K6 =
                   32 x ticks with an active slot; the restores' rows of the
                   rewritten chunks bitwise those of the texts embedded
                   alone.  (b) one more batch of 16 on A, an ``update`` of
                   one chunk of a planned cluster made just after its first
                   fetch: ``replans`` = 1, ``ivf_topk`` 2 launches, fp32
                   ``slab_topk`` 1, and ids, scores and tokens equal to B
                   (drained after (a)) given the same update before
                   ``answer_batch``.  (c) (a) replayed on the port's CPU
                   index (the same clustering, a ``TableEmbedder`` over the
                   card's rows, those of the rewritten texts included, the
                   same rewrites, ``generator=None``): ids equal outside
                   near-ties, every count of the trace equal (fires,
                   replans, bubble ops, checkpoints, queue depths), and its
                   modeled seconds within ``SCHEDULE_RTOL`` where no
                   near-tie swap changed a prompt.  Prints A's and B's wall
                   seconds and A's host seconds per stage and in drains, the
                   rows and embed seconds of each S2 fire and drain, the
                   trace and the launches.  The pipeline orders the stages'
                   work on the modeled clock; the work itself runs one
                   stage at a time on the host, so nothing overlaps on the
                   card and A's wall is that of serving the batches in turn.
  scheduler        ``RequestScheduler`` (``serving/scheduler.py``) and the
                   metrics registry (``serving/metrics.py``).  (a) ``run``
                   on the main path's serving stack: a fresh fp32 index
                   (deferred maintenance, the main path's clustering, the
                   table embedder regenerating) with one chunk rewritten
                   in each of up to two clusters no query probes (a
                   restore each), ``RAGEngine`` (k 10, nprobe 8) on the
                   full-width generator with ``SCHED_NEW_TOKENS`` tokens;
                   48 of the main path's queries with Poisson arrivals
                   (seed 0, mean gap 1.25 x the main path's first batch's
                   mean modeled TTFT, SLO 2 x that TTFT), tenant "a" on 3
                   of every 4 and "b" on the rest, ``TokenBucketAdmission``
                   at half and all of that TTFT's rate (burst 2); the
                   ``serve_fn`` is ``answer(...).ttft_edge_s`` and the
                   ``maintenance_fn`` the idle-gap drain of
                   ``benchmarks/online_churn.py``.  Checks: every request
                   completed once, a ``met`` and a ``rejected``,
                   ``maintenance_s`` > 0 and the queue drained, K1 and K2
                   once a served request, K5 causal 32 and K6 64 a served
                   request; a CPU replay (generator None) gives the same
                   outcomes, stamps within ``SCHEDULE_RTOL``, admission
                   stats, ``maintenance_s`` and ids outside near-ties.
                   (b) ``run_pipelined`` on ``staged_pipeline``'s setup
                   (twin indexes with ``cache_bytes=0``, gte-base
                   regenerating, the same kind of rewrites, a fresh
                   16-slot batcher): 32 requests 0.05 modeled s apart at
                   fiqa's SLO in batches of 16 (A), against the same two
                   ``PipelineBatch`` es built by hand through
                   ``StagedPipeline.run`` (B).  Checks: ids, scores,
                   tokens, the trace and every request stamp bitwise B's;
                   ``maintenance_s`` = the trace's bubble and final-drain
                   seconds, > 0; K1 2, K2 2, K5 causal 32 x admissions,
                   K6 32 x active ticks, K5 non-causal 12 x micro-batches;
                   a CPU replay (a table of the card's rows) gives the
                   same outcomes, stamps within ``SCHEDULE_RTOL`` and ids
                   outside near-ties.  In both, ``collect_scheduler``
                   (and ``collect_pipeline_trace``) render the same
                   samples from the card's run and the replay's, values
                   within ``SCHEDULE_RTOL``; the card's text goes to
                   ``build/scheduler_run.prom`` and
                   ``build/scheduler_pipelined.prom``.  Prints outcomes,
                   admission stats, ``maintenance_s``, modeled latency p50
                   / p99, each part's wall and launches, the sample
                   counts and headline samples.
  codec_paths      the same corpus, clustering, queries and generator under
                   each quantized storage codec: ``EdgeRAGIndex(
                   storage_codec="fp16" | "int8" | "pq")`` (pq in the memmap
                   mode, on a temporary root inside ``build/``), 4 batches of
                   16 through ``search_batch`` and one through
                   ``RAGEngine.answer_batch``.  Checks that every tier ran,
                   that ``slab_topk`` launched in the codec's mode and in
                   fp32 (in the profiled batch, one ``score_merge`` device
                   event per call in each mode and no other top-k event),
                   that ids equal the port's CPU run (same codec,
                   clustering and codebook) outside near-ties with the same
                   tier decisions, and the stored bytes against the fp32
                   index; prints recall@10 against the fp32 index's ids and,
                   for one more warm batch, its stages' host seconds and
                   its device time under ``torch.profiler``.
  kernels_checked  each kernel (ivf_topk; slab_topk in fp32, fp16, int8 and
                   pq) against its plain PyTorch version on the card, at the
                   recorded inputs of the main path and the codec paths:
                   scores within the stated tolerance and ids equal away from
                   near-ties (pq: bitwise); bitwise on integer-valued inputs;
                   a batch bitwise equal to its queries run one at a time;
                   plus the empty-slab, k > N and all-tie contracts; fp16,
                   and int8 with unit scales, give fp32's bits on the
                   widened slab; pq at m = 300 bitwise, fp16 and int8 at D =
                   60,000 within tolerance (bitwise on integer inputs).  The
                   attention kernels against their plain versions at the
                   recorded prefill, encode and decode inputs and at extra
                   shapes (GQA, windows, ragged and unequal lengths, D = 128,
                   bf16, mixed per-slot lengths, a length >= Smax, decode
                   at D = 32), within
                   :func:`attn_tol` (bf16: + one ulp), which K and V
                   rounded to bf16 must miss at the recorded inputs, and
                   which q, K and V rounded to TF32 (what a 1xTF32
                   ``flash_attention`` would see) must miss at the recorded
                   prefill and encode inputs; K and V off a 16-byte
                   boundary, and a decode cache whose row strides are (a
                   head dim pad sliced off), are staged by plain loads and
                   give the aligned bits;
                   batch == sequential, bitwise; and each
                   refusal (a head dim not built, a length of 0, a logit
                   softcap) raises, with the next launch running.
  breakdown        one more retrieval batch, one request's generation,
                   and one ``ContinuousBatcher`` tick of 16 active slots
                   (its ``decode_fwd`` events and copies counted) under
                   ``torch.profiler``: device time (kernels and copies)
                   against host wall time, and in the retrieval batch
                   exactly one device launch of the one-launch top-k kernel
                   per ``ivf_topk`` and per fp32 ``slab_topk`` call (and no
                   other top-k event); K7 against K6 on its dequantized cache
                   and against its library composite at K7's ``kernels``
                   shape; K6 against ``scaled_dot_product_attention`` at
                   the recorded decode input and, in ``decode_long``, at a
                   4,096-row f32 cache (every row valid), with its error
                   and bound there; each K6 and K7 call one device event;
                   K5 against
                   ``scaled_dot_product_attention`` at the recorded prefill
                   and encode inputs; and each top-k kernel against its
                   library call at its ``kernels`` inputs: 100 calls each,
                   device ms per call beside wall ms per call; and the fp32
                   ``slab_topk`` launch's device ms with L2 warm and with
                   L2 flushed before each call.
  profiler_lead_in how many of each profiler window's ``LEAD_IN`` spin
                   kernels the profiler lost, beside the window's seconds
                   since the first window (see ``profiled``); a window
                   that lost them all has failed already.

Then the ``kernels`` line (per kernel: launches, error, time, plain and
library time, and the bound from this run's inputs; every row also carries
the breakdown's device ms of the kernel and of its library call), the
``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.  Bounds: bytes read once at HBM's
3.35 TB/s against the function's operations at the fp32-accurate peak of
the unit the kernel runs them on: for K5 the tensor cores, whose 495 TFLOP/s
in TF32 give 165 TFLOP/s at fp32 accuracy (3xTF32 takes three TF32
products for one fp32 product); for the others the CUDA cores' 67 TFLOP/s
in fp32.  A row's times and bound are at its one recorded input; its
``launches`` is the sum of its ``launches_by_phase``: the launches of its
kernel in its mode or mask that each phase driving a path of the port
counted in its checked window (``main_path``, ``continuous_batching``'s
trace and engine batch, ``encode``, ``online_index``, ``staged_pipeline``
and its stale batch, ``scheduler`` (a) and (b)), whatever their shapes;
K6 launched by a batcher's ticks goes to ``decode_attention_batcher`` (K6
at ``continuous_batching``'s recorded (16, 1, 32, 80) call and per-slot
lengths), every other K6 launch to ``decode_attention``; the codec rows
take ``codec_paths``' launches and K7's row ``kv_int8``'s.  Any failed
check raises, so the script exits non-zero without that last line; it also
does so when no CUDA device is present or the package is missing beside
it.
"""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12          # fp32 outside the tensor cores
TF32_FLOPS_PER_S = 495e12         # TF32 on the tensor cores
F32_TC_FLOPS_PER_S = TF32_FLOPS_PER_S / 3  # fp32-accurate (3xTF32) on them

DATASET, RECORDS, DIM, NLIST = "fiqa", 25_000, 768, 125
BATCHES, BATCH, K, NPROBE = 4, 16, 10, 8
GENERATOR, MAX_PROMPT, NEW_TOKENS = "sheared-llama-2.7b", 128, 16
CODECS, CODEC_NEW_TOKENS = ("fp16", "int8", "pq"), 2
SLAB_INPUTS = "topk_inputs.pt"   # under build/: each top-k's recorded call
NEAR_TIE = 1e-4           # |score gap| under which two ids may swap places
SEED = 0
PARITY_LAYERS, SLOT_LENS = 2, (128, 100, 77, 140)
# continuous_batching: BATCH slots of the batcher's max_len (the longest
# prompt, its new tokens and one), a trace of TRACE_REQUESTS requests, and
# its first PARITY_REQUESTS through PARITY_SLOTS slots on the card and CPU
BATCHER_LEN = MAX_PROMPT + NEW_TOKENS + 1
TRACE_REQUESTS, PARITY_REQUESTS, PARITY_SLOTS = 32, 8, 4
# staged_pipeline: PIPE_BATCHES batches of BATCH through the pipeline; the
# seeded maintenance rewrites one chunk in each of up to REWRITE_CLUSTERS
# clusters, adding at least REWRITE_CHARS characters; the CPU replay's
# modeled seconds agree to SCHEDULE_RTOL (the same formulas on the same
# decisions: only the order of a few float sums could differ)
PIPE_BATCHES, REWRITE_CLUSTERS, REWRITE_CHARS = 4, 2, 4000
SCHEDULE_RTOL = 1e-9
# scheduler: (a) SCHED_REQUESTS of the main path's queries through
# RequestScheduler.run, Poisson arrivals with a mean gap of SCHED_GAP x the
# main path's first batch's mean modeled TTFT, an SLO of SCHED_SLO x that
# TTFT (fiqa's 1 s is under every modeled TTFT of the path, >= 2.2 s),
# tenant "a" on 3 of every 4 requests and "b" on the rest, token buckets
# of depth SCHED_BURST refilling at half and all of that TTFT's rate, and
# SCHED_NEW_TOKENS new tokens a request; (b) PIPE_REQUESTS requests
# PIPE_SPACING modeled s apart through run_pipelined in batches of BATCH.
# (a)'s SLO, rates and tenant split are a smoke setting, chosen so that the
# stream has met, missed and shed requests; they come from no source and
# are no benchmark cell's
SCHED_REQUESTS, SCHED_GAP, SCHED_SLO, SCHED_BURST = 48, 1.25, 2.0, 2.0
SCHED_NEW_TOKENS = 2
PIPE_REQUESTS, PIPE_SPACING = 32, 0.05
# ENC_TEXTS is ModelEmbedder's MICRO_BATCH: the encode phase's shape is the
# one every micro-batch of online_index launches K5 at
ENCODER, ENC_TEXTS, ENC_LEN = "gte-base-en-v1.5", 256, 128
# Logits (|x| < ~10) of one 2-layer model on the card and the CPU: fp32
# matmuls of up to 6,912 terms summed in other orders, a few ulps apart per
# op, drift by ~1e-5; 1e-4 leaves an order of magnitude over that, and is
# well under what a lower-precision attention kernel would move them.
GEN_TOL = 1e-4
# Unit-norm embeddings (elements ~0.036) after 12 fp32 layers: relative
# drift ~1e-6 of the elements, so 1e-5 leaves an order of magnitude.
ENC_TOL = 1e-5
# |int8-cache decode - fp32-cache decode| at unit-variance q, K, V: the JAX
# package's bound (tests/test_quantization.py:60); see int8_bound().
INT8_UNIT_BOUND = 0.03


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def score_tol(e, q) -> float:
    """Two fp32 sums of the same D products in different orders differ by
    at most 2 * D * 2**-24 * sum|q_i e_i|; the largest bound of the batch."""
    d = e.shape[1]
    return float(2 * d * 2.0 ** -24 * (q.abs() @ e.abs().T).max())


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def bound(nbytes: float, ops: float,
          flops_per_s: float = FP32_FLOPS_PER_S) -> tuple:
    """(least ms on the card, what bounds it): the bytes over HBM's rate
    against the operations over the peak of the unit the kernel uses (the
    fp32 peak outside the tensor cores unless ``flops_per_s`` says
    otherwise)."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, ops / flops_per_s
    return max(t_b, t_f) * 1e3, "bytes" if t_b >= t_f else "operations"


def flash_ptxas(lines) -> object:
    """``ptxas``'s registers and spill stores per ``flash_attention``
    entry (dtype, head dim, warps sharing a row tile), checking that none
    spills; "not rebuilt" when the library was built before this run."""
    import re
    if not lines:
        return "not rebuilt in this run"
    out = {}
    for ln in lines:
        kind = re.search(r"flash_fwdI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        check(kind and regs and spill, f"unread ptxas line: {ln}")
        dtype = "f32" if kind[1] == "f" else "bf16"
        out[f"{dtype} D={kind[2]} x{kind[3]}"] = [int(regs[1]),
                                                  int(spill[1])]
    check(len(out) == 12, f"flash_attention: {len(out)} entries, not 12")
    spilled = {k: v for k, v in out.items() if v[1]}
    check(not spilled, f"flash_attention spills: {spilled}")
    return {"registers_and_spill_bytes": out}


def tiled_ptxas(report) -> object:
    """``ptxas``'s registers and spill stores per entry of the one-launch
    top-k kernel (``topk::tiled::score_merge<mode, rows>``: ivf_topk, and
    slab_topk in each of its four modes, at 16- and 64-row tiles), checking
    that none spills; "not rebuilt" when neither library was built in this
    run."""
    import re
    if not (report.get("ivf_topk") and report.get("slab_topk")):
        return "not rebuilt in this run"
    lines = [ln for name in ("ivf_topk", "slab_topk")
             for ln in report[name] if "score_merge" in ln]
    out = {}
    for ln in lines:
        kind = re.search(r"score_mergeILi(\d)ELi(\d+)E", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        check(kind and regs and spill, f"unread ptxas line: {ln}")
        out[f"{TILED_NAMES[int(kind[1])]} rows={kind[2]}"] = [
            int(regs[1]), int(spill[1])]
    check(len(out) == 2 * len(TILED_NAMES),
          f"topk_tiled: {len(out)} entries, not {2 * len(TILED_NAMES)}")
    spilled = {k: v for k, v in out.items() if v[1]}
    check(not spilled, f"topk_tiled spills: {spilled}")
    return {"registers_and_spill_bytes": out}


def decode_ptxas(lines) -> object:
    """``ptxas``'s registers and spill stores per ``decode_fwd`` entry (K6
    over an f32 or bf16 cache, K7 over an int8 cache with an f32 or bf16 q;
    head dims 32, 64, 80, 128), checking that none spills; "not rebuilt"
    when the library was built before this run."""
    import re
    if not lines:
        return "not rebuilt in this run"
    out = {}
    for ln in lines:
        kind = re.search(r"decode_fwdI(f|13__nv_bfloat16)Li(\d+)E.*?"
                         r"(FpRows|Q8Rows)", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        check(kind and regs and spill, f"unread ptxas line: {ln}")
        name = "decode_attention" if kind[3] == "FpRows" else \
            "decode_attention_q8"
        dtype = "f32" if kind[1] == "f" else "bf16"
        out[f"{name} {dtype} D={kind[2]}"] = [int(regs[1]), int(spill[1])]
    check(len(out) == 16, f"decode_attention: {len(out)} entries, not 16")
    spilled = {k: v for k, v in out.items() if v[1]}
    check(not spilled, f"decode_attention spills: {spilled}")
    return {"registers_and_spill_bytes": out}


# the one-launch top-k kernel's entries by mode (its first template
# argument), and the device event name of each: the only top-k kernel
TILED_NAMES = ("ivf_topk", "slab_topk_fp32", "slab_topk_fp16",
               "slab_topk_int8", "slab_topk_pq")
TILED_EVENTS = {name: f"tiled::score_merge<{i}," for i, name in
                enumerate(TILED_NAMES)}


PROFILE_WINDOWS = 3   # profiler windows a one-launch check may take


def profiled_one_launch(fn, where: str) -> dict:
    """``profiled(fn, events=True)``, checking the window's device events
    against the top-k wrappers' calls in it: one ``score_merge`` event of
    the call's mode per call, and no other top-k event.  The profiler may
    drop an event of a window, so a window that shows fewer score_merge
    events than calls, and nothing else wrong, is profiled again, up to
    PROFILE_WINDOWS windows; an extra event or another top-k kernel fails at
    once.  Adds ``calls``, ``launches`` (the events counted), ``windows``
    (the windows it took) and ``short_windows`` (the events counted in each
    window that came up short)."""
    short = []
    for window in range(1, PROFILE_WINDOWS + 1):
        before = topk_calls()
        prof = profiled(fn, events=True)
        calls = calls_since(before)
        events = prof.pop("events")
        seen = {name: sum(n for k, (n, _) in events.items()
                          if TILED_EVENTS[name] in k) for name in TILED_NAMES}
        other = [k for k in events if "topk::" in k and "score_merge" not in k]
        msg = (f"{where}: calls {calls}, score_merge events {seen}, other "
               f"top-k events {other}, short windows {short}; want one "
               "score_merge launch a call")
        check(not other and all(seen[k] <= calls[k] for k in seen), msg)
        if seen == calls:
            prof.update(calls=calls, launches=seen, windows=window,
                        short_windows=short)
            return prof
        short.append(seen)
    raise AssertionError(msg)


def topk_calls() -> dict:
    """The top-k wrappers' launch counts, by TILED_NAMES name."""
    from repro_torch.kernels.ivf_topk import topk_ip
    from repro_torch.kernels.slab_topk import slab_topk
    out = {f"slab_topk_{m}": n for m, n in slab_topk.launches_by_mode.items()}
    out["ivf_topk"] = topk_ip.launches
    return out


def calls_since(before: dict) -> dict:
    return {k: n - before[k] for k, n in topk_calls().items()}


def cuda_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# torch.profiler may lose the device records of a window's first span of
# time, a longer span the longer ago the process's first window was (a
# lone kernel at a window's start goes missing within a minute of it).
# Each window therefore opens with LEAD_IN spin kernels of LEAD_IN_CYCLES
# SM cycles each (~0.1 ms at 1.98 GHz, so ~6.4 ms in all) that take that
# loss; they are left out of every count, and ``lead_in_lost`` says how
# many went missing.  A window that lost all of them may have lost records
# of ``fn`` too, and fails.  LEAD_IN_LOST keeps every window's seconds
# since the first window and its loss, printed at the end.
LEAD_IN, LEAD_IN_CYCLES, LEAD_IN_EVENT = 64, 200_000, "spin_kernel"
LEAD_IN_LOST: list = []


def profiled(fn, count=(), events=False) -> dict:
    """Host wall ms of one call of ``fn`` (ending in a device sync) under
    ``torch.profiler``, the device time in it (kernels and copies only, so
    nothing is counted twice), the largest device events and, for each
    name in ``count``, how many device events had a name containing it and
    their device ms; with ``events``, every device event name's count and
    device ms.  The window's ``LEAD_IN`` spin kernels run and finish before
    ``fn`` starts and are counted nowhere."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t_window = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_IN):
            torch.cuda._sleep(LEAD_IN_CYCLES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev, lead_in_seen, lead_in_ms = {}, 0, 0.0
    for ev in prof.key_averages():
        t = (getattr(ev, "self_device_time_total", 0)
             or getattr(ev, "self_cuda_time_total", 0)) / 1e3
        if t > 0 and str(ev.device_type).endswith("CUDA"):
            if LEAD_IN_EVENT in ev.key:
                lead_in_seen += ev.count
                lead_in_ms += t
            else:
                dev[ev.key] = (ev.count, t)
    top = sorted(dev.items(), key=lambda kv: -kv[1][1])[:8]
    out = {"wall_ms": wall_ms,
           "device_ms": sum(t for _, t in dev.values()) if dev
           else "not measured",
           "top_device_events": [[k[:80], n, t] for k, (n, t) in top],
           "lead_in_lost": LEAD_IN - lead_in_seen,
           "lead_in_spin_ms": lead_in_ms / lead_in_seen if lead_in_seen
           else "not measured"}
    LEAD_IN_LOST.append((t_window, out["lead_in_lost"]))
    check(out["lead_in_lost"] < LEAD_IN, f"profiler: all {LEAD_IN} lead-in "
          "kernels of a window lost; its records of the call may be too")
    if events:
        out["events"] = dev
    if count:
        out["launches"] = {name: sum(n for k, (n, _) in dev.items()
                                     if name in k) for name in count}
        out["device_ms_of"] = {name: sum(t for k, (_, t) in dev.items()
                                         if name in k) for name in count}
    return out


def zero_launches() -> None:
    """Sets the launch counts of ``ivf_topk``, ``slab_topk`` (by mode),
    ``flash_attention`` (by mask) and ``decode_attention`` to 0."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ivf_topk import topk_ip
    from repro_torch.kernels.slab_topk import slab_topk
    topk_ip.launches = slab_topk.launches = 0
    slab_topk.launches_by_mode = dict.fromkeys(slab_topk.launches_by_mode, 0)
    flash_attention.launches = decode_attention.launches = 0
    flash_attention.launches_by_mask = dict.fromkeys(
        flash_attention.launches_by_mask, 0)


def launch_counts() -> dict:
    """The launches counted since :func:`zero_launches`."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ivf_topk import topk_ip
    from repro_torch.kernels.slab_topk import slab_topk
    return {"ivf_topk": topk_ip.launches,
            "slab_topk": dict(slab_topk.launches_by_mode),
            "flash_attention": dict(flash_attention.launches_by_mask),
            "decode_attention": decode_attention.launches}


def launch_rows(phases) -> dict:
    """The ``launches_by_phase`` of the ``kernels`` line's path rows:
    ``phases`` lists (phase, its counts as :func:`launch_counts` gives
    them, any key missing being 0, and whether its K6 launches are a
    batcher's ticks).  Returns each row's phases that launched it."""
    rows = {}
    for phase, counts, batched in phases:
        attn = counts.get("flash_attention", {})
        for row, n in (
                ("ivf_topk", counts.get("ivf_topk", 0)),
                ("slab_topk", counts.get("slab_topk", {}).get("fp32", 0)),
                ("flash_attention", attn.get("causal", 0)),
                ("flash_attention_encode", attn.get("non_causal", 0)),
                ("decode_attention_batcher" if batched
                 else "decode_attention", counts.get("decode_attention", 0))):
            if n:
                rows.setdefault(row, {})[phase] = n
    return rows


class Recorder:
    """Passes every call through to a kernel wrapper and keeps a copy of
    the first call's arguments for each ``key(*args, **kw)`` (the main
    path's real kernel inputs, per slab mode for ``slab_topk``)."""

    def __init__(self, fn, key=lambda *args, **kw: None):
        self.fn = fn
        self.key = key
        self.first = {}

    def __call__(self, *args, **kw):
        key = self.key(*args, **kw)
        if key not in self.first:
            clone = lambda a: a.clone() if hasattr(a, "clone") else a
            self.first[key] = ([clone(a) for a in args],
                               {n: clone(a) for n, a in kw.items()})
        return self.fn(*args, **kw)


class StepRecorder:
    """Passes every call through to ``decode_attention`` and keeps, per
    call, q and the K / V row the model has just inserted (row lengths[b]
    - 1 of every slot b) with its position, cloned: the cache is written
    in place."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = []

    def __call__(self, q, k, v, lengths, **kw):
        import torch
        lens = getattr(lengths, "lengths", lengths)
        pos = (torch.as_tensor(lens, device=q.device).reshape(-1).long()
               - 1).expand(q.shape[0])
        rows = torch.arange(q.shape[0], device=q.device)
        self.calls.append((q.clone(), k[rows, pos].clone(),
                           v[rows, pos].clone(), pos.clone()))
        return self.fn(q, k, v, lengths, **kw)


class EmbedLog:
    """Passes every call through to an embedder and keeps each call's
    texts, rows and host wall seconds (the rows come back to the host as
    numpy, so a call has waited for the card when it returns)."""

    def __init__(self, embedder):
        self.embedder = embedder
        self.calls = []

    def __call__(self, texts):
        t0 = time.perf_counter()
        rows = self.embedder(texts)
        self.calls.append((list(texts), rows, time.perf_counter() - t0))
        return rows


def isolated_ids_equal(vals, ids, ref_ids, full, tol) -> int:
    """Checks ids lane by lane wherever the reference score is more than
    2*tol from both neighbours in the full sorted list; returns how many
    lanes were checked."""
    srt = np.sort(full, axis=1)[:, ::-1]
    n_checked = 0
    for qi in range(vals.shape[0]):
        s = srt[qi]
        for i in range(vals.shape[1]):
            lo = s[i] - s[i + 1] if i + 1 < len(s) else np.inf
            hi = s[i - 1] - s[i] if i > 0 else np.inf
            if min(lo, hi) > 2 * tol:
                check(ids[qi, i] == ref_ids[qi, i],
                      f"id mismatch at query {qi} lane {i}")
                n_checked += 1
    return n_checked


def near_tie_mismatches(ids, ref_ids, ref_vals) -> tuple:
    """(swaps, mismatches): lanes whose id differs from the reference, split
    by whether a neighbouring reference score lies within NEAR_TIE."""
    swaps = mismatches = 0
    for qi in range(len(ids)):
        for lane in np.nonzero(np.asarray(ids[qi]) != ref_ids[qi])[0]:
            v = ref_vals[qi]
            near = any(abs(v[lane] - v[j]) <= NEAR_TIE
                       for j in (lane - 1, lane + 1) if 0 <= j < len(v))
            swaps += int(near)
            mismatches += int(not near)
    return swaps, mismatches


def tier_decisions(lats) -> list:
    return [(x.n_storage_loads, x.n_cache_hits, x.n_generated) for x in lats]


def codec_path(codec, ctx) -> dict:
    """One quantized storage tier on the card (module docstring,
    ``codec_paths``), checked against the port's CPU run."""
    import torch
    from repro_torch.convert import index_state_from_numpy
    from repro_torch.core import EdgeRAGIndex
    from repro_torch.kernels.ivf_topk import topk_ip
    from repro_torch.kernels.slab_topk import slab_topk
    from repro_torch.serving import RAGEngine

    ds, cost, dev = ctx["ds"], ctx["cost"], ctx["dev"]
    mode = "memmap" if codec == "pq" else "memory"
    roots = {side: tempfile.mkdtemp(prefix=f"{codec}_{side}_",
                                    dir=ctx["scratch"])
             if mode == "memmap" else None for side in ("card", "cpu")}
    make = lambda device, side: EdgeRAGIndex(
        DIM, ds.embedder, ds.get_chunks, cost, slo_s=ds.spec.slo_s,
        storage_codec=codec, storage_mode=mode, storage_root=roots[side],
        device=device)
    t_phase = time.perf_counter()
    ix = make(dev, "card")
    t0 = time.perf_counter()
    index_state_from_numpy(ix, ctx["centroids"], ctx["assign"], ds.chunk_ids,
                           ds.texts, ds.embeddings)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    engine = RAGEngine(ix, ctx["gen"], cost_model=cost, k=K, nprobe=NPROBE,
                       max_new_tokens=CODEC_NEW_TOKENS)
    last = slice(BATCHES * BATCH, (BATCHES + 1) * BATCH)
    queries = [f"query-{i}" for i in range(last.start, last.stop)]

    topk_ip.launches = slab_topk.launches = 0
    slab_topk.launches_by_mode = dict.fromkeys(slab_topk.launches_by_mode, 0)
    card, walls = [], []
    for b in range(BATCHES):
        t0 = time.perf_counter()
        ids, _, lats = ix.search_batch(
            ds.query_embs[b * BATCH:(b + 1) * BATCH], K, NPROBE)
        walls.append(time.perf_counter() - t0)
        card.append((ids, tier_decisions(lats)))
    resp = engine.answer_batch(queries, ds.query_embs[last], ds.get_chunks)
    launches = dict(slab_topk.launches_by_mode, ivf_topk=topk_ip.launches)

    check(all(len(r.chunk_ids) == K for r in resp), f"{codec}: short "
          f"retrieval")
    card.append(([r.chunk_ids for r in resp],
                 tier_decisions([r.retrieval for r in resp])))
    flat = [t for _, dec in card for t in dec]
    tiers = {name: sum(t[i] for t in flat) for i, name in
             enumerate(("stored", "cached", "regenerated"))}
    check(all(v > 0 for v in tiers.values()),
          f"{codec}: a tier never ran: {tiers}")
    check(launches[codec] > 0 and launches["fp32"] > 0,
          f"{codec}: slab_topk not launched in {codec} and fp32: {launches}")
    check(all(len(r.output_tokens) == CODEC_NEW_TOKENS for r in resp),
          f"{codec}: short generation")

    # the port's own CPU run: same codec, clustering and codebook
    cpu_ix = make("cpu", "cpu")
    index_state_from_numpy(cpu_ix, ctx["centroids"], ctx["assign"],
                           ds.chunk_ids, ds.texts, ds.embeddings,
                           pq_codebook=ix.storage.pq)
    swaps = mismatches = 0
    for b, (ids, dec) in enumerate(card):
        rows = slice(b * BATCH, (b + 1) * BATCH)
        chars = ([len(q) for q in queries] if b == BATCHES else None)
        c_ids, c_vals, c_lats = cpu_ix.search_batch(
            ds.query_embs[rows], K, NPROBE, query_chars=chars)
        check(tier_decisions(c_lats) == dec,
              f"{codec}: the CPU run took other tier decisions in batch {b}")
        s, m = near_tie_mismatches(ids, c_ids, c_vals)
        swaps, mismatches = swaps + s, mismatches + m
    check(mismatches == 0, f"{codec}: {mismatches} ids differ from the CPU "
          f"run outside near-ties")

    # where a warm batch's time goes: the three stages of search_batch on
    # the host clock, then one more batch under the profiler
    embs, stage_s = ds.query_embs[last], {}
    t0 = time.perf_counter()
    state = ix.search_begin(embs, K, NPROBE)
    stage_s["probe_plan"] = time.perf_counter() - t0
    ix.search_fetch(state)
    stage_s["fetch"] = time.perf_counter() - t0 - stage_s["probe_plan"]
    ix.search_finish(state)
    stage_s["pack_score"] = (time.perf_counter() - t0 - stage_s["fetch"]
                             - stage_s["probe_plan"])
    prof = profiled_one_launch(lambda: ix.search_batch(embs, K, NPROBE),
                               f"{codec} profiled batch")
    check(prof["calls"][f"slab_topk_{codec}"] > 0,
          f"{codec}: the profiled batch made no {codec} slab_topk call")

    ratio = ix.storage_bytes() / ctx["fp32_storage_bytes"]
    check(ratio == 0.5 if codec == "fp16" else ratio < 1.0,
          f"{codec}: stored bytes {ratio} of the fp32 index's")
    fp32_ids = ctx["fp32_ids"]
    recall = float(np.mean([
        len(set(ids[qi]) & set(fp32_ids[b * BATCH + qi])) / K
        for b, (ids, _) in enumerate(card[:BATCHES])
        for qi in range(BATCH)]))
    out = {"codec": codec, "storage_mode": mode,
           "stored_clusters": ix.stats()["stored_clusters"],
           "stored_bytes": ix.storage_bytes(),
           "stored_bytes_vs_fp32": ratio,
           "recall_at_10_vs_fp32": recall,
           "retrieval_wall_s_per_batch": walls,
           "answer_batch_retrieval_s": sum(r.ttft_wall_s for r in resp),
           "index_install_s": install_s, "tiers": tiers,
           "launches": launches, "cpu_match": True,
           "near_tie_swaps": swaps, "warm_batch_stage_s": stage_s,
           "warm_batch_profile": prof,
           "phase_s": time.perf_counter() - t_phase}
    for root in roots.values():
        if root:
            shutil.rmtree(root, ignore_errors=True)
    return out


REPLACES = {"fp32": 141, "fp16": 116, "int8": 121,  # kernel.py line per mode
            "pq": 102}


def check_quantized(mode, e, q, v, k, kw, rint) -> dict:
    """``slab_topk`` in a quantized mode against its plain version on the
    card at one recorded call (module docstring, ``kernels_checked``)."""
    import torch
    from repro_torch.kernels.slab_topk import NOT_PROBED, ROW_PAD, slab_topk
    from repro_torch.kernels.slab_topk.ref import NEG_INF, slab_topk_ref

    def both(e_, q_, v_, k_, kw_):
        return (slab_topk(e_, q_, v_, k_, **kw_),
                slab_topk_ref(e_, q_, v_, k_, **kw_))

    def equal(a, b):
        return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    member = v < NOT_PROBED
    lane = torch.arange(k, device=v.device)[None, :] < member.sum(1)[:, None]
    (kv, kr), (pv, pr) = both(e, q, v, k, kw)
    err = float((kv - pv)[lane].abs().max())
    out = {"max_abs_err": err, "member_pairs": int(member.sum())}
    if mode == "pq":             # gathers and adds in one order: bitwise
        check(equal((kv, kr), (pv, pr)), "slab_topk pq not bitwise equal "
              "to the plain version on the recorded inputs")
        out["tol"] = 0.0
        # m = 300: 300 KB of tables a query, past the 227 KB a block can
        # hold, staged a slice of subspaces at a time
        ew = rint((e.shape[0], 300), 0, 256).to(torch.uint8)
        lw = rint((q.shape[0], 300, 256), -1000, 1000) / 7.0
        check(equal(*both(ew, q, v, k, {"luts": lw})), "slab_topk pq with "
              "m = 300 not bitwise equal to the plain version")
        out["wide_m_checked"] = 300
    else:
        ef = e.float()
        tol = score_tol(ef, q)
        exact = q.double() @ ef.double().T
        if mode == "int8":       # the scale multiplies the finished dot
            tol *= float(kw["scales"].abs().max())
            exact = exact * kw["scales"].double()[:, 0][None, :]
        check(err <= tol, f"slab_topk {mode} error {err} > {tol}")
        out["tol"] = tol
        # the contract K3 shares with K2: fp16, and int8 with unit scales,
        # give the fp32 mode's bits on the widened slab
        unit = {"scales": torch.ones_like(kw["scales"])} if kw else {}
        check(equal(slab_topk(e, q, v, k, **unit), slab_topk(ef, q, v, k)),
              f"slab_topk {mode} does not give the fp32 mode's bits on the "
              f"widened slab")
        out["fp32_bits_on_widened"] = True
        out["ids_checked"] = isolated_ids_equal(
            torch.where(lane, kv, NEG_INF).cpu().numpy(),
            torch.where(lane, kr, -1).cpu().numpy(),
            torch.where(lane, pr, -1).cpu().numpy(),
            torch.where(member, exact, NEG_INF).cpu().numpy(), tol)
    # integer-valued inputs: small integers in fp16, int8 with power-of-two
    # scales, integer tables: every score exact in any order
    if mode == "fp16":
        ei, kwi = rint(e.shape, -3, 4).half(), {}
    elif mode == "int8":
        ei = rint(e.shape, -3, 4).to(torch.int8)
        kwi = {"scales": 2.0 ** rint(kw["scales"].shape, -4, 5)}
    else:
        ei, kwi = e, {"luts": rint(kw["luts"].shape, -8, 9)}
    qi = rint(q.shape, -2, 3)
    check(equal(*both(ei, qi, v, k, kwi)),
          f"slab_topk {mode} integer inputs not bitwise equal to the plain "
          f"version")
    if mode == "pq":             # every member scores the same
        et, kwt = e, {"luts": torch.ones_like(kw["luts"])}
    else:
        et = torch.ones_like(e)
        kwt = ({"scales": torch.full_like(kw["scales"], 0.5)}
               if mode == "int8" else {})
    check(equal(*both(et, torch.ones_like(q), v, k, kwt)),
          f"slab_topk {mode} all-tie rows")
    for i in range(q.shape[0]):
        one = {n: (a[i:i + 1] if n == "luts" else a) for n, a in kw.items()}
        s1 = slab_topk(e, q[i:i + 1], v[i:i + 1], k, **one)
        check(torch.equal(s1[0][0], kv[i]) and torch.equal(s1[1][0], kr[i]),
              f"slab_topk {mode} batch != sequential")
    rows = lambda extra, n: {name: (a[:n] if name == "scales" else a)
                             for name, a in extra.items()}
    ev, er = slab_topk(e[:0], q, v[:, :0], k, **rows(kw, 0))
    check(bool(torch.isinf(ev).all() and (er == ROW_PAD).all()),
          f"slab_topk {mode} empty slab")
    a = slab_topk(ei[:5], qi, v[:, :5], k, **rows(kwi, 5))
    b = slab_topk_ref(ei[:5], qi, v[:, :5].contiguous(), 5, **rows(kwi, 5))
    check(bool((a[1][:, 5:] == ROW_PAD).all()
               and torch.equal(a[1][:, :5], b[1])), f"slab_topk {mode} k > N")
    return out


def check_wide_rows(dev, rint) -> dict:
    """fp16 and int8 ``slab_topk`` at D = 60,000 (past the 57,573 that a
    whole query in one block's shared memory allowed) on 300 rows and 16
    queries, each probing about 40% of them: within ``score_tol`` of the
    plain version (int8: times the largest scale), and bitwise on integer
    inputs."""
    import torch
    from repro_torch.kernels.slab_topk import NOT_PROBED, slab_topk
    from repro_torch.kernels.slab_topk.ref import slab_topk_ref
    n, d, nq, k = 300, 60_000, 16, 10
    gen = torch.Generator(device=dev).manual_seed(3)
    member = torch.rand((nq, n), generator=gen, device=dev) < 0.4
    v = torch.where(member, torch.arange(n, device=dev, dtype=torch.int32),
                    NOT_PROBED).to(torch.int32)
    lane = torch.arange(k, device=dev)[None, :] < member.sum(1)[:, None]
    e = torch.randn((n, d), generator=gen, device=dev)
    q = torch.randn((nq, d), generator=gen, device=dev)
    scales = e.abs().amax(1, keepdim=True) / 127.0
    cases = {"fp16": (e.half(), {}, rint((n, d), -3, 4).half(), {}),
             "int8": ((e / scales).round().to(torch.int8), {"scales": scales},
                      rint((n, d), -3, 4).to(torch.int8),
                      {"scales": 2.0 ** rint((n, 1), -4, 5)})}
    out = {"rows": n, "d": d}
    for mode, (ew, kw, ei, kwi) in cases.items():
        (kv, kr), (pv, pr) = (slab_topk(ew, q, v, k, **kw),
                              slab_topk_ref(ew, q, v, k, **kw))
        err = float((kv - pv)[lane].abs().max())
        tol = score_tol(ew.float(), q) * (float(scales.max())
                                         if kw else 1.0)
        check(err <= tol, f"slab_topk {mode} at D = {d}: error {err} > {tol}")
        qi = rint((nq, d), -2, 3)
        a, b = slab_topk(ei, qi, v, k, **kwi), slab_topk_ref(ei, qi, v, k,
                                                            **kwi)
        check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
              f"slab_topk {mode} at D = {d}: integer inputs not bitwise "
              f"equal to the plain version")
        out[mode] = {"max_abs_err": err, "tol": tol}
    return out


def topk_library(mode, e, q, v, k, kw):
    """One PyTorch call that computes ``slab_topk``'s function in ``mode``
    on these inputs (the ``kernels`` line's yardstick, never used by the
    port): ``torch.topk`` over the masked scores, for pq a composite (one
    gather of the tables by the codes and a sum)."""
    import torch
    from repro_torch.kernels.slab_topk import NOT_PROBED
    from repro_torch.kernels.slab_topk.ref import NEG_INF

    member = v < NOT_PROBED
    if mode == "pq":
        (n, w), nq, luts = e.shape, q.shape[0], kw["luts"]
        return lambda: torch.topk(torch.where(member, luts.gather(
            2, e.long().T[None].expand(nq, w, n)).sum(1), NEG_INF), k)
    if mode == "int8":
        return lambda: torch.topk(torch.where(
            member, (q @ e.float().T) * kw["scales"].T, NEG_INF), k)
    return lambda: torch.topk(torch.where(member, q @ e.float().T, NEG_INF),
                              k)


def slab_row(mode, e, q, v, k, kw, launches, err, calls, dev_ms) -> dict:
    """The ``kernels`` line's row of ``slab_topk`` in ``mode``, timed at one
    recorded call (fp32: the main path's; the others: their codec path's).
    The bound reads each probed row once (D x 4 bytes fp32, D x 2 fp16,
    D + 4 int8 with its scale, m pq), the queries or tables, ``virt`` and
    the outputs once, against 2 D flops a member pair (int8: + 1 for the
    scale; pq: m adds).  ``calls``: (the kernel's call, the library call);
    ``dev_ms``: their device ms a call."""
    from repro_torch.kernels.slab_topk import NOT_PROBED
    from repro_torch.kernels.slab_topk.ref import slab_topk_ref

    member = v < NOT_PROBED
    pairs, rows_used = int(member.sum()), int(member.any(0).sum())
    (n, w), nq = e.shape, q.shape[0]
    rest = nq * n * 4 + nq * k * 8                   # virt in, results out
    if mode == "pq":
        lim = bound(rows_used * w + kw["luts"].numel() * 4 + rest, pairs * w)
    elif mode == "int8":
        lim = bound(rows_used * (w + 4) + nq * w * 4 + rest,
                    (2 * w + 1) * pairs)
    else:
        lim = bound(rows_used * w * e.element_size() + nq * w * 4 + rest,
                    2 * w * pairs)
    name = "slab_topk" if mode == "fp32" else f"slab_topk_{mode}"
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/slab_topk.cu",
            "replaces": f"src/repro/kernels/slab_topk/kernel.py:"
                        f"{REPLACES[mode]}",
            "launches": launches, "max_abs_err": err,
            "ms": cuda_ms(calls[0], 200),
            "plain_ms": cuda_ms(lambda: slab_topk_ref(e, q, v, k, **kw), 5),
            "bound_ms": lim[0], "bound_by": lim[1],
            "library_ms": cuda_ms(calls[1], 200),
            "device_ms": dev_ms[name]["device_ms_per_call"],
            "library_device_ms": dev_ms[f"{name}_library"]
            ["device_ms_per_call"]}


def attn_tol(d: int) -> float:
    """Bound on |kernel - plain| for an f32 attention output at head dim
    ``d``: the JAX package's own bound for its attention kernels against
    their references (2e-5 at D = 64, ``tests/test_kernels.py``), scaled by
    D / 64 for wider heads (a score's rounding grows with its terms).  The
    kernels measure 2e-7 to 6e-6 at every shape checked here.  A kernel
    that staged K and V in bf16 would err by about 2**-9 |out|, one that
    took a single TF32 product by about 2**-12 |out|; the
    ``bf16_kv_control`` and ``tf32_control`` entries show that such errors
    exceed this bound at the main path's prefill and encode inputs (and,
    for bf16, decode)."""
    return 2e-5 * max(1.0, d / 64)


def attn_err(got, ref) -> tuple:
    """(max |got - ref|, the largest |got - ref| / allowance over the
    elements; the check holds when it is <= 1).  The allowance is
    :func:`attn_tol` for f32 outputs; bf16 outputs, rounded once from f32 on
    each side, may also land one bf16 ulp of the plain element apart."""
    import torch
    diff = (got.float() - ref.float()).abs()
    allow = torch.full_like(diff, attn_tol(got.shape[-1]))
    if got.dtype == torch.bfloat16:
        r = ref.float()
        _, e = torch.frexp(r)
        allow = allow + torch.where(r == 0, 0.0, torch.ldexp(
            torch.ones_like(r), e - 8))
    return float(diff.max()), float((diff / allow).max())


def tf32(t):
    """f32 ``t`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` rounds."""
    import torch
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def sdpa(q, k, v, **kw):
    """PyTorch's ``scaled_dot_product_attention`` on the model's layout."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        enable_gqa=q.shape[2] != k.shape[2], **kw).transpose(1, 2)


def flash_plain(q, k, v, causal=True, window=0):
    from repro_torch.kernels.flash_attention import flash_attention_ref
    return flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window).transpose(1, 2)


def decode_plain(q, k, v, lengths, window=0):
    from repro_torch.kernels.decode_attention import decode_attention_ref
    return decode_attention_ref(q[:, 0], k, v, lengths, window=window)[:, None]


def generator_parity(dev) -> tuple:
    """The 2-layer full-width generator on the card and on the CPU (module
    docstring, ``generator_parity``).  Returns the phase's line and what the
    card run recorded for ``kv_int8``."""
    import copy
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    prefill)
    from repro_torch.models import model as model_mod

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(get_config(GENERATOR), num_layers=PARITY_LAYERS)
    m_cpu = init_params(cfg, seed=SEED, device="cpu")
    m_card = copy.deepcopy(m_cpu).to(dev)
    smax = MAX_PROMPT + NEW_TOKENS
    toks = torch.randint(0, cfg.vocab_size, (1, MAX_PROMPT),
                         generator=torch.Generator().manual_seed(3))
    c_cpu = init_cache(cfg, 1, smax, device=cpu)
    c_card = init_cache(cfg, 1, smax, device=dev)
    f0, d0 = flash_attention.launches, decode_attention.launches
    l_cpu, _ = prefill(m_cpu, {"tokens": toks}, c_cpu)
    l_card, _ = prefill(m_card, {"tokens": toks.to(dev)}, c_card)
    recorded = {"single": record_prompt(c_card)}
    rec = model_mod.decode_attention = StepRecorder(model_mod.decode_attention)
    errs, tokens_checked, near_ties = [], 0, 0
    for step in range(NEW_TOKENS + 1):
        lc, lk = l_cpu[0], l_card[0].cpu()
        errs.append(float((lk - lc).abs().max()))
        top2 = torch.topk(lc, 2).values
        if float(top2[0] - top2[1]) > 2 * GEN_TOL:
            check(int(lk.argmax()) == int(lc.argmax()),
                  f"generator parity: greedy token differs at step {step}")
            tokens_checked += 1
        else:
            near_ties += 1
        if step == NEW_TOKENS:
            break
        nxt = lc.argmax().reshape(1, 1)     # the same token into both
        l_cpu, _ = decode_step(m_cpu, nxt, c_cpu, MAX_PROMPT + step)
        l_card, _ = decode_step(m_card, nxt.to(dev), c_card,
                                MAX_PROMPT + step)
    model_mod.decode_attention = rec.fn
    recorded["single"]["calls"] = rec.calls
    check(max(errs) <= GEN_TOL, f"generator parity: logits differ by "
          f"{max(errs)} > {GEN_TOL}")
    launches = {"flash_attention": flash_attention.launches - f0,
                "decode_attention": decode_attention.launches - d0}
    check(launches == {"flash_attention": PARITY_LAYERS,
                       "decode_attention": PARITY_LAYERS * NEW_TOKENS},
          f"generator parity: attention launches {launches}")

    # one decode step of 4 slots at different lengths
    b = len(SLOT_LENS)
    toks4 = torch.randint(0, cfg.vocab_size, (b, MAX_PROMPT),
                          generator=torch.Generator().manual_seed(4))
    nxt4 = torch.randint(0, cfg.vocab_size, (b, 1),
                         generator=torch.Generator().manual_seed(5))
    lens = torch.tensor(SLOT_LENS)
    c_cpu = init_cache(cfg, b, smax, device=cpu)
    c_card = init_cache(cfg, b, smax, device=dev)
    prefill(m_cpu, {"tokens": toks4}, c_cpu)
    prefill(m_card, {"tokens": toks4.to(dev)}, c_card)
    recorded["slots"] = record_prompt(c_card)
    rec = model_mod.decode_attention = StepRecorder(model_mod.decode_attention)
    d0 = decode_attention.launches
    l_cpu, _ = decode_step(m_cpu, nxt4, c_cpu, lens)
    l_card, _ = decode_step(m_card, nxt4.to(dev), c_card, lens.to(dev))
    model_mod.decode_attention = rec.fn
    recorded["slots"]["calls"] = rec.calls
    check(decode_attention.launches - d0 == PARITY_LAYERS,
          "per-slot decode did not launch decode_attention")
    slot_err = float((l_card.cpu() - l_cpu).abs().max())
    check(slot_err <= GEN_TOL, f"per-slot decode: logits differ by "
          f"{slot_err} > {GEN_TOL}")
    return {"phase": "generator_parity", "generator": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "head_dim": cfg.head_dim,
            "vocab": cfg.vocab_size, "prompt": MAX_PROMPT,
            "decode_steps": NEW_TOKENS, "tol": GEN_TOL,
            "max_abs_err_per_step": errs, "tokens_checked": tokens_checked,
            "near_ties": near_ties, "launches": launches,
            "slot_lengths": list(SLOT_LENS), "slot_step_max_abs_err": slot_err,
            "phase_s": time.perf_counter() - t_phase}, recorded


def record_prompt(caches) -> dict:
    """The prompt's K / V rows of every layer's cache right after prefill
    (cloned: decode writes the cache in place)."""
    return {"prompt": [(c.k[:, :MAX_PROMPT].clone(),
                        c.v[:, :MAX_PROMPT].clone()) for c in caches]}


def int8_bound(q, k, v) -> float:
    """Bound on |int8-cache decode - fp32-cache decode| at the recorded
    activations, from the JAX package's 0.03 at unit-variance q, K and V
    (``tests/test_quantization.py:60``).  The error has two terms: V's
    rounding (each element within amax / 254 of its row, so it scales with
    V's magnitude) and V weighted by the change in the softmax weights that
    K's rounding makes in the scores q . k / sqrt(D) (it scales with V's
    magnitude times q's and K's).  So 0.03 is scaled by the recorded V's
    rms, and by rms(q) * rms(K) where that exceeds 1 (unit inputs give 1)."""
    rms = lambda t: float(t.float().square().mean().sqrt())
    return INT8_UNIT_BOUND * rms(v) * max(1.0, rms(q) * rms(k))


def kv_int8(dev, recorded) -> dict:
    """The int8 KV cache decoded through K7 on the recorded K / V and q of
    ``generator_parity`` (module docstring, ``kv_int8``).  Returns the
    phase's line; its ``"row"`` holds the inputs the ``kernels`` line times
    K7 at."""
    import torch
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_q8, decode_attention_q8_ref)
    from repro_torch.models.quantization import (
        QuantKV, dequantize_kv, init_quant_cache, quant_insert, quantize_kv)

    t_phase = time.perf_counter()
    layers, smax = PARITY_LAYERS, MAX_PROMPT + NEW_TOKENS
    tol = attn_tol(recorded["single"]["prompt"][0][0].shape[-1])
    stats = {"max_abs_err": 0.0, "err_over_allowance": 0.0,
             "vs_k6_dequant_max_abs_err": 0.0,
             "vs_k6_dequant_err_over_allowance": 0.0,
             "vs_k6_dequant_bitwise_calls": 0, "vs_fp32_max_abs_err": 0.0}

    def plain(q, ck, cv, lens):
        return decode_attention_q8_ref(q[:, 0], ck.q, ck.scale, cv.q,
                                       cv.scale, lens)[:, None]

    def held(out, q, ck, cv, fk, fv, lens, where):
        err, ratio = attn_err(out, plain(q, ck, cv, lens))
        check(ratio <= 1, f"kv_int8 {where}: K7 vs plain {err} is {ratio} x "
              f"its allowance")
        k6 = decode_attention(q, dequantize_kv(ck), dequantize_kv(cv), lens)
        err6, ratio6 = attn_err(out, k6)
        check(ratio6 <= 1, f"kv_int8 {where}: K7 vs K6 on the dequantized "
              f"cache {err6} is {ratio6} x its allowance")
        err_fp = float((out - decode_attention(q, fk, fv, lens)).abs().max())
        stats["max_abs_err"] = max(stats["max_abs_err"], err)
        stats["err_over_allowance"] = max(stats["err_over_allowance"], ratio)
        stats["vs_k6_dequant_max_abs_err"] = max(
            stats["vs_k6_dequant_max_abs_err"], err6)
        stats["vs_k6_dequant_err_over_allowance"] = max(
            stats["vs_k6_dequant_err_over_allowance"], ratio6)
        stats["vs_k6_dequant_bitwise_calls"] += int(torch.equal(out, k6))
        stats["vs_fp32_max_abs_err"] = max(stats["vs_fp32_max_abs_err"],
                                           err_fp)

    def caches(batch, prompt):
        """Per layer: the int8 K and V caches with the prompt's rows
        inserted at 0, and the fp32 caches the model held."""
        out = []
        for k0, v0 in prompt:
            kh, d = k0.shape[2:]
            ck = init_quant_cache(batch, smax, kh, d, device=dev)
            cv = init_quant_cache(batch, smax, kh, d, device=dev)
            quant_insert(ck, k0, 0)
            quant_insert(cv, v0, 0)
            fk = torch.zeros((batch, smax, kh, d), device=dev)
            fv = torch.zeros_like(fk)
            fk[:, :MAX_PROMPT], fv[:, :MAX_PROMPT] = k0, v0
            out.append((ck, cv, fk, fv))
        return out

    single, slots = recorded["single"], recorded["slots"]
    check(len(single["calls"]) == layers * NEW_TOKENS
          and len(slots["calls"]) == layers,
          f"kv_int8: recorded {len(single['calls'])} + "
          f"{len(slots['calls'])} decode calls")
    want = layers * NEW_TOKENS + layers
    # ---- the path: counts zeroed just before, read just after ----------
    decode_attention_q8.launches = 0
    one = caches(1, single["prompt"])
    for i, (q, kr, vr, pos) in enumerate(single["calls"]):
        layer, step = i % layers, i // layers
        ck, cv, fk, fv = one[layer]
        check(int(pos[0]) == MAX_PROMPT + step,
              f"kv_int8: step {step} inserted at {int(pos[0])}")
        quant_insert(ck, kr[:, None], MAX_PROMPT + step)
        quant_insert(cv, vr[:, None], MAX_PROMPT + step)
        fk[:, MAX_PROMPT + step], fv[:, MAX_PROMPT + step] = kr, vr
        length = MAX_PROMPT + step + 1
        out = decode_attention_q8(q, ck.q, ck.scale, cv.q, cv.scale, length)
        held(out, q, ck, cv, fk, fv, length, f"layer {layer} step {step}")
    four = caches(len(SLOT_LENS), slots["prompt"])
    slot_outs = []
    for layer, (q, kr, vr, pos) in enumerate(slots["calls"]):
        ck, cv, fk, fv = four[layer]
        check(pos.tolist() == list(SLOT_LENS), f"kv_int8: 4-slot step "
              f"inserted at {pos.tolist()}")
        quant_insert(ck, kr[:, None], pos)
        quant_insert(cv, vr[:, None], pos)
        rows = torch.arange(len(SLOT_LENS), device=dev)
        fk[rows, pos], fv[rows, pos] = kr, vr
        lens = (pos + 1).to(torch.int32)
        out = decode_attention_q8(q, ck.q, ck.scale, cv.q, cv.scale, lens)
        held(out, q, ck, cv, fk, fv, lens, f"4-slot layer {layer}")
        slot_outs.append((q, ck, cv, lens, out))
    launches = decode_attention_q8.launches
    check(launches == want, f"kv_int8: K7 launched {launches} times, the "
          f"loop implies {want}")
    check(stats["vs_k6_dequant_bitwise_calls"] == want, f"kv_int8: K7 gave "
          f"K6's bits on the dequantized cache at "
          f"{stats['vs_k6_dequant_bitwise_calls']} of {want} calls")

    # ---- the int8 cache against the fp32 one ---------------------------
    qs = torch.cat([c[0].flatten() for c in single["calls"] + slots["calls"]])
    ks = torch.cat([t[0].flatten() for t in single["prompt"] + slots["prompt"]]
                   + [c[1].flatten() for c in single["calls"]
                      + slots["calls"]])
    vs = torch.cat([t[1].flatten() for t in single["prompt"] + slots["prompt"]]
                   + [c[2].flatten() for c in single["calls"]
                      + slots["calls"]])
    bound = int8_bound(qs, ks, vs)
    check(stats["vs_fp32_max_abs_err"] <= bound, f"kv_int8: int8 vs fp32 "
          f"cache {stats['vs_fp32_max_abs_err']} > {bound}")

    # ---- control: every scale 1 must miss the bound ----------------------
    control = []
    for (q, kr, vr, pos), (ck, cv, _, _) in zip(single["calls"][-layers:],
                                                 one):
        ones = lambda c: QuantKV(c.q, torch.ones_like(c.scale))
        length = int(pos[0]) + 1
        got = decode_attention_q8(q, *ones(ck), *ones(cv), length)
        control.append(attn_err(got, plain(q, ck, cv, length))[1])
    check(min(control) > 1, f"kv_int8: K7 with unit scales stays within the "
          f"bound ({control} x), so the bound cannot tell the scales "
          f"reached the kernel")

    # ---- batch == sequential, bitwise ------------------------------------
    for q, ck, cv, lens, out in slot_outs:
        for i in range(len(SLOT_LENS)):
            s_ = slice(i, i + 1)
            got = decode_attention_q8(q[s_], ck.q[s_], ck.scale[s_], cv.q[s_],
                                      cv.scale[s_], lens[s_])
            check(torch.equal(got[0], out[i]),
                  f"kv_int8: batch != sequential at slot {i}")

    # ---- quantize_kv on the card against the CPU -------------------------
    kv_rows = torch.cat([t.reshape(-1, *t.shape[-2:]) for pair in
                      single["prompt"] + slots["prompt"] for t in pair]
                     + [t.reshape(-1, *t.shape[-2:]) for c in
                        single["calls"] + slots["calls"] for t in c[1:3]])
    card, cpu = quantize_kv(kv_rows), quantize_kv(kv_rows.cpu())
    check(torch.equal(card.scale.cpu(), cpu.scale),
          "kv_int8: quantize_kv scales differ between the card and the CPU")
    y = kv_rows.cpu() / cpu.scale
    ay = y.abs()
    near_half = ((ay - ay.floor() - 0.5).abs()
                 <= torch.nextafter(ay, torch.full_like(ay, float("inf")))
                 - ay)
    differ = card.q.cpu() != cpu.q
    check(not bool((differ & ~near_half).any()), "kv_int8: quantize_kv "
          "codes differ away from half-integers")

    # ---- more shapes against the plain version ---------------------------
    gen = torch.Generator(device=dev).manual_seed(7)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    extra = {}
    for name, (b, smax_, h, kh, d, lens, window, dtype) in {
            "d32": (2, 128, 8, 8, 32, [128, 60], 0, torch.float32),
            "mixed_gqa4_window_bf16": (4, 144, 32, 8, 80, [1, 77, 144, 300],
                                       16, torch.bfloat16),
            "no_valid_position": (2, 64, 4, 2, 64, [1000, 70], 5,
                                  torch.float32)}.items():
        q = rand(b, 1, h, d).to(dtype)
        ck, cv = quantize_kv(rand(b, smax_, kh, d)), \
            quantize_kv(rand(b, smax_, kh, d))
        lt = torch.tensor(lens, dtype=torch.int32, device=dev)
        got = decode_attention_q8(q, ck.q, ck.scale, cv.q, cv.scale, lt,
                                  window=window)
        ref = decode_attention_q8_ref(q[:, 0], ck.q, ck.scale, cv.q,
                                      cv.scale, lt, window=window)[:, None]
        err, ratio = attn_err(got, ref)
        check(ratio <= 1, f"kv_int8 {name}: {err} is {ratio} x its "
              f"allowance")
        extra[name] = {"shape": list(q.shape), "cache": list(ck.q.shape),
                       "lengths": lens, "window": window,
                       "dtype": str(dtype)[6:], "max_abs_err": err,
                       "err_over_allowance": ratio}

    ck = one[0][0]
    cache_bytes = ck.q.numel() * ck.q.element_size() + \
        ck.scale.numel() * ck.scale.element_size()
    vs_fp32, vs_bf16 = cache_bytes / (ck.q.numel() * 4), \
        cache_bytes / (ck.q.numel() * 2)
    check(vs_bf16 < 0.6, f"kv_int8: QuantKV is {vs_bf16} of a bf16 cache")
    q0 = single["calls"][0][0]
    return {"phase": "kv_int8", "layers": layers,
            "cache": list(ck.q.shape), "decode_steps": NEW_TOKENS,
            "slot_lengths": list(SLOT_LENS), "launches": launches,
            "launches_implied": want, "tol": tol, **stats,
            "vs_fp32_bound": bound, "rms_q_k_v": [
                float(t.square().mean().sqrt()) for t in (qs, ks, vs)],
            "unit_scales_control_err_over_allowance": control,
            "batch_vs_sequential": "bitwise",
            "quantize_kv_card_vs_cpu": {
                "scales": "bitwise", "elements": kv_rows.numel(),
                "codes_differ": int(differ.sum()),
                "within_one_ulp_of_half": int(near_half.sum())},
            "quant_bytes_vs_fp32": vs_fp32, "quant_bytes_vs_bf16": vs_bf16,
            "extra_shapes": extra, "phase_s": time.perf_counter() - t_phase,
            "row": (q0, one[0][0], one[0][1], MAX_PROMPT + 1)}


class BatcherLog:
    """Wraps a batcher's ``admit`` and ``tick`` (instance attributes, so
    its ``run`` calls them) and the model's ``decode_attention``: the
    ticks so far at each admission, the sorted distinct lengths that the
    active slots of each tick with one attend over (from the host's
    ``lens``), the host seconds of each admission and of each tick with an
    active slot (each ends in a copy to the host, so they cover the
    device's work), and a clone of the first K6 call (q, K and V of the
    whole cache, the (S,) lengths) of the first tick with the most
    distinct active lengths so far."""

    def __init__(self, batcher, decode_fn):
        self.fn = decode_fn
        self.admitted_at, self.tick_lens = [], []
        self.admit_s, self.tick_s = [], []
        self.ticks, self.armed, self.k6_call = 0, False, None
        admit, tick = batcher.admit, batcher.tick

        def admit_(*args, **kw):
            t0 = time.perf_counter()
            slot = admit(*args, **kw)
            if slot is not None:
                self.admit_s.append(time.perf_counter() - t0)
                self.admitted_at.append(self.ticks)
            return slot

        def tick_():
            active = [i for i, s in enumerate(batcher.slots) if not s.free]
            if active:
                lens = sorted(set((batcher.lens[active] + 1).tolist()))
                self.armed = len(lens) > max(
                    (len(t) for t in self.tick_lens), default=0)
                self.tick_lens.append(lens)
            self.ticks += 1
            t0 = time.perf_counter()
            n = tick()
            if active:
                self.tick_s.append(time.perf_counter() - t0)
            return n
        batcher.admit, batcher.tick = admit_, tick_

    def __call__(self, q, k, v, lengths, **kw):
        if self.armed:
            self.armed = False
            self.k6_call = (q.clone(), k.clone(), v.clone(),
                            getattr(lengths, "lengths", lengths).clone())
        return self.fn(q, k, v, lengths, **kw)


def batcher_trace(vocab: int) -> list:
    """The phase's seeded trace: prompts of 16-128 tokens drawn in [2,
    vocab), budgets of 1-``NEW_TOKENS`` tokens."""
    rng = np.random.default_rng(SEED + 24)
    return [{"id": i, "prompt_tokens": rng.integers(
                 2, vocab, int(rng.integers(16, MAX_PROMPT + 1))).tolist(),
             "max_new_tokens": int(rng.integers(1, NEW_TOKENS + 1))}
            for i in range(TRACE_REQUESTS)]


def lone_run(model, prompt, budget, dev) -> tuple:
    """One request alone: prefill, then ``decode_step`` on a one-row cache
    of the batcher's length (``tests/test_batching.py``'s
    ``sequential_generate``).  Returns (greedy tokens, each one's top-2
    logit margin)."""
    import torch
    from repro_torch.models import decode_step, init_cache, prefill
    caches = init_cache(model.cfg, 1, BATCHER_LEN, device=dev)
    logits, _ = prefill(model, {"tokens": torch.tensor(
        [prompt], dtype=torch.long, device=dev)}, caches)
    toks, margins = [], []
    for i in range(budget):
        toks.append(int(logits[0].argmax()))
        top2 = torch.topk(logits[0], 2).values.tolist()
        margins.append(top2[0] - top2[1])
        if i + 1 < budget:
            logits, _ = decode_step(model, torch.tensor(
                [[toks[-1]]], dtype=torch.long, device=dev), caches,
                len(prompt) + i)
    return toks, margins


def near_tie_compare(got, want, margins) -> tuple:
    """``got == want`` token by token while the reference's top-2 margin
    exceeds 2 x ``GEN_TOL``; at the first step under it the request stops
    being compared.  Returns (tokens compared, 1 if it stopped at a
    near-tie else 0)."""
    for t, (a, b, m) in enumerate(zip(got, want, margins)):
        if m <= 2 * GEN_TOL:
            return t, 1
        check(a == b, f"continuous_batching: token {t} is {a}, the lone "
              f"run's {b} (margin {m})")
    return len(want), 0


def logged_run(batcher, requests) -> dict:
    """``batcher.run(requests)`` with every admission's and tick's logits
    kept on the host per request (``batching.prefill`` and
    ``decode_step`` wrapped): row t of a request gave its token t."""
    from repro_torch.serving import batching as batching_mod
    prefill_fn, decode_fn = batching_mod.prefill, batching_mod.decode_step
    rows, last = {}, {}
    admit = batcher.admit

    def prefill_(*args, **kw):
        out = prefill_fn(*args, **kw)
        last["row"] = out[0][0].cpu()
        return out

    def decode_(*args, **kw):
        out = decode_fn(*args, **kw)
        host = out[0].cpu()
        for i, s in enumerate(batcher.slots):
            if not s.free:
                rows[s.request_id].append(host[i])
        return out

    def admit_(rid, *args):
        slot = admit(rid, *args)
        if slot is not None:
            rows[rid] = [last.pop("row")]
        return slot
    batcher.admit = admit_
    batching_mod.prefill, batching_mod.decode_step = prefill_, decode_
    try:
        outs = batcher.run(requests)
    finally:
        batching_mod.prefill, batching_mod.decode_step = prefill_fn, decode_fn
    return {"outs": {r["id"]: outs[r["id"]] for r in requests}, "rows": rows}


def continuous_batching(ctx) -> tuple:
    """``ContinuousBatcher`` on the main path's generator (module
    docstring, ``continuous_batching``).  Returns the phase's line and the
    recorded K6 call at the batcher's shape with its error, for the
    ``kernels`` line."""
    import copy
    import dataclasses
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import init_params
    from repro_torch.models import model as model_mod
    from repro_torch.serving import ContinuousBatcher

    t_phase = time.perf_counter()
    dev, gen, engine, ds = ctx["dev"], ctx["gen"], ctx["engine"], ctx["ds"]
    gcfg, layers = gen.cfg, gen.cfg.num_layers
    vocab = gcfg.vocab_size
    b = ContinuousBatcher(gcfg, gen.params, num_slots=BATCH,
                          max_len=BATCHER_LEN, device=dev)
    log = BatcherLog(b, model_mod.decode_attention)
    rec_odd = Recorder(model_mod.flash_attention,
                       lambda q, k, v, causal=True, window=0:
                       (causal, q.shape[1] % 2))
    model_mod.decode_attention, model_mod.flash_attention = log, rec_odd

    def zero_counts():
        flash_attention.launches = decode_attention.launches = 0
        flash_attention.launches_by_mask = dict.fromkeys(
            flash_attention.launches_by_mask, 0)

    def read_counts():
        return {"flash_attention": dict(flash_attention.launches_by_mask),
                "decode_attention": decode_attention.launches}

    # (a) the seeded trace, one run
    trace = batcher_trace(vocab)
    zero_counts()
    t0 = time.perf_counter()
    outs = dict(b.run(trace))           # (b) reuses ids in ``completed``
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches_a = read_counts()
    admissions, active_ticks = len(log.admitted_at), len(log.tick_lens)
    ticks_a = log.ticks

    # (b) one batch of the main path's queries through the engine
    qs = [f"query-{i}" for i in range(BATCH)]
    n_adm, n_tick = admissions, active_ticks
    zero_counts()
    t0 = time.perf_counter()
    resp = engine.answer_batch(qs, ds.query_embs[:BATCH], ds.get_chunks,
                               batcher=b)
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0
    launches_b = read_counts()
    model_mod.decode_attention, model_mod.flash_attention = log.fn, rec_odd.fn
    adm_b, ticks_b = len(log.admitted_at) - n_adm, len(log.tick_lens) - n_tick

    # 1. every request completes with its budget of tokens, in range
    check(sorted(outs) == list(range(TRACE_REQUESTS)) and all(
        len(outs[r["id"]]) == r["max_new_tokens"] for r in trace),
        "continuous_batching: a request of the trace did not complete with "
        "its budget")
    check(all(len(r.output_tokens) == NEW_TOKENS for r in resp),
          "continuous_batching: an engine request is short of its budget")
    check(all(0 <= t < vocab for toks in [outs[i] for i in outs]
              + [r.output_tokens for r in resp] for t in toks),
          "continuous_batching: a token out of range")
    # 2. it was continuous
    check(max(log.admitted_at[:n_adm]) > 0,
          "continuous_batching: every admission came before the first tick")
    most = max(len(t) for t in log.tick_lens[:n_tick])
    check(most >= 4, f"continuous_batching: at most {most} distinct "
          f"lengths in a tick")
    # 3. exact launch counts
    want_a = {"flash_attention": {"causal": layers * admissions,
                                  "non_causal": 0},
              "decode_attention": layers * active_ticks}
    check(launches_a == want_a, f"continuous_batching: launches in the "
          f"trace {launches_a}, want {want_a}")
    want_b = {"causal": layers * BATCH, "decode": layers * NEW_TOKENS}
    check(adm_b == BATCH and ticks_b == NEW_TOKENS and launches_b == {
              "flash_attention": {"causal": want_b["causal"],
                                  "non_causal": 0},
              "decode_attention": want_b["decode"]},
          f"continuous_batching: the engine batch launched {launches_b} "
          f"in {adm_b} admissions and {ticks_b} ticks, want {want_b}")

    # 4. each request alone on the card, full depth
    t0 = time.perf_counter()
    room = BATCHER_LEN - NEW_TOKENS - 1
    lone_cases = [(r["prompt_tokens"], r["max_new_tokens"], outs[r["id"]])
                  for r in trace]
    lone_cases += [(gen.tokenizer.encode(" ".join(
        ds.get_chunks(r.chunk_ids) + [r.query]), BATCHER_LEN)[:room],
        NEW_TOKENS, r.output_tokens) for r in resp]
    compared = near_ties = total = 0
    for prompt, budget, got in lone_cases:
        want, margins = lone_run(gen.params, prompt, budget, dev)
        n, tie = near_tie_compare(got, want, margins)
        compared, near_ties, total = compared + n, near_ties + tie, \
            total + budget
    lone_s = time.perf_counter() - t0
    check(compared >= 0.9 * total, f"continuous_batching: {compared} of "
          f"{total} tokens compared with the lone runs")

    # (c) + 5. card against CPU: 2 layers at full width, 4 slots
    cpu = torch.device("cpu")
    cfg2 = dataclasses.replace(gcfg, num_layers=PARITY_LAYERS)
    m_cpu = init_params(cfg2, seed=SEED, device="cpu")
    m_card = copy.deepcopy(m_cpu).to(dev)
    par = trace[:PARITY_REQUESTS]
    runs = {name: logged_run(ContinuousBatcher(
                cfg2, m, num_slots=PARITY_SLOTS, max_len=BATCHER_LEN,
                device=d), par)
            for name, m, d in (("card", m_card, dev), ("cpu", m_cpu, cpu))}
    par_compared = par_ties = 0
    par_err = 0.0
    for r in par:
        rid = r["id"]
        tk, tc = runs["card"]["outs"][rid], runs["cpu"]["outs"][rid]
        rk, rc = runs["card"]["rows"][rid], runs["cpu"]["rows"][rid]
        check(len(rk) == len(rc) == r["max_new_tokens"] + 1,
              f"continuous_batching: {len(rk)} / {len(rc)} logit rows for "
              f"request {rid}")
        for t, (lk, lc) in enumerate(zip(rk, rc)):
            if t and tk[t - 1] != tc[t - 1]:
                break                       # the inputs differ from here
            par_err = max(par_err, float((lk - lc).abs().max()))
            if t == len(tc):
                break
            top2 = torch.topk(lc, 2).values
            if float(top2[0] - top2[1]) > 2 * GEN_TOL:
                check(tk[t] == tc[t], f"continuous_batching: card token "
                      f"{t} of request {rid} differs from the CPU's")
                par_compared += 1
            else:
                par_ties += 1
    check(par_err <= GEN_TOL, f"continuous_batching: card logits differ "
          f"from the CPU's by {par_err} > {GEN_TOL}")
    del m_cpu, m_card, runs

    # 6. the recorded K6 and odd-length K5 calls against the plain versions
    q, kc, vc, lens = log.k6_call
    check(q.shape[0] == BATCH and kc.shape[1] == BATCHER_LEN,
          f"continuous_batching: recorded K6 call {tuple(q.shape)}")
    k6_err, k6_ratio = attn_err(decode_attention(q, kc, vc, lens),
                                decode_plain(q, kc, vc, lens))
    check(k6_ratio <= 1, f"continuous_batching: K6 error {k6_err} is "
          f"{k6_ratio} x its allowance")
    check((True, 1) in rec_odd.first, "continuous_batching: no prefill at "
          "an odd prompt length")
    (qo, ko, vo), _ = rec_odd.first[(True, 1)]
    k5_err, k5_ratio = attn_err(flash_attention(qo, ko, vo, causal=True),
                                flash_plain(qo, ko, vo, True))
    check(k5_ratio <= 1, f"continuous_batching: K5 error {k5_err} at "
          f"length {qo.shape[1]} is {k5_ratio} x its allowance")

    main = ctx["per_batch"]
    line = {
        "phase": "continuous_batching", "generator": gcfg.name,
        "layers": layers, "slots": BATCH, "max_len": BATCHER_LEN,
        "kv_cache_bytes": sum(c.k.numel() * 4 * 2 for c in b.caches),
        "trace": {"requests": TRACE_REQUESTS, "prompt_tokens": [
                      len(r["prompt_tokens"]) for r in trace],
                  "budgets": [r["max_new_tokens"] for r in trace],
                  "wall_s": wall_a, "ticks": ticks_a,
                  "ticks_with_active_slot": active_ticks,
                  "admissions": admissions,
                  "admitted_at_tick": log.admitted_at[:n_adm],
                  "launches": launches_a,
                  "admissions_s": sum(log.admit_s[:n_adm]),
                  "ticks_s": sum(log.tick_s[:n_tick]),
                  "distinct_lengths_per_tick": [
                      len(t) for t in log.tick_lens[:n_tick]],
                  "most_distinct_lengths": most},
        "engine": {"requests": BATCH, "new_tokens": NEW_TOKENS,
                   "wall_s": wall_b, "admissions": adm_b,
                   "ticks": ticks_b, "launches": launches_b,
                   "admissions_s": log.admit_s[n_adm:n_adm + adm_b],
                   "ticks_s": log.tick_s[n_tick:n_tick + ticks_b],
                   "decode_wall_s_per_query": resp[0].decode_wall_s,
                   "retrieval_wall_s": sum(r.ttft_wall_s for r in resp),
                   "main_path_batch0_per_query": {
                       "decode_s": main[0]["decode_s"] / BATCH,
                       "prefill_plus_decode_s": (main[0]["prefill_s"]
                                                 + main[0]["decode_s"])
                       / BATCH},
                   "main_path_mean_per_query_prefill_plus_decode_s":
                       sum(p["prefill_s"] + p["decode_s"] for p in main)
                       / (len(main) * BATCH),
                   "tiers": {"stored": sum(r.retrieval.n_storage_loads
                                           for r in resp),
                             "cached": sum(r.retrieval.n_cache_hits
                                           for r in resp),
                             "regenerated": sum(r.retrieval.n_generated
                                                for r in resp)}},
        "lone_runs": {"requests": len(lone_cases), "tokens": total,
                      "compared": compared, "near_ties": near_ties,
                      "seconds": lone_s, "tol": GEN_TOL},
        "card_vs_cpu": {"layers": PARITY_LAYERS, "slots": PARITY_SLOTS,
                        "requests": PARITY_REQUESTS,
                        "tokens_compared": par_compared,
                        "near_ties": par_ties, "max_abs_logit_err": par_err,
                        "tol": GEN_TOL},
        "k6_recorded": {"shape": list(q.shape), "cache": list(kc.shape),
                        "lengths": lens.tolist(), "max_abs_err": k6_err,
                        "err_over_allowance": k6_ratio},
        "k5_odd_length": {"shape": list(qo.shape), "max_abs_err": k5_err,
                          "err_over_allowance": k5_ratio},
        "phase_s": time.perf_counter() - t_phase}
    del b
    return line, {"call": log.k6_call, "max_abs_err": k6_err}


def encode_phase(dev, texts) -> dict:
    """gte-base at full width, ``encode`` on the card against the CPU
    (module docstring, ``encode``)."""
    import copy
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.tokenizer import HashingTokenizer
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import encode, init_params

    t_phase = time.perf_counter()
    cfg = get_config(ENCODER)
    m_cpu = init_params(cfg, seed=SEED, device="cpu")
    m_card = copy.deepcopy(m_cpu).to(dev)
    ids, mask = HashingTokenizer(vocab_size=cfg.vocab_size).encode_batch(
        texts, ENC_LEN)
    ids, mask = torch.from_numpy(ids).long(), torch.from_numpy(mask)
    flash_attention.launches = 0
    flash_attention.launches_by_mask = dict.fromkeys(
        flash_attention.launches_by_mask, 0)
    t0 = time.perf_counter()
    emb = encode(m_card, {"tokens": ids.to(dev), "attn_mask": mask.to(dev)})
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(flash_attention.launches_by_mask)
    check(launches == {"causal": 0, "non_causal": cfg.num_layers},
          f"encode: flash_attention launches {launches}")
    check(emb.shape == (len(texts), cfg.d_model)
          and bool(torch.isfinite(emb).all()), "encode: bad embeddings")
    norm_err = float((emb.norm(dim=-1) - 1).abs().max())
    check(norm_err < 1e-5, f"encode: rows not unit norm ({norm_err})")
    e_cpu = encode(m_cpu, {"tokens": ids[:8], "attn_mask": mask[:8]})
    err = float((emb[:8].cpu() - e_cpu).abs().max())
    check(err <= ENC_TOL, f"encode: card vs CPU {err} > {ENC_TOL}")
    return {"phase": "encode", "encoder": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "head_dim": cfg.head_dim,
            "texts": len(texts), "tokens_per_text": ENC_LEN,
            "encode_wall_s": wall_s, "launches": launches,
            "unit_norm_max_err": norm_err, "rows_vs_cpu": 8,
            "max_abs_err_vs_cpu": err, "tol": ENC_TOL,
            "phase_s": time.perf_counter() - t_phase}


def online_index(ctx) -> tuple:
    """EdgeRAG with gte-base at full width on the card as ``embed_fn``:
    the build embeds the corpus through it and every regenerated cluster
    goes through it again (module docstring, ``online_index``).  Returns
    the phase's line and what ``staged_pipeline`` reuses: the embedder,
    the build's rows, centroids and assignment, and the query texts and
    rows."""
    import copy
    import torch
    from repro_torch.convert import index_state_from_numpy
    from repro_torch.core import EdgeRAGIndex
    from repro_torch.data import ModelEmbedder, TableEmbedder
    from repro_torch.data.embedder import MICRO_BATCH
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import encode
    from repro_torch.serving import RAGEngine

    ds, cost, dev, gen = ctx["ds"], ctx["cost"], ctx["dev"], ctx["gen"]
    gcfg = gen.cfg
    t_phase = time.perf_counter()
    embedder = ModelEmbedder(reduced=False, seed=SEED, device=dev)
    cfg = embedder.cfg
    check(MICRO_BATCH == ENC_TEXTS and embedder.max_len == ENC_LEN,
          "online_index: the embedder's micro-batch is not the encode shape")
    log = EmbedLog(embedder)
    index = EdgeRAGIndex(DIM, log, ds.get_chunks, cost, slo_s=ds.spec.slo_s,
                         device=dev)
    # query q is the text of one chunk of its topic, drawn with the seed
    rng = np.random.default_rng(SEED)
    n_q = (BATCHES + 1) * BATCH
    src = np.array([rng.choice(np.flatnonzero(ds.topic_of_chunk == t))
                    for t in ds.query_topic[:n_q]])
    queries = [ds.texts[i] for i in src]

    # ---- the path: counts zeroed just before, read just after ----------
    zero_launches()
    t0 = time.perf_counter()
    assign = index.build(ds.chunk_ids, ds.texts, nlist=NLIST, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    (_, built, build_embed_s), = log.calls      # one call over the corpus
    build_micro = embedder.micro_batches
    build_tokenize_s = embedder.tokenize_s
    t0 = time.perf_counter()
    q_embs = embedder(queries)
    query_embed_s = time.perf_counter() - t0
    per_batch, card = [], []
    for b in range(BATCHES):
        # search_batch's three stages, timed apart
        n_calls, micro = len(log.calls), embedder.micro_batches
        tok = embedder.tokenize_s
        t0 = time.perf_counter()
        state = index.search_begin(q_embs[b * BATCH:(b + 1) * BATCH], K,
                                   NPROBE)
        t1 = time.perf_counter()
        index.search_fetch(state)
        t2 = time.perf_counter()
        ids, _, lats = index.search_finish(state)
        t3 = time.perf_counter()
        new = log.calls[n_calls:]
        per_batch.append({
            "retrieval_s": t3 - t0, "probe_plan_s": t1 - t0,
            "fetch_s": t2 - t1, "pack_score_s": t3 - t2,
            "embed_s": sum(c[2] for c in new), "embed_calls": len(new),
            "rows_regenerated": sum(len(c[0]) for c in new),
            "micro_batches": embedder.micro_batches - micro,
            "tokenize_s": embedder.tokenize_s - tok})
        card.append((ids, state.plan.probed_per_q, tier_decisions(lats)))
    before_answer = dict(flash_attention.launches_by_mask)
    engine = RAGEngine(index, gen, cost_model=cost, k=K, nprobe=NPROBE,
                       max_new_tokens=CODEC_NEW_TOKENS)
    last = slice(BATCHES * BATCH, n_q)
    n_calls, micro = len(log.calls), embedder.micro_batches
    p0, d0 = gen.prefill_wall_s, gen.decode_wall_s
    t0 = time.perf_counter()
    resp = engine.answer_batch(queries[last], q_embs[last], ds.get_chunks)
    answer_s = time.perf_counter() - t0
    launches = launch_counts()
    micro_batches = embedder.micro_batches
    new = log.calls[n_calls:]
    answer = {"wall_s": answer_s,
              "retrieval_s": sum(r.ttft_wall_s for r in resp),
              "prefill_s": gen.prefill_wall_s - p0,
              "decode_s": gen.decode_wall_s - d0,
              "embed_s": sum(c[2] for c in new),
              "rows_regenerated": sum(len(c[0]) for c in new),
              "micro_batches": embedder.micro_batches - micro}

    # 1. every tier ran
    card.append(([r.chunk_ids for r in resp], None,
                 tier_decisions([r.retrieval for r in resp])))
    flat = [t for _, _, dec in card for t in dec]
    tiers = {name: sum(t[i] for t in flat) for i, name in
             enumerate(("stored", "cached", "regenerated"))}
    check(all(v > 0 for v in tiers.values()),
          f"online_index: a tier never ran: {tiers}")
    check(all(len(r.chunk_ids) == K
              and len(r.output_tokens) == CODEC_NEW_TOKENS for r in resp),
          "online_index: short retrieval or generation")
    # 2. K5 non-causal once a layer a micro-batch; causal only in prefill
    want = {"causal": gcfg.num_layers * BATCH,
            "non_causal": cfg.num_layers * micro_batches}
    check(before_answer["causal"] == 0
          and launches["flash_attention"] == want
          and launches["decode_attention"]
          == gcfg.num_layers * CODEC_NEW_TOKENS * BATCH
          and launches["ivf_topk"] > 0 and launches["slab_topk"]["fp32"] > 0,
          f"online_index: launches {launches} ({micro_batches} "
          f"micro-batches, causal {before_answer['causal']} before "
          f"answer_batch); want flash_attention {want}")
    # the build's rows: finite, unit norm
    check(built.shape == (ds.n, DIM) and bool(np.isfinite(built).all()),
          "online_index: bad build embeddings")
    norm_err = float(np.abs(np.linalg.norm(built, axis=1) - 1).max())
    check(norm_err < 1e-5, f"online_index: rows not unit norm ({norm_err})")
    # 6. 8 rows against the same weights on the CPU; on the card, an
    # embedder given those weights as ``params`` (on cuda:0, the embedder
    # on the default device) gives the build's bits
    given = ModelEmbedder(cfg, embedder.params)(ds.texts[:8])
    check(np.array_equal(given, built[:8]), "online_index: an embedder "
          "given the card's params differs from the build's rows")
    m_cpu = copy.deepcopy(embedder.params).cpu()
    toks, mask = embedder.tokenizer.encode_batch(ds.texts[:8],
                                                 embedder.max_len)
    e_cpu = encode(m_cpu, {"tokens": torch.from_numpy(toks).long(),
                           "attn_mask": torch.from_numpy(mask)})
    del m_cpu
    cpu_err = float(np.abs(built[:8] - e_cpu.numpy()).max())
    check(cpu_err <= ENC_TOL,
          f"online_index: card vs CPU {cpu_err} > {ENC_TOL}")

    # 4. a query's source chunk is at rank 1 wherever its cluster was probed
    probed_src = 0
    for b, (ids, probed, _) in enumerate(card[:BATCHES]):
        for qi in range(BATCH):
            s = src[b * BATCH + qi]
            if assign[s] in probed[qi]:
                probed_src += 1
                check(ids[qi][0] == ds.chunk_ids[s],
                      f"online_index: query {b * BATCH + qi}'s source chunk "
                      f"{ds.chunk_ids[s]} probed but not at rank 1: "
                      f"{list(ids[qi][:3])}")

    # 5. the port's CPU index on the card's clustering and build rows
    cpu_ix = EdgeRAGIndex(
        DIM, TableEmbedder(dict(zip(ds.chunk_ids.tolist(), built)), DIM),
        ds.get_chunks, cost, slo_s=ds.spec.slo_s, device="cpu")
    index_state_from_numpy(cpu_ix, index.centroids, assign, ds.chunk_ids,
                           ds.texts, built)
    swaps = mismatches = 0
    for b, (ids, _, dec) in enumerate(card):
        rows = slice(b * BATCH, (b + 1) * BATCH)
        chars = [len(q) for q in queries[rows]] if b == BATCHES else None
        c_ids, c_vals, c_lats = cpu_ix.search_batch(q_embs[rows], K, NPROBE,
                                                    query_chars=chars)
        check(tier_decisions(c_lats) == dec, "online_index: the CPU run "
              f"took other tier decisions in batch {b}")
        s, m = near_tie_mismatches(ids, c_ids, c_vals)
        swaps, mismatches = swaps + s, mismatches + m
    check(mismatches == 0, f"online_index: {mismatches} ids differ from "
          f"the CPU run outside near-ties")

    # the last batch twice more under the profiler: as the cache stands
    # (its clusters cached or stored), then with the cache emptied, so that
    # it regenerates
    profiles = {}
    for name in ("cache_warm", "cache_cold"):
        if name == "cache_cold":
            index.cache = index.cache.fresh()
        n_calls, micro = len(log.calls), embedder.micro_batches
        tok = embedder.tokenize_s
        prof = profiled(lambda: index.search_batch(q_embs[last], K, NPROBE),
                        count=("flash_fwd", "score_merge", "Memcpy HtoD",
                               "Memcpy DtoH"))
        new = log.calls[n_calls:]
        prof.update(micro_batches=embedder.micro_batches - micro,
                    rows_regenerated=sum(len(c[0]) for c in new),
                    embed_s=sum(c[2] for c in new),
                    tokenize_s=embedder.tokenize_s - tok,
                    busy_share=prof["device_ms"] / prof["wall_ms"]
                    if isinstance(prof["device_ms"], float)
                    else "not measured")
        profiles[name] = prof

    # 3. every regenerated row (and every query row) is the build's, bitwise
    pos = {t: i for i, t in enumerate(ds.texts)}
    regen_rows = not_bitwise = 0
    max_diff = 0.0
    for texts, rows in [(queries, q_embs)] + [(c[0], c[1])
                                              for c in log.calls[1:]]:
        ref = built[[pos[t] for t in texts]]
        regen_rows += len(texts)
        not_bitwise += int((rows != ref).any(axis=1).sum())
        max_diff = max(max_diff, float(np.abs(rows - ref).max(initial=0.0)))
    check(not_bitwise == 0, f"online_index: {not_bitwise} of {regen_rows} "
          f"regenerated rows differ from the build's (max {max_diff})")

    return {"phase": "online_index", "encoder": cfg.name,
            "layers": cfg.num_layers, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "head_dim": cfg.head_dim,
            "tokens_per_text": embedder.max_len,
            "micro_batch": MICRO_BATCH, "records": ds.n, "nlist": index.nlist,
            "index_build_s": build_s, "build_embed_s": build_embed_s,
            "build_tokenize_s": build_tokenize_s,
            "build_rows": len(built), "build_micro_batches": build_micro,
            "stored_clusters_at_build": index.stats()["stored_clusters"],
            "query_embed_s": query_embed_s, "per_batch": per_batch,
            "answer_batch": answer, "tiers": tiers, "launches": launches,
            "micro_batches": micro_batches,
            "rows_checked_bitwise": regen_rows, "not_bitwise": not_bitwise,
            "sources_probed": probed_src, "cpu_match": True,
            "near_tie_swaps": swaps, "unit_norm_max_err": norm_err,
            "rows_vs_cpu": 8, "max_abs_err_vs_cpu": cpu_err,
            "tol": ENC_TOL, "warm_batch_profiles": profiles,
            "phase_s": time.perf_counter() - t_phase}, {
        "embedder": embedder, "built": built, "centroids": index.centroids,
        "assign": assign, "queries": queries, "q_embs": q_embs}


def close(x, y) -> bool:
    """Modeled seconds of the card's run and a CPU replay agree."""
    return abs(x - y) <= SCHEDULE_RTOL * max(abs(x), abs(y))


def twin(ctx, embed_fn, get_chunks, device, rows, **kw):
    """An fp32 ``EdgeRAGIndex`` with deferred maintenance on ``ctx``'s
    corpus and clustering (``centroids``, ``assign``), its second level
    from ``rows``; ``kw`` goes to the index (``cache_bytes``)."""
    from repro_torch.convert import index_state_from_numpy
    from repro_torch.core import EdgeRAGIndex
    ds = ctx["ds"]
    ix = EdgeRAGIndex(DIM, embed_fn, get_chunks, ctx["cost"],
                      slo_s=ds.spec.slo_s, maintenance="deferred",
                      device=device, **kw)
    index_state_from_numpy(ix, ctx["centroids"], ctx["assign"],
                           ds.chunk_ids, ds.texts, rows)
    return ix


def scored(ix) -> list:
    """Keeps (ids, scores) of every ``search_finish`` of ``ix``."""
    out, finish = [], ix.search_finish

    def logged(state):
        ids, vals, lats = finish(state)
        out.append((ids, vals))
        return ids, vals, lats
    ix.search_finish = logged
    return out


def offpath_rewrites(ix, store, q_embs, centroids, ctx, phase) -> tuple:
    """Seeded maintenance: one chunk each of up to ``REWRITE_CLUSTERS``
    clusters of ``ix`` that no query of ``q_embs`` probes (K1 gives each
    query the same probes alone or in any batch), the farthest from the
    probe cut first, rewritten: long enough that regenerating the cluster
    goes over the storage SLO, short of a split.  Returns (rewrites
    {chunk: text}, the clusters, the probed set, each cluster's best
    rank over the queries); applying them is the caller's."""
    ds, cost = ctx["ds"], ctx["cost"]
    probed = set().union(*ix._probe(q_embs, NPROBE))
    rank = np.argsort(np.argsort(-(q_embs.astype(np.float64)
                                   @ centroids.astype(np.float64).T),
                                 axis=1), axis=1).min(axis=0)
    slo_chars = (ds.spec.slo_s - cost.embed_fixed_s) * cost.embed_chars_per_sec
    rewrites, targets = {}, []
    for cid in sorted(set(range(len(ix.clusters))) - probed,
                      key=lambda c: (-rank[c], c)):
        cl = ix.clusters[cid]
        extra = max(REWRITE_CHARS, int(slo_chars - cl.char_count)
                    + REWRITE_CHARS)
        if cl.size == 0 or cl.char_count + extra + 4 >= ix.split_max_chars:
            continue
        chunk = int(cl.ids[0])
        rewrites[chunk] = store[chunk] + " rev" + " tok" * (extra // 4)
        targets.append(cid)
        if len(targets) == REWRITE_CLUSTERS:
            break
    check(len(targets) > 0, f"{phase}: every cluster is probed "
          f"({len(probed)} of {len(ix.clusters)})")
    return rewrites, targets, probed, rank


def staged_pipeline(ctx) -> dict:
    """``StagedPipeline`` on the card: gte-base regeneration, bubble
    maintenance and the batcher's decode in one schedule on the modeled
    clock (module docstring, ``staged_pipeline``)."""
    import torch
    from repro_torch.data import TableEmbedder
    from repro_torch.serving import (ContinuousBatcher, PipelineBatch,
                                     RAGEngine, StagedPipeline)

    t_phase = time.perf_counter()
    ds, cost, dev, gen = ctx["ds"], ctx["cost"], ctx["dev"], ctx["gen"]
    embedder, built, centroids = ctx["embedder"], ctx["built"], ctx["centroids"]
    queries, q_embs = ctx["queries"], ctx["q_embs"]
    enc_layers, gen_layers = embedder.cfg.num_layers, gen.cfg.num_layers
    # the phase's own chunk store: its rewrites stay out of ``ds``, which
    # the later phases read
    original = dict(zip(ds.chunk_ids.tolist(), ds.texts))
    store = dict(original)

    def get_chunks(ids):
        return [store[int(i)] for i in ids]

    log_a = EmbedLog(embedder)
    a = twin(ctx, log_a, get_chunks, dev, built, cache_bytes=0)
    b = twin(ctx, embedder, get_chunks, dev, built, cache_bytes=0)
    scores_a, scores_b = scored(a), scored(b)
    batches = [PipelineBatch(queries=queries[i * BATCH:(i + 1) * BATCH],
                             query_embs=q_embs[i * BATCH:(i + 1) * BATCH])
               for i in range(PIPE_BATCHES)]
    last = PipelineBatch(queries=queries[BATCHES * BATCH:],
                         query_embs=q_embs[BATCHES * BATCH:])

    rewrites, targets, probed, rank = offpath_rewrites(
        a, store, q_embs, centroids, ctx, "staged_pipeline")
    rewritten_rows = embedder(list(rewrites.values()))   # for (c)'s table
    store.update(rewrites)
    for ix in (a, b):
        for chunk, text in rewrites.items():
            ix.update(chunk, text)
    seeded = [(op.kind, op.cid) for op in a.maintenance.pending]
    check(len(a.maintenance) > 0 and seeded == [
              (op.kind, op.cid) for op in b.maintenance.pending]
          and sorted(cid for _, cid in seeded) == sorted(targets),
          f"staged_pipeline: seeded maintenance {seeded} on the "
          f"clusters {targets}")

    # (a) pipelined (A) against sequential (B), one 16-slot batcher
    batcher = ContinuousBatcher(gen.cfg, gen.params, num_slots=BATCH,
                                max_len=BATCHER_LEN, device=dev)
    tlog = BatcherLog(batcher, None)        # admissions and active ticks
    engine_a = RAGEngine(a, gen, cost_model=cost, k=K, nprobe=NPROBE,
                         max_new_tokens=NEW_TOKENS,
                         maintenance_owner="external")
    host_s = dict.fromkeys(("s1", "s2", "s3", "s4", "drain"), 0.0)
    regen = {"s2": [], "drain": []}       # per call: rows, embed seconds

    def timed(name, fn):
        def run(*args, **kw):
            n_calls = len(log_a.calls)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            host_s[name] += time.perf_counter() - t0
            if name in regen:
                new = log_a.calls[n_calls:]
                regen[name].append([sum(len(c[0]) for c in new),
                                    sum(c[2] for c in new)])
            return out
        return run
    for name, attr in (("s1", "stage_plan"), ("s2", "stage_fetch"),
                       ("s3", "stage_score"), ("s4", "stage_decode")):
        setattr(engine_a, attr, timed(name, getattr(engine_a, attr)))
    a.maintenance.drain = timed("drain", a.maintenance.drain)

    micro = embedder.micro_batches
    zero_launches()
    t0 = time.perf_counter()
    resp_a, trace = StagedPipeline(engine_a, get_chunks,
                                   batcher=batcher).run(batches)
    torch.cuda.synchronize()
    wall_a = time.perf_counter() - t0
    launches_a = launch_counts()
    micro_a = embedder.micro_batches - micro
    admissions, active_ticks = len(tlog.admitted_at), len(tlog.tick_lens)
    host_a, regen_a = dict(host_s), {n: list(v) for n, v in regen.items()}

    engine_b = RAGEngine(b, gen, cost_model=cost, k=K, nprobe=NPROBE,
                         max_new_tokens=NEW_TOKENS)
    t0 = time.perf_counter()
    resp_b = [engine_b.answer_batch(pb.queries, pb.query_embs, get_chunks,
                                    batcher=batcher) for pb in batches]
    torch.cuda.synchronize()
    wall_b = time.perf_counter() - t0

    flat_a = [r for rs in resp_a for r in rs]
    flat_b = [r for rs in resp_b for r in rs]
    check(len(flat_a) == len(flat_b) == PIPE_BATCHES * BATCH
          and [r.chunk_ids for r in flat_a] == [r.chunk_ids for r in flat_b]
          and all(len(r.chunk_ids) == K for r in flat_a),
          "staged_pipeline: pipelined ids differ from the sequential arm's")
    check(len(scores_a) == len(scores_b) == PIPE_BATCHES and all(
              np.array_equal(ia, ib) and np.array_equal(va, vb)
              for (ia, va), (ib, vb) in zip(scores_a, scores_b)),
          "staged_pipeline: pipelined scores not bitwise the sequential's")
    check([r.output_tokens for r in flat_a]
          == [r.output_tokens for r in flat_b]
          and all(len(r.output_tokens) == NEW_TOKENS for r in flat_a),
          "staged_pipeline: pipelined tokens differ from the sequential's")
    ops = sum(st.maintenance_ops for st in trace.stages.values())
    # a drain isolates an op that raises (counts it, re-queues it); none may
    check(all(ix.maintenance.n_failures == 0 for ix in (a, b)),
          f"staged_pipeline: maintenance ops raised: "
          f"{[dict(ix.maintenance.quarantined) for ix in (a, b)]}")
    check(trace.maintenance_in_bubbles_s > 0 and ops > 0
          and len(a.maintenance) == 0 and len(b.maintenance) == 0
          and all(a.clusters[c].storage_fresh and b.clusters[c].storage_fresh
                  for c in targets),
          f"staged_pipeline: {ops} ops in bubbles "
          f"({trace.maintenance_in_bubbles_s} s), {len(a.maintenance)} "
          f"left, targets fresh "
          f"{[a.clusters[c].storage_fresh for c in targets]}")
    fired = {s: st.n_fired for s, st in trace.stages.items()}
    check(trace.hidden_retrieval_fraction > 0 and fired == {
              "s1": PIPE_BATCHES + trace.replans,
              "s2": PIPE_BATCHES + trace.replans,
              "s3": PIPE_BATCHES, "s4": PIPE_BATCHES},
          f"staged_pipeline: fired {fired}, replans {trace.replans}, "
          f"hidden {trace.hidden_retrieval_fraction}")
    want_a = {"ivf_topk": fired["s1"],
              "slab_topk": {**dict.fromkeys(launches_a["slab_topk"], 0),
                            "fp32": fired["s3"]},
              "flash_attention": {"causal": gen_layers * admissions,
                                  "non_causal": enc_layers * micro_a},
              "decode_attention": gen_layers * active_ticks}
    check(launches_a == want_a and admissions == PIPE_BATCHES * BATCH,
          f"staged_pipeline: launches {launches_a} in {admissions} "
          f"admissions, {active_ticks} active ticks and {micro_a} "
          f"micro-batches; want {want_a}")
    # the restores regenerated the rewritten chunks to (c)'s table rows
    restored = {t: row for texts, rows, _ in log_a.calls
                for t, row in zip(texts, rows) if t in rewrites.values()}
    check(len(restored) == len(rewrites) and all(
              np.array_equal(restored[t], r)
              for t, r in zip(rewrites.values(), rewritten_rows)),
          "staged_pipeline: a restore's rows of a rewritten chunk differ "
          "from the same text embedded alone")

    # (b) a content update after the first fetch sends the batch back to
    # S1; B, drained by its engine after (a), is the twin it must equal
    engine_s = RAGEngine(a, gen, cost_model=cost, k=K, nprobe=NPROBE,
                         max_new_tokens=NEW_TOKENS,
                         maintenance_owner="external")
    fetch, mutated = engine_s.stage_fetch, {}

    def fetch_then_update(job, **kw):
        fetch(job, **kw)
        if not mutated:
            cid = next(iter(job.state.plan.owner))
            chunk = int(a.clusters[cid].ids[0])
            mutated.update(cid=cid, chunk=chunk,
                           text=store[chunk] + " rev")
            store[chunk] = mutated["text"]
            a.update(chunk, mutated["text"])
        return job
    engine_s.stage_fetch = fetch_then_update
    zero_launches()
    t0 = time.perf_counter()
    resp_s, trace_s = StagedPipeline(engine_s, get_chunks,
                                     batcher=batcher).run([last])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches_s = launch_counts()
    b.update(mutated["chunk"], mutated["text"])
    seq = engine_b.answer_batch(last.queries, last.query_embs, get_chunks,
                                batcher=batcher)
    check(trace_s.replans == 1 and launches_s["ivf_topk"] == 2
          and a.maintenance.n_failures == b.maintenance.n_failures == 0
          and launches_s["slab_topk"]["fp32"] == 1,
          f"staged_pipeline: the stale batch replanned {trace_s.replans} "
          f"times, launches {launches_s}")
    check([r.chunk_ids for r in resp_s[0]] == [r.chunk_ids for r in seq]
          and [r.output_tokens for r in resp_s[0]]
          == [r.output_tokens for r in seq]
          and np.array_equal(scores_a[-1][1], scores_b[-1][1]),
          "staged_pipeline: the replanned batch differs from the twin "
          "updated before serving")

    # (c) (a)'s schedule replayed on the CPU: the card's rows in a table
    table = dict(zip(ds.chunk_ids.tolist(), built))
    table.update(zip(rewrites, rewritten_rows))
    cpu_store = {**original, **rewrites}

    def cpu_chunks(ids):
        return [cpu_store[int(i)] for i in ids]
    c = twin(ctx, TableEmbedder(table, DIM), cpu_chunks, "cpu", built,
             cache_bytes=0)
    scores_c = scored(c)
    for chunk, text in rewrites.items():
        c.update(chunk, text)
    resp_c, trace_c = StagedPipeline(
        RAGEngine(c, None, cost_model=cost, k=K, nprobe=NPROBE,
                  max_new_tokens=NEW_TOKENS, maintenance_owner="external"),
        cpu_chunks).run(batches)
    swaps = mismatches = 0
    swapped = []
    for i, ((ids, _), (c_ids, c_vals)) in enumerate(zip(scores_a, scores_c)):
        s, m = near_tie_mismatches(ids, c_ids, c_vals)
        swaps, mismatches = swaps + s, mismatches + m
        if s:
            swapped.append(i)
    check(mismatches == 0 and c.maintenance.n_failures == 0,
          f"staged_pipeline: {mismatches} ids differ from the CPU replay "
          f"outside near-ties ({c.maintenance.n_failures} ops raised)")
    counts = ("n_fired", "maintenance_ops", "checkpoints", "max_queue_depth")
    card_counts = {s: [getattr(st, n) for n in counts]
                   for s, st in trace.stages.items()}
    cpu_counts = {s: [getattr(st, n) for n in counts]
                  for s, st in trace_c.stages.items()}
    check(card_counts == cpu_counts and trace.replans == trace_c.replans,
          f"staged_pipeline: trace counts {card_counts} on the card, "
          f"{cpu_counts} on the CPU")
    if not swapped:           # a near-tie swap changes a prompt, so S4
        d, dc = trace.as_dict(), trace_c.as_dict()
        secs = [(k, d[k], dc[k]) for k in d
                if isinstance(d[k], float)] + [
            (f"{s}.{k}", v, dc["stages"][s][k])
            for s, st in d["stages"].items()
            for k, v in st.items() if isinstance(v, float)] + [
            (f"response {i}", x, y) for i, (ra, rc) in
            enumerate(zip(flat_a, [r for rs in resp_c for r in rs]))
            for x, y in ((ra.ttft_edge_s, rc.ttft_edge_s),
                         (ra.queue_wait_s, rc.queue_wait_s))]
        off = [(k, x, y) for k, x, y in secs if not close(x, y)]
        check(not off, f"staged_pipeline: modeled seconds differ from the "
              f"CPU replay: {off[:4]}")

    return {"phase": "staged_pipeline", "batches": PIPE_BATCHES,
            "batch": BATCH, "k": K, "nprobe": NPROBE,
            "new_tokens": NEW_TOKENS, "slots": BATCH,
            "max_len": BATCHER_LEN, "cache_bytes": 0,
            "rewritten_clusters": targets,
            "rewritten_best_rank": rank[targets].tolist(),
            "clusters_probed": len(probed),
            "rewrite_chars": [len(t) for t in rewrites.values()],
            "seeded_ops": seeded,
            "pipelined_wall_s": wall_a, "sequential_wall_s": wall_b,
            "pipelined_host_s": host_a,
            "s2_rows_and_embed_s": regen_a["s2"],
            "drain_rows_and_embed_s": regen_a["drain"],
            "trace": trace.as_dict(), "launches": launches_a,
            "admissions": admissions, "active_ticks": active_ticks,
            "micro_batches": micro_a,
            "stale": {"cid": mutated["cid"], "chunk": mutated["chunk"],
                      "replans": trace_s.replans, "wall_s": wall_s,
                      "launches": launches_s,
                      "trace": trace_s.as_dict()},
            "cpu_replay": {"near_tie_swaps": swaps,
                           "batches_with_swaps": swapped,
                           "counts_equal": True,
                           "seconds_rtol": SCHEDULE_RTOL,
                           "seconds_compared": not swapped},
            "phase_s": time.perf_counter() - t_phase}


def metric_samples(text: str) -> list:
    """(name and labels, value) of every sample line of a Prometheus text
    exposition."""
    out = []
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, value = line.rsplit(" ", 1)
            out.append((key, float(value.replace("+Inf", "inf"))))
    return out


def metrics_agree(card, cpu, name: str, phase: str) -> dict:
    """Holds the card run's registry text against the CPU replay's (the
    same names, label sets and sample count; values within
    ``SCHEDULE_RTOL``), writes the card's under ``build/`` and returns the
    sample count and where the text went."""
    a, b = metric_samples(card), metric_samples(cpu)
    check([k for k, _ in a] == [k for k, _ in b],
          f"{phase}: metric samples differ from the CPU replay's: "
          f"{sorted(set(a) ^ set(b))[:4]}")
    off = [(k, x, y) for (k, x), (_, y) in zip(a, b) if not close(x, y)]
    check(not off, f"{phase}: metric values differ from the CPU replay's: "
          f"{off[:4]}")
    path = ROOT / "build" / name
    path.parent.mkdir(exist_ok=True)
    path.write_text(card)
    return {"samples": len(a), "file": str(path.relative_to(ROOT))}


def stamps_agree(card, cpu, phase: str) -> None:
    """The same requests in the same order with the same outcomes, and
    their stamps within ``SCHEDULE_RTOL``."""
    check([(r.rid, r.outcome) for r in card]
          == [(r.rid, r.outcome) for r in cpu],
          f"{phase}: outcomes differ from the CPU replay's")
    off = [(r.rid, x, y) for r, c in zip(card, cpu)
           for x, y in ((r.start_s, c.start_s), (r.finish_s, c.finish_s))
           if not close(x, y)]
    check(not off, f"{phase}: stamps differ from the CPU replay's: "
          f"{off[:4]}")


def scheduler_phase(ctx) -> dict:
    """``RequestScheduler`` on the card: (a) ``run`` over a queued,
    admission-controlled stream on the main path's index and generator,
    (b) ``run_pipelined`` on ``staged_pipeline``'s setup (module
    docstring, ``scheduler``)."""
    import types

    import torch
    from repro_torch.data import TableEmbedder
    from repro_torch.serving import (ContinuousBatcher, PipelineBatch,
                                     RAGEngine, RequestScheduler,
                                     StagedPipeline, TokenBucketAdmission)
    from repro_torch.serving.metrics import (MetricsRegistry,
                                             collect_pipeline_trace,
                                             collect_scheduler)

    t_phase = time.perf_counter()
    ds, cost, dev, gen = ctx["ds"], ctx["cost"], ctx["dev"], ctx["gen"]
    gen_layers = gen.cfg.num_layers
    original = dict(zip(ds.chunk_ids.tolist(), ds.texts))

    # ---- (a) run: a Poisson stream on the main path's serving stack ----
    main = {"ds": ds, "cost": cost, "centroids": ctx["main_centroids"],
            "assign": ctx["main_assign"]}
    mean_ttft = float(np.mean([r.ttft_edge_s for r in ctx["first_batch"]]))
    mu = 1.0 / mean_ttft
    arrivals = np.cumsum(np.random.default_rng(SEED).exponential(
        SCHED_GAP * mean_ttft, SCHED_REQUESTS))
    stream = [dict(arrival_s=float(t), query=f"query-{i}",
                   query_emb=ds.query_embs[i], query_chars=len(f"query-{i}"),
                   slo_s=SCHED_SLO * mean_ttft,
                   tenant="b" if i % 4 == 3 else "a")
              for i, t in enumerate(arrivals)]
    rates = {"a": 0.5 * mu, "b": mu}

    def serve_stream(device, generator, seeded=None):
        """(a) on a fresh index on ``device``, with launches zeroed just
        before ``run``; the rewrites are chosen on this index unless
        ``seeded`` (rewrites, clusters) gives them.  Returns the
        scheduler, the index, the responses and their (ids, scores) in
        serve order, the rewrites and clusters, and the wall seconds of
        ``run``."""
        store = dict(original)
        ix = twin(main, ds.embedder,
                  lambda ids: [store[int(i)] for i in ids], device,
                  ds.embeddings)
        if seeded is None:
            seeded = offpath_rewrites(ix, store, ds.query_embs[
                :SCHED_REQUESTS], main["centroids"], main,
                "scheduler (a)")[:2]
        rewrites, targets = seeded
        store.update(rewrites)
        for chunk, text in rewrites.items():
            ix.update(chunk, text)
        queued = sorted(op.cid for op in ix.maintenance.pending)
        check(queued == sorted(targets), f"scheduler (a): seeded "
              f"maintenance on {queued}, rewrites on {sorted(targets)}")
        engine = RAGEngine(ix, generator, cost_model=cost, k=K,
                           nprobe=NPROBE, max_new_tokens=SCHED_NEW_TOKENS,
                           maintenance_owner="external")
        scores = scored(ix)
        sched = RequestScheduler(TokenBucketAdmission(rates,
                                                      burst=SCHED_BURST))
        for kw in stream:
            sched.submit(**kw)
        served = []

        def serve(req):                 # as examples/edge_serving.py
            served.append(engine.answer(req.query, req.query_emb,
                                        ix.get_chunks))
            return served[-1].ttft_edge_s

        def idle_drain(gap_s):          # as benchmarks/online_churn.py
            if gap_s is None:
                return ix.maintenance.drain(None).edge_s
            return ix.maintenance.drain(gap_s, strict=True).edge_s
        zero_launches()
        t0 = time.perf_counter()
        sched.run(serve, maintenance_fn=idle_drain)
        if generator is not None:
            torch.cuda.synchronize()
        return (sched, ix, served, scores, seeded,
                time.perf_counter() - t0)

    sched, ix, served, scores, seeded, wall_run = serve_stream(dev, gen)
    launches_run = launch_counts()
    n_served = len(served)
    counts = sched.outcome_counts()
    check(sorted(r.rid for r in sched.completed)
          == list(range(SCHED_REQUESTS))
          and n_served == SCHED_REQUESTS - counts["rejected"]
          and not sched.errors,
          f"scheduler (a): {len(sched.completed)} completed, {n_served} "
          f"served, errors {sched.errors[:2]}")
    check(counts["met"] > 0 and counts["rejected"] > 0,
          f"scheduler (a): outcomes {counts}")
    check(sched.maintenance_s > 0 and len(ix.maintenance) == 0
          and ix.maintenance.n_failures == 0,
          f"scheduler (a): maintenance {sched.maintenance_s} s, "
          f"{len(ix.maintenance)} left, {ix.maintenance.n_failures} raised")
    check(all(len(r.output_tokens) == SCHED_NEW_TOKENS
              and len(r.chunk_ids) == K for r in served),
          "scheduler (a): a response is short of tokens or ids")
    want_run = {"ivf_topk": n_served,
                "slab_topk": {**dict.fromkeys(launches_run["slab_topk"], 0),
                              "fp32": n_served},
                "flash_attention": {"causal": gen_layers * n_served,
                                    "non_causal": 0},
                "decode_attention": gen_layers * SCHED_NEW_TOKENS * n_served}
    check(launches_run == want_run, f"scheduler (a): launches "
          f"{launches_run} for {n_served} served; want {want_run}")
    # the CPU replay: the same stream, rewrites and clustering
    r_sched, _, r_served, r_scores, _, _ = serve_stream("cpu", None, seeded)
    check(len(r_scores) == len(scores) == n_served,
          f"scheduler (a): {len(r_scores)} requests served on the CPU, "
          f"{n_served} on the card")
    swaps, mismatches = near_tie_mismatches(
        [i[0] for i, _ in scores], [i[0] for i, _ in r_scores],
        [v[0] for _, v in r_scores])
    check(mismatches == 0, f"scheduler (a): {mismatches} ids differ from "
          f"the CPU replay outside near-ties")
    stamps_agree(sched.completed, r_sched.completed, "scheduler (a)")
    check(sched.admission.stats() == r_sched.admission.stats()
          and close(sched.maintenance_s, r_sched.maintenance_s),
          f"scheduler (a): admission {sched.admission.stats()} and "
          f"{sched.maintenance_s} s of maintenance on the card, "
          f"{r_sched.admission.stats()} and {r_sched.maintenance_s} s on "
          f"the CPU")
    text_run = collect_scheduler(MetricsRegistry(), sched).render()
    metrics_run = metrics_agree(
        text_run, collect_scheduler(MetricsRegistry(), r_sched).render(),
        "scheduler_run.prom", "scheduler (a)")
    metrics_run["headline"] = {
        k: v for k, v in metric_samples(text_run) if k.startswith((
            "edgerag_requests_total", "edgerag_admission",
            "edgerag_maintenance"))}
    lat = [r.latency_s for r in sched.completed if not r.rejected]
    busy = sum(r.finish_s - r.start_s for r in sched.completed)
    part_a = {"requests": SCHED_REQUESTS, "served": n_served,
              "new_tokens": SCHED_NEW_TOKENS,
              "slo_s": SCHED_SLO * mean_ttft,
              "mean_ttft_edge_s": mean_ttft, "mean_gap_s": SCHED_GAP
              * mean_ttft, "rates_per_s": rates, "burst": SCHED_BURST,
              "rewritten_clusters": seeded[1],
              "outcomes": counts, "admission": sched.admission.stats(),
              "maintenance_s": sched.maintenance_s,
              "latency_p50_s": float(np.percentile(lat, 50)),
              "latency_p99_s": float(np.percentile(lat, 99)),
              "slo_hit_rate": sched.slo_hit_rate(),
              "utilisation": busy / (max(r.finish_s for r in sched.completed)
                                     - stream[0]["arrival_s"]),
              "wall_s": wall_run,
              "launches": launches_run, "near_tie_swaps": swaps,
              "metrics": metrics_run}
    del ix, served

    # ---- (b) run_pipelined on staged_pipeline's setup ------------------
    embedder, built, slo = ctx["embedder"], ctx["built"], ds.spec.slo_s
    queries = ctx["queries"][:PIPE_REQUESTS]
    q_embs = ctx["q_embs"][:PIPE_REQUESTS]
    enc_layers = embedder.cfg.num_layers
    store = dict(original)

    def get_chunks(ids):
        return [store[int(i)] for i in ids]
    a = twin(ctx, embedder, get_chunks, dev, built, cache_bytes=0)
    b = twin(ctx, embedder, get_chunks, dev, built, cache_bytes=0)
    scores_a, scores_b = scored(a), scored(b)
    rewrites, targets, _, _ = offpath_rewrites(
        a, store, q_embs, ctx["centroids"], ctx, "scheduler (b)")
    rewritten_rows = embedder(list(rewrites.values()))   # the replay's
    store.update(rewrites)
    for x in (a, b):
        for chunk, text in rewrites.items():
            x.update(chunk, text)
    check(sorted(op.cid for op in a.maintenance.pending) == sorted(targets)
          == sorted(op.cid for op in b.maintenance.pending),
          f"scheduler (b): seeded maintenance on {targets}")
    batcher = ContinuousBatcher(gen.cfg, gen.params, num_slots=BATCH,
                                max_len=BATCHER_LEN, device=dev)
    tlog = BatcherLog(batcher, None)        # admissions and active ticks
    arrive = [PIPE_SPACING * i for i in range(PIPE_REQUESTS)]

    def engine(x, generator):
        return RAGEngine(x, generator, cost_model=cost, k=K, nprobe=NPROBE,
                         max_new_tokens=NEW_TOKENS,
                         maintenance_owner="external")

    def pipelined(x, generator, get, with_batcher):
        s = RequestScheduler()
        for i, t in enumerate(arrive):
            s.submit(t, query=queries[i], query_emb=q_embs[i],
                     query_chars=len(queries[i]), slo_s=slo)
        s.run_pipelined(StagedPipeline(
            engine(x, generator), get,
            batcher=batcher if with_batcher else None), batch_size=BATCH)
        return s

    micro = embedder.micro_batches
    zero_launches()
    t0 = time.perf_counter()
    sched_a = pipelined(a, gen, get_chunks, True)
    torch.cuda.synchronize()
    wall_pipe = time.perf_counter() - t0
    launches_pipe = launch_counts()
    micro_a = embedder.micro_batches - micro
    admissions, active_ticks = len(tlog.admitted_at), len(tlog.tick_lens)
    trace = sched_a.pipeline_trace

    # B: the same two batches built by hand, with test-local requests
    reqs_b = [types.SimpleNamespace(arrival_s=t, start_s=0.0, finish_s=0.0,
                                    degraded=False) for t in arrive]
    batches = [PipelineBatch(
        queries=queries[j:j + BATCH], query_embs=q_embs[j:j + BATCH],
        arrival_s=max(arrive[j:j + BATCH]), slos=[slo] * BATCH,
        requests=reqs_b[j:j + BATCH])
        for j in range(0, PIPE_REQUESTS, BATCH)]
    t0 = time.perf_counter()
    resp_b, trace_b = StagedPipeline(engine(b, gen), get_chunks,
                                     batcher=batcher).run(batches)
    torch.cuda.synchronize()
    wall_hand = time.perf_counter() - t0
    flat_a, flat_b = sched_a.pipeline_responses, [r for rs in resp_b
                                                  for r in rs]
    check(len(flat_a) == len(flat_b) == PIPE_REQUESTS
          and [r.chunk_ids for r in flat_a] == [r.chunk_ids for r in flat_b]
          and [r.output_tokens for r in flat_a]
          == [r.output_tokens for r in flat_b]
          and all(len(r.output_tokens) == NEW_TOKENS for r in flat_a),
          "scheduler (b): run_pipelined's ids or tokens differ from the "
          "hand-built batches'")
    check(len(scores_a) == len(scores_b) == PIPE_REQUESTS // BATCH and all(
              np.array_equal(ia, ib) and np.array_equal(va, vb)
              for (ia, va), (ib, vb) in zip(scores_a, scores_b)),
          "scheduler (b): run_pipelined's scores not bitwise the "
          "hand-built batches'")
    check(trace.as_dict() == trace_b.as_dict(),
          "scheduler (b): run_pipelined's trace differs from the "
          "hand-built batches'")
    check([(r.start_s, r.finish_s, r.degraded) for r in sched_a.completed]
          == [(r.start_s, r.finish_s, r.degraded) for r in reqs_b],
          "scheduler (b): request stamps differ from the hand-built "
          "batches'")
    check(sched_a.maintenance_s == trace.maintenance_in_bubbles_s
          + trace.final_drain_s and sched_a.maintenance_s > 0
          and len(a.maintenance) == len(b.maintenance) == 0
          and a.maintenance.n_failures == b.maintenance.n_failures == 0,
          f"scheduler (b): maintenance {sched_a.maintenance_s} s against "
          f"the trace's {trace.maintenance_in_bubbles_s} + "
          f"{trace.final_drain_s}, {len(a.maintenance)} left")
    fired = {s: st.n_fired for s, st in trace.stages.items()}
    want_pipe = {"ivf_topk": PIPE_REQUESTS // BATCH,
                 "slab_topk": {**dict.fromkeys(launches_pipe["slab_topk"], 0),
                               "fp32": PIPE_REQUESTS // BATCH},
                 "flash_attention": {"causal": gen_layers * admissions,
                                     "non_causal": enc_layers * micro_a},
                 "decode_attention": gen_layers * active_ticks}
    check(launches_pipe == want_pipe and admissions == PIPE_REQUESTS
          and trace.replans == 0,
          f"scheduler (b): launches {launches_pipe} in {admissions} "
          f"admissions, {active_ticks} active ticks and {micro_a} "
          f"micro-batches, fired {fired}; want {want_pipe}")

    # the CPU replay: the card's rows in a table, no generator
    table = dict(zip(ds.chunk_ids.tolist(), built))
    table.update(zip(rewrites, rewritten_rows))
    cpu_store = {**original, **rewrites}
    c = twin(ctx, TableEmbedder(table, DIM),
             lambda ids: [cpu_store[int(i)] for i in ids], "cpu", built,
             cache_bytes=0)
    scores_c = scored(c)
    for chunk, text in rewrites.items():
        c.update(chunk, text)
    sched_c = pipelined(c, None, c.get_chunks, False)
    swaps_b = mismatches = 0
    for (ids, _), (c_ids, c_vals) in zip(scores_a, scores_c):
        s_, m_ = near_tie_mismatches(ids, c_ids, c_vals)
        swaps_b, mismatches = swaps_b + s_, mismatches + m_
    check(mismatches == 0 and len(scores_c) == len(scores_a),
          f"scheduler (b): {mismatches} ids differ from the CPU replay "
          f"outside near-ties")
    stamps_agree(sched_a.completed, sched_c.completed, "scheduler (b)")
    check(sched_a.outcome_counts() == sched_c.outcome_counts()
          and close(sched_a.maintenance_s, sched_c.maintenance_s),
          f"scheduler (b): outcomes {sched_a.outcome_counts()} on the "
          f"card, {sched_c.outcome_counts()} on the CPU")

    def registry(s):
        reg = collect_scheduler(MetricsRegistry(), s)
        return collect_pipeline_trace(reg, s.pipeline_trace).render()
    text_pipe = registry(sched_a)
    metrics_pipe = metrics_agree(text_pipe, registry(sched_c),
                                 "scheduler_pipelined.prom", "scheduler (b)")
    metrics_pipe["headline"] = {
        k: v for k, v in metric_samples(text_pipe) if k.startswith((
            "edgerag_requests_total", "edgerag_pipeline_"))}
    lat_b = [r.latency_s for r in sched_a.completed]
    part_b = {"requests": PIPE_REQUESTS, "spacing_s": PIPE_SPACING,
              "batch_size": BATCH, "slo_s": slo, "new_tokens": NEW_TOKENS,
              "slots": BATCH, "cache_bytes": 0,
              "rewritten_clusters": targets,
              "outcomes": sched_a.outcome_counts(),
              "maintenance_s": sched_a.maintenance_s,
              "latency_p50_s": float(np.percentile(lat_b, 50)),
              "latency_p99_s": float(np.percentile(lat_b, 99)),
              "run_pipelined_wall_s": wall_pipe,
              "hand_built_wall_s": wall_hand, "trace": trace.as_dict(),
              "launches": launches_pipe, "admissions": admissions,
              "active_ticks": active_ticks, "micro_batches": micro_a,
              "near_tie_swaps": swaps_b, "metrics": metrics_pipe}
    return {"phase": "scheduler", "run": part_a, "run_pipelined": part_b,
            "phase_s": time.perf_counter() - t_phase}


def check_attention(rec_flash, rec_dec, dev) -> dict:
    """The attention kernels against their plain versions on the card
    (module docstring, ``kernels_checked``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import init_cache, init_params, prefill

    out = {}

    def held(name, got, ref, entry):
        err, ratio = attn_err(got, ref)
        check(ratio <= 1, f"{name}: error {err} is {ratio} x its allowance")
        entry.update(dtype=str(got.dtype)[6:], max_abs_err=err,
                     tol=attn_tol(got.shape[-1]), err_over_allowance=ratio)
        out[name] = entry

    def control(name, plain, q, k, v, *args):
        """The plain version on K and V rounded to bf16 must miss the f32
        bound: a kernel that staged them so would fail these checks."""
        bf = lambda t: t.bfloat16().float()
        ref = plain(q, k, v, *args)
        _, ratio = attn_err(plain(q, bf(k), bf(v), *args), ref)
        check(ratio > 1, f"{name}: K, V rounded to bf16 stay within the f32 "
              f"bound ({ratio} x), so the bound cannot catch them")
        out[name]["bf16_kv_control_err_over_allowance"] = ratio

    def tf32_control(name, q, k, v, causal):
        """The plain version on q, K and V rounded to TF32 must miss the
        f32 bound: a flash_attention that took one TF32 product (and not
        3xTF32) would fail these checks."""
        ref = flash_plain(q, k, v, causal)
        _, ratio = attn_err(flash_plain(tf32(q), tf32(k), tf32(v), causal),
                            ref)
        check(ratio > 1, f"{name}: q, K, V rounded to TF32 stay within the "
              f"f32 bound ({ratio} x), so the bound cannot catch them")
        out[name]["tf32_control_err_over_allowance"] = ratio

    def shifted(t):
        """A copy of ``t`` 4 bytes off a 16-byte boundary."""
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
        moved = buf[1:].view(t.shape)
        moved.copy_(t)
        return moved

    def flash_case(name, q, k, v, causal=True, window=0):
        got = flash_attention(q, k, v, causal=causal, window=window)
        held(f"flash_attention_{name}", got,
             flash_plain(q, k, v, causal, window),
             {"shape": list(q.shape), "kv": list(k.shape), "causal": causal,
              "window": window})
        return got

    def decode_case(name, q, k, v, lengths, window=0):
        got = decode_attention(q, k, v, lengths, window=window)
        lens = lengths.tolist() if hasattr(lengths, "tolist") else lengths
        held(f"decode_attention_{name}", got,
             decode_plain(q, k, v, lengths, window),
             {"shape": list(q.shape), "cache": list(k.shape),
              "lengths": lens, "window": window})
        return got

    gen = torch.Generator(device=dev).manual_seed(6)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # the recorded main-path and encode inputs
    (q, k, v), kw = rec_flash.first[True]
    flash_case("prefill", q, k, v, **kw)
    control("flash_attention_prefill", flash_plain, q, k, v, True)
    tf32_control("flash_attention_prefill", q, k, v, True)
    check(torch.equal(flash_attention(q, shifted(k), shifted(v)),
                      flash_attention(q, k, v)),
          "flash_attention: K, V off 16 bytes do not give the aligned bits")
    out["flash_attention_prefill"]["unaligned_kv"] = "bitwise"
    (qe, ke, ve), kw = rec_flash.first[False]
    enc = flash_case("encode", qe, ke, ve, **kw)
    control("flash_attention_encode", flash_plain, qe, ke, ve, False)
    tf32_control("flash_attention_encode", qe, ke, ve, False)
    (qd, kd, vd, lens), kw = rec_dec.first[None]
    decode_case("decode", qd, kd, vd, lens, **kw)
    control("decode_attention_decode", decode_plain, qd, kd, vd, lens)
    # GQA with a window; ragged, unequal lengths; D = 128; bf16
    flash_case("gqa4_window", rand(2, 256, 32, 80), rand(2, 256, 8, 80),
               rand(2, 256, 8, 80), True, 100)
    flash_case("ragged_77x150", rand(2, 77, 8, 80), rand(2, 150, 2, 80),
               rand(2, 150, 2, 80), True)
    flash_case("ragged_150x77_window", rand(1, 150, 8, 64),
               rand(1, 77, 4, 64), rand(1, 77, 4, 64), False, 20)
    flash_case("d128", rand(2, 130, 8, 128), rand(2, 130, 8, 128),
               rand(2, 130, 8, 128), True)
    flash_case("bf16", *(rand(2, 128, 8, 80, dtype=torch.bfloat16)
                         for _ in range(3)), True)
    # mixed per-slot lengths with GQA, a window, lengths >= Smax
    kc, vc = rand(4, 144, 8, 80), rand(4, 144, 8, 80)
    qc = rand(4, 1, 32, 80)
    mixed = torch.tensor([1, 77, 144, 300], dtype=torch.int32, device=dev)
    dec = decode_case("mixed_gqa4", qc, kc, vc, mixed)
    decode_case("mixed_window", qc, kc, vc, mixed, 16)
    decode_case("all_past_smax", qc, kc, vc, 10_000)
    decode_case("bf16", qc.bfloat16(), kc.bfloat16(), vc.bfloat16(), mixed)
    decode_case("d32", rand(2, 1, 8, 32), rand(2, 128, 8, 32),
                rand(2, 128, 8, 32),
                torch.tensor([128, 60], dtype=torch.int32, device=dev))

    def padded(t):
        """``t``'s values with a head dim pad sliced off: row strides off
        16 bytes."""
        buf = t.new_zeros((*t.shape[:-1], t.shape[-1] + 1))
        buf[..., :-1] = t
        return buf[..., :-1]

    check(torch.equal(decode_attention(qc, padded(kc), padded(vc), mixed),
                      dec), "decode_attention: a cache off 16-byte strides "
          "does not give the aligned bits")
    out["decode_attention_mixed_gqa4"]["unaligned_cache"] = "bitwise"

    # batch == sequential, bitwise: row b's output does not depend on B
    for i in range(16):
        one = flash_attention(qe[i:i + 1], ke[i:i + 1], ve[i:i + 1],
                              causal=False)
        check(torch.equal(one[0], enc[i]),
              f"flash_attention batch != sequential at row {i}")
    for i in range(4):
        one = decode_attention(qc[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                               mixed[i:i + 1])
        check(torch.equal(one[0], dec[i]),
              f"decode_attention batch != sequential at slot {i}")

    # refusals raise, and the next launch runs
    refused = []
    q96 = rand(1, 16, 4, 96)
    for name, call, exc in (
            ("flash_d96", lambda: flash_attention(q96, q96, q96), ValueError),
            ("decode_d96", lambda: decode_attention(q96[:, :1], q96, q96, 4),
             ValueError),
            ("decode_len0", lambda: decode_attention(qc, kc, vc, 0),
             ValueError),
            ("decode_len0_slot", lambda: decode_attention(
                qc, kc, vc, mixed * torch.tensor([1, 1, 0, 1], device=dev,
                                                 dtype=torch.int32)),
             ValueError)):
        try:
            call()
        except exc:
            refused.append(name)
        else:
            raise AssertionError(f"{name} was not refused")
        check(torch.equal(decode_attention(qc, kc, vc, mixed), dec),
              f"decode_attention after the refusal {name}")
        check(torch.equal(flash_attention(qe[:16], ke[:16], ve[:16],
                                          causal=False), enc[:16]),
              f"flash_attention after the refusal {name}")
    cfg = dataclasses.replace(get_config(GENERATOR).reduced(
        num_layers=1, d_model=128), attn_logit_softcap=30.0)
    try:
        prefill(init_params(cfg, device=dev),
                {"tokens": torch.zeros((1, 8), dtype=torch.long, device=dev)},
                init_cache(cfg, 1, 8, device=dev))
    except NotImplementedError:
        refused.append("model_softcap")
    else:
        raise AssertionError("a logit softcap on the card was not refused")
    check(torch.equal(flash_attention(qe[:16], ke[:16], ve[:16],
                                      causal=False), enc[:16]),
          "flash_attention after the softcap refusal")
    out["batch_vs_sequential"] = "bitwise"
    out["refused"] = refused
    return out


def decode_mask(q, kc, lens):
    """(the (B, 1, 1, Smax) mask of the valid cache positions, how many
    there are over the batch) for ``scaled_dot_product_attention``."""
    import torch
    b, smax = q.shape[0], kc.shape[1]
    lens = getattr(lens, "lengths", lens)           # a DecodeLengths
    valid = (torch.arange(smax, device=q.device)[None, :]
             < torch.as_tensor(lens, device=q.device).reshape(-1, 1))
    return valid[:, None, None, :], int(valid.expand(b, smax).sum())


def decode_device_ms(q, kc, vc, lens, calls: int = 100) -> dict:
    """Device ms per call of K6 and of ``scaled_dot_product_attention``
    with the same mask at a decode input (the recorded one in ``main``),
    each over ``calls`` calls under ``torch.profiler``; each K6 call must
    show one device event, its ``decode_fwd``."""
    from repro_torch.kernels.decode_attention import decode_attention
    mask, _ = decode_mask(q, kc, lens)
    out = device_ms({"decode_attention": lambda: decode_attention(
                         q, kc, vc, lens),
                     "sdpa": lambda: sdpa(q, kc, vc, attn_mask=mask)}, calls)
    one_kernel_event(out, "decode_attention", "decode_fwd")
    return out


def decode_long(dev, calls: int = 100) -> dict:
    """K6 at a long cache: q (1, 1, 32, 80) against a 4,096-row f32 cache
    (1, 4096, 32, 80), every row valid -- Sheared-LLaMA-2.7B's 4,096-token
    context, inherited from LLaMA-2.  K6 within :func:`attn_tol` of its
    plain version, its device ms and ``scaled_dot_product_attention``'s
    (no mask: every row is valid) over ``calls`` calls, one device event a
    K6 call, and the bound: K and V read once at HBM's rate against 4 D
    flops per (head, row) at the fp32 peak."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    gen = torch.Generator(device=dev).manual_seed(8)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    b, smax, h, d = 1, 4096, 32, 80
    q, kc, vc = rand(b, 1, h, d), rand(b, smax, h, d), rand(b, smax, h, d)
    err, ratio = attn_err(decode_attention(q, kc, vc, smax),
                          decode_plain(q, kc, vc, smax))
    check(ratio <= 1, f"decode_long: K6 error {err} is {ratio} x its "
          f"allowance")
    runs = device_ms({"decode_attention": lambda: decode_attention(
                          q, kc, vc, smax),
                      "sdpa": lambda: sdpa(q, kc, vc)}, calls)
    one_kernel_event(runs, "decode_attention", "decode_fwd")
    lim = bound((kc.numel() + vc.numel() + 2 * q.numel()) * 4,
                4 * b * h * d * smax)
    k6 = runs["decode_attention"]["device_ms_per_call"]
    return {"shape": list(q.shape), "cache": list(kc.shape), "length": smax,
            "max_abs_err": err, "err_over_allowance": ratio,
            "bound_ms": lim[0], "bound_by": lim[1],
            "device_ms": k6,
            "library_device_ms": runs["sdpa"]["device_ms_per_call"],
            "device_over_bound": k6 / lim[0],
            "ms": cuda_ms(lambda: decode_attention(q, kc, vc, smax), 200),
            "library_ms": cuda_ms(lambda: sdpa(q, kc, vc), 200),
            "profile": runs}


def attention_rows(rec_flash, rec_dec, launches, checked, k5_dev,
                   k6_dev) -> list:
    """The ``kernels`` line's rows of the attention kernels at the recorded
    prefill, encode and decode inputs.  Bound: q, k, v read once and the
    output written once (for decode, only the valid cache rows of K and V)
    at HBM's rate, against 4 D flops per (query, valid key) pair per head
    (q . k and p v): for K5 at the tensor cores' fp32-accurate (3xTF32)
    peak, for K6 at the fp32 peak.  Library: PyTorch's
    ``scaled_dot_product_attention`` with the same mask.  The rows add
    ``k5_dev``'s and ``k6_dev``'s device ms per call of the kernel and of
    that library call."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention

    rows = []
    for name, shape, causal, n_launch in (
            ("flash_attention", "prefill", True,
             launches["flash_attention_causal"]),
            ("flash_attention_encode", "encode", False,
             launches["flash_attention_encode"])):
        (q, k, v), _ = rec_flash.first[causal]
        (b, sq, h, d), skv = q.shape, k.shape[1]
        pairs = sq * skv
        if causal:
            pairs = int(torch.tril(torch.ones(sq, skv)).sum())
        lim = bound((2 * q.numel() + k.numel() + v.numel())
                    * q.element_size(), 4 * b * h * d * pairs,
                    F32_TC_FLOPS_PER_S)
        err = checked[f"flash_attention_{shape}"]["max_abs_err"]
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
            "launches": n_launch, "max_abs_err": err,
            "ms": cuda_ms(lambda: flash_attention(q, k, v, causal=causal),
                          200),
            "plain_ms": cuda_ms(lambda: flash_plain(q, k, v, causal), 10),
            "bound_ms": lim[0], "bound_by": lim[1],
            "library_ms": cuda_ms(lambda: sdpa(q, k, v, is_causal=causal),
                                  200),
            "device_ms": k5_dev[shape]["flash_attention"]["device_ms_per_call"],
            "library_device_ms": k5_dev[shape]["sdpa"]["device_ms_per_call"]})
    (q, kc, vc, lens), _ = rec_dec.first[None]
    rows.append(k6_row("decode_attention", q, kc, vc, lens,
                       launches["decode_attention"],
                       checked["decode_attention_decode"]["max_abs_err"],
                       k6_dev))
    return rows


def k6_row(name, q, kc, vc, lens, launches, err, k6_dev) -> dict:
    """A ``kernels`` line row of K6 at one decode input: ``lens`` an int,
    or per-slot lengths as a :class:`DecodeLengths` (checked once, as the
    model passes them, so a call is its one launch; the free slots'
    lengths count too: K6 reads them all).  Bound and library as in
    :func:`attention_rows`; ``k6_dev``: :func:`decode_device_ms` at it."""
    from repro_torch.kernels.decode_attention import decode_attention
    (b, _, h, d), kh = q.shape, kc.shape[2]
    mask, n_valid = decode_mask(q, kc, lens)
    raw = getattr(lens, "lengths", lens)
    lim = bound((n_valid * kh * d * 2 + 2 * q.numel()) * q.element_size(),
                4 * h * d * n_valid)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:86",
        "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(lambda: decode_attention(q, kc, vc, lens), 200),
        "plain_ms": cuda_ms(lambda: decode_plain(q, kc, vc, raw), 10),
        "bound_ms": lim[0], "bound_by": lim[1],
        "library_ms": cuda_ms(lambda: sdpa(q, kc, vc, attn_mask=mask), 200),
        "device_ms": k6_dev["decode_attention"]["device_ms_per_call"],
        "library_device_ms": k6_dev["sdpa"]["device_ms_per_call"]}


def q8_row(row, launches, err, q8_dev) -> dict:
    """The ``kernels`` line's row of K7 at the recorded decode shape: q (1,
    1, 32, 80) against the int8 (1, 144, 32, 80) cache of layer 0 at 129
    valid rows.  Bound: the valid K and V rows at 1 byte an element with
    their f32 scales, q and the output, at HBM's rate, against 4 D flops
    per (head, valid position) and one dequantizing multiply per valid
    cache element at the fp32 peak.  Library: a composite, one
    dequantize of the cache and ``scaled_dot_product_attention`` with the
    same mask (:func:`q8_library`).  ``q8_dev``: :func:`q8_device_ms`."""
    from repro_torch.kernels.decode_attention import (
        decode_attention_q8, decode_attention_q8_ref)

    q, ck, cv, length = row
    (b, _, h, d), (smax, kh) = q.shape, ck.q.shape[1:3]
    n_valid = b * min(length, smax)
    lim = bound(2 * n_valid * kh * (d + 4) + 2 * q.numel() * q.element_size(),
                4 * h * d * n_valid + 2 * kh * d * n_valid)
    return {"name": "decode_attention_q8", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention/kernel.py:122",
            "launches": launches, "max_abs_err": err,
            "ms": cuda_ms(lambda: decode_attention_q8(
                q, ck.q, ck.scale, cv.q, cv.scale, length), 200),
            "plain_ms": cuda_ms(lambda: decode_attention_q8_ref(
                q[:, 0], ck.q, ck.scale, cv.q, cv.scale, length), 10),
            "bound_ms": lim[0], "bound_by": lim[1],
            "library_ms": cuda_ms(q8_library(row), 200),
            "device_ms": q8_dev["decode_attention_q8"]["device_ms_per_call"],
            "library_device_ms": q8_dev["library"]["device_ms_per_call"]}


def q8_library(row):
    """K7's yardstick at ``row``: one dequantize of the int8 cache and
    ``scaled_dot_product_attention`` with the valid positions' mask."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models.quantization import dequantize_kv

    q, ck, cv, length = row
    (h, smax, kh) = q.shape[2], ck.q.shape[1], ck.q.shape[2]
    mask = (torch.arange(smax, device=q.device) < length)[None, None, None]
    return lambda: F.scaled_dot_product_attention(
        q.transpose(1, 2), dequantize_kv(ck).transpose(1, 2),
        dequantize_kv(cv).transpose(1, 2), attn_mask=mask,
        enable_gqa=h != kh)


def q8_device_ms(row, calls: int = 100) -> dict:
    """Device ms per call of K7, of K6 on the dequantized cache and of
    K7's library composite (:func:`q8_library`) at the ``kernels`` line's
    K7 shape, each over ``calls`` calls under ``torch.profiler``: what the
    kernels take without their wrappers.  Each K7 and K6 call must show
    one device event, its ``decode_fwd``."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_q8)
    from repro_torch.models.quantization import dequantize_kv

    q, ck, cv, length = row
    fk, fv = dequantize_kv(ck), dequantize_kv(cv)
    out = device_ms({"decode_attention_q8": lambda: decode_attention_q8(
                         q, ck.q, ck.scale, cv.q, cv.scale, length),
                     "decode_attention_dequantized": lambda: decode_attention(
                         q, fk, fv, length),
                     "library": q8_library(row)}, calls)
    for name in ("decode_attention_q8", "decode_attention_dequantized"):
        one_kernel_event(out, name, "decode_fwd")
    return out


def k5_device_ms(rec_flash, calls: int = 100) -> dict:
    """Device ms per call of K5 and of ``scaled_dot_product_attention``
    with the same mask at the recorded prefill and encode inputs, each over
    ``calls`` calls under ``torch.profiler``."""
    from repro_torch.kernels.flash_attention import flash_attention
    out = {}
    for shape, causal in (("prefill", True), ("encode", False)):
        (q, k, v), _ = rec_flash.first[causal]
        out[shape] = device_ms(
            {"flash_attention": lambda: flash_attention(q, k, v,
                                                        causal=causal),
             "sdpa": lambda: sdpa(q, k, v, is_causal=causal)}, calls)
    return out


def device_ms(runs: dict, calls: int) -> dict:
    """Per named function: device ms per call over ``calls`` calls under
    ``torch.profiler`` (what the kernels take without their wrappers),
    beside wall ms per call with the profiler on.  The profiler may miss a
    few of a window's events, so an event name seen at least ``calls`` / 2
    times counts its mean device ms times the times it appears a call (its
    count over ``calls``, rounded): the kernel events counted, not
    ``calls``, divide its time.  A rarer one (a one-off fill or first-use
    launch) counts its total over ``calls``.  ``events_per_call`` gives
    those counts (0 for the rare ones)."""
    out = {"calls": calls}
    for name, fn in runs.items():
        fn()                                            # warm
        prof = profiled(lambda: [fn() for _ in range(calls)], events=True)
        per_call = {k: round(n / calls) if 2 * n >= calls else 0
                    for k, (n, _) in prof["events"].items()}
        out[name] = {"device_ms_per_call": sum(
                         t / n * per_call[k] if per_call[k] else t / calls
                         for k, (n, t) in prof["events"].items())
                     if prof["events"] else "not measured",
                     "events": sum(n for n, _ in prof["events"].values()),
                     "events_per_call": {k[:80]: c
                                         for k, c in per_call.items()},
                     "wall_ms_per_call": prof["wall_ms"] / calls,
                     "top_device_events": prof["top_device_events"][:2],
                     "lead_in_lost": prof["lead_in_lost"]}
    return out


def one_kernel_event(runs: dict, name: str, event: str) -> None:
    """Checks that each call of ``runs[name]`` (a :func:`device_ms` entry)
    showed one device event, and that it was ``event``."""
    per_call = runs[name]["events_per_call"]
    check(len(per_call) == 1 and event in next(iter(per_call))
          and next(iter(per_call.values())) == 1
          and runs[name]["events"] <= runs["calls"],
          f"{name}: device events {per_call} ({runs[name]['events']} in "
          f"{runs['calls']} calls); want one {event} a call")


def cold_l2_device_ms(fn, event: str, calls: int = 100) -> dict:
    """Device ms per device event named ``event`` in ``calls`` calls of
    ``fn``, with L2 warm (the calls back to back) and cold (a 256 MB
    buffer, five times the H100's 50 MB L2, read and written before each
    call, so the call finds none of its operands in L2)."""
    import torch
    flush = torch.zeros(64 << 20, dtype=torch.float32, device="cuda")
    out = {"calls": calls}
    for name, before in (("warm", lambda: None),
                         ("cold", lambda: flush.add_(1.0))):
        def run(before=before):
            for _ in range(calls):
                before()
                fn()
        run()                                           # warm up
        prof = profiled(run, count=(event,))
        n = prof["launches"][event]
        out[name] = {"events": n, "device_ms_per_event":
                     prof["device_ms_of"][event] / n if n else
                     "not measured"}
    del flush
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.convert import index_state_from_numpy
    from repro_torch.core import edgerag as edgerag_mod
    from repro_torch.core import EdgeCostModel, EdgeRAGIndex
    from repro_torch.data.synthetic import scaled_beir
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_lengths)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.ivf_topk import topk_ip
    from repro_torch.kernels.ivf_topk.ref import topk_ip_ref
    from repro_torch.kernels.slab_topk import (NOT_PROBED, ROW_PAD,
                                               slab_mode, slab_topk)
    from repro_torch.kernels.slab_topk.ref import NEG_INF, slab_topk_ref
    from repro_torch.models import init_params, param_count, prefill
    from repro_torch.models import model as model_mod
    from repro_torch.models.cache import init_cache
    from repro_torch.serving import (ContinuousBatcher, GeneratorModel,
                                     RAGEngine)

    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 means fp32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi()

    # ---- env: build every kernel, in parallel --------------------------
    t0 = time.perf_counter()
    per_kernel_s = _build.build()
    build_s = time.perf_counter() - t0
    k5_ptxas = flash_ptxas(_build.ptxas_report.get("flash_attention"))
    topk_ptxas = tiled_ptxas(_build.ptxas_report)
    k6_ptxas = decode_ptxas(_build.ptxas_report.get("decode_attention"))
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_s_per_kernel": per_kernel_s,
          "flash_attention_ptxas": k5_ptxas, "topk_tiled_ptxas": topk_ptxas,
          "decode_attention_ptxas": k6_ptxas,
          "ptxas": _build.ptxas_report})

    # ---- main path ------------------------------------------------------
    t0 = time.perf_counter()
    ds = scaled_beir(DATASET, n_records=RECORDS, dim=DIM,
                     n_queries=(BATCHES + 1) * BATCH, seed=SEED)
    data_s = time.perf_counter() - t0
    cost = EdgeCostModel()
    rec_ivf = Recorder(topk_ip)
    rec_slab = Recorder(slab_topk, lambda e, q, v, k, **kw: slab_mode(
        e, q, v, **kw))
    edgerag_mod.topk_ip, edgerag_mod.slab_topk = rec_ivf, rec_slab
    rec_flash = Recorder(flash_attention,
                         lambda q, k, v, causal=True, window=0: causal)
    rec_dec = Recorder(decode_attention)
    model_mod.flash_attention = rec_flash
    model_mod.decode_attention = rec_dec
    gcfg = get_config(GENERATOR)
    t0 = time.perf_counter()
    gen = GeneratorModel(gcfg, seed=SEED, max_prompt=MAX_PROMPT, device=dev)
    torch.cuda.synchronize()
    gen_init_s = time.perf_counter() - t0
    index = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, cost,
                         slo_s=ds.spec.slo_s, device=dev)
    engine = RAGEngine(index, gen, cost_model=cost, k=K, nprobe=NPROBE,
                       max_new_tokens=NEW_TOKENS)

    zero_launches()
    t0 = time.perf_counter()
    assign = index.build(ds.chunk_ids, ds.texts, nlist=NLIST,
                         embeddings=ds.embeddings, seed=SEED)
    torch.cuda.synchronize()
    build_index_s = time.perf_counter() - t0
    stored_at_build = index.stats()["stored_clusters"]
    responses, per_batch = [], []
    for b in range(BATCHES):
        qs = [f"query-{b * BATCH + i}" for i in range(BATCH)]
        embs = ds.query_embs[b * BATCH:(b + 1) * BATCH]
        p0, d0 = gen.prefill_wall_s, gen.decode_wall_s
        t0 = time.perf_counter()
        resp = engine.answer_batch(qs, embs, ds.get_chunks)
        wall = time.perf_counter() - t0
        responses.append(resp)
        per_batch.append({
            "wall_s": wall,
            "retrieval_s": sum(r.ttft_wall_s for r in resp),
            "prefill_s": gen.prefill_wall_s - p0,
            "decode_s": gen.decode_wall_s - d0})
    launches = {"ivf_topk": topk_ip.launches, "slab_topk": slab_topk.launches,
                "flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    main_by_mode = dict(slab_topk.launches_by_mode)
    main_by_mask = dict(flash_attention.launches_by_mask)

    flat = [r for resp in responses for r in resp]
    tiers = {"stored": sum(r.retrieval.n_storage_loads for r in flat),
             "cached": sum(r.retrieval.n_cache_hits for r in flat),
             "regenerated": sum(r.retrieval.n_generated for r in flat)}
    check(all(v > 0 for v in tiers.values()), f"a tier never ran: {tiers}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel was not launched on the main path: {launches}")
    n_req = BATCHES * BATCH
    want = {"causal": gcfg.num_layers * n_req, "non_causal": 0}
    check(main_by_mask == want and launches["decode_attention"]
          == gcfg.num_layers * NEW_TOKENS * n_req,
          f"attention launches {main_by_mask}, {launches['decode_attention']}"
          f" on the main path; want {want} and "
          f"{gcfg.num_layers * NEW_TOKENS * n_req}")
    check(all(len(r.output_tokens) == NEW_TOKENS
              and all(0 <= t < gcfg.vocab_size for t in r.output_tokens)
              for r in flat), "generated tokens out of range")
    check(all(len(r.chunk_ids) == K for r in flat), "short retrieval")

    # the port's own CPU run on the same clustering and the same batches
    cpu_ix = EdgeRAGIndex(DIM, ds.embedder, ds.get_chunks, cost,
                          slo_s=ds.spec.slo_s, device="cpu")
    index_state_from_numpy(cpu_ix, index.centroids, assign, ds.chunk_ids,
                           ds.texts, ds.embeddings)
    swaps = mismatches = 0
    for b, resp in enumerate(responses):
        embs = ds.query_embs[b * BATCH:(b + 1) * BATCH]
        ids, vals, _ = cpu_ix.search_batch(
            embs, K, NPROBE, query_chars=[len(r.query) for r in resp])
        s, m = near_tie_mismatches([r.chunk_ids for r in resp], ids, vals)
        swaps, mismatches = swaps + s, mismatches + m
    check(mismatches == 0, f"{mismatches} ids differ from the CPU run "
          f"outside near-ties")
    check(cpu_ix.stats()["cache_hit_rate"] == index.stats()["cache_hit_rate"],
          "the CPU run took other tier decisions")

    # full-width logits are finite; a reduced copy agrees with the CPU
    toks = torch.randint(0, gcfg.vocab_size, (1, MAX_PROMPT),
                         generator=torch.Generator().manual_seed(1))
    logits, _ = prefill(gen.params, {"tokens": toks.to(dev)},
                        init_cache(gcfg, 1, MAX_PROMPT, device=dev))
    check(bool(torch.isfinite(logits).all()), "non-finite full-width logits")
    small = get_config(GENERATOR).reduced(num_layers=2, d_model=256)
    m_cpu = init_params(small, seed=SEED, device="cpu")
    m_gpu = init_params(small, seed=SEED, device="cpu").to(dev)
    st = toks[:, :32] % small.vocab_size
    l_cpu, _ = prefill(m_cpu, {"tokens": st},
                       init_cache(small, 1, 32, device=torch.device("cpu")))
    l_gpu, _ = prefill(m_gpu, {"tokens": st.to(dev)},
                       init_cache(small, 1, 32, device=dev))
    small_err = float((l_gpu.cpu() - l_cpu).abs().max())
    check(small_err < 1e-3, f"reduced model on the card vs CPU: {small_err}")

    emit({"phase": "main_path", "dataset": DATASET, "records": ds.n,
          "dim": DIM, "nlist": index.nlist, "batches": BATCHES,
          "batch": BATCH, "requests": len(flat), "k": K, "nprobe": NPROBE,
          "generator": gcfg.name, "layers": gcfg.num_layers,
          "d_model": gcfg.d_model, "head_dim": gcfg.head_dim,
          "vocab": gcfg.vocab_size,
          "param_bytes": param_count(gen.params) * 4,
          "data_s": data_s, "generator_init_s": gen_init_s,
          "index_build_s": build_index_s,
          "stored_clusters_at_build": stored_at_build,
          "per_batch": per_batch, "tiers": tiers, "launches": launches,
          "slab_topk_launches_by_mode": main_by_mode,
          "flash_attention_launches_by_mask": main_by_mask,
          "slab_rows_first_batch": int(rec_slab.first["fp32"][0][0].shape[0]),
          "cache_hit_rate": index.stats()["cache_hit_rate"],
          "gen_tokens": [r.output_tokens for r in flat[:3]],
          "first_chunk_ids": [r.chunk_ids[:5] for r in flat[:3]],
          "cpu_match": True, "near_tie_swaps": swaps,
          "reduced_model_card_vs_cpu_max_err": small_err})

    # ---- the generator on the card against the CPU; encode -------------
    parity, recorded = generator_parity(dev)
    emit(parity)
    kv8 = kv_int8(dev, recorded)
    q8_inputs = kv8.pop("row")
    emit(kv8)
    del recorded
    batching, k6_batcher = continuous_batching({
        "dev": dev, "gen": gen, "engine": engine, "ds": ds,
        "per_batch": per_batch})
    emit(batching)
    enc = encode_phase(dev, ds.texts[:ENC_TEXTS])
    emit(enc)
    online, reuse = online_index({"ds": ds, "cost": cost, "dev": dev,
                                  "gen": gen})
    emit(online)
    pipe = staged_pipeline({"ds": ds, "cost": cost, "dev": dev, "gen": gen,
                            **reuse})
    emit(pipe)
    sched = scheduler_phase({"ds": ds, "cost": cost, "dev": dev, "gen": gen,
                             "first_batch": responses[0],
                             "main_centroids": index.centroids,
                             "main_assign": assign, **reuse})
    del reuse
    emit(sched)
    by_row = launch_rows([
        ("main_path", {**launches, "slab_topk": main_by_mode,
                       "flash_attention": main_by_mask}, False),
        ("continuous_batching", batching["trace"]["launches"], True),
        ("continuous_batching_engine", batching["engine"]["launches"],
         True),
        ("encode", {"flash_attention": enc["launches"]}, False),
        ("online_index", online["launches"], False),
        ("staged_pipeline", pipe["launches"], True),
        ("staged_pipeline_stale", pipe["stale"]["launches"], True),
        ("scheduler_run", sched["run"]["launches"], False),
        ("scheduler_run_pipelined", sched["run_pipelined"]["launches"],
         True)])

    def n_path(row):
        return sum(by_row[row].values())

    # ---- codec paths: fp16, int8, pq on the same corpus and generator ----
    ctx = {"ds": ds, "cost": cost, "dev": dev, "gen": gen,
           "centroids": index.centroids, "assign": assign,
           "scratch": str(ROOT / "build"),
           "fp32_storage_bytes": index.storage_bytes(),
           "fp32_ids": [r.chunk_ids for r in flat]}
    (ROOT / "build").mkdir(exist_ok=True)
    t0 = time.perf_counter()
    codecs = [codec_path(codec, ctx) for codec in CODECS]
    edgerag_mod.topk_ip, edgerag_mod.slab_topk = topk_ip, slab_topk
    model_mod.flash_attention = flash_attention
    model_mod.decode_attention = decode_attention
    emit({"phase": "codec_paths", "phase_s": time.perf_counter() - t0,
          "codecs": codecs})

    # ---- kernels against their plain versions, on the card --------------
    report = {}
    (e1, q1, k1), _ = rec_ivf.first[None]
    (e2, q2, v2, k2), _ = rec_slab.first["fp32"]
    gen_int = torch.Generator(device=dev).manual_seed(2)
    rint = lambda shape, lo, hi: torch.randint(
        lo, hi, shape, generator=gen_int, device=dev).float()

    # ivf_topk
    tol1 = score_tol(e1, q1)
    kv, ki = topk_ip(e1, q1, k1)
    pv, pi = topk_ip_ref(e1, q1, k1)
    err1 = float((kv - pv).abs().max())
    check(err1 <= tol1, f"ivf_topk error {err1} > {tol1}")
    full1 = (q1.double() @ e1.double().T).cpu().numpy()
    n1 = isolated_ids_equal(kv.cpu().numpy(), ki.cpu().numpy(),
                            pi.cpu().numpy(), full1, tol1)
    ei, qi_ = rint(e1.shape, -3, 4), rint(q1.shape, -2, 3)
    ei[7:15] = ei[3]                                    # exact ties
    a, b = topk_ip(ei, qi_, k1), topk_ip_ref(ei, qi_, k1)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "ivf_topk integer inputs not bitwise equal to the plain version")
    for i in range(q1.shape[0]):
        s = topk_ip(e1, q1[i:i + 1], k1)
        check(torch.equal(s[0][0], kv[i]) and torch.equal(s[1][0], ki[i]),
              "ivf_topk batch != sequential")
    pad_v, pad_i = topk_ip(e1[:5], q1, 8)
    check(bool((pad_i[:, 5:] == -1).all() and torch.isinf(pad_v[:, 5:]).all()),
          "ivf_topk k > N padding")
    report["ivf_topk"] = {"max_abs_err": err1, "tol": tol1,
                          "ids_checked": n1}

    # slab_topk (fp32)
    member = v2 < NOT_PROBED
    n_valid = member.sum(1)
    lane = torch.arange(k2, device=dev)[None, :] < n_valid[:, None]
    tol2 = score_tol(e2, q2)
    kv, kr = slab_topk(e2, q2, v2, k2)
    pv, pr = slab_topk_ref(e2, q2, v2, k2)
    err2 = float((kv - pv)[lane].abs().max())
    check(err2 <= tol2, f"slab_topk error {err2} > {tol2}")
    full2 = torch.where(member, q2.double() @ e2.double().T,
                        NEG_INF).cpu().numpy()
    n2 = isolated_ids_equal(torch.where(lane, kv, NEG_INF).cpu().numpy(),
                            torch.where(lane, kr, -1).cpu().numpy(),
                            torch.where(lane, pr, -1).cpu().numpy(), full2,
                            tol2)
    ei, qi_ = rint(e2.shape, -3, 4), rint(q2.shape, -2, 3)
    a, b = slab_topk(ei, qi_, v2, k2), slab_topk_ref(ei, qi_, v2, k2)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "slab_topk integer inputs not bitwise equal to the plain version")
    ones = torch.ones_like(e2)
    a, b = slab_topk(ones, torch.ones_like(q2), v2, k2), \
        slab_topk_ref(ones, torch.ones_like(q2), v2, k2)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "slab_topk all-tie rows")
    for i in range(q2.shape[0]):
        s = slab_topk(e2, q2[i:i + 1], v2[i:i + 1], k2)
        check(torch.equal(s[0][0], kv[i]) and torch.equal(s[1][0], kr[i]),
              "slab_topk batch != sequential")
    ev, er = slab_topk(e2[:0], q2, v2[:, :0], k2)
    check(bool(torch.isinf(ev).all() and (er == ROW_PAD).all()),
          "slab_topk empty slab")
    a = slab_topk(ei[:5], qi_, v2[:, :5], k2)
    b = slab_topk_ref(ei[:5], qi_, v2[:, :5].contiguous(), 5)
    check(bool((a[1][:, 5:] == ROW_PAD).all()
               and torch.equal(a[1][:, :5], b[1])), "slab_topk k > N")
    report["slab_topk"] = {"max_abs_err": err2, "tol": tol2,
                           "ids_checked": n2,
                           "member_pairs": int(member.sum())}
    for mode in CODECS:
        (e, q, v, k), kw = rec_slab.first[mode]
        report[f"slab_topk_{mode}"] = check_quantized(mode, e, q, v, k, kw,
                                                      rint)
    report["slab_topk_wide_rows"] = check_wide_rows(dev, rint)
    report.update(check_attention(rec_flash, rec_dec, dev))
    emit({"phase": "kernels_checked",
          "ivf_topk_shape": [*e1.shape, q1.shape[0], k1],
          "slab_topk_shape": {m: [*a[0].shape, a[1].shape[0], a[3]]
                              for m, (a, _) in rec_slab.first.items()},
          "integer_inputs": "bitwise", "batch_vs_sequential": "bitwise",
          "pq_recorded_inputs": "bitwise", "checks": report})

    # ---- timing and bounds at the main path's shapes ---------------------
    # each top-k kernel and its library call at its recorded inputs; device
    # ms a call from 100 calls each under the profiler
    slab_inputs = {"fp32": ((e2, q2, v2, k2), {})}
    slab_inputs.update((m, rec_slab.first[m]) for m in CODECS)
    # kept for scripts/kernel_timing.py and kernel_phases.py
    torch.save({"ivf_topk": ((e1, q1, None, k1), {}), **slab_inputs},
               ROOT / "build" / SLAB_INPUTS)
    calls = {"ivf_topk": (lambda: topk_ip(e1, q1, k1),
                          lambda: torch.topk(q1 @ e1.T, k1))}
    for mode, ((e, q, v, k), kw) in slab_inputs.items():
        calls["slab_topk" if mode == "fp32" else f"slab_topk_{mode}"] = (
            lambda e=e, q=q, v=v, k=k, kw=kw: slab_topk(e, q, v, k, **kw),
            topk_library(mode, e, q, v, k, kw))
    topk_dev = device_ms({f"{name}{tag}": fn for name, pair in calls.items()
                          for tag, fn in zip(("", "_library"), pair)}, 100)
    for name in calls:
        one_kernel_event(topk_dev, name, TILED_EVENTS[
            "slab_topk_fp32" if name == "slab_topk" else name])
    (n, d), nq = e1.shape, q1.shape[0]
    b1 = bound((n * d + nq * d) * 4 + nq * k1 * 8, 2 * nq * n * d)
    kernels = [
        {"name": "ivf_topk", "route": "cuda",
         "source": "src/repro_torch/csrc/ivf_topk.cu",
         "replaces": "src/repro/kernels/ivf_topk/kernel.py:98",
         "launches": n_path("ivf_topk"), "max_abs_err": err1,
         "ms": cuda_ms(calls["ivf_topk"][0], 200),
         "plain_ms": cuda_ms(lambda: topk_ip_ref(e1, q1, k1), 10),
         "bound_ms": b1[0], "bound_by": b1[1],
         "library_ms": cuda_ms(calls["ivf_topk"][1], 200),
         "device_ms": topk_dev["ivf_topk"]["device_ms_per_call"],
         "library_device_ms": topk_dev["ivf_topk_library"]
         ["device_ms_per_call"]}]
    for mode, ((e, q, v, k), kw) in slab_inputs.items():
        name = "slab_topk" if mode == "fp32" else f"slab_topk_{mode}"
        n_launch = (n_path("slab_topk") if mode == "fp32" else
                    codecs[CODECS.index(mode)]["launches"][mode])
        if mode != "fp32":
            by_row[name] = {"codec_paths": n_launch}
        kernels.append(slab_row(mode, e, q, v, k, kw, n_launch,
                                report[name]["max_abs_err"], calls[name],
                                topk_dev))
    k5_dev = k5_device_ms(rec_flash)
    k6_dev = decode_device_ms(*rec_dec.first[None][0])
    q8_dev = q8_device_ms(q8_inputs)
    kernels += attention_rows(
        rec_flash, rec_dec,
        {"flash_attention_causal": n_path("flash_attention"),
         "flash_attention_encode": n_path("flash_attention_encode"),
         "decode_attention": n_path("decode_attention")},
        report, k5_dev, k6_dev)
    kernels.append(q8_row(q8_inputs, kv8["launches"], kv8["max_abs_err"],
                          q8_dev))
    by_row["decode_attention_q8"] = {"kv_int8": kv8["launches"]}
    q, kc, vc, lens = k6_batcher["call"]
    lens = decode_lengths(lens, q.shape[0], dev)
    kernels.append(k6_row("decode_attention_batcher", q, kc, vc, lens,
                          n_path("decode_attention_batcher"),
                          k6_batcher["max_abs_err"],
                          decode_device_ms(q, kc, vc, lens)))
    for row in kernels:
        row["launches_by_phase"] = by_row[row["name"]]

    # ---- breakdown: one retrieval batch and one request's generation ----
    embs = ds.query_embs[BATCHES * BATCH:(BATCHES + 1) * BATCH]
    index.search_batch(embs, K, NPROBE)                 # warm
    r0 = flat[0]
    prompt = " ".join(ds.get_chunks(r0.chunk_ids) + [r0.query])
    # ivf_topk and fp32 slab_topk: one kernel launch a call
    ret = profiled_one_launch(lambda: index.search_batch(embs, K, NPROBE),
                              "profiled retrieval batch")
    check(ret["calls"]["ivf_topk"] > 0 and ret["calls"]["slab_topk_fp32"] > 0,
          f"profiled retrieval batch: calls {ret['calls']}")
    gen_prof = profiled(lambda: gen.generate(prompt, NEW_TOKENS))
    # one batcher tick of 16 active slots (the trace's first 16 prompts)
    tb = ContinuousBatcher(gcfg, gen.params, num_slots=BATCH,
                           max_len=BATCHER_LEN, device=dev)
    for r in batcher_trace(gcfg.vocab_size)[:BATCH]:
        tb.admit(r["id"], r["prompt_tokens"], NEW_TOKENS)
    tb.tick()                                           # warm
    tick_prof = profiled(tb.tick, count=("decode_fwd", "Memcpy HtoD",
                                         "Memcpy DtoH"))
    del tb
    emit({"phase": "breakdown", "retrieval_batch": ret,
          "one_request_generation": gen_prof, "one_batcher_tick": tick_prof,
          "k7_vs_k6_device": q8_dev, "k6_vs_sdpa_device": k6_dev,
          "decode_long": decode_long(dev),
          "k5_vs_sdpa_device": k5_dev, "topk_vs_library_device": topk_dev,
          "k2_cold_vs_warm_l2": cold_l2_device_ms(
              calls["slab_topk"][0], TILED_EVENTS["slab_topk_fp32"])})
    t_first = LEAD_IN_LOST[0][0]
    emit({"phase": "profiler_lead_in", "lead_in": LEAD_IN,
          "spin_cycles": LEAD_IN_CYCLES, "windows": len(LEAD_IN_LOST),
          "lost_max": max(lost for _, lost in LEAD_IN_LOST),
          "s_since_first_window_and_lost": [
              [round(t - t_first, 1), lost] for t, lost in LEAD_IN_LOST]})

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
