#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py        # from the root of a checkout, on a CUDA card

Phases, one JSON line each:

  env              card (``nvidia-smi`` name and power limit), torch / CUDA
                   versions, and the build of every kernel from
                   ``src/repro_torch/csrc`` (one ``nvcc`` per source, all at
                   once, into the git-ignored ``build/kernels/``), with
                   ``ptxas``'s registers and spills per kernel entry; every
                   ``flash_attention`` entry (head dims 64, 80, 128, 256,
                   f32 and bf16, both layouts: 16, and the 8 f32 entries
                   that also write each row's log-sum-exp for training),
                   every entry of K5's backward
                   (``flash_attention_bwd_ptxas``: 9), every entry of the
                   one-launch
                   top-k kernel (``topk_tiled_ptxas``: ivf_topk, and
                   slab_topk in fp32, fp16, int8 and pq, at 16- and 64-row
                   tiles: 10 entries) and every
                   ``decode_fwd`` entry (``decode_attention_ptxas``: K6 and
                   K7, f32 and bf16, head dims 32, 64, 80, 128, 256: 20)
                   must spill nothing.
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
  dense_archs      the assigned dense configs (``configs.ASSIGNED_ARCHS``).
                   (a) yi-9b at full width (48 layers, d_model 4096, 32
                   heads over 4 kv heads of 128, d_ff 11008, vocab 64,000,
                   untied head, fp32: 8,829,407,232 parameters, 35.32 GB,
                   random weights drawn on the card from the seed, the draw
                   timed) as ``RAGEngine``'s generator over the main path's
                   index, beside the main generator: the main path's first
                   2 batches of 16 through ``answer_batch`` (prompts of 128
                   tokens, 16 greedy tokens).  Counts zeroed before, read
                   after.  Checks: K5 causal exactly 48 x 32 = 1,536, none
                   non-causal, K6 exactly 48 x 16 x 32 = 24,576, no K7; the
                   ids equal the main path's for the same queries outside
                   near-ties; every token in range.  Prints each batch's
                   retrieval, prefill and decode wall, the weights' bytes
                   and ``torch.cuda.max_memory_allocated()``, then profiles
                   the first request's generation once more (as
                   ``moe_archs`` (a) does).  (b) each of
                   the five configs at full width cut to 2 layers, one set
                   of weights drawn on the CPU from the seed and copied to
                   the card: prefill of 128 positions, then 8 decode steps,
                   the same inputs into both (musicgen-large prefills from
                   (1, 128, 2048) frame embeds, decodes codec ids and takes
                   its last step by an embed; qwen2-vl-2b's prompt opens on
                   32 ``vision_embeds`` rows on an 8-wide patch grid, with
                   (3, 1, 128) M-RoPE positions whose streams differ over
                   the image).  Logits of every step within ``GEN_TOL`` of
                   the CPU's, greedy tokens equal wherever the top-2 margin
                   exceeds 2 x ``GEN_TOL``, K5 2 and K6 16 launches, and
                   each config's first K5 and K6 call within
                   :func:`attn_tol` of the plain versions on the card
                   (starcoder2-7b's K6: the first full-width launch of a
                   9-head group, two passes of the kernel's 8 heads).
                   gemma3-12b is ``swa_gemma3``'s.
  swa_gemma3       gemma3-12b's sliding-window layers over ring caches.
                   (a) gemma3-12b at full width (48 layers of the pattern
                   5 x "swa" (window 1,024) then 1 x "attn", d_model 3840,
                   16 heads over 8 kv heads of 256, d_ff 15360, vocab
                   262,144, tied head, fp32: 11,765,395,200 parameters,
                   47.06 GB, random weights drawn on the card from the
                   seed, the draw timed; yi-9b freed before) as
                   ``RAGEngine``'s generator over the main path's index,
                   beside the main generator: the main path's first batch
                   of 16, prompts left-padded to 2,048 positions (the pad
                   attended, as in the JAX engine), 16 greedy tokens.
                   Counts zeroed before, read after.  Checks: K5 causal
                   exactly 48 x 16 = 768, 640 of them with the window (the
                   40 "swa" layers), none non-causal; K6 exactly 48 x 16 x
                   16 = 12,288 (10,240 over 1,024-row rings, 2,048 over
                   2,064-row caches, counted by the cache each call got);
                   no K7; one request's caches (``init_cache`` as
                   ``generate`` makes them) of 8 x 2 x 2,064 x 8 x 256 x 4
                   + 40 x 2 x 1,024 x 8 x 256 x 4 bytes; the ids equal the
                   main path's outside near-ties; every token in range.
                   Prints the batch's retrieval, prefill and decode wall,
                   the draw's seconds, ``max_memory_allocated``, the
                   prompts' token counts and the launches, and profiles the
                   first request's generation.  (b) the first
                   pattern (6 layers: 5 "swa", 1 "attn") at full width,
                   one set of weights drawn on the CPU from the seed and
                   copied to the card: a prompt of 1,040 positions (past
                   the window: the rings wrap) and 8 decode steps, the same
                   tokens into both; logits of every step within
                   ``GEN_TOL`` of the CPU's, greedy tokens equal wherever
                   the top-2 margin exceeds 2 x ``GEN_TOL``, K5 6 (5
                   windowed) and K6 48 launches, the first K5 call of each
                   kind and K6 call of each cache within :func:`attn_tol`
                   of the plain versions; the CPU's and the card's seconds
                   printed.
  moe_archs        the mixture-of-experts configs (``models/moe.py``).
                   (a) olmoe-1b-7b at full width (16 layers of ``"moe"``
                   blocks, d_model 2048, 16 heads of 128 (MHA), 64 experts
                   of d_ff 1024, top-8, vocab 50,304, untied head, fp32:
                   6,919,096,320 parameters, 27,676,385,280 bytes, random
                   weights drawn on the card from the seed, the draw
                   timed; gemma3-12b freed before) as ``RAGEngine``'s
                   generator over the main path's index, beside the main
                   generator: the main path's first 2 batches of 16,
                   128-token prompts, 16 greedy tokens.  Counts zeroed
                   before, read after.  Checks: K5 causal exactly 16 x 32
                   = 512, none non-causal or windowed; K6 exactly 16 x 16 x
                   32 = 8,192; no K7; K1 and K2 one launch a batch; the
                   weight bytes; the ids equal the main path's outside
                   near-ties; every token in range.  Prints each batch's
                   retrieval, prefill and decode wall, the draw's seconds,
                   ``max_memory_allocated``, each prefill's capacity (20:
                   ``int(max(8, 128 x 8 / 64 x 1.25))``) and the prefill
                   assignments it dropped, counted by the port's routing
                   step (``models.moe.route``) on each layer's normed
                   input (decode is dropless, capacity = B x S = 1, so
                   every step reads all 64 experts' weights); then the
                   first request's generation once more under
                   ``torch.profiler`` (wall and device ms, the largest
                   device events).  (b) both
                   MoE configs (olmoe-1b-7b; granite-moe-3b-a800m: d_model
                   1536, 24 heads over 8 kv heads of 64, a GQA group of 3,
                   40 experts of d_ff 512, top-8, vocab 49,155, tied) at
                   full width cut to 2 layers, one set of weights drawn on
                   the CPU from the seed and copied to the card: prefill of
                   128 positions (capacity 20 and 32: prefill drops), then
                   8 decode steps, the same tokens into both.  Each MoE
                   layer's top-k expert sets are recorded on both sides;
                   where they agree, logits within ``GEN_TOL`` and greedy
                   tokens equal outside near-ties; where a token's set
                   differs, the CPU's k-th and (k+1)-th router
                   probabilities must lie within ``ROUTE_TIE_TOL`` (a flip
                   outside it fails), the flip is printed as a near-tie and
                   that step and the steps after it are not compared
                   (counted).  K5 2 and K6 16 launches, and each config's
                   first K5 and K6 call within :func:`attn_tol` of the
                   plain versions (granite's K6: the first full-width
                   launch of a 3-head group).
  rwkv6_arch       the attention-free RWKV6 config (``models/rwkv6.py``),
                   the first generator whose decode state does not grow
                   with the sequence.  (a) rwkv6-1.6b at full width (24
                   ``"rwkv6"`` layers, d_model 2048, 32 WKV heads of 64,
                   d_ff 7168, vocab 65,536, untied head, fp32:
                   1,483,180,032 parameters, 5,932,720,128 bytes, the JAX
                   ``init_params`` tree's count, not the reference's
                   ``param_count()``; random weights drawn on the card from
                   the seed, the draw timed; olmoe-1b-7b freed before) as
                   ``RAGEngine``'s generator over the main path's index,
                   beside the main generator: the main path's first 2
                   batches of 16, 128-token prompts, 16 greedy tokens.
                   Counts zeroed before, read after.  Checks: no K5, K6 or
                   K7 launch; K1 and K2 one launch a batch; the weight
                   bytes; one request's state (``init_cache`` as
                   ``generate`` makes it) 24 x (32 x 64 x 64 + 2 x 2048) x
                   4 = 12,976,128 bytes, the same at 144 and 2,048
                   positions; the ids equal the main path's outside
                   near-ties; every token in range.  Prints each batch's
                   retrieval, prefill and decode wall, the draw's seconds,
                   ``max_memory_allocated`` and the first request's
                   generation under ``torch.profiler``.  (b) its first 2
                   layers at full width, one set of weights drawn on the
                   CPU from the seed and copied to the card: prompts of 128
                   (four chunks of 32), 100 (a partial last chunk) and 1
                   position (the recurrent prefill), each followed by 8
                   decode steps, the same tokens into both; logits of
                   every step within ``GEN_TOL`` of the CPU's, greedy
                   tokens equal wherever the top-2 margin exceeds 2 x
                   ``GEN_TOL``, every layer's prefill state and shift
                   carries within ``WKV_TOL`` (relative to 1 + |CPU|), no
                   attention launch; then ``wkv6_chunked`` against
                   ``wkv6_recurrent`` on the card at (1, 128, 32, 64) under
                   the model's, the weakest and the strongest clipped
                   decay: within ``WKV_TOL`` but the strongest, where both
                   must stay finite and the gap is printed; each form's ms.
  hybrid_zamba2    the hybrid config (``models/mamba2.py`` and one shared
                   attention block), the first generator with two kinds of
                   state and parameters shared across layers.  (a)
                   zamba2-2.7b at full width (54 layers: 9 x (5
                   ``"mamba2"`` then the one ``"shared_attn"`` block),
                   d_model 2560, 32 heads over 32 kv heads of 80, d_ff
                   10,240, vocab 32,000, tied head; SSM 80 heads of 64,
                   state 64, conv width 4; fp32: 1,981,519,920 parameters,
                   7,926,079,680 bytes, the JAX ``init_params`` tree's
                   count, the shared block's 104,862,720 once; random
                   weights drawn on the card from the seed, the draw timed;
                   rwkv6-1.6b freed before) as ``RAGEngine``'s generator
                   over the main path's index, beside the main generator:
                   the main path's first 2 batches of 16, 128-token
                   prompts, 16 greedy tokens.  Counts zeroed before, read
                   after.  Checks: K5 causal exactly 9 x 32 = 288, none
                   windowed or non-causal; K6 exactly 9 x 16 x 32 = 4,608;
                   no K7; K1 and K2 one launch a batch; the shared block's
                   first K5 and K6 calls at the main path's shapes; the
                   weight bytes; one request's state (``init_cache`` as
                   ``generate`` makes it) 88,358,400 bytes at 144
                   positions and 439,303,680 at 2,048; the ids equal the
                   main path's outside near-ties; every token in range.
                   Prints each batch's retrieval, prefill and decode wall,
                   the draw's seconds, ``max_memory_allocated`` and the
                   first request's generation under ``torch.profiler``.
                   (b) its first 12 layers at full width (the shared block
                   at layers 5 and 11), one set of weights drawn on the
                   CPU from the seed and copied to the card: prompts of
                   128 (two chunks of 64), 100 (a partial chunk) and 1
                   position (the recurrent prefill), each followed by 8
                   decode steps, the same tokens into both; logits of
                   every step within ``GEN_TOL`` of the CPU's, greedy
                   tokens equal wherever the top-2 margin exceeds 2 x
                   ``GEN_TOL``, every Mamba2 layer's prefill SSM state and
                   conv carry within ``SSD_TOL`` (relative to 1 + |CPU|),
                   K5 2 and K6 16 launches a prompt, the first K5 and K6
                   call within :func:`attn_tol` of the plain versions, the
                   shared block one parameter storage on the card with a
                   KV cache of its own at each layer; then ``ssd_chunked``
                   against ``ssd_reference`` on the card at (1, 128, 80,
                   64), N 64, under the model's decay and the strongest
                   the init allows, both within ``SSD_TOL`` and finite;
                   each form's ms.
  baselines        the paper's Table 4 rows 1-2 on the main path's corpus
                   and 64 queries (k 10).  ``FlatIndex`` on the card holds
                   all 25,000 rows (76,800,000 bytes) and takes each batch
                   of 16 in one ``search``: exactly 4 ``ivf_topk`` launches
                   (the first K1 launches past 2,048 rows, so on 64-row
                   tiles) and no other kernel; ids equal a
                   ``FlatIndex(device="cpu")`` outside near-ties, scores
                   within ``score_tol``.  ``IVFIndex.build`` (nlist 125, the
                   main path's seed, timed) must give the main path's
                   assignment or the count of chunks that differ is printed
                   and the main path's clustering loaded
                   (``ivf_state_from_numpy``); then the 64 queries one at a
                   time at nprobe 8: exactly 2 ``ivf_topk`` launches a query
                   (probe and scan), ids equal as sets to the main path's
                   EdgeRAG retrieval of the same queries outside near-ties
                   (the paper's §6.3.1 claim), scores within ``score_tol``;
                   how many queries' ids and scores are bitwise the main
                   path's is printed, not gated.  Recall@10 of IVF against
                   flat at nprobe 1, 4, 8, 16 and 125 (2 launches a query
                   each, checked) must not decrease and must be >= 0.999 at
                   125.  Prints the flat wall per batch, the IVF wall per
                   query, the build seconds and the recalls.
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
  tenancy          ``TenantRouter`` (``core/tenant.py``) on the card:
                   tenant "fiqa" (the main path's corpus, rows and nlist-125
                   clustering) beside "scidocs" (``scaled_beir("scidocs")``
                   at Table 2's 3,600 records and dim 768, clustered once on
                   the CPU at nlist 18, 200 chunks a cluster), memory
                   storage, fp32, the default cache, deferred maintenance,
                   each tenant regenerating through a ``TableEmbedder`` over
                   its own rows (logged), and a shared storage budget of
                   fiqa's standalone stored bytes plus half of scidocs'.
                   4 batches of 16 requests, each request's tenant drawn by
                   ``zipf_over_tenants(2, 64, seed=0)`` (every batch holds
                   both, checked) and its row its tenant's next query.
                   (a) each batch in one ``search_batch``: one K1 launch a
                   tenant and ONE fp32 ``slab_topk`` launch; ids and scores
                   bitwise those of two standalone card indexes (2 K1 and 2
                   K2 a batch); each embedder saw only its tenant's texts;
                   puts refused, per-tenant bytes summing to the total.
                   (b) a router holding fiqa alone equals a standalone
                   index with the same cache on the main path's 4 batches,
                   bitwise: ids, scores and every modeled field.  (c) (a)
                   replayed on a CPU router: ids outside near-ties, tier
                   decisions and the cache, storage and maintenance stats
                   equal, ``collect_router``'s samples within
                   ``SCHEDULE_RTOL`` (the card's text to
                   ``build/tenancy.prom``).  (d) one mixed batch through
                   ``RAGEngine(router, <the main generator>).answer_batch(
                   ..., tenants=)`` with 2 new tokens: every context a text
                   of its query's tenant, K1 2, K2 1, K5 causal and K6 as
                   the main path's rule gives, ids equal to the CPU
                   router's outside near-ties.  (e) 32 tenant-tagged
                   requests 0.05 modeled s apart through
                   ``RequestScheduler.run_pipelined`` (no generator)
                   against the same two ``PipelineBatch(tenants=...)``
                   built by hand on a twin router: ids, scores, trace and
                   stamps bitwise, K1 = tenants a batch, K2 1 a batch.
                   (f) the two tenants on an int8 router, one batch: one
                   int8 ``slab_topk`` launch over both tenants' stored
                   clusters, ids and tier decisions equal to a CPU int8
                   router's.  Prints the fused and silo walls a batch,
                   the launches and the stored bytes.
  durability       crash-consistent durability (``core/durability.py``) on
                   the main path's fiqa corpus and clustering: disk storage
                   on a temporary root inside ``build/``, sync maintenance,
                   regeneration through a ``TableEmbedder`` keyed by chunk
                   id (the corpus rows and the inserted chunks'; so no
                   text enters a heal), a ``Durability`` handle taking a
                   snapshot every 16 WAL records.  A seeded stream of 48 public ops (24 inserts of
                   new chunks drawn near existing rows, 12 removes, 12
                   updates, one of them fat enough to split its cluster),
                   with one stored blob deleted behind the index and a batch
                   of 16 answered before op 20 (the resolver's self-heal):
                   49 events, one WAL record each (checked), the op kinds
                   logged printed.  (a) fp32, cut by
                   ``CrashInjector("wal_torn_append", at=30)`` and, in a
                   second run, ``("snap_pre_rename", at=2)`` (the first
                   checkpoint after the baseline dies before its rename);
                   the root released (``del``, ``gc.collect()``), then
                   ``recover(..., device="cuda")``.  The recovered index
                   lands on the crashed event's pre- or post-event prefix
                   and equals a card twin that ran that prefix with no
                   durability: membership, cluster fields, centroids, chunk
                   maps and blob manifest bitwise (the storage-event stamps
                   of a cluster recovery healed move by one), the Alg. 3
                   threshold bitwise the twin's at the snapshot recovery
                   started from (records carry no threshold); ids and
                   scores on the main path's 4 batches of 16 bitwise, one
                   K1 and one fp32 K2 a batch.  (b) int8, the same stream
                   with no injector: the index answers one batch (one K3
                   int8 launch), is dropped and recovered; the recovered
                   index's answers to that batch are bitwise, one K3 int8
                   launch; its state equals an int8 twin's that ran the
                   stream without durability (threshold aside).  (c)
                   ``tenancy``'s two tenants on one shared disk root, its
                   deferred maintenance; ``enable_durability(
                   checkpoint_every=8)``, 8 inserts a tenant, one
                   fair-share drain (their restores and checkpoints), 4
                   removes a tenant, then ``tenancy``'s 4 Zipf-mixed
                   batches; the router is dropped and
                   ``recover_router(..., router_kwargs={"device": "cuda"})``
                   answers the same batches bitwise, one K1 a tenant and
                   one fp32 K2 a batch.  (d) a copy of (a)'s first crashed
                   root recovered with ``device="cpu"``: state bitwise the
                   card's recovery, ids equal outside near-ties, scores
                   within ``score_tol``'s bound.  Prints every
                   ``RecoveryReport``, the WAL and snapshot bytes on disk,
                   and the stream's host wall with durability against the
                   twins' without, each line with the ``nvidia-smi`` name
                   and power limit; the recovered indexes' first fp32 and
                   int8 K2 calls are held against the plain version in
                   ``kernels_checked``.
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
                   recorded inputs of the main path, the flat scan of
                   ``baselines``, the codec paths and ``tenancy`` (a)'s
                   first fused batch (both tenants' clusters in one slab):
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
                   at D = 32; ``dense_archs`` (a)'s first K5 and K6
                   calls, yi-9b's head dim 128 and group of 8;
                   ``swa_gemma3`` (a)'s first K5 calls with and without
                   the window and K6 calls over a ring and the global
                   cache; ``moe_archs`` (a)'s first K5 and K6 calls,
                   olmoe-1b-7b's 16 heads of 128; head dim 256: K5 at (1,
                   2048, 16, 256) against
                   8 kv heads with the 1,024 window in f32 and bf16, causal
                   without it, ragged non-causal, K6 over a 1,024-row ring,
                   a 2,064-row cache, per-slot lengths, a window and bf16,
                   K7 there (K6's bits on the dequantized cache)), within
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
                   the recorded decode input, at ``dense_archs`` (a)'s
                   and ``moe_archs`` (a)'s first decode calls (yi-9b,
                   olmoe-1b-7b) and, in ``decode_long``, at a
                   4,096-row f32 cache (every row valid), with its error
                   and bound there; each K6 and K7 call one device event;
                   K5 against
                   ``scaled_dot_product_attention`` (``enable_gqa`` where
                   the heads differ) at the recorded prefill and encode
                   inputs and at yi-9b's and olmoe-1b-7b's first prefill
                   calls; and each top-k kernel (K1 at the
                   probe's and the flat scan's inputs) against its
                   library call at its ``kernels`` inputs: 100 calls each,
                   device ms per call beside wall ms per call; and the fp32
                   ``slab_topk`` launch's device ms with L2 warm and with
                   L2 flushed before each call.
  profiler_lead_in how many of each profiler window's ``LEAD_IN`` spin
                   kernels the profiler lost, beside the window's seconds
                   since the first window (see ``profiled``); a window
                   that lost them all has failed already.
  train_lm         training (``repro_torch.train``), after the generators
                   are freed.  (a) K5's hand-written backward
                   (``csrc/flash_attention_bwd.cu``) at ``BWD_SHAPES``
                   (stablelm-1.6b's (1, 4096, 32, 64) causal, GQA 8 at
                   D 128, gemma3-12b's windowed D 256, non-causal D 80,
                   ragged, rows with no valid key) against
                   ``flash_attention_bwd_ref`` on the card (TF32 off):
                   dq, dk, dv within ``BWD_TOL``, two calls bitwise equal,
                   K5's output with its lse bitwise without, the lse
                   within :func:`attn_tol`; at the full-width shape its
                   ms, device ms, bound, plain ms and SDPA's backward.
                   (b) stablelm-1.6b's first 2 layers at full width, one
                   set of weights drawn on the CPU and copied to the card,
                   2 x 128 tokens: the loss and every parameter's gradient
                   card vs CPU within ``TRAIN_LOSS_TOL`` /
                   ``TRAIN_GRAD_TOL``, K5 4 launches (a forward and its
                   recompute a layer) and its backward 2.  (c)
                   stablelm-1.6b at full width (24 layers, d_model 2048,
                   32 heads of 64, d_ff 5632, vocab 100,352, fp32:
                   1,644,267,520 parameters) drawn on the card, 3 steps of
                   ``make_train_step(peak_lr=3e-3)`` on
                   ``synthetic_lm_batch`` at 1 x 4,096 tokens: finite
                   losses and grad norms > 0, step 0's loss within 0.5 of
                   ln(100,352), the parameters bitwise unchanged by step 0
                   (lr 0) and every one moved by step 2, K5 exactly 2 x 24
                   x 3 and its backward 24 x 3; prints seconds a step,
                   tokens a second, ``max_memory_allocated`` and one more
                   step profiled (device ms split into K5 forward, K5
                   backward, GEMMs and the rest).  (d)
                   ``tests/test_serving_train.py``'s overfit (2 layers,
                   d_model 128, 40 steps of a fixed (2, 33) batch) on the
                   card and the CPU: the last loss < 0.7 x the first, every
                   loss within ``OVERFIT_TOL`` of the CPU's, exact
                   launches.  Adds the ``flash_attention_bwd`` row (the
                   launches of (b)-(d)) and ``flash_attention_stablelm_
                   1p6b_train`` (K5's training entry, the one that writes
                   the lse, timed at (c)'s shape with (c)'s launches, and
                   the serving entry's device ms beside it) to the
                   ``kernels`` line.

Then the ``kernels`` line (per kernel: launches, error, time, plain and
library time, and the bound from this run's inputs; every row also carries
the breakdown's device ms of the kernel and of its library call), the
``nvidia-smi`` line, and
last ``{"ok": true, "device": {...}}``.  Bounds: bytes read once at HBM's
3.35 TB/s against the function's operations at the fp32-accurate peak of
the unit the kernel runs them on: for K5 the tensor cores, whose 495 TFLOP/s
in TF32 give 165 TFLOP/s at fp32 accuracy (3xTF32 takes three TF32
products for one fp32 product), and the same for K5's backward, whose
products are the same kind, though it runs them on the CUDA cores; for the
others the CUDA cores' 67 TFLOP/s in fp32.  A row's times and bound are at its one recorded input; its
``launches`` is the sum of its ``launches_by_phase``: the launches of its
kernel in its mode or mask that each phase driving a path of the port
counted in its checked window (``main_path``, ``baselines``' IVF searches
at nprobe 8, ``continuous_batching``'s trace and engine batch, ``encode``,
``online_index``, ``staged_pipeline`` and its stale batch, ``scheduler``
(a) and (b), ``tenancy`` (a), (d) and (e), ``durability``,
``dense_archs`` (a), ``swa_gemma3`` (a), ``moe_archs`` (a),
``rwkv6_arch`` (a), ``hybrid_zamba2`` (a)), whatever their shapes
(``hybrid_zamba2`` (a)'s K5 and K6 go to the ``flash_attention`` and
``decode_attention`` rows: its shared block attends at the main path's
shapes); ``flash_attention_yi_9b``
and ``decode_attention_yi_9b`` are K5 and K6 at ``dense_archs`` (a)'s
first calls (q (1, 128, 32, 128) against (1, 128, 4, 128) causal; (1, 1,
32, 128) against a (1, 144, 4, 128) cache, 129 rows valid) and take that
part's K5 and K6 launches (its K1 and K2 go to their rows);
``flash_attention_gemma3_12b_swa`` / ``_global`` and
``decode_attention_gemma3_12b_ring`` / ``_global`` are K5 and K6 at
``swa_gemma3`` (a)'s first calls (q (1, 2048, 16, 256) against (1, 2048,
8, 256), causal with the 1,024 window and without; (1, 1, 16, 256)
against a 1,024-row ring, every row valid, and a (1, 2064, 8, 256) cache,
2,049 rows valid; library: SDPA with ``enable_gqa``, a boolean mask for
the window) and take that part's K5 launches by window and K6 launches by
cache; ``flash_attention_olmoe_1b_7b`` and ``decode_attention_olmoe_1b_7b``
are K5 and K6 at ``moe_archs`` (a)'s first calls (q (1, 128, 16, 128)
against (1, 128, 16, 128) causal; (1, 1, 16, 128) against a (1, 144, 16,
128) cache, 129 rows valid) and take that part's K5 and K6 launches;
``ivf_topk_flat`` is K1 at the flat
scan's recorded call (16 x 25,000 x 768) and takes ``baselines``' flat
launches, the recall sweep's launches go to no row;
K6 launched by a batcher's ticks goes to ``decode_attention_batcher`` (K6
at ``continuous_batching``'s recorded (16, 1, 32, 80) call and per-slot
lengths), every other K6 launch to ``decode_attention``; the codec rows
take ``codec_paths``' launches (int8 also ``tenancy`` (f)'s and
``durability``'s) and K7's row
``kv_int8``'s.  Any failed
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
# tenancy: the main path's corpus as tenant "fiqa" beside "scidocs" at
# Table 2's record count and gte-base's width, clustered at SCI_NLIST (the
# main path's 200 chunks a cluster); the engine batch's new tokens
TENANTS, SCI_RECORDS, SCI_NLIST = ("fiqa", "scidocs"), 3_600, 18
TENANCY_NEW_TOKENS = 2
# durability: the stream's op counts, the event before which the blob is
# deleted and the self-heal batch answered, the snapshot cadence, (a)'s
# crashes (point, occurrence), (c)'s per-tenant ops and cadence.  A smoke
# setting from the issue's scenarios, no benchmark cell's
DUR_INSERTS, DUR_REMOVES, DUR_UPDATES, DUR_HEAL_AT = 24, 12, 12, 20
DUR_CHECKPOINT = 16
DUR_CRASHES = (("wal_torn_append", 30), ("snap_pre_rename", 2))
ROUTER_INSERTS, ROUTER_REMOVES, ROUTER_CHECKPOINT = 8, 4, 8
# baselines: recall@K of the IVF index against the flat one at these nprobe
RECALL_NPROBES = (1, 4, NPROBE, 16, NLIST)
# dense_archs: (a) DENSE_GEN at full width behind the main index, the main
# path's first DENSE_BATCHES batches; (b) each assigned dense config at
# PARITY_LAYERS layers, MAX_PROMPT positions of prefill and DENSE_STEPS
# decode steps, qwen2-vl's prompt opening on VISION_ROWS patch embeds laid
# on a grid VISION_GRID_W patches wide
DENSE_GEN, DENSE_BATCHES, DENSE_STEPS = "yi-9b", 2, 8
VISION_ROWS, VISION_GRID_W = 32, 8
# swa_gemma3: (a) SWA_GEN at full width behind the main index, prompts
# left-padded to SWA_PROMPT positions (past its 1,024-key window), the main
# path's first batch; (b) its first pattern (5 "swa" layers and 1 "attn")
# at full width on the card and the CPU, a prompt of SWA_PARITY_PROMPT
# positions (past the window, so the rings wrap in prefill) and
# DENSE_STEPS decode steps
SWA_GEN, SWA_PROMPT, SWA_PARITY_PROMPT = "gemma3-12b", 2048, 1040
# moe_archs: (a) MOE_GEN at full width behind the main index, the main
# path's first MOE_BATCHES batches; (b) each of MOE_ARCHS at PARITY_LAYERS
# layers, MAX_PROMPT positions of prefill and DENSE_STEPS decode steps.
# ROUTE_TIE_TOL: a token whose top-k expert set differs between the card
# and the CPU must have its k-th and (k+1)-th CPU router probabilities
# (~1/64 each) within it.  The router logits (|l| ~ 1) differ between the
# two by the residual stream's drift, at most ~1e-5 (GEN_TOL's
# reasoning), which moves a probability by ~p x 1e-5 ~ 2e-7; 1e-5 (a
# logit gap of ~6e-4 at p = 1/64) leaves a margin of ~50x, and a flip
# across a wider gap is a routing fault, not rounding.
MOE_GEN, MOE_BATCHES = "olmoe-1b-7b", 2
MOE_ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
ROUTE_TIE_TOL = 1e-5
# rwkv6_arch: (a) RWKV_GEN at full width behind the main index, the main
# path's first RWKV_BATCHES batches.  Its model holds RWKV_PARAMS
# parameters, the JAX init_params tree's count (the reference's
# param_count() counts 57 x d_model more a layer: 1,485,981,696), and one
# request's state is RWKV_STATE_BYTES = 24 x (32 x 64 x 64 + 2 x 2048) x 4
# at any max_len.  (b) it at PARITY_LAYERS layers on the card and the CPU,
# prompts of STATE_PROMPTS positions (four chunks of 32, a partial last
# chunk, the one-token recurrent prefill) and DENSE_STEPS decode steps.
# WKV_TOL bounds |a - b| / (1 + |b|) between the card's and the CPU's
# prefill state, and between the chunked and the recurrent WKV on the card
# (tests/test_mixers.py's 1e-4 between the two forms: the same terms summed
# in other orders, the chunked form's decays differences of cumulative
# sums); at the strongest clipped decay (ww = 10, logw = -exp(10)) the
# chunked form of either package departs from the recurrence by ~0.07
# (cumulative log decays of ~3.5e5, whose fp32 ulp is 0.03), so there only
# finiteness is gated and the gap is printed.
RWKV_GEN, RWKV_BATCHES = "rwkv6-1.6b", 2
RWKV_PARAMS, RWKV_STATE_BYTES = 1_483_180_032, 12_976_128
STATE_PROMPTS = (128, 100, 1)
WKV_TOL = 1e-4
# hybrid_zamba2: (a) HYBRID_GEN at full width behind the main index, the
# main path's first HYBRID_BATCHES batches.  Its model holds HYBRID_PARAMS
# parameters, the JAX init_params tree's count (the reference's
# param_count() misses conv_x, conv_b, conv_c and dt_bias, 21,072 a Mamba2
# layer: 1,980,571,680), its one shared block HYBRID_SHARED_PARAMS of them,
# and one request's state is HYBRID_STATE_BYTES at 144 and 2,048 positions:
# 45 x (80 x 64 x 64 + 3 x 5,248) x 4 + 9 x 2 x rows x 32 x 80 x 4.  (b) its
# first HYBRID_PARITY_LAYERS layers (two applications of the shared block)
# on the card and the CPU, prompts of STATE_PROMPTS positions (two chunks
# of 64, a partial chunk, the recurrent prefill) and DENSE_STEPS decode
# steps.  SSD_TOL bounds |a - b| / (1 + |b|) between the card's and the
# CPU's prefill SSM state and conv carry, and between ssd_chunked and
# ssd_reference on the card (tests/test_mixers.py's 1e-4 between the two
# forms: the same terms summed in other orders, the chunked form's decays
# differences of cumulative sums).
HYBRID_GEN, HYBRID_BATCHES, HYBRID_PARITY_LAYERS = "zamba2-2.7b", 2, 12
HYBRID_PARAMS, HYBRID_SHARED_PARAMS = 1_981_519_920, 104_862_720
HYBRID_STATE_BYTES = {144: 88_358_400, 2048: 439_303_680}
SSD_TOL = 1e-4
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

# train_lm: K5's backward (csrc/flash_attention_bwd.cu) at BWD_SHAPES, (B,
# Sq, Skv, H, KH, D, causal, window), against its plain version: dq, dk and
# dv within BWD_TOL relative Frobenius (the same f32 products summed in
# other orders; measured ~1e-6), the lse within attn_tol(D).  (b)
# TRAIN_ARCH's first PARITY_LAYERS layers at full width, card vs CPU, on
# TRAIN_PARITY_BATCH x TRAIN_PARITY_SEQ tokens: the loss within
# TRAIN_LOSS_TOL relative and every parameter's gradient within
# TRAIN_GRAD_TOL relative Frobenius (fp32 GEMMs and K5 on the card against
# plain PyTorch on the CPU, GEN_TOL's reasoning; the vocab-wide softmax's
# gradient sums 100,352 terms).  (c) TRAIN_ARCH at full width, TRAIN_STEPS
# steps of make_train_step(peak_lr=TRAIN_LR) on synthetic_lm_batch at
# TRAIN_BATCH x TRAIN_SEQ tokens (train_4k's sequence length).  (d)
# tests/test_serving_train.py's overfit (TRAIN_ARCH reduced to 2 layers and
# d_model 128, OVERFIT_STEPS steps at TRAIN_LR, total_steps OVERFIT_TOTAL,
# a fixed (2, 33) batch) on the card against the CPU: every loss within
# OVERFIT_TOL of the CPU's relative to 1 + |loss| (on a CPU, scaling every
# weight by 1 + 1e-6 noise moved the 40 losses by 1.5e-6 relative at most:
# the trajectory does not amplify the card's ~1e-6 per-op drift).
BWD_SHAPES = {"stablelm_1p6b": (1, 4096, 4096, 32, 32, 64, True, 0),
              "gqa8_d128": (1, 512, 512, 32, 4, 128, True, 0),
              "gemma3_12b_window": (1, 2048, 2048, 16, 8, 256, True, 1024),
              "non_causal_d80": (2, 128, 128, 12, 12, 80, False, 0),
              "ragged": (1, 77, 77, 8, 2, 64, True, 0),
              "masked_rows": (1, 96, 40, 4, 2, 64, True, 16)}
BWD_TOL = 1e-4
TRAIN_ARCH, TRAIN_STEPS, TRAIN_LR = "stablelm-1.6b", 3, 3e-3
TRAIN_BATCH, TRAIN_SEQ = 1, 4096
TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 2, 128
TRAIN_LOSS_TOL, TRAIN_GRAD_TOL = 1e-5, 1e-4
OVERFIT_STEPS, OVERFIT_TOTAL, OVERFIT_TOL = 40, 60, 1e-4


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
    entry (dtype, head dim, warps sharing a row tile, and `` lse`` for the
    f32 entries that also write the rows' log-sum-exp, the training
    forward's: 16 + 8), checking that none spills; "not rebuilt" when the
    library was built before this run."""
    import re
    if not lines:
        return "not rebuilt in this run"
    out = {}
    for ln in lines:
        kind = re.search(r"flash_fwdI(f|13__nv_bfloat16)Li(\d+)ELi(\d)E"
                         r"Lb(\d)E", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        check(kind and regs and spill, f"unread ptxas line: {ln}")
        dtype = "f32" if kind[1] == "f" else "bf16"
        lse = " lse" if kind[4] == "1" else ""
        out[f"{dtype} D={kind[2]} x{kind[3]}{lse}"] = [int(regs[1]),
                                                       int(spill[1])]
    check(len(out) == 24, f"flash_attention: {len(out)} entries, not 24")
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
    head dims 32, 64, 80, 128, 256), checking that none spills; "not rebuilt"
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
    check(len(out) == 20, f"decode_attention: {len(out)} entries, not 20")
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
    ``fn`` starts and are counted nowhere.  Only device activity is
    recorded: every number here is a device event's or the host clock's,
    and recording each host op as well slowed a generation's ~3,000 ops a
    step (zamba2-2.7b: 2,243 ms profiled against ~1,280 ms a request in its
    batches) and took tens of seconds to parse after each window."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t_window = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
    ``flash_attention`` (by mask, and those with a window), its backward
    ``flash_attention_bwd`` and ``decode_attention`` to 0."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)
    from repro_torch.kernels.ivf_topk import topk_ip
    from repro_torch.kernels.slab_topk import slab_topk
    topk_ip.launches = slab_topk.launches = 0
    slab_topk.launches_by_mode = dict.fromkeys(slab_topk.launches_by_mode, 0)
    flash_attention.launches = decode_attention.launches = 0
    flash_attention.launches_by_mask = dict.fromkeys(
        flash_attention.launches_by_mask, 0)
    flash_attention.launches_windowed = 0
    flash_attention_bwd.launches = 0


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
    batcher's ticks).  ``ivf_topk_flat`` counts K1's launches over the
    whole corpus (``baselines``' flat scan), ``ivf_topk`` every other K1
    launch.  Returns each row's phases that launched it."""
    rows = {}
    for phase, counts, batched in phases:
        attn = counts.get("flash_attention", {})
        for row, n in (
                ("ivf_topk", counts.get("ivf_topk", 0)),
                ("ivf_topk_flat", counts.get("ivf_topk_flat", 0)),
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
    path's real kernel inputs, per slab mode for ``slab_topk``), and the
    calls of each key."""

    def __init__(self, fn, key=lambda *args, **kw: None):
        self.fn = fn
        self.key = key
        self.first = {}
        self.calls = {}

    def __call__(self, *args, **kw):
        key = self.key(*args, **kw)
        self.calls[key] = self.calls.get(key, 0) + 1
        if key not in self.first:
            clone = lambda a: a.clone() if hasattr(a, "clone") else a
            self.first[key] = ([clone(a) for a in args],
                               {n: clone(a) for n, a in kw.items()})
        return self.fn(*args, **kw)


class RouteLog:
    """Passes every call through to ``moe_block`` and keeps, per call, its
    device, tokens (B x S) and capacity.  For a call at the config's
    factor (no ``capacity`` given: prefill), or every call with
    ``record``, it first runs the port's routing step
    (``models.moe.route``) on the same input and keeps the capacity it
    took and the assignments it dropped (a device tensor, read after the
    run); with ``record`` also the top-k expert ids and the top k + 1
    probabilities of every token, on the host."""

    def __init__(self, fn, record: bool = False):
        self.fn = fn
        self.record = record
        self.calls = []

    def __call__(self, params, x, **kw):
        import torch
        from repro_torch.models.moe import route
        entry = {"device": x.device.type, "tokens": x.shape[0] * x.shape[1],
                 "capacity": kw.get("capacity", 0)}
        if self.record or entry["capacity"] <= 0:
            r = route(params, x, **kw)
            entry.update(capacity=r.capacity, dropped=(~r.keep).sum())
            if self.record:
                k = r.expert_ids.shape[1]
                entry.update(ids=r.expert_ids.cpu(), top=torch.sort(
                    r.probs, dim=-1, descending=True).values[:, :k + 1].cpu())
        self.calls.append(entry)
        return self.fn(params, x, **kw)


def route_flips(calls, n_moe: int, where: str) -> list:
    """One step's routing on the CPU and the card: ``calls``, the step's
    ``RouteLog(record=True)`` entries, the CPU's ``n_moe`` layers first.
    Returns each token whose top-k expert set differs between the two
    (layer, token, both sets, the CPU's k-th and (k+1)-th probability
    gap); fails unless that gap is within ``ROUTE_TIE_TOL``."""
    import torch
    cpu, card = calls[:n_moe], calls[n_moe:]
    check(len(card) == n_moe and all(c["device"] == "cpu" for c in cpu)
          and all(c["device"] == "cuda" for c in card),
          f"{where}: routing calls {[c['device'] for c in calls]}")
    flips = []
    for layer, (a, b) in enumerate(zip(cpu, card)):
        k = a["ids"].shape[1]
        sa, sb = (torch.sort(c["ids"], dim=-1).values for c in (a, b))
        for t in torch.nonzero((sa != sb).any(-1)).flatten().tolist():
            gap = float(a["top"][t, k - 1] - a["top"][t, k])
            flip = {"layer": layer, "token": t, "cpu": sa[t].tolist(),
                    "card": sb[t].tolist(), "cpu_gap": gap}
            check(gap <= ROUTE_TIE_TOL, f"{where}: routing differs outside "
                  f"a near-tie: {flip}, ROUTE_TIE_TOL {ROUTE_TIE_TOL}")
            flips.append(flip)
    return flips


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


def check_slab_fp32(e, q, v, k, where: str) -> dict:
    """fp32 ``slab_topk`` at one recorded call against its plain version:
    member lanes' scores within ``score_tol``, ids equal away from
    near-ties, and the batch bitwise its queries one at a time."""
    import torch
    from repro_torch.kernels.slab_topk import NOT_PROBED, slab_topk
    from repro_torch.kernels.slab_topk.ref import NEG_INF, slab_topk_ref
    member = v < NOT_PROBED
    lane = torch.arange(k, device=e.device)[None, :] < member.sum(1)[:, None]
    tol = score_tol(e, q)
    kv, kr = slab_topk(e, q, v, k)
    pv, pr = slab_topk_ref(e, q, v, k)
    err = float((kv - pv)[lane].abs().max())
    check(err <= tol, f"{where} error {err} > {tol}")
    full = torch.where(member, q.double() @ e.double().T,
                       NEG_INF).cpu().numpy()
    n = isolated_ids_equal(torch.where(lane, kv, NEG_INF).cpu().numpy(),
                           torch.where(lane, kr, -1).cpu().numpy(),
                           torch.where(lane, pr, -1).cpu().numpy(), full, tol)
    for i in range(q.shape[0]):
        one = slab_topk(e, q[i:i + 1], v[i:i + 1], k)
        check(torch.equal(one[0][0], kv[i]) and torch.equal(one[1][0], kr[i]),
              f"{where} batch != sequential")
    return {"max_abs_err": err, "tol": tol, "ids_checked": n,
            "member_pairs": int(member.sum()), "shape": [*e.shape,
                                                         q.shape[0], k]}


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


def mrope_positions(s: int, prefix: int, grid_w: int):
    """(3, 1, s) M-RoPE positions of a ``prefix``-patch image on a grid
    ``grid_w`` patches wide, then text: the image's temporal stream 0, its
    height and width streams the patch's row and column; the text from
    one past the largest image position on all three streams (qwen2-vl's
    rule, arXiv:2409.12191)."""
    import torch
    pos = torch.empty((3, 1, s), dtype=torch.long)
    i = torch.arange(prefix)
    pos[0, 0, :prefix] = 0
    pos[1, 0, :prefix] = i // grid_w
    pos[2, 0, :prefix] = i % grid_w
    start = int(pos[:, 0, :prefix].max()) + 1
    pos[:, 0, prefix:] = start + torch.arange(s - prefix)
    return pos


def behind_index(ctx, cfg, max_prompt: int, batches: int,
                 flash_key=lambda *args, **kw: None,
                 dec_key=lambda *args, **kw: None, moe_log=None,
                 params: int = 0) -> tuple:
    """``cfg`` at full width (random weights drawn on the card from the
    seed, the draw timed) as ``RAGEngine``'s generator over the main path's
    index, beside the main generator: the main path's first ``batches``
    batches of 16, prompts left-padded to ``max_prompt`` positions,
    ``NEW_TOKENS`` greedy tokens, counts zeroed before and read after.
    Checks the weight bytes, every token in range and the ids against the
    main path's outside near-ties; the caller checks the launches.  Returns
    the part's line and its K5 / K6 recorders (first calls and calls by
    ``flash_key`` / ``dec_key``); the generator is freed first.
    ``moe_log``, a :class:`RouteLog`, wraps ``moe_block`` during the
    batches.  Then the first request's generation runs once more,
    unwrapped, under ``torch.profiler`` (``one_request_generation``: wall
    and device ms, the largest device events).  The weights must hold
    ``params`` parameters, or ``cfg.param_count()`` when it is 0."""
    import gc
    import torch
    from repro_torch.kernels.decode_attention import decode_attention_q8
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import model as model_mod
    from repro_torch.models import param_count
    from repro_torch.serving import GeneratorModel, RAGEngine

    dev, ds = ctx["dev"], ctx["ds"]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = GeneratorModel(cfg, seed=SEED, max_prompt=max_prompt, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    weight_bytes = param_count(gen.params) * 4
    want_bytes = (params or cfg.param_count()) * 4
    check(weight_bytes == want_bytes, f"{cfg.name}: {weight_bytes} weight "
          f"bytes, want {want_bytes}")
    engine = RAGEngine(ctx["index"], gen, cost_model=ctx["cost"], k=K,
                       nprobe=NPROBE, max_new_tokens=NEW_TOKENS)
    rec_flash = Recorder(model_mod.flash_attention, flash_key)
    rec_dec = Recorder(model_mod.decode_attention, dec_key)
    saved = (model_mod.flash_attention, model_mod.decode_attention,
             model_mod.moe_block)
    model_mod.flash_attention, model_mod.decode_attention = rec_flash, rec_dec
    if moe_log is not None:
        model_mod.moe_block = moe_log
    q8_before = decode_attention_q8.launches
    per_batch, flat = [], []
    zero_launches()
    try:
        for b in range(batches):
            lo, hi = b * BATCH, (b + 1) * BATCH
            p0, d0 = gen.prefill_wall_s, gen.decode_wall_s
            t0 = time.perf_counter()
            resp = engine.answer_batch(
                [f"query-{i}" for i in range(lo, hi)], ds.query_embs[lo:hi],
                ds.get_chunks)
            wall = time.perf_counter() - t0
            flat += resp
            per_batch.append({
                "wall_s": wall,
                "retrieval_s": sum(r.ttft_wall_s for r in resp),
                "prefill_s": gen.prefill_wall_s - p0,
                "decode_s": gen.decode_wall_s - d0})
        counts = launch_counts()
        windowed = flash_attention.launches_windowed
    finally:
        (model_mod.flash_attention, model_mod.decode_attention,
         model_mod.moe_block) = saved
    q8 = decode_attention_q8.launches - q8_before
    peak = torch.cuda.max_memory_allocated()
    n_req = batches * BATCH
    check(all(len(r.output_tokens) == NEW_TOKENS
              and all(0 <= t < cfg.vocab_size for t in r.output_tokens)
              for r in flat), f"{cfg.name}: generated tokens out of range")
    swaps, mismatches = near_tie_mismatches(
        [r.chunk_ids for r in flat], ctx["main_ids"][:n_req],
        ctx["main_vals"][:n_req])
    check(mismatches == 0, f"{cfg.name}: {mismatches} ids differ from the "
          f"main path's outside near-ties")
    prompt_tokens = [len(gen.tokenizer.encode(" ".join(r.context + [r.query]),
                                              max_prompt)) for r in flat]
    line = {"generator": cfg.name, "layers": cfg.num_layers,
            "pattern": list(cfg.block_pattern),
            "window": cfg.sliding_window, "d_model": cfg.d_model,
            "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
            "head_dim": cfg.head_dim, "d_ff": cfg.d_ff,
            "vocab": cfg.vocab_size, "weight_bytes": weight_bytes,
            "draw_s": draw_s, "max_memory_allocated": peak,
            "batches": batches, "batch": BATCH, "prompt": max_prompt,
            "prompt_tokens_min_max": [min(prompt_tokens),
                                      max(prompt_tokens)],
            "new_tokens": NEW_TOKENS, "per_batch": per_batch,
            "launches": counts, "k5_windowed_launches": windowed,
            "decode_attention_q8_launches": q8,
            "ids_equal_main_path": True, "near_tie_swaps": swaps,
            "gen_tokens": [r.output_tokens for r in flat[:3]]}
    prompt = " ".join(flat[0].context + [flat[0].query])
    line["one_request_generation"] = profiled(
        lambda: gen.generate(prompt, NEW_TOKENS))
    del engine, gen, flat
    gc.collect()
    torch.cuda.empty_cache()
    return line, rec_flash, rec_dec


def dense_yi(ctx) -> tuple:
    """(a) of ``dense_archs``: full-width yi-9b as the main index's
    generator (module docstring).  Returns the part's line and its first
    K5 and K6 calls (the ``kernels`` line's ``*_yi_9b`` rows)."""
    from repro_torch.configs import get_config

    cfg = get_config(DENSE_GEN)
    line, rec_flash, rec_dec = behind_index(ctx, cfg, MAX_PROMPT,
                                            DENSE_BATCHES)
    n_req, layers = DENSE_BATCHES * BATCH, cfg.num_layers
    want = ({"causal": layers * n_req, "non_causal": 0},
            layers * NEW_TOKENS * n_req)
    got = (line["launches"]["flash_attention"],
           line["launches"]["decode_attention"])
    q8 = line["decode_attention_q8_launches"]
    check(got == want and q8 == 0, f"dense_archs (a): attention launches "
          f"{got[0]}, K6 {got[1]}, K7 {q8}; want {want[0]}, K6 {want[1]}, "
          f"K7 0")
    return line, {"flash": rec_flash.first[None],
                  "decode": rec_dec.first[None]}


def arch_parity(cfg, dev, prompt: int,
                flash_key=lambda *args, **kw: None,
                dec_key=lambda *args, **kw: None) -> dict:
    """``cfg`` (cut in depth) at full width on the card and on the CPU,
    one set of weights drawn on the CPU from the seed and copied to the
    card: prefill of ``prompt`` positions, then ``DENSE_STEPS`` decode
    steps, the same inputs into both (module docstring, ``dense_archs``
    (b) and ``swa_gemma3`` (b)).  Checks every step's logits within
    ``GEN_TOL``, greedy tokens outside near-ties, exact K5 (windowed: the
    ``"swa"`` layers) and K6 launches, and the first K5 / K6 call of each
    ``flash_key`` / ``dec_key`` within :func:`attn_tol` of the plain
    versions.  With mixture-of-experts layers (``moe_archs`` (b)) every
    step's top-k expert sets are held against each other
    (:func:`route_flips`); from the first step where they differ (a
    near-tie) on, steps are run but not compared, and counted."""
    import copy
    import gc
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    param_count, prefill)
    from repro_torch.models import model as model_mod

    name, cpu = cfg.name, torch.device("cpu")
    t0 = time.perf_counter()
    m_cpu = init_params(cfg, seed=SEED, device="cpu")
    m_card = copy.deepcopy(m_cpu).to(dev)
    init_s = time.perf_counter() - t0
    g = torch.Generator().manual_seed(9)
    if cfg.embedding_inputs:                 # the stubbed codec's frames
        batch = {"embeds": torch.randn((1, prompt, cfg.d_model),
                                       generator=g)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, prompt),
                                         generator=g)}
    if cfg.use_mrope:                        # the stubbed ViT's patches
        batch["vision_embeds"] = torch.randn((1, VISION_ROWS, cfg.d_model),
                                             generator=g)
        batch["positions"] = mrope_positions(prompt, VISION_ROWS,
                                             VISION_GRID_W)
    smax = prompt + DENSE_STEPS
    c_cpu = init_cache(cfg, 1, smax, device=cpu)
    c_card = init_cache(cfg, 1, smax, device=dev)
    rec_flash = Recorder(model_mod.flash_attention, flash_key)
    rec_dec = Recorder(model_mod.decode_attention, dec_key)
    routes = RouteLog(model_mod.moe_block, record=True)
    n_moe = sum(b.moe is not None for b in m_cpu.blocks)
    saved = (model_mod.flash_attention, model_mod.decode_attention,
             model_mod.moe_block)
    f0, w0 = flash_attention.launches, flash_attention.launches_windowed
    d0 = decode_attention.launches
    errs, tokens_checked, near_ties, fed = [], 0, 0, []
    flips, not_compared = [], 0
    cpu_s = card_s = 0.0
    try:
        model_mod.flash_attention = rec_flash
        model_mod.decode_attention = rec_dec
        if n_moe:
            model_mod.moe_block = routes
        t0 = time.perf_counter()
        l_cpu, _ = prefill(m_cpu, batch, c_cpu)
        t1 = time.perf_counter()
        l_card, _ = prefill(m_card, {n: t.to(dev) for n, t in batch.items()},
                            c_card)
        lk = l_card[0].cpu()
        cpu_s, card_s = t1 - t0, time.perf_counter() - t1
        for step in range(DENSE_STEPS + 1):
            lc = l_cpu[0]
            if n_moe and not flips:
                flips = [dict(f, step=step) for f in route_flips(
                    routes.calls[-2 * n_moe:], n_moe, f"{name} step {step}")]
            if flips:
                not_compared += 1        # a routing near-tie at or before
            else:
                errs.append(float((lk - lc).abs().max()))
                top2 = torch.topk(lc, 2).values
                if float(top2[0] - top2[1]) > 2 * GEN_TOL:
                    check(int(lk.argmax()) == int(lc.argmax()),
                          f"{name}: greedy token differs at step {step}")
                    tokens_checked += 1
                else:
                    near_ties += 1
            if step == DENSE_STEPS:
                break
            if cfg.embedding_inputs and step == DENSE_STEPS - 1:
                nxt = torch.randn((1, 1, cfg.d_model), generator=g)
                fed.append("embeds")
            else:                            # the same token into both
                nxt = lc.argmax().reshape(1, 1)
                fed.append("ids" if cfg.embedding_inputs else "tokens")
            t0 = time.perf_counter()
            l_cpu, _ = decode_step(m_cpu, nxt, c_cpu, prompt + step)
            t1 = time.perf_counter()
            l_card, _ = decode_step(m_card, nxt.to(dev), c_card,
                                    prompt + step)
            lk = l_card[0].cpu()
            cpu_s, card_s = cpu_s + t1 - t0, card_s + time.perf_counter() - t1
    finally:
        (model_mod.flash_attention, model_mod.decode_attention,
         model_mod.moe_block) = saved
    windowed = sum(b.window > 0 for b in m_card.blocks)
    launches = {"flash_attention": flash_attention.launches - f0,
                "flash_attention_windowed":
                flash_attention.launches_windowed - w0,
                "decode_attention": decode_attention.launches - d0}
    check(launches == {"flash_attention": cfg.num_layers,
                       "flash_attention_windowed": windowed,
                       "decode_attention": cfg.num_layers * DENSE_STEPS},
          f"{name}: attention launches {launches}")
    check(max(errs, default=0.0) <= GEN_TOL, f"{name}: logits differ by "
          f"{max(errs)} > {GEN_TOL}")

    first = first_calls(cfg, rec_flash, rec_dec)
    line = {"name": name, "layers": cfg.num_layers,
            "pattern": list(cfg.block_pattern), "window": cfg.sliding_window,
            "d_model": cfg.d_model, "heads": cfg.num_heads,
            "kv_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "tied": cfg.tie_embeddings, "params": param_count(m_card),
            "inputs": sorted(batch), "prompt": prompt, "decode_fed": fed,
            "cache_rows": [c.k.shape[1] for c in c_card], "init_s": init_s,
            "cpu_s": cpu_s, "card_s": card_s, "tol": GEN_TOL,
            "max_abs_err_per_step": errs, "tokens_checked": tokens_checked,
            "near_ties": near_ties, "launches": launches,
            "k6_calls": rec_dec.calls, **first}
    if n_moe:
        pre = routes.calls[:2 * n_moe]           # the prefill's, CPU first
        line.update(
            moe_layers=n_moe, experts=cfg.num_experts,
            top_k=cfg.num_experts_per_tok,
            prefill_capacity=[c["capacity"] for c in pre[:n_moe]],
            prefill_dropped_cpu=[int(c["dropped"]) for c in pre[:n_moe]],
            prefill_dropped_card=[int(c["dropped"]) for c in pre[n_moe:]],
            route_tie_tol=ROUTE_TIE_TOL, routing_flips=flips,
            steps_not_compared=not_compared)
    del m_cpu, m_card, c_cpu, c_card, rec_flash, rec_dec, routes
    gc.collect()
    torch.cuda.empty_cache()
    return line


def first_calls(cfg, rec_flash, rec_dec) -> dict:
    """The first K5 and K6 call of each key that ``rec_flash`` /
    ``rec_dec`` recorded, each held within :func:`attn_tol` of the plain
    version on the card."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention

    def held(got, ref) -> dict:
        err, ratio = attn_err(got, ref)
        check(ratio <= 1, f"{cfg.name}: first call's error {err} is {ratio} "
              f"x its allowance")
        return {"max_abs_err": err, "tol": attn_tol(got.shape[-1]),
                "err_over_allowance": ratio}

    first = {}
    for key, ((q, k, v), kw) in rec_flash.first.items():
        first["k5_first" if key is None else f"k5_{key}"] = {
            "shape": list(q.shape), "kv": list(k.shape), **kw,
            **held(flash_attention(q, k, v, **kw),
                   flash_plain(q, k, v, kw["causal"], kw["window"]))}
    group = cfg.num_heads // cfg.num_kv_heads
    for key, ((q, kc, vc, lens), kw) in rec_dec.first.items():
        k6 = {"shape": list(q.shape), "cache": list(kc.shape),
              "length": lens, "group": group,
              "group_passes": -(-group // 8),
              **held(decode_attention(q, kc, vc, lens, **kw),
                     decode_plain(q, kc, vc, lens, kw["window"]))}
        if group > 8:
            k6["note"] = (f"the first full-width launch of a {group}-head "
                          f"group (8 query heads a pass: a second pass of "
                          f"{group - 8})")
        first["k6_first" if key is None else f"k6_{key}"] = k6
    return first


def dense_archs(ctx) -> tuple:
    """The ``dense_archs`` phase (module docstring): (a) then (b) for each
    config of ``configs.ASSIGNED_ARCHS`` made of ``"attn"`` blocks alone.
    Returns its line and (a)'s first K5 and K6 calls."""
    import dataclasses
    from repro_torch.configs import ASSIGNED_ARCHS, get_config
    t_phase = time.perf_counter()
    line, record = dense_yi(ctx)
    archs = []
    for name in ASSIGNED_ARCHS:
        cfg = get_config(name)
        if set(cfg.block_pattern) != {"attn"}:
            continue                         # gemma3-12b: swa_gemma3's
        archs.append(arch_parity(dataclasses.replace(
            cfg, num_layers=PARITY_LAYERS), ctx["dev"], MAX_PROMPT))
    return {"phase": "dense_archs", "nvidia_smi": ctx["smi"], "yi_9b": line,
            "archs": archs, "phase_s": time.perf_counter() - t_phase}, record


def swa_gemma3(ctx) -> tuple:
    """The ``swa_gemma3`` phase (module docstring): (a) full-width
    gemma3-12b as the main index's generator, then (b) its first pattern
    on the card against the CPU.  Returns its line and (a)'s first K5
    calls by window ("swa", "global") and K6 calls by cache ("ring",
    "global")."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import cache_bytes, init_cache

    t_phase = time.perf_counter()
    cfg = get_config(SWA_GEN)
    ring = cfg.sliding_window
    by_window = lambda q, k, v, causal=True, window=0: (
        "swa" if window else "global")
    by_cache = lambda q, k, v, lengths, window=0: (
        "ring" if k.shape[1] == ring else "global")
    line, rec_flash, rec_dec = behind_index(ctx, cfg, SWA_PROMPT, 1,
                                            by_window, by_cache)
    layers = cfg.num_layers
    n_swa = cfg.block_pattern.count("swa") * cfg.depth_repeat
    want = ({"causal": layers * BATCH, "non_causal": 0}, n_swa * BATCH,
            layers * NEW_TOKENS * BATCH)
    got = (line["launches"]["flash_attention"], line["k5_windowed_launches"],
           line["launches"]["decode_attention"])
    q8 = line["decode_attention_q8_launches"]
    check(got == want and q8 == 0, f"swa_gemma3 (a): K5 {got[0]}, windowed "
          f"{got[1]}, K6 {got[2]}, K7 {q8}; want {want[0]}, {want[1]}, "
          f"{want[2]}, K7 0")
    k6_by_cache = {"ring": n_swa * NEW_TOKENS * BATCH,
                   "global": (layers - n_swa) * NEW_TOKENS * BATCH}
    check(rec_dec.calls == k6_by_cache, f"swa_gemma3 (a): K6 calls by cache "
          f"{rec_dec.calls}, want {k6_by_cache}")
    # one request's caches, as ``generate`` makes them: rings of the
    # window's rows in the "swa" layers, prompt + new tokens in the others
    rows = SWA_PROMPT + NEW_TOKENS
    caches = init_cache(cfg, 1, rows, device=ctx["dev"])
    per_row = 2 * cfg.num_kv_heads * cfg.head_dim * 4
    want_bytes = (layers - n_swa) * rows * per_row + n_swa * ring * per_row
    got_bytes = cache_bytes(caches)
    del caches
    seen_rows = {kind: int(call[0][1].shape[1])
                 for kind, call in rec_dec.first.items()}
    check(got_bytes == want_bytes and seen_rows == {"ring": ring,
                                                    "global": rows},
          f"swa_gemma3 (a): cache bytes {got_bytes} (want {want_bytes}), "
          f"K6 cache rows {seen_rows}")
    line.update(k5_launches={"swa": got[1], "global": got[0]["causal"]
                             - got[1]},
                k6_launches=rec_dec.calls, cache_bytes_one_request=got_bytes,
                cache_rows=seen_rows)
    parity = arch_parity(dataclasses.replace(
        cfg, num_layers=len(cfg.block_pattern)), ctx["dev"],
        SWA_PARITY_PROMPT, by_window, by_cache)
    check(parity["k6_calls"] == {"ring": n_swa // cfg.depth_repeat
                                 * DENSE_STEPS, "global": DENSE_STEPS},
          f"swa_gemma3 (b): K6 calls by cache {parity['k6_calls']}")
    return {"phase": "swa_gemma3", "nvidia_smi": ctx["smi"],
            "gemma3_12b": line, "parity": parity,
            "phase_s": time.perf_counter() - t_phase}, {
                "flash": rec_flash.first, "decode": rec_dec.first}


def moe_archs(ctx) -> tuple:
    """The ``moe_archs`` phase (module docstring): (a) full-width
    olmoe-1b-7b as the main index's generator, its prefills' routing
    counted, then (b) both MoE configs at 2 layers on the card against
    the CPU.  Returns its line and (a)'s first K5 and K6 calls."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as model_mod
    from repro_torch.models.moe import capacity_of

    t_phase = time.perf_counter()
    cfg = get_config(MOE_GEN)
    log = RouteLog(model_mod.moe_block)
    line, rec_flash, rec_dec = behind_index(ctx, cfg, MAX_PROMPT,
                                            MOE_BATCHES, moe_log=log)
    n_req, layers = MOE_BATCHES * BATCH, cfg.num_layers
    e, k, factor = (cfg.num_experts, cfg.num_experts_per_tok,
                    cfg.expert_capacity_factor)
    want = ({"causal": layers * n_req, "non_causal": 0}, 0,
            layers * NEW_TOKENS * n_req, 0, MOE_BATCHES, MOE_BATCHES)
    n = line["launches"]
    got = (n["flash_attention"], line["k5_windowed_launches"],
           n["decode_attention"], line["decode_attention_q8_launches"],
           n["ivf_topk"], n["slab_topk"]["fp32"])
    check(got == want, f"moe_archs (a): K5 {got[0]}, windowed {got[1]}, "
          f"K6 {got[2]}, K7 {got[3]}, K1 {got[4]}, K2 {got[5]}; want "
          f"{want}")
    check(line["weight_bytes"] == 27_676_385_280,
          f"moe_archs (a): {line['weight_bytes']} weight bytes")
    # routing: prefills at the factor's capacity, decode dropless
    pre = [c for c in log.calls if "dropped" in c]
    dec = [c for c in log.calls if "dropped" not in c]
    cap = capacity_of(MAX_PROMPT, e, k, factor)
    check(len(pre) == layers * n_req and len(dec) == layers * NEW_TOKENS
          * n_req and all(c["tokens"] == MAX_PROMPT and c["capacity"] == cap
                          for c in pre)
          and all(c["tokens"] == c["capacity"] == 1 for c in dec),
          f"moe_archs (a): {len(pre)} prefill and {len(dec)} decode MoE "
          f"calls, capacities {sorted({c['capacity'] for c in pre})} / "
          f"{sorted({c['capacity'] for c in dec})}")
    dropped = torch.stack([c["dropped"] for c in pre]).view(
        n_req, layers).cpu()
    line.update(
        experts=e, top_k=k, capacity_factor=factor,
        prefill_capacity=[sorted({c["capacity"] for c in
                                  pre[i * layers:(i + 1) * layers]})
                          for i in range(n_req)],
        prefill_assignments_per_layer=MAX_PROMPT * k,
        prefill_dropped_per_request=dropped.sum(1).tolist(),
        prefill_dropped_per_layer=dropped.sum(0).tolist(),
        prefill_dropped=int(dropped.sum()),
        prefill_dropped_share=float(dropped.sum())
        / (n_req * layers * MAX_PROMPT * k),
        decode_capacity=1,
        decode_expert_weight_bytes_a_step=layers * e * 3 * cfg.d_model
        * cfg.d_ff * 4)
    del log, pre, dec
    archs = []
    for name in MOE_ARCHS:
        small = dataclasses.replace(get_config(name),
                                    num_layers=PARITY_LAYERS)
        part = arch_parity(small, ctx["dev"], MAX_PROMPT)
        want_cap = capacity_of(MAX_PROMPT, small.num_experts,
                               small.num_experts_per_tok,
                               small.expert_capacity_factor)
        check(part["prefill_capacity"] == [want_cap] * PARITY_LAYERS,
              f"{name}: prefill capacities {part['prefill_capacity']}, "
              f"want {want_cap}")
        archs.append(part)
    return {"phase": "moe_archs", "nvidia_smi": ctx["smi"],
            "olmoe_1b_7b": line, "archs": archs,
            "phase_s": time.perf_counter() - t_phase}, {
                "flash": rec_flash.first[None],
                "decode": rec_dec.first[None]}


def rel_err(got, ref) -> float:
    """max |got - ref| / (1 + |ref|), on the CPU."""
    got, ref = got.cpu().double(), ref.cpu().double()
    return float(((got - ref).abs() / (1 + ref.abs())).max())


def rwkv6_arch(ctx) -> dict:
    """The ``rwkv6_arch`` phase (module docstring): (a) full-width
    rwkv6-1.6b as the main index's generator, then (b) its first
    ``PARITY_LAYERS`` layers on the card against the CPU and the WKV forms
    at the full-width shape on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import cache_bytes, init_cache
    from repro_torch.models.rwkv6 import CHUNK

    t_phase = time.perf_counter()
    cfg = get_config(RWKV_GEN)
    line, _, _ = behind_index(ctx, cfg, MAX_PROMPT, RWKV_BATCHES,
                              params=RWKV_PARAMS)
    n = line["launches"]
    want = ({"causal": 0, "non_causal": 0}, 0, 0, 0, RWKV_BATCHES,
            RWKV_BATCHES)
    got = (n["flash_attention"], line["k5_windowed_launches"],
           n["decode_attention"], line["decode_attention_q8_launches"],
           n["ivf_topk"], n["slab_topk"]["fp32"])
    check(got == want, f"rwkv6_arch (a): K5 {got[0]}, windowed {got[1]}, "
          f"K6 {got[2]}, K7 {got[3]}, K1 {got[4]}, K2 {got[5]}; want "
          f"{want}")
    # one request's state, as ``generate`` makes it, and at 2,048 positions
    state = {rows: cache_bytes(init_cache(cfg, 1, rows, device=ctx["dev"]))
             for rows in (MAX_PROMPT + NEW_TOKENS, SWA_PROMPT)}
    check(set(state.values()) == {RWKV_STATE_BYTES},
          f"rwkv6_arch (a): state bytes {state}, want {RWKV_STATE_BYTES}")
    heads = {"wkv_heads": cfg.d_model // cfg.ssm_head_dim,
             "wkv_head_dim": cfg.ssm_head_dim}
    line.update(params=RWKV_PARAMS, config_param_count=cfg.param_count(),
                state_bytes_one_request=state, **heads)
    small = dataclasses.replace(cfg, num_layers=PARITY_LAYERS)
    parity = state_parity(small, ctx["dev"], WKV_TOL, CHUNK)
    parity.update(heads)
    parity["wkv_forms"] = wkv_forms(cfg, ctx["dev"])
    return {"phase": "rwkv6_arch", "nvidia_smi": ctx["smi"],
            "rwkv6_1p6b": line, "parity": parity,
            "phase_s": time.perf_counter() - t_phase}


def hybrid_zamba2(ctx) -> dict:
    """The ``hybrid_zamba2`` phase (module docstring): (a) full-width
    zamba2-2.7b as the main index's generator, its shared block's K5 / K6
    calls at the main path's shapes, then (b) its first
    ``HYBRID_PARITY_LAYERS`` layers on the card against the CPU and the SSD
    forms at the full-width shape on the card."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.models import cache_bytes, init_cache
    from repro_torch.models.mamba2 import CHUNK

    t_phase = time.perf_counter()
    cfg = get_config(HYBRID_GEN)
    line, rec_flash, rec_dec = behind_index(ctx, cfg, MAX_PROMPT,
                                            HYBRID_BATCHES,
                                            params=HYBRID_PARAMS)
    n_req = HYBRID_BATCHES * BATCH
    n_shared = cfg.block_pattern.count("shared_attn") * cfg.depth_repeat
    n = line["launches"]
    want = ({"causal": n_shared * n_req, "non_causal": 0}, 0,
            n_shared * NEW_TOKENS * n_req, 0, HYBRID_BATCHES, HYBRID_BATCHES)
    got = (n["flash_attention"], line["k5_windowed_launches"],
           n["decode_attention"], line["decode_attention_q8_launches"],
           n["ivf_topk"], n["slab_topk"]["fp32"])
    check(got == want, f"hybrid_zamba2 (a): K5 {got[0]}, windowed "
          f"{got[1]}, K6 {got[2]}, K7 {got[3]}, K1 {got[4]}, K2 {got[5]}; "
          f"want {want}")
    # the shared block attends at the main path's K5 and K6 shapes, so its
    # launches go to those rows of the kernels line
    (q, k, _), _ = rec_flash.first[None]
    (qd, kc, _, _), _ = rec_dec.first[None]
    shapes = {"k5": [list(q.shape), list(k.shape)],
              "k6": [list(qd.shape), list(kc.shape)]}
    check(shapes == ctx["main_shapes"], f"hybrid_zamba2 (a): K5 / K6 "
          f"shapes {shapes}, the main path's {ctx['main_shapes']}")
    # one request's state, as ``generate`` makes it, and at 2,048 positions
    state = {rows: cache_bytes(init_cache(cfg, 1, rows, device=ctx["dev"]))
             for rows in HYBRID_STATE_BYTES}
    check(state == HYBRID_STATE_BYTES, f"hybrid_zamba2 (a): state bytes "
          f"{state}, want {HYBRID_STATE_BYTES}")
    ssm = {"mamba_layers": cfg.num_layers - n_shared,
           "shared_applications": n_shared,
           "ssm_heads": cfg.ssm_num_heads, "ssm_head_dim": cfg.ssm_head_dim,
           "ssm_state": cfg.ssm_state_size,
           "conv_width": cfg.ssm_conv_width}
    line.update(params=HYBRID_PARAMS, config_param_count=cfg.param_count(),
                attention_shapes=shapes, state_bytes_one_request=state,
                **ssm)
    small = dataclasses.replace(cfg, num_layers=HYBRID_PARITY_LAYERS)
    parity = state_parity(small, ctx["dev"], SSD_TOL, CHUNK)
    shared = parity["shared_blocks"]
    width = len(cfg.block_pattern)
    want_layers = [list(range(width - 1, HYBRID_PARITY_LAYERS, width))]
    check([b["layers"] for b in shared] == want_layers
          and [b["params"] for b in shared] == [HYBRID_SHARED_PARAMS],
          f"hybrid_zamba2 (b): shared blocks {shared}, want layers "
          f"{want_layers} of {HYBRID_SHARED_PARAMS} parameters")
    parity.update(ssm)
    parity["ssd_forms"] = ssd_forms(cfg, ctx["dev"])
    return {"phase": "hybrid_zamba2", "nvidia_smi": ctx["smi"],
            "zamba2_2p7b": line, "parity": parity,
            "phase_s": time.perf_counter() - t_phase}


# each recurrent cache's state tensors, held card against CPU in (b)
STATE_FIELDS = {"RwkvCache": ("wkv", "shift_t", "shift_c"),
                "MambaCache": ("ssm", "conv")}


def state_parity(cfg, dev, state_tol: float, chunk: int) -> dict:
    """(b) of ``rwkv6_arch`` and ``hybrid_zamba2``: ``cfg`` (cut in depth)
    at full width on the card and the CPU, one set of weights drawn on the
    CPU from the seed and copied to the card; for each prompt of
    ``STATE_PROMPTS`` positions, prefill then ``DENSE_STEPS`` decode steps,
    the same tokens into both.  Checks every step's logits within
    ``GEN_TOL``, greedy tokens outside near-ties, every recurrent layer's
    prefill state (``STATE_FIELDS``) within ``state_tol`` relative to 1 +
    |CPU|, and the attention launches: one K5 an attention layer a prompt,
    one K6 an attention layer a step (none without one), the first card K5
    and K6 call within :func:`attn_tol` of the plain versions; a block at
    several layers (a shared block) must hold one parameter storage on the
    card and a KV cache of its own at each layer.  ``chunk``: the
    recurrent form's chunk, for the printout."""
    import copy
    import gc
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import (decode_step, init_cache, init_params,
                                    param_count, prefill)
    from repro_torch.models import model as model_mod

    name, cpu = cfg.name, torch.device("cpu")
    t0 = time.perf_counter()
    m_cpu = init_params(cfg, seed=SEED, device="cpu")
    m_card = copy.deepcopy(m_cpu).to(dev)
    init_s = time.perf_counter() - t0
    layers_of = {}
    for i, block in enumerate(m_card.blocks):
        layers_of.setdefault(id(block), []).append(i)
    shared = [group for group in layers_of.values() if len(group) > 1]
    for group in shared:
        ptrs = {p.data_ptr() for i in group
                for p in m_card.blocks[i].parameters()}
        check(len(ptrs) == len(list(m_card.blocks[group[0]].parameters())),
              f"{name}: the block at layers {group} holds more than one "
              f"parameter storage on the card")
    n_attn = sum(isinstance(b, model_mod.AttnBlock) for b in m_card.blocks)
    g = torch.Generator().manual_seed(9)
    rec_flash = Recorder(model_mod.flash_attention)
    rec_dec = Recorder(model_mod.decode_attention)
    saved = (model_mod.flash_attention, model_mod.decode_attention)
    f0, d0 = flash_attention.launches, decode_attention.launches
    runs = []
    try:
        model_mod.flash_attention, model_mod.decode_attention = (rec_flash,
                                                                 rec_dec)
        for prompt in STATE_PROMPTS:
            toks = torch.randint(0, cfg.vocab_size, (1, prompt), generator=g)
            c_cpu = init_cache(cfg, 1, prompt + DENSE_STEPS, device=cpu)
            c_card = init_cache(cfg, 1, prompt + DENSE_STEPS, device=dev)
            for group in shared:
                check(len({c_card[i].k.data_ptr() for i in group})
                      == len(group), f"{name}: layers {group} share a KV "
                      f"cache")
            t0 = time.perf_counter()
            l_cpu, _ = prefill(m_cpu, {"tokens": toks}, c_cpu)
            t1 = time.perf_counter()
            l_card, _ = prefill(m_card, {"tokens": toks.to(dev)}, c_card)
            lk = l_card[0].cpu()
            cpu_s, card_s = t1 - t0, time.perf_counter() - t1
            state_err = max((rel_err(getattr(c, f), getattr(k, f))
                             for c, k in zip(c_card, c_cpu)
                             for f in STATE_FIELDS.get(type(c).__name__,
                                                       ())), default=0.0)
            check(state_err <= state_tol, f"{name}: prompt {prompt}'s "
                  f"prefill state differs by {state_err} > {state_tol}")
            errs, checked, ties = [], 0, 0
            for step in range(DENSE_STEPS + 1):
                lc = l_cpu[0]
                errs.append(float((lk - lc).abs().max()))
                top2 = torch.topk(lc, 2).values
                if float(top2[0] - top2[1]) > 2 * GEN_TOL:
                    check(int(lk.argmax()) == int(lc.argmax()), f"{name}: "
                          f"prompt {prompt}: greedy token differs at step "
                          f"{step}")
                    checked += 1
                else:
                    ties += 1
                if step == DENSE_STEPS:
                    break
                nxt = lc.argmax().reshape(1, 1)  # the same token into both
                t0 = time.perf_counter()
                l_cpu, _ = decode_step(m_cpu, nxt, c_cpu, prompt + step)
                t1 = time.perf_counter()
                l_card, _ = decode_step(m_card, nxt.to(dev), c_card,
                                        prompt + step)
                lk = l_card[0].cpu()
                cpu_s += t1 - t0
                card_s += time.perf_counter() - t1
            check(max(errs) <= GEN_TOL, f"{name}: prompt {prompt}: logits "
                  f"differ by {max(errs)} > {GEN_TOL}")
            runs.append({"prompt": prompt, "chunks": -(-prompt // chunk)
                         if prompt > 1 else "recurrent", "cpu_s": cpu_s,
                         "card_s": card_s, "prefill_state_rel_err": state_err,
                         "max_abs_err_per_step": errs,
                         "tokens_checked": checked, "near_ties": ties})
    finally:
        model_mod.flash_attention, model_mod.decode_attention = saved
    launches = {"flash_attention": flash_attention.launches - f0,
                "decode_attention": decode_attention.launches - d0}
    n_prompts = len(STATE_PROMPTS)
    want = {"flash_attention": n_attn * n_prompts,
            "decode_attention": n_attn * DENSE_STEPS * n_prompts}
    check(launches == want, f"{name}: attention launches {launches}, want "
          f"{want}")
    line = {"name": name, "layers": cfg.num_layers,
            "pattern": list(cfg.block_pattern), "d_model": cfg.d_model,
            "d_ff": cfg.d_ff, "vocab": cfg.vocab_size,
            "params": param_count(m_card), "init_s": init_s,
            "tol": GEN_TOL, "state_tol": state_tol,
            "decode_steps": DENSE_STEPS, "prompts": runs,
            "launches": launches,
            "shared_blocks": [{"layers": group, "params": sum(
                p.numel() for p in m_card.blocks[group[0]].parameters())}
                for group in shared],
            **first_calls(cfg, rec_flash, rec_dec)}
    del m_cpu, m_card, c_cpu, c_card, rec_flash, rec_dec
    gc.collect()
    torch.cuda.empty_cache()
    return line


def wkv_forms(cfg, dev) -> dict:
    """``wkv6_chunked`` against ``wkv6_recurrent`` on the card at the
    full-width shape (1, MAX_PROMPT, H, hd), r / k / v N(0, 1), u N(0,
    0.1), a state N(0, 0.1), the log decay from ``ww`` as the block clips
    it: the model's (``w0`` -0.6 plus N(0, 1)), the weakest (-20) and the
    strongest (10).  Each within ``WKV_TOL`` but the strongest, which must
    stay finite (module docstring, ``WKV_TOL``); the ms of each form."""
    import torch
    from repro_torch.models.rwkv6 import wkv6_chunked, wkv6_recurrent

    g = torch.Generator(device=dev).manual_seed(SEED)
    h, hd = cfg.d_model // cfg.ssm_head_dim, cfg.ssm_head_dim
    n = lambda *shape: torch.randn(shape, generator=g, device=dev)
    r, k, v = (n(1, MAX_PROMPT, h, hd) for _ in range(3))
    u, s0 = 0.1 * n(h, hd), 0.1 * n(1, h, hd, hd)
    out = {}
    for case, ww in (("model", -0.6 + n(1, MAX_PROMPT, h, hd)),
                     ("weakest", torch.full_like(r, -20.0)),
                     ("strongest", torch.full_like(r, 10.0))):
        logw = -torch.exp(torch.clamp(ww, -20.0, 10.0))
        args = (r, k, v, logw, u, s0)
        oc, sc = wkv6_chunked(*args)
        o_r, s_r = wkv6_recurrent(*args)
        finite = all(bool(torch.isfinite(t).all()) for t in (oc, sc, o_r,
                                                            s_r))
        err = max(rel_err(oc, o_r), rel_err(sc, s_r))
        check(finite, f"wkv forms ({case}): non-finite output or state")
        if case != "strongest":
            check(err <= WKV_TOL, f"wkv forms ({case}): chunked against "
                  f"recurrent {err} > {WKV_TOL}")
        out[case] = {"rel_err": err, "gated": case != "strongest",
                     "finite": finite,
                     "chunked_ms": cuda_ms(lambda: wkv6_chunked(*args), 5),
                     "recurrent_ms": cuda_ms(lambda: wkv6_recurrent(*args),
                                             5)}
    return {"shape": [1, MAX_PROMPT, h, hd], "tol": WKV_TOL, **out}


def ssd_forms(cfg, dev) -> dict:
    """``ssd_chunked`` against ``ssd_reference`` on the card at the
    full-width shape (1, MAX_PROMPT, nh, hd), N = the config's state size:
    x, B, C N(0, 1), a state N(0, 0.1), the log decay -A dt under the
    model's decay (``A`` = linspace(1, 16, nh) as ``A_log`` holds it, ``dt``
    = softplus(N(0, 1) + ``dt_bias`` drawn as the init draws it)) and the
    strongest the init allows (``A`` = 16, ``dt`` = exp(-1.1), the largest
    the ``dt_bias`` init gives at a zero input).  Each within ``SSD_TOL``
    relative to 1 + |reference|, finite; the ms of each form."""
    import torch
    from repro_torch.models.mamba2 import softplus, ssd_chunked, ssd_reference

    g = torch.Generator(device=dev).manual_seed(SEED)
    nh, hd, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_size
    r = lambda *shape: torch.randn(shape, generator=g, device=dev)
    x, b, c = r(1, MAX_PROMPT, nh, hd), r(1, MAX_PROMPT, n), r(1, MAX_PROMPT,
                                                                n)
    s0 = 0.1 * r(1, nh, hd, n)
    u = torch.rand((nh,), generator=g, device=dev)
    dt_bias = torch.log(torch.expm1(torch.exp(u * 3.5 - 4.6)))
    a = torch.linspace(1.0, 16.0, nh, device=dev)
    out = {}
    for case, log_a in (
            ("model", -a * softplus(r(1, MAX_PROMPT, nh) + dt_bias)),
            ("strongest", torch.full((1, MAX_PROMPT, nh),
                                     -16.0 * float(np.exp(-1.1)),
                                     device=dev))):
        args = (x, log_a, b, c, s0)
        yc, sc = ssd_chunked(*args)
        yr, sr = ssd_reference(*args)
        finite = all(bool(torch.isfinite(t).all()) for t in (yc, sc, yr, sr))
        err = max(rel_err(yc, yr), rel_err(sc, sr))
        check(finite, f"ssd forms ({case}): non-finite output or state")
        check(err <= SSD_TOL, f"ssd forms ({case}): chunked against the "
              f"recurrence {err} > {SSD_TOL}")
        out[case] = {"rel_err": err, "finite": finite,
                     "log_a_min_max": [float(log_a.min()),
                                       float(log_a.max())],
                     "chunked_ms": cuda_ms(lambda: ssd_chunked(*args), 5),
                     "reference_ms": cuda_ms(lambda: ssd_reference(*args),
                                             5)}
    return {"shape": [1, MAX_PROMPT, nh, hd], "state": n, "tol": SSD_TOL,
            **out}


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


def add_counts(total: dict, counts: dict) -> dict:
    """``total`` plus ``counts`` (as :func:`launch_counts` gives them),
    key by key, nested dicts included."""
    out = dict(total)
    for k, v in counts.items():
        out[k] = (add_counts(out.get(k, {}), v) if isinstance(v, dict)
                  else out.get(k, 0) + v)
    return out


def want_counts(ivf=0, fp32=0, causal=0, decode=0, **modes) -> dict:
    """A :func:`launch_counts` dict: ``ivf`` K1 launches, ``fp32`` (and
    ``modes``) slab_topk launches by mode, K5 causal, K6; nothing else."""
    from repro_torch.kernels.slab_topk import slab_topk
    return {"ivf_topk": ivf,
            "slab_topk": {**dict.fromkeys(slab_topk.launches_by_mode, 0),
                          "fp32": fp32, **modes},
            "flash_attention": {"causal": causal, "non_causal": 0},
            "decode_attention": decode}


def tenant_data(ctx) -> tuple:
    """``tenancy``'s tenants: {tenant: (dataset, centroids, assignment)},
    fiqa on the main path's corpus and clustering beside scidocs at Table
    2's record count, clustered once on the CPU; and that clustering's
    seconds."""
    from repro_torch.core.kmeans import kmeans
    from repro_torch.data.synthetic import scaled_beir
    sci = scaled_beir("scidocs", n_records=SCI_RECORDS, dim=DIM,
                      n_queries=BATCHES * BATCH, seed=SEED)
    t0 = time.perf_counter()
    sci_centroids, sci_assign = kmeans(sci.embeddings, SCI_NLIST, iters=20,
                                       seed=SEED, device="cpu")
    return ({"fiqa": (ctx["ds"], ctx["main_centroids"], ctx["main_assign"]),
             "scidocs": (sci, sci_centroids, sci_assign)},
            time.perf_counter() - t0)


def tenant_batches(data) -> tuple:
    """``tenancy``'s requests: Zipf over the two tenants, each taking its
    tenant's next query row, in batches of BATCH (BATCHES of them), and
    (d)'s batch: (a)'s first batch's tenants on the tenants' next rows.
    Returns (tenant names, rows, the batches as (names, rows), (d)'s)."""
    from repro_torch.serving import zipf_over_tenants
    draw = zipf_over_tenants(len(TENANTS), BATCHES * BATCH, seed=SEED)
    names = [TENANTS[int(i)] for i in draw.tenant_ids] + \
        [TENANTS[int(i)] for i in draw.tenant_ids[:BATCH]]
    used = dict.fromkeys(TENANTS, 0)
    rows = []
    for t in names:
        rows.append(data[t][0].query_embs[used[t]])
        used[t] += 1
    batches = [(names[j:j + BATCH], np.stack(rows[j:j + BATCH]))
               for j in range(0, len(names), BATCH)]
    return names, rows, batches[:-1], batches[-1]


def tenancy(ctx) -> dict:
    """``TenantRouter`` on the card: two tenants' retrieval fused into one
    ``slab_topk`` launch a batch, through the engine, pipeline and
    scheduler (module docstring, ``tenancy``)."""
    import types

    import torch
    from repro_torch.convert import index_state_from_numpy
    from repro_torch.core import EdgeRAGIndex, TenantRouter
    from repro_torch.core import edgerag as edgerag_mod
    from repro_torch.serving import (PipelineBatch, RAGEngine,
                                     RequestScheduler, StagedPipeline)
    from repro_torch.serving.metrics import MetricsRegistry, collect_router

    t_phase = time.perf_counter()
    ds, cost, dev, gen = ctx["ds"], ctx["cost"], ctx["dev"], ctx["gen"]
    gen_layers = gen.cfg.num_layers
    data, sci_cluster_s = tenant_data(ctx)
    own = {t: set(d.texts) for t, (d, _, _) in data.items()}
    names, rows, batches, batch_d = tenant_batches(data)
    for b, (tn, _) in enumerate(batches):
        check(set(tn) == set(TENANTS), f"tenancy: batch {b} holds only "
              f"{sorted(set(tn))}")

    def router(device, budget=None, codec="fp32", logs=None):
        r = TenantRouter(DIM, cost, storage_codec=codec,
                         storage_budget_bytes=budget, device=device)
        for t, (d, cents, assign) in data.items():
            embed = d.embedder if logs is None else \
                logs.setdefault(t, EmbedLog(d.embedder))
            index_state_from_numpy(
                r.create_tenant(t, embed, d.get_chunks, slo_s=d.spec.slo_s),
                cents, assign, d.chunk_ids, d.texts, d.embeddings)
        return r

    def silo(t, device):
        d, cents, assign = data[t]
        ix = EdgeRAGIndex(DIM, d.embedder, d.get_chunks, cost,
                          slo_s=d.spec.slo_s, maintenance="deferred",
                          device=device)
        index_state_from_numpy(ix, cents, assign, d.chunk_ids, d.texts,
                               d.embeddings)
        return ix

    # ---- (a) fused against silos, on a shared budget --------------------
    silos = {t: silo(t, dev) for t in TENANTS}
    stored = {t: ix.storage_bytes() for t, ix in silos.items()}
    budget = stored["fiqa"] + stored["scidocs"] // 2
    logs = {}
    card = router(dev, budget, logs=logs)
    rec = Recorder(edgerag_mod.slab_topk, lambda e, q, v, k, **kw: None)
    launches_a = {}
    card_out, walls = [], {"fused": [], "silos": []}
    for b, (tn, embs) in enumerate(batches):
        if b == 0:
            edgerag_mod.slab_topk, outer = rec, edgerag_mod.slab_topk
        zero_launches()
        t0 = time.perf_counter()
        ids, vals, lats = card.search_batch(embs, K, NPROBE, tenants=tn)
        walls["fused"].append(time.perf_counter() - t0)
        fused = launch_counts()
        if b == 0:
            edgerag_mod.slab_topk = outer
        check(fused == want_counts(ivf=len(TENANTS), fp32=1),
              f"tenancy (a): batch {b} launched {fused}; want one K1 a "
              f"tenant and one fp32 slab_topk")
        card_out.append((ids, vals, tier_decisions(lats)))
        zero_launches()
        t0 = time.perf_counter()
        for t in TENANTS:
            local = [i for i, x in enumerate(tn) if x == t]
            s_ids, s_vals, _ = silos[t].search_batch(embs[local], K, NPROBE)
            check(np.array_equal(s_ids, ids[local])
                  and np.array_equal(s_vals, vals[local]),
                  f"tenancy (a): batch {b}, tenant {t}: fused ids or "
                  f"scores not bitwise the silo's")
        walls["silos"].append(time.perf_counter() - t0)
        silo_counts = launch_counts()
        check(silo_counts == want_counts(ivf=len(TENANTS),
                                         fp32=len(TENANTS)),
              f"tenancy (a): the silos of batch {b} launched {silo_counts}")
        launches_a = add_counts(add_counts(launches_a, fused), silo_counts)
    for t, log in logs.items():
        seen = [x for texts, _, _ in log.calls for x in texts]
        check(seen and set(seen) <= own[t], f"tenancy (a): tenant {t}'s "
              f"embedder saw {len(set(seen) - own[t])} texts of another "
              f"tenant ({len(seen)} in all)")
    st = card.stats()["storage"]
    check(st["put_rejected"] > 0 and st["total_bytes"] <= budget
          and sum(st["per_tenant"].values()) == st["total_bytes"],
          f"tenancy (a): storage {st} under a budget of {budget}")

    # ---- (b) one tenant: a router equals a standalone index -------------
    one = TenantRouter(DIM, cost, device=dev)
    d, cents, assign = data["fiqa"]
    index_state_from_numpy(
        one.create_tenant("fiqa", d.embedder, d.get_chunks,
                          slo_s=d.spec.slo_s),
        cents, assign, d.chunk_ids, d.texts, d.embeddings)
    alone = EdgeRAGIndex(DIM, d.embedder, d.get_chunks, cost,
                         slo_s=d.spec.slo_s, cache_bytes=one.cache
                         .capacity_bytes, maintenance="deferred",
                         device=dev)
    index_state_from_numpy(alone, cents, assign, d.chunk_ids, d.texts,
                           d.embeddings)
    for b in range(BATCHES):
        embs = ds.query_embs[b * BATCH:(b + 1) * BATCH]
        chars = [len(f"query-{b * BATCH + i}") for i in range(BATCH)]
        r_ids, r_vals, r_lats = one.search_batch(embs, K, NPROBE, chars,
                                                 tenants="fiqa")
        a_ids, a_vals, a_lats = alone.search_batch(embs, K, NPROBE, chars)
        strip = lambda lat: {**vars(lat), "wall_s": None}
        check(np.array_equal(r_ids, a_ids) and np.array_equal(r_vals, a_vals)
              and [strip(x) for x in r_lats] == [strip(x) for x in a_lats],
              f"tenancy (b): batch {b} of the one-tenant router differs "
              f"from the standalone index")
    check(one.memory_bytes() == alone.memory_bytes()
          and one.tenant("fiqa").threshold.threshold
          == alone.threshold.threshold,
          "tenancy (b): resident bytes or Alg. 3 threshold differ")
    del one, alone

    # ---- (c) the CPU replay ----------------------------------------------
    cpu = router("cpu", budget)
    swaps = mismatches = 0
    for b, ((tn, embs), (ids, _, dec)) in enumerate(zip(batches, card_out)):
        c_ids, c_vals, c_lats = cpu.search_batch(embs, K, NPROBE, tenants=tn)
        check(tier_decisions(c_lats) == dec, f"tenancy (c): the CPU router "
              f"took other tier decisions in batch {b}")
        s_, m_ = near_tie_mismatches(ids, c_ids, c_vals)
        swaps, mismatches = swaps + s_, mismatches + m_
    check(mismatches == 0, f"tenancy (c): {mismatches} ids differ from the "
          f"CPU router outside near-ties")
    card_st, cpu_st = card.stats(), cpu.stats()
    for part in ("cache", "storage", "maintenance"):
        check(card_st[part] == cpu_st[part], f"tenancy (c): stats()"
              f"[{part!r}] {card_st[part]} on the card, {cpu_st[part]} on "
              f"the CPU")
    text = collect_router(MetricsRegistry(), card).render()
    metrics = metrics_agree(text, collect_router(MetricsRegistry(),
                                                 cpu).render(),
                            "tenancy.prom", "tenancy (c)")

    # ---- (d) the engine at full width -------------------------------------
    tn, embs = batch_d
    queries = [f"{t}-query-{i}" for i, t in enumerate(tn)]
    engine = RAGEngine(card, gen, cost_model=cost, k=K, nprobe=NPROBE,
                       max_new_tokens=TENANCY_NEW_TOKENS)
    zero_launches()
    t0 = time.perf_counter()
    resp = engine.answer_batch(queries, embs, tenants=tn)
    torch.cuda.synchronize()
    wall_d = time.perf_counter() - t0
    launches_d = launch_counts()
    want = want_counts(ivf=len(set(tn)), fp32=1, causal=gen_layers * BATCH,
                       decode=gen_layers * TENANCY_NEW_TOKENS * BATCH)
    check(launches_d == want, f"tenancy (d): launches {launches_d}; want "
          f"{want}")
    check(all(len(r.output_tokens) == TENANCY_NEW_TOKENS
              and len(r.chunk_ids) == K and r.context
              and all(c in own[t] for c in r.context)
              for r, t in zip(resp, tn)),
          "tenancy (d): a response is short, or holds another tenant's "
          "text")
    c_ids, c_vals, _ = cpu.search_batch(
        embs, K, NPROBE, [len(q) for q in queries], tenants=tn)
    swaps_d, mismatches = near_tie_mismatches([r.chunk_ids for r in resp],
                                              c_ids, c_vals)
    check(mismatches == 0, f"tenancy (d): {mismatches} ids differ from the "
          f"CPU router outside near-ties")
    del cpu

    # ---- (e) run_pipelined against the same batches built by hand --------
    a, b_ = router(dev, budget), router(dev, budget)
    scores_a, scores_b = scored(a), scored(b_)
    req_names = names[:PIPE_REQUESTS]
    req_rows, arrive = rows[:PIPE_REQUESTS], [PIPE_SPACING * i for i in
                                              range(PIPE_REQUESTS)]
    req_q = [f"{t}-request-{i}" for i, t in enumerate(req_names)]
    slos = [data[t][0].spec.slo_s for t in req_names]

    def engine_of(x):
        return RAGEngine(x, None, cost_model=cost, k=K, nprobe=NPROBE,
                         maintenance_owner="external")
    sched = RequestScheduler()
    for i, t in enumerate(arrive):
        sched.submit(t, query=req_q[i], query_emb=req_rows[i],
                     query_chars=len(req_q[i]), slo_s=slos[i],
                     tenant=req_names[i])
    zero_launches()
    t0 = time.perf_counter()
    sched.run_pipelined(StagedPipeline(engine_of(a), None), batch_size=BATCH)
    wall_e = time.perf_counter() - t0
    launches_e = launch_counts()
    trace = sched.pipeline_trace
    reqs_b = [types.SimpleNamespace(arrival_s=t, start_s=0.0, finish_s=0.0,
                                    degraded=False) for t in arrive]
    hand = [PipelineBatch(
        queries=req_q[j:j + BATCH], query_embs=np.stack(req_rows[j:j + BATCH]),
        arrival_s=max(arrive[j:j + BATCH]), slos=slos[j:j + BATCH],
        requests=reqs_b[j:j + BATCH], tenants=req_names[j:j + BATCH])
        for j in range(0, PIPE_REQUESTS, BATCH)]
    t0 = time.perf_counter()
    resp_b, trace_b = StagedPipeline(engine_of(b_), None).run(hand)
    wall_hand = time.perf_counter() - t0
    flat_b = [r for rs in resp_b for r in rs]
    check([r.chunk_ids for r in sched.pipeline_responses]
          == [r.chunk_ids for r in flat_b]
          and len(flat_b) == PIPE_REQUESTS, "tenancy (e): run_pipelined's "
          "ids differ from the hand-built batches'")
    check(len(scores_a) == len(scores_b) == PIPE_REQUESTS // BATCH and all(
              np.array_equal(ia, ib) and np.array_equal(va, vb)
              for (ia, va), (ib, vb) in zip(scores_a, scores_b)),
          "tenancy (e): run_pipelined's scores not bitwise the hand-built "
          "batches'")
    check(trace.as_dict() == trace_b.as_dict() and trace.replans == 0,
          "tenancy (e): run_pipelined's trace differs from the hand-built "
          "batches' or replanned")
    check([(r.start_s, r.finish_s, r.degraded) for r in sched.completed]
          == [(r.start_s, r.finish_s, r.degraded) for r in reqs_b],
          "tenancy (e): request stamps differ from the hand-built batches'")
    want = want_counts(ivf=sum(len(set(x.tenants)) for x in hand),
                       fp32=trace.stages["s3"].n_fired)
    check(launches_e == want and trace.stages["s3"].n_fired == len(hand),
          f"tenancy (e): launches {launches_e}; want {want}")
    del a, b_

    # ---- (f) int8: both tenants' stored clusters in one int8 launch ------
    r8, c8 = router(dev, codec="int8"), router("cpu", codec="int8")
    packed, pack = [], r8.resolver.pack_slab

    def pack_logged(*args):
        packed.append(pack(*args))
        return packed[-1]
    r8.resolver.pack_slab = pack_logged
    tn, embs = batches[0]
    zero_launches()
    ids, _, lats = r8.search_batch(embs, K, NPROBE, tenants=tn)
    launches_f = launch_counts()
    int8_tenants = sorted({key[0] for seg in packed[0].segments
                           if seg.kind == "int8" for key in seg.clusters})
    check(launches_f["slab_topk"]["int8"] == 1
          and launches_f["slab_topk"]["fp32"] <= 1
          and launches_f["ivf_topk"] == len(TENANTS)
          and int8_tenants == sorted(TENANTS),
          f"tenancy (f): launches {launches_f}, int8 segment of tenants "
          f"{int8_tenants}")
    c_ids, c_vals, c_lats = c8.search_batch(embs, K, NPROBE, tenants=tn)
    swaps_f, mismatches = near_tie_mismatches(ids, c_ids, c_vals)
    check(mismatches == 0 and tier_decisions(c_lats) == tier_decisions(lats),
          f"tenancy (f): {mismatches} ids differ from the CPU int8 router "
          f"outside near-ties, or its tier decisions differ")

    n_rows = {t: sum(len(x[0]) for x in log.calls) for t, log in logs.items()}
    return {"phase": "tenancy", "tenants": {
                t: {"records": d.n, "nlist": len(c), "slo_s": d.spec.slo_s,
                    "stored_bytes_alone": stored[t],
                    "stored_bytes_in_router": st["per_tenant"][t],
                    "regenerated_rows": n_rows.get(t, 0)}
                for t, (d, c, _) in data.items()},
            "scidocs_kmeans_cpu_s": sci_cluster_s,
            "budget_bytes": budget,
            "budget_rule": "fiqa's standalone stored bytes + half of "
                           "scidocs'",
            "put_rejected": st["put_rejected"],
            "requests_per_batch": [{t: tn.count(t) for t in TENANTS}
                                   for tn, _ in batches],
            "fused_wall_s_per_batch": walls["fused"],
            "silo_wall_s_per_batch": walls["silos"],
            "cache_hit_rate": card_st["cache"]["hit_rate"],
            "cpu_match": True, "near_tie_swaps": swaps,
            "metrics": metrics,
            "engine": {"wall_s": wall_d, "launches": launches_d,
                       "new_tokens": TENANCY_NEW_TOKENS,
                       "near_tie_swaps": swaps_d},
            "run_pipelined": {"requests": PIPE_REQUESTS,
                              "wall_s": wall_e, "hand_built_wall_s":
                              wall_hand, "launches": launches_e,
                              "outcomes": sched.outcome_counts(),
                              "trace": trace.as_dict()},
            "int8": {"launches": launches_f, "near_tie_swaps": swaps_f},
            "launches": add_counts(add_counts(launches_a, launches_d),
                                   launches_e),
            "record": rec.first[None],
            "phase_s": time.perf_counter() - t_phase}


def threshold_of(ix) -> tuple:
    """The Alg. 3 controller's state, as a snapshot holds it."""
    thr = ix.threshold
    return (thr.threshold, thr.step_s, thr.alpha, thr.moving_avg_latency,
            thr._initialized)


def index_state(ix) -> dict:
    """Everything durable of ``ix``, exactly: cluster fields, centroids,
    chunk maps, the Alg. 3 threshold and the blob manifest."""
    return {
        "clusters": [(np.asarray(c.ids, np.int64).tobytes(), c.char_count,
                      c.gen_latency_est, c.stored, c.active, c.generation,
                      c.content_generation, c.stored_generation)
                     for c in ix.clusters],
        "centroids": np.ascontiguousarray(ix.centroids, np.float32).tobytes(),
        "chunk_cluster": sorted(ix._chunk_cluster.items()),
        "chunk_chars": sorted(ix._chunk_chars.items()),
        "threshold": threshold_of(ix),
        "manifest": {cid: ix.storage.payload_crc(cid)
                     for cid, c in enumerate(ix.clusters) if c.stored}}


def states_agree(got: dict, want: dict, healed: int, where: str) -> int:
    """``got`` (a recovered index's :func:`index_state`) against ``want``,
    part by part, the threshold aside: bitwise, except that the
    storage-event stamps of at most ``healed`` clusters move as a heal's
    restore moves them (generation + 1, stored_generation = generation).
    Returns how many moved."""
    for part in want:
        if part not in ("threshold", "clusters"):
            check(got[part] == want[part], f"{where}: recovered {part} "
                  f"differs from the twin's")
    check(len(got["clusters"]) == len(want["clusters"]),
          f"{where}: {len(got['clusters'])} clusters, the twin "
          f"{len(want['clusters'])}")
    content = (0, 1, 2, 3, 4, 6)
    moved = 0
    for cid, (a, b) in enumerate(zip(got["clusters"], want["clusters"])):
        if a == b:
            continue
        check(all(a[i] == b[i] for i in content) and a[5] == b[5] + 1
              and a[7] == a[5], f"{where}: cluster {cid} differs from the "
              f"twin's")
        moved += 1
    check(moved <= healed, f"{where}: {moved} clusters' stamps moved, "
          f"{healed} healed")
    return moved


def counts_since(before: dict) -> dict:
    """:func:`launch_counts` less ``before``, key by key."""
    def sub(a, b):
        return {k: sub(v, b[k]) if isinstance(v, dict) else v - b[k]
                for k, v in a.items()}
    return sub(launch_counts(), before)


class CallTimes:
    """Host seconds and calls of the named functions while installed:
    ``targets`` lists (owner, attribute) pairs, a class's methods and
    static methods or a module's functions, each wrapped in place and
    restored on exit.  Nested calls count in both."""

    def __init__(self, targets):
        self.targets = targets
        self.stats = {}

    def __enter__(self):
        self.saved = []
        for owner, name in self.targets:
            orig = owner.__dict__[name]
            static = isinstance(orig, staticmethod)
            fn = orig.__func__ if static else orig
            self.stats[name] = [0, 0.0]

            def timed(*args, _fn=fn, _st=self.stats[name], **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*args, **kw)
                finally:
                    _st[0] += 1
                    _st[1] += time.perf_counter() - t0
            setattr(owner, name, staticmethod(timed) if static else timed)
            self.saved.append((owner, name, orig))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in self.saved:
            setattr(owner, name, orig)


def dur_events(ds, assign, split_max_chars: int) -> tuple:
    """The durability stream (module docstring, ``durability``): DUR_INSERTS
    inserts of new chunks (a corpus row plus the generator's noise,
    renormalised, under a new id, with a text of the generator's length),
    DUR_REMOVES removes and DUR_UPDATES updates of distinct corpus chunks
    in a seeded order, and ``("heal", -1)`` before event DUR_HEAL_AT.  The
    first update's text is long enough to push its cluster past
    ``split_max_chars``.  Returns (events, new rows {id: row}, texts
    {id: the event's text})."""
    rng = np.random.default_rng(SEED + 30)
    n = ds.n
    events, rows, texts = [], {}, {}
    for j in range(DUR_INSERTS):
        nid = n + j
        v = ds.embeddings[int(rng.integers(n))] + 0.35 * \
            rng.standard_normal(DIM)
        rows[nid] = (v / np.linalg.norm(v)).astype(np.float32)
        chars = max(40, int(rng.normal(300, 90)))
        texts[nid] = (f"doc-{nid} " + "tok " * chars)[:chars]
        events.append(("ins", nid))
    picked = [int(i) for i in rng.choice(n, DUR_REMOVES + DUR_UPDATES,
                                         replace=False)]
    events += [("rm", cid) for cid in picked[:DUR_REMOVES]]
    sizes = np.bincount(assign, weights=[len(t) for t in ds.texts])
    for j, cid in enumerate(picked[DUR_REMOVES:]):
        chars = int(rng.integers(100, 3000))
        if j == 0:
            chars = int(split_max_chars - sizes[assign[cid]]
                        + len(ds.texts[cid]) + 10_000)
        texts[cid] = (f"doc-{cid} " + "rev " * chars)[:chars]
        events.append(("up", cid))
    events = [events[i] for i in rng.permutation(len(events))]
    events.insert(DUR_HEAL_AT, ("heal", -1))
    return events, rows, texts


def durability(ctx) -> tuple:
    """Crash-consistent durability on the card: the fiqa index's WAL,
    snapshots, ``recover`` and ``recover_router`` (module docstring,
    ``durability``).  Returns (the phase's line, its scenario lines, the
    recovered indexes' first fp32 and int8 ``slab_topk`` calls)."""
    import collections
    import gc
    import itertools

    import torch
    from repro_torch.convert import index_state_from_numpy
    from repro_torch.core import (CrashInjector, Durability, EdgeRAGIndex,
                                  IndexSnapshot, SimulatedCrash,
                                  TenantRouter, recover, recover_router)
    from repro_torch.core import durability as durability_mod
    from repro_torch.core import edgerag as edgerag_mod
    from repro_torch.core.durability import WriteAheadLog
    from repro_torch.core.storage import StorageBackend
    from repro_torch.data import TableEmbedder
    from repro_torch.kernels.slab_topk import slab_mode, slab_topk

    t_phase = time.perf_counter()
    ds, cost, dev, smi = ctx["ds"], ctx["cost"], ctx["dev"], ctx["smi"]
    centroids, assign = ctx["main_centroids"], ctx["main_assign"]
    slo = ds.spec.slo_s
    scratch = Path(tempfile.mkdtemp(prefix="durability_",
                                    dir=ROOT / "build"))
    roots = (str(scratch / f"root{i}") for i in itertools.count())
    heal_q = ds.query_embs[BATCHES * BATCH:(BATCHES + 1) * BATCH]
    q_batches = [ds.query_embs[b * BATCH:(b + 1) * BATCH]
                 for b in range(BATCHES)]
    corpus = dict(zip(ds.chunk_ids.tolist(), ds.texts))
    events, new_rows, texts = dur_events(ds, assign, 200_000)
    embed = TableEmbedder({**ds.embedder.table, **new_rows}, DIM)
    # the largest |q . e| sum of the phase's queries over unit rows bounds
    # two fp32 summation orders' difference (score_tol's rule)
    score_tol_ = float(2 * DIM * 2.0 ** -24
                       * np.abs(ds.query_embs).sum(axis=1).max())
    zero_launches()

    def chunks(store):
        return lambda ids: [store[int(i)] for i in ids]

    def fiqa(codec, root, store):
        """The main path's index on a disk root of its own."""
        ix = EdgeRAGIndex(DIM, embed, chunks(store), cost, slo_s=slo,
                          storage_mode="disk", storage_root=root,
                          storage_codec=codec, device=dev)
        check(ix.split_max_chars == 200_000 and ix.maintenance_mode
              == "sync", "durability: the index's defaults moved")
        index_state_from_numpy(ix, centroids, assign, ds.chunk_ids,
                               ds.texts, ds.embeddings)
        return ix

    def event(ix, ev, store):
        kind, cid = ev
        if kind == "heal":
            probed = set().union(*ix._probe(heal_q, NPROBE))
            victim = min(c for c in probed if ix.clusters[c].stored)
            Path(ix.storage._path(victim)).unlink()     # behind the index
            ix.search_batch(heal_q, K, NPROBE)
            check(victim in ix.storage, "durability: the resolver did not "
                  "re-persist the deleted blob")
            return
        if kind != "rm":
            store[cid] = texts[cid]
        got = {"ins": lambda: ix.insert(cid, texts[cid]),
               "rm": lambda: ix.remove(cid),
               "up": lambda: ix.update(cid, texts[cid])}[kind]()
        check(got is not None, f"durability: {kind} {cid} found no chunk")

    def stream(ix, store):
        """Runs the events; returns each one's host wall."""
        walls = []
        for ev in events:
            t0 = time.perf_counter()
            event(ix, ev, store)
            walls.append(time.perf_counter() - t0)
        return walls

    def logged(dur):
        """Keeps each WAL record's (op, clusters) as it is appended."""
        log, inner = [], dur.log_mutation

        def log_mutation(index, op, cids, gone):
            out = inner(index, op, cids, gone)
            log.append((op, len(cids)))
            return out
        dur.log_mutation = log_mutation
        return log

    def on_disk(dur) -> dict:
        snaps = [IndexSnapshot.path(dur.dir, lsn)
                 for lsn in IndexSnapshot.lsns(dur.dir)]
        return {"wal_bytes": dur.wal.nbytes(),
                "snapshot_bytes": sum(Path(p).stat().st_size for p in snaps),
                "snapshots": len(snaps)}

    def answers(ix, batches, want):
        """ids and scores of each batch, each batch's launches checked."""
        out = []
        for b, embs in enumerate(batches):
            before = launch_counts()
            ids, vals, _ = ix.search_batch(embs, K, NPROBE)
            got = counts_since(before)
            check(got == want, f"durability: batch {b} launched {got}; "
                  f"want {want}")
            out.append((np.asarray(ids), np.asarray(vals)))
        return out

    def bitwise(a, b, where):
        check(len(a) == len(b) and all(
            np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
            for x, y in zip(a, b)), f"{where}: ids or scores not bitwise")

    def timed_recover(root, store, device):
        """``recover`` with its wall and where it went: the snapshot
        search and apply, the WAL read and replay, the blob CRC reads, the
        heals and the closing checkpoint (host seconds and calls)."""
        with CallTimes([
                (WriteAheadLog, "truncate_torn_tail"),
                (WriteAheadLog, "records"),
                (IndexSnapshot, "newest_valid"), (IndexSnapshot, "apply"),
                (durability_mod, "_replay_record"),
                (StorageBackend, "payload_crc"),
                (EdgeRAGIndex, "_restore_cluster"),
                (Durability, "checkpoint")]) as ct:
            t0 = time.perf_counter()
            out = recover(root, embed, chunks(store), cost,
                          checkpoint_every=DUR_CHECKPOINT, slo_s=slo,
                          device=device)
            if device != "cpu":
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        return out + ({"wall_s": wall, **ct.stats},)

    # a dropped index is del-ed and collected before its root is recovered:
    # the index <-> scheduler cycle pins the root's writer claim till then
    one_k2 = want_counts(ivf=1, fp32=1)
    # the kernel itself for the phase (the main path's recorder keeps the
    # calls of its own phases); the recovered indexes' calls recorded
    saved, edgerag_mod.slab_topk = edgerag_mod.slab_topk, slab_topk
    rec_slab = Recorder(slab_topk,
                        lambda e, q, v, k, **kw: slab_mode(e, q, v, **kw))
    lines, copy_root, card_rec = [], None, None

    # ---- (a) fp32, crashed inside the stream, recovered on the card -----
    for point, at in DUR_CRASHES:
        root, store = next(roots), dict(corpus)
        ix = fiqa("fp32", root, store)
        dur = Durability(root, cost_model=cost,
                         checkpoint_every=DUR_CHECKPOINT,
                         crash=CrashInjector(point, at=at, seed=SEED))
        ix.attach_durability(dur)
        log = logged(dur)
        walls, crashed = [], None
        for j, ev in enumerate(events):
            t0 = time.perf_counter()
            try:
                event(ix, ev, store)
            except SimulatedCrash:
                crashed = j
                break
            walls.append(time.perf_counter() - t0)
        check(crashed is not None, f"durability (a): {point} at {at} never "
              f"fired")
        check(len(log) == crashed, f"durability (a): {len(log)} records "
              f"for {crashed} events before the crash")
        disk = on_disk(dur)
        del ix, dur
        gc.collect()
        if copy_root is None:
            copy_root, copy_store = str(scratch / "copy"), store
            shutil.copytree(root, copy_root)
        rec, rep, recover_t = timed_recover(root, store, dev)
        landed = rep.snapshot_lsn + rep.replayed_records
        check(landed in (crashed, crashed + 1), f"durability (a) {point}: "
              f"recovered to event {landed}, the crash was in event "
              f"{crashed}")
        # the twin: the landed prefix with no durability, thresholds kept
        t_store = dict(corpus)
        twin = fiqa("fp32", next(roots), t_store)
        thr = [threshold_of(twin)]
        twin_walls = []
        for ev in events[:landed]:
            t0 = time.perf_counter()
            event(twin, ev, t_store)
            twin_walls.append(time.perf_counter() - t0)
            thr.append(threshold_of(twin))
        got, want = index_state(rec), index_state(twin)
        moved = states_agree(got, want, rep.healed, f"durability (a) {point}")
        check(got["threshold"] == thr[rep.snapshot_lsn], f"durability (a) "
              f"{point}: threshold not the twin's at the snapshot")
        edgerag_mod.slab_topk = rec_slab
        rec_out = answers(rec, q_batches, one_k2)
        edgerag_mod.slab_topk = slab_topk
        bitwise(rec_out, answers(twin, q_batches, one_k2),
                f"durability (a) {point}: the recovered index against the "
                f"twin")
        if card_rec is None:
            card_rec = (got, rec_out)
        n = min(len(walls), len(twin_walls))
        lines.append({
            "phase": "durability", "scenario": f"a_{point}",
            "nvidia_smi": smi, "crash": {"point": point, "at": at},
            "crashed_in_event": crashed, "landed_event": landed,
            "records_logged": collections.Counter(op for op, _ in log),
            "multi_cluster_records": sum(c > 1 for _, c in log),
            "on_disk_at_crash": disk, "report": rep.as_dict(),
            "recover": recover_t,
            "on_disk_after_recovery": on_disk(rec.durability),
            "stamps_moved_by_heals": moved,
            "stream_host_s": {"events": n, "durable": sum(walls[:n]),
                              "twin": sum(twin_walls[:n])},
            "stream_host_s_per_event": {"durable": walls[:n],
                                        "twin": twin_walls[:n]},
            "nlist": len(rec.clusters), "bitwise_batches": len(rec_out)})
        del rec, twin
        gc.collect()
        shutil.rmtree(root)

    # ---- (b) int8: dropped after the whole stream, recovered -----------
    root, store = next(roots), dict(corpus)
    ix = fiqa("int8", root, store)
    dur = ix.attach_durability(Durability(root, cost_model=cost,
                                          checkpoint_every=DUR_CHECKPOINT))
    log = logged(dur)
    walls = stream(ix, store)
    check(len(log) == len(events), f"durability (b): {len(log)} records "
          f"for {len(events)} events")
    before = launch_counts()
    ids8, vals8, _ = ix.search_batch(q_batches[0], K, NPROBE)
    dropped_counts = counts_since(before)
    check(dropped_counts["slab_topk"]["int8"] == 1
          and dropped_counts == want_counts(
              ivf=1, fp32=dropped_counts["slab_topk"]["fp32"], int8=1),
          f"durability (b): the dropped index launched {dropped_counts}")
    disk = on_disk(dur)
    del ix, dur
    gc.collect()
    rec, rep, recover_t = timed_recover(root, store, dev)
    check(rec.storage.codec == "int8", "durability (b): recovered codec")
    edgerag_mod.slab_topk = rec_slab
    rec_out = answers(rec, q_batches[:1], dropped_counts)
    edgerag_mod.slab_topk = slab_topk
    bitwise(rec_out, [(np.asarray(ids8), np.asarray(vals8))],
            "durability (b): the recovered int8 index against the dropped "
            "one")
    t_store = dict(corpus)
    twin = fiqa("int8", next(roots), t_store)
    twin_walls = stream(twin, t_store)
    moved = states_agree(index_state(rec), index_state(twin), rep.healed,
                         "durability (b)")
    lines.append({
        "phase": "durability", "scenario": "b_int8", "nvidia_smi": smi,
        "events": len(events),
        "records_logged": collections.Counter(op for op, _ in log),
        "multi_cluster_records": sum(c > 1 for _, c in log),
        "on_disk_at_drop": disk, "report": rep.as_dict(),
        "recover": recover_t,
        "on_disk_after_recovery": on_disk(rec.durability),
        "stamps_moved_by_heals": moved, "launches_a_batch": dropped_counts,
        "stream_host_s": {"events": len(events), "durable": sum(walls),
                          "twin": sum(twin_walls)},
        "stream_host_s_per_event": {"durable": walls, "twin": twin_walls}})
    del rec, twin
    gc.collect()
    shutil.rmtree(root)

    # ---- (c) the router: every tenant recovered from one shared root ----
    data, _ = tenant_data(ctx)
    _, _, batches, _ = tenant_batches(data)
    rng = np.random.default_rng(SEED + 31)
    root = next(roots)
    specs, stores = {}, {}
    router = TenantRouter(DIM, cost, storage_mode="disk", storage_root=root,
                          device=dev)
    for t, (d, cents, asg) in data.items():
        stores[t] = dict(zip(d.chunk_ids.tolist(), d.texts))
        rows_t = {}
        for j in range(ROUTER_INSERTS):
            nid = d.n + j
            v = d.embeddings[int(rng.integers(d.n))] + 0.35 * \
                rng.standard_normal(DIM)
            rows_t[nid] = (v / np.linalg.norm(v)).astype(np.float32)
        specs[t] = (TableEmbedder({**d.embedder.table, **rows_t}, DIM),
                    chunks(stores[t]))
        index_state_from_numpy(
            router.create_tenant(t, *specs[t], slo_s=d.spec.slo_s),
            cents, asg, d.chunk_ids, d.texts, d.embeddings)
    check(len({d.spec.slo_s for d, _, _ in data.values()}) == 1,
          "durability (c): the tenants' SLOs differ")
    handles = router.enable_durability(checkpoint_every=ROUTER_CHECKPOINT)
    logs = {t: logged(h) for t, h in handles.items()}
    # the inserts, an idle gap's drain (their restores and the
    # checkpoints they queued), the removes: the batches then heal what the
    # removes left stale, so recovery replays records past a snapshot
    t0 = time.perf_counter()
    for t, (d, _, _) in data.items():
        for j in range(ROUTER_INSERTS):
            nid = d.n + j
            stores[t][nid] = (f"doc-{nid} " + "tok " * 80)[:300]
            router.tenant(t).insert(nid, stores[t][nid])
    drained = router.maintenance.drain(None)
    for t, (d, _, _) in data.items():
        for cid in rng.choice(d.n, ROUTER_REMOVES, replace=False):
            check(router.tenant(t).remove(int(cid)) is not None,
                  f"durability (c): remove {cid}")
    ops_s = time.perf_counter() - t0
    pre = []
    for b, (tn, embs) in enumerate(batches):
        before = launch_counts()
        ids, vals, _ = router.search_batch(embs, K, NPROBE, tenants=tn)
        got = counts_since(before)
        check(got == want_counts(ivf=len(set(tn)), fp32=1), f"durability "
              f"(c): batch {b} launched {got}")
        pre.append((np.asarray(ids), np.asarray(vals)))
    check(any(op == "checkpoint" for op, _ in drained.executed),
          "durability (c): no checkpoint ran in the drain")
    disk = {t: on_disk(h) for t, h in handles.items()}
    del router, handles
    gc.collect()
    t0 = time.perf_counter()
    router, reps = recover_router(
        root, specs, cost, checkpoint_every=ROUTER_CHECKPOINT,
        router_kwargs={"device": dev},
        tenant_kwargs={"slo_s": data["fiqa"][0].spec.slo_s})
    torch.cuda.synchronize()
    recover_wall = time.perf_counter() - t0
    check(sorted(reps) == sorted(TENANTS), f"durability (c): recovered "
          f"{sorted(reps)}")
    post = []
    for b, (tn, embs) in enumerate(batches):
        before = launch_counts()
        ids, vals, _ = router.search_batch(embs, K, NPROBE, tenants=tn)
        got = counts_since(before)
        check(got == want_counts(ivf=len(set(tn)), fp32=1), f"durability "
              f"(c): recovered batch {b} launched {got}")
        post.append((np.asarray(ids), np.asarray(vals)))
    bitwise(post, pre, "durability (c): the recovered router")
    lines.append({
        "phase": "durability", "scenario": "c_router", "nvidia_smi": smi,
        "records_logged": {t: collections.Counter(op for op, _ in lg)
                           for t, lg in logs.items()},
        "ops_and_drain_host_s": ops_s,
        "drained": collections.Counter(k for k, _ in drained.executed),
        "on_disk_at_drop": disk,
        "reports": {t: r.as_dict() for t, r in reps.items()},
        "recover_wall_s": recover_wall, "bitwise_batches": len(post)})
    check(all(r.replayed_records > 0 for r in reps.values()),
          f"durability (c): a tenant replayed nothing: {reps}")
    del router
    gc.collect()
    shutil.rmtree(root)

    # ---- (d) (a)'s first crashed root recovered on the CPU ---------------
    cpu, rep, recover_t = timed_recover(copy_root, copy_store, "cpu")
    card_state, card_out = card_rec
    check(index_state(cpu) == card_state, "durability (d): the CPU "
          "recovery's state differs from the card's")
    swaps = worst = 0
    for b, embs in enumerate(q_batches):
        ids, vals, _ = cpu.search_batch(embs, K, NPROBE)
        s_, m_ = near_tie_mismatches(card_out[b][0], ids, vals)
        check(m_ == 0, f"durability (d): {m_} ids differ from the card's "
              f"outside near-ties in batch {b}")
        swaps += s_
        same = card_out[b][0] == np.asarray(ids)
        worst = max(worst, float(np.abs(card_out[b][1] - vals)[same].max(
            initial=0.0)))
    check(worst <= score_tol_, f"durability (d): scores {worst} apart, "
          f"over {score_tol_}")
    lines.append({
        "phase": "durability", "scenario": "d_cpu_replay", "nvidia_smi": smi,
        "report": rep.as_dict(), "recover": recover_t,
        "state": "bitwise the card's", "near_tie_swaps": swaps,
        "max_score_diff": worst, "score_tol": score_tol_})
    del cpu
    gc.collect()
    shutil.rmtree(scratch)
    edgerag_mod.slab_topk = saved
    launches = launch_counts()
    return ({"phase": "durability", "nvidia_smi": smi,
             "events": [list(ev) for ev in events], "launches": launches,
             "phase_s": time.perf_counter() - t_phase},
            lines, {m: rec_slab.first[m] for m in ("fp32", "int8")})


def set_mismatches(ids, vals, ref_ids, ref_vals) -> tuple:
    """(swaps, mismatches) of two top-k id lists compared as sets, query by
    query: an id in one list and not the other is a swap across the top-k's
    edge when its score lies within NEAR_TIE of the reference's k-th score,
    else a mismatch.  Swaps count the reference's ids that went missing."""
    swaps = mismatches = 0
    for qi in range(len(ids)):
        edge = ref_vals[qi][-1]
        got, want = set(ids[qi].tolist()), set(ref_ids[qi].tolist())
        for i, v in zip(ref_ids[qi].tolist(), ref_vals[qi]):
            if i not in got:
                near = abs(v - edge) <= NEAR_TIE
                swaps, mismatches = swaps + near, mismatches + (not near)
        for i, v in zip(ids[qi].tolist(), vals[qi]):
            if i not in want and abs(v - edge) > NEAR_TIE:
                mismatches += 1
    return swaps, mismatches


def baselines(ctx) -> tuple:
    """The paper's Table 4 rows 1-2 on the card: ``FlatIndex`` and
    ``IVFIndex`` on the main path's corpus and queries (module docstring,
    ``baselines``).  Returns the phase line and the flat scan's recorded
    K1 call (the corpus on the card, the first batch's queries)."""
    import torch
    from repro_torch.convert import ivf_state_from_numpy
    from repro_torch.core import FlatIndex, IVFIndex

    t_phase = time.perf_counter()
    ds, cost, dev = ctx["ds"], ctx["cost"], ctx["dev"]
    main_ids, main_vals = ctx["main_ids"], ctx["main_vals"]
    n_q = BATCHES * BATCH
    queries = ds.query_embs[:n_q]
    e_dev = torch.from_numpy(ds.embeddings).to(dev)
    tol = score_tol(e_dev, torch.from_numpy(queries).to(dev))

    # ---- flat: one K1 launch a batch of 16 over all 25,000 rows ---------
    flat = FlatIndex(DIM, cost, device=dev)
    flat.add(ds.embeddings, ds.chunk_ids)
    check(flat.memory_bytes() == RECORDS * DIM * 4 and flat.ntotal == RECORDS,
          f"flat index holds {flat.memory_bytes()} bytes, {flat.ntotal} rows")
    torch.cuda.synchronize()
    zero_launches()
    found = [flat.search(queries[b * BATCH:(b + 1) * BATCH], K)
             for b in range(BATCHES)]
    flat_counts = launch_counts()
    check(flat_counts["ivf_topk"] == BATCHES
          and not any(flat_counts["slab_topk"].values())
          and not any(flat_counts["flash_attention"].values())
          and flat_counts["decode_attention"] == 0,
          f"flat searches launched {flat_counts}; want {BATCHES} ivf_topk")
    f_ids = np.concatenate([f[0] for f in found])
    f_vals = np.concatenate([f[1] for f in found])
    cpu_flat = FlatIndex(DIM, cost, device="cpu")
    cpu_flat.add(ds.embeddings, ds.chunk_ids)
    c_ids, c_vals, _ = cpu_flat.search(queries, K)
    flat_swaps, flat_mism = near_tie_mismatches(f_ids, c_ids, c_vals)
    flat_err = float(np.abs(f_vals - c_vals).max())
    check(flat_mism == 0, f"flat: {flat_mism} ids differ from the CPU "
          "outside near-ties")
    check(flat_err <= tol, f"flat scores {flat_err} from the CPU's > {tol}")

    # ---- IVF: the same k-means as the main path's index, on the card ----
    t0 = time.perf_counter()
    ivf = IVFIndex(DIM, cost, device=dev)
    assign = ivf.build(ds.embeddings, ds.chunk_ids, nlist=NLIST, seed=SEED)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    assign_differs = int((assign != ctx["main_assign"]).sum())
    if assign_differs:
        ivf_state_from_numpy(ivf, ctx["main_centroids"], ctx["main_assign"],
                             ds.chunk_ids, ds.embeddings)
    check(ivf.memory_bytes() == (NLIST + RECORDS) * DIM * 4
          and ivf.ntotal == RECORDS,
          f"IVF index holds {ivf.memory_bytes()} bytes, {ivf.ntotal} rows")

    def ivf_run(nprobe):
        out = [ivf.search(queries[qi], K, nprobe) for qi in range(n_q)]
        return (np.concatenate([o[0] for o in out]),
                np.concatenate([o[1] for o in out]), [o[2] for o in out])

    torch.cuda.synchronize()
    zero_launches()
    i_ids, i_vals, i_lats = ivf_run(NPROBE)
    ivf_counts = launch_counts()
    check(ivf_counts["ivf_topk"] == 2 * n_q
          and not any(ivf_counts["slab_topk"].values())
          and not any(ivf_counts["flash_attention"].values())
          and ivf_counts["decode_attention"] == 0,
          f"IVF searches launched {ivf_counts}; want {2 * n_q} ivf_topk "
          "(a probe and a scan a query)")
    # §6.3.1 on the card: the IVF baseline retrieves what EdgeRAG did
    ivf_swaps, ivf_mism = set_mismatches(i_ids, i_vals, main_ids, main_vals)
    ivf_err = float(np.abs(i_vals - main_vals).max())
    check(ivf_mism == 0, f"IVF: {ivf_mism} ids differ as sets from the main "
          "path's EdgeRAG retrieval outside near-ties")
    check(ivf_err <= tol, f"IVF scores {ivf_err} from the main path's > {tol}")
    bitwise = int(sum(np.array_equal(i_vals[qi], main_vals[qi])
                      and np.array_equal(i_ids[qi], main_ids[qi])
                      for qi in range(n_q)))

    # ---- recall@10 of IVF against flat as nprobe grows ------------------
    zero_launches()
    recall = {}
    for nprobe in RECALL_NPROBES:
        ids = i_ids if nprobe == NPROBE else ivf_run(nprobe)[0]
        recall[nprobe] = float(np.mean([
            len(set(ids[qi].tolist()) & set(f_ids[qi].tolist())) / K
            for qi in range(n_q)]))
    sweep = topk_calls()["ivf_topk"]
    want_sweep = 2 * n_q * (len(RECALL_NPROBES) - 1)
    check(sweep == want_sweep, f"recall sweep: {sweep} ivf_topk launches, "
          f"want {want_sweep}")
    rs = [recall[n] for n in RECALL_NPROBES]
    check(rs == sorted(rs), f"recall@{K} decreases as nprobe grows: {recall}")
    check(recall[NLIST] >= 0.999, f"recall@{K} at nprobe {NLIST} "
          f"(every cluster) {recall[NLIST]} < 0.999")

    walls = [lat.wall_s for lat in i_lats]
    out = {"phase": "baselines", "records": RECORDS, "dim": DIM, "k": K,
           "flat": {"memory_bytes": flat.memory_bytes(),
                    "batches": BATCHES, "batch": BATCH,
                    "wall_s_per_batch": [f[2].wall_s for f in found],
                    "modeled_l2_s": found[0][2].l2_mem_load_s
                    + found[0][2].l2_search_s,
                    "launches": flat_counts["ivf_topk"],
                    "cpu_near_tie_swaps": flat_swaps,
                    "cpu_max_abs_err": flat_err, "score_tol": tol},
           "ivf": {"nlist": ivf.nlist, "nprobe": NPROBE,
                   "memory_bytes": ivf.memory_bytes(), "build_s": build_s,
                   "assign_differs_from_main_path": assign_differs,
                   "queries": n_q, "wall_s_per_query": {
                       "mean": float(np.mean(walls)),
                       "median": float(np.median(walls)),
                       "first": walls[0], "max": float(max(walls))},
                   "launches": ivf_counts["ivf_topk"],
                   "vs_edgerag_near_tie_swaps": ivf_swaps,
                   "vs_edgerag_max_abs_err": ivf_err,
                   "vs_edgerag_bitwise_queries": bitwise},
           "recall_at_k_vs_flat": {str(n): r for n, r in recall.items()},
           "recall_sweep_launches": sweep,
           "phase_s": time.perf_counter() - t_phase}
    return out, (e_dev, torch.from_numpy(queries[:BATCH]).to(dev))


def check_attention(rec_flash, rec_dec, dense_calls, swa_calls,
                    moe_calls, dev) -> dict:
    """The attention kernels against their plain versions on the card
    (module docstring, ``kernels_checked``); ``dense_calls``: the first K5
    and K6 calls of ``dense_archs`` (a); ``swa_calls``: those of
    ``swa_gemma3`` (a), by window and by cache; ``moe_calls``: those of
    ``moe_archs`` (a)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.decode_attention import (
        decode_attention, decode_attention_q8, decode_attention_q8_ref)
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import init_cache, init_params, prefill
    from repro_torch.models.quantization import dequantize_kv, quantize_kv

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
    # yi-9b's (head dim 128, 32 heads over 4)
    (q, k, v), kw = dense_calls["flash"]
    flash_case("yi_9b", q, k, v, **kw)
    (q, k, v, lens), kw = dense_calls["decode"]
    decode_case("yi_9b", q, k, v, lens, **kw)
    # gemma3-12b's (head dim 256, 16 heads over 8): K5 with its window and
    # causal-global, K6 over a 1,024-row ring and the 2,064-row cache
    for kind in ("swa", "global"):
        (q, k, v), kw = swa_calls["flash"][kind]
        flash_case(f"gemma3_12b_{kind}", q, k, v, **kw)
    for kind in ("ring", "global"):
        (q, k, v, lens), kw = swa_calls["decode"][kind]
        decode_case(f"gemma3_12b_{kind}", q, k, v, lens, **kw)
    # olmoe-1b-7b's (head dim 128, 16 heads, MHA)
    (q, k, v), kw = moe_calls["flash"]
    flash_case("olmoe_1b_7b", q, k, v, **kw)
    (q, k, v, lens), kw = moe_calls["decode"]
    decode_case("olmoe_1b_7b", q, k, v, lens, **kw)
    # head dim 256 at gemma3's prefill shape with its window, f32 and bf16;
    # causal without a window; ragged non-causal
    q256, k256, v256 = (rand(1, 2048, n, 256) for n in (16, 8, 8))
    flash_case("d256_window", q256, k256, v256, True, 1024)
    flash_case("d256_window_bf16", q256.bfloat16(), k256.bfloat16(),
               v256.bfloat16(), True, 1024)
    flash_case("d256_causal", q256[:, :300], k256[:, :300], v256[:, :300],
               True)
    qr, kr, vr = rand(3, 150, 16, 256), rand(3, 77, 8, 256), \
        rand(3, 77, 8, 256)
    ragged256 = flash_case("d256_ragged", qr, kr, vr, False)
    # K6 at head dim 256: a 1,024-row ring (every row valid), a 2,064-row
    # cache at the engine's first length, per-slot lengths, a window, bf16
    qd, rk, rv = rand(4, 1, 16, 256), rand(4, 1024, 8, 256), \
        rand(4, 1024, 8, 256)
    decode_case("d256_ring", qd, rk, rv, 2064)
    decode_case("d256_global", qd[:1], rand(1, 2064, 8, 256),
                rand(1, 2064, 8, 256), 2049)
    mixed256 = torch.tensor([2064, 1, 700, 1024], dtype=torch.int32,
                            device=dev)
    dec256 = decode_case("d256_mixed", qd, rk, rv, mixed256)
    decode_case("d256_window", qd, rk, rv, mixed256, 300)
    decode_case("d256_bf16", qd.bfloat16(), rk.bfloat16(), rv.bfloat16(),
                mixed256)
    # K7 at head dim 256: within the bound of its plain version, and K6's
    # bits on the dequantized cache
    ck, cv = quantize_kv(rk), quantize_kv(rv)
    got = decode_attention_q8(qd, ck.q, ck.scale, cv.q, cv.scale, mixed256)
    held("decode_attention_q8_d256", got, decode_attention_q8_ref(
        qd[:, 0], ck.q, ck.scale, cv.q, cv.scale, mixed256)[:, None],
        {"shape": list(qd.shape), "cache": list(ck.q.shape),
         "lengths": mixed256.tolist(), "window": 0})
    check(torch.equal(got, decode_attention(qd, dequantize_kv(ck),
                                            dequantize_kv(cv), mixed256)),
          "decode_attention_q8 at D = 256: not K6's bits on the dequantized "
          "cache")
    out["decode_attention_q8_d256"]["k6_bits_on_dequantized"] = True
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
    for i in range(3):
        one = flash_attention(qr[i:i + 1], kr[i:i + 1], vr[i:i + 1],
                              causal=False)
        check(torch.equal(one[0], ragged256[i]),
              f"flash_attention at D = 256: batch != sequential at row {i}")
    for i in range(4):
        one = decode_attention(qd[i:i + 1], rk[i:i + 1], rv[i:i + 1],
                               mixed256[i:i + 1])
        check(torch.equal(one[0], dec256[i]),
              f"decode_attention at D = 256: batch != sequential at slot {i}")

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
    rows = []
    for name, shape, causal, n_launch in (
            ("flash_attention", "prefill", True,
             launches["flash_attention_causal"]),
            ("flash_attention_encode", "encode", False,
             launches["flash_attention_encode"])):
        (q, k, v), _ = rec_flash.first[causal]
        rows.append(k5_row(name, q, k, v, causal, n_launch,
                           checked[f"flash_attention_{shape}"]["max_abs_err"],
                           k5_dev[shape]))
    (q, kc, vc, lens), _ = rec_dec.first[None]
    rows.append(k6_row("decode_attention", q, kc, vc, lens,
                       launches["decode_attention"],
                       checked["decode_attention_decode"]["max_abs_err"],
                       k6_dev))
    return rows


def flash_mask(sq: int, skv: int, causal: bool, window: int, device):
    """The (Sq, Skv) boolean mask of the pairs K5 attends, positions from 0
    for q and for k."""
    import torch
    qp = torch.arange(sq, device=device)[:, None]
    kp = torch.arange(skv, device=device)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        ok &= kp <= qp
    if window:
        ok &= kp > qp - window
    return ok


def flash_library(q, k, v, causal, window):
    """K5's yardstick: ``scaled_dot_product_attention`` with the same
    mask (``is_causal``, or a boolean mask under a window)."""
    if not window:
        return lambda: sdpa(q, k, v, is_causal=causal)
    mask = flash_mask(q.shape[1], k.shape[1], causal, window, q.device)
    return lambda: sdpa(q, k, v, attn_mask=mask)


def k5_call(q, k, v, causal, window: int = 0, with_lse: bool = False):
    """One call of K5 at an input: the serving entry (``flash_attention``
    with no grad), or with ``with_lse`` the entry that also writes the
    rows' log-sum-exp, which the training forward launches."""
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.flash_attention import ops as fa_ops
    if with_lse:
        return lambda: fa_ops._launch(q, k, v, causal, window,
                                      with_lse=True)
    return lambda: flash_attention(q, k, v, causal=causal, window=window)


def k5_row(name, q, k, v, causal, launches, err, k5_dev,
           window: int = 0, with_lse: bool = False) -> dict:
    """A ``kernels`` line row of K5 at one input; bound and library as in
    :func:`attention_rows` (the pairs under the window, if any, and SDPA
    with its mask); ``k5_dev``: :func:`k5_device_ms_at` at it, with the
    same ``with_lse``, which times the training entry (:func:`k5_call`)
    and adds the serving entry's device ms beside it."""
    (b, sq, h, d), skv = q.shape, k.shape[1]
    pairs = int(flash_mask(sq, skv, causal, window, "cpu").sum())
    lim = bound((2 * q.numel() + k.numel() + v.numel()) * q.element_size(),
                4 * b * h * d * pairs, F32_TC_FLOPS_PER_S)
    return {
        "name": name, "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
        "launches": launches, "max_abs_err": err,
        "ms": cuda_ms(k5_call(q, k, v, causal, window, with_lse), 200),
        "plain_ms": cuda_ms(lambda: flash_plain(q, k, v, causal, window),
                            10),
        "bound_ms": lim[0], "bound_by": lim[1],
        "library_ms": cuda_ms(flash_library(q, k, v, causal, window), 200),
        "device_ms": k5_dev["flash_attention"]["device_ms_per_call"],
        "library_device_ms": k5_dev["sdpa"]["device_ms_per_call"],
        **({"serving_entry_device_ms":
            k5_dev["serving_entry"]["device_ms_per_call"]}
           if with_lse else {})}


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
    out = {}
    for shape, causal in (("prefill", True), ("encode", False)):
        (q, k, v), _ = rec_flash.first[causal]
        out[shape] = k5_device_ms_at(q, k, v, causal, calls)
    return out


def k5_device_ms_at(q, k, v, causal, calls: int = 100,
                    window: int = 0, with_lse: bool = False) -> dict:
    """Device ms per call of K5 (:func:`k5_call`) and of
    ``scaled_dot_product_attention`` (GQA through ``enable_gqa``) with the
    same mask at one input; with ``with_lse`` K5 is the training entry and
    ``serving_entry`` the serving one."""
    runs = {"flash_attention": k5_call(q, k, v, causal, window, with_lse),
            "sdpa": flash_library(q, k, v, causal, window)}
    if with_lse:
        runs["serving_entry"] = k5_call(q, k, v, causal, window)
    return device_ms(runs, calls)


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


def bwd_ptxas(lines) -> object:
    """``ptxas``'s registers and spill stores per entry of K5's backward
    (``flash_bwd_prep``, and ``flash_bwd_dkv`` / ``flash_bwd_dq`` at head
    dims 64, 80, 128, 256: 9), checking that none spills; "not rebuilt"
    when the library was built before this run."""
    import re
    if not lines:
        return "not rebuilt in this run"
    out = {}
    for ln in lines:
        kind = re.search(r"flash_bwd_(prep|dkv|dq)(?:ILi(\d+)E)?", ln)
        regs = re.search(r"Used (\d+) registers", ln)
        spill = re.search(r"(\d+) bytes spill stores", ln)
        check(kind and regs and spill, f"unread ptxas line: {ln}")
        key = kind[1] if kind[2] is None else f"{kind[1]} D={kind[2]}"
        out[key] = [int(regs[1]), int(spill[1])]
    check(len(out) == 9, f"flash_attention_bwd: {len(out)} entries, not 9")
    spilled = {k: v for k, v in out.items() if v[1]}
    check(not spilled, f"flash_attention_bwd spills: {spilled}")
    return {"registers_and_spill_bytes": out}


def bwd_bound(q, k, causal: bool, window: int) -> tuple:
    """:func:`bound` of K5's backward at q (B, Sq, H, D), k (B, Skv, KH,
    D): q, k, v, out, dout, lse read once and dq, dk, dv written once,
    against the five products (S, dP, dV, dK, dQ: 2 FLOP a pair and dim
    each) at the card's fp32-accurate peak, 3xTF32 on the tensor cores
    (as for K5's forward), whatever unit the kernel runs them on."""
    (b, sq, h, d), skv = q.shape, k.shape[1]
    nbytes = (4 * q.numel() + 4 * k.numel() + b * h * sq) * 4
    pairs = int(flash_mask(sq, skv, causal, window, "cpu").sum())
    return bound(nbytes, 10 * b * h * d * pairs, F32_TC_FLOPS_PER_S)


def bwd_check(dev, name: str, shape: tuple, seed: int) -> tuple:
    """K5's backward (``flash_attention_bwd``) at one shape on the card,
    against ``flash_attention_bwd_ref`` on the same inputs (q, k, v, dout
    ~ N(0, 1); out and lse from K5 asked for its lse, whose output must be
    bitwise K5's without it; the lse within :func:`attn_tol` of the plain
    one on the rows with a valid key).  dq, dk and dv within ``BWD_TOL``
    relative Frobenius; a second call bitwise the first.  Returns (its
    entry, the inputs)."""
    import torch
    from repro_torch.kernels.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_ref, flash_attention_lse_ref)
    from repro_torch.kernels.flash_attention import ops as fa_ops
    b, sq, skv, h, kh, d, causal, window = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, h, d), device=dev, generator=g)
    k, v = (torch.randn((b, skv, kh, d), device=dev, generator=g)
            for _ in range(2))
    dout = torch.randn((b, sq, h, d), device=dev, generator=g)
    out0, _ = fa_ops._launch(q, k, v, causal, window)
    out, lse = fa_ops._launch(q, k, v, causal, window, with_lse=True)
    check(torch.equal(out, out0), f"{name}: K5's output with its lse is "
          f"not bitwise its output without")
    heads = lambda *ts: [t.transpose(1, 2) for t in ts]
    lse_ref = flash_attention_lse_ref(*heads(q, k), causal=causal,
                                      window=window)
    live = lse_ref > -1e29
    dead = int((~live).sum()) // (b * h)
    lse_err = float((lse - lse_ref)[live].abs().max())
    check(lse_err <= attn_tol(d), f"{name}: lse error {lse_err}")
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                              window=window)
    want = heads(*flash_attention_bwd_ref(*heads(q, k, v, out), lse,
                                          *heads(dout), causal=causal,
                                          window=window))
    err = {}
    for gname, a, w in zip(("dq", "dk", "dv"), got, want):
        rel = float(torch.linalg.norm(a - w)) / max(
            float(torch.linalg.norm(w)), 1e-30)
        err[gname] = {"rel_frobenius": rel,
                      "max_abs": float((a - w).abs().max())}
        check(rel <= BWD_TOL, f"{name}: {gname} relative error {rel} > "
              f"{BWD_TOL}")
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal,
                                window=window)
    check(all(torch.equal(x, y) for x, y in zip(again, got)),
          f"{name}: two calls differ")
    torch.cuda.synchronize()
    entry = {"shape_b_sq_skv_h_kh_d": [b, sq, skv, h, kh, d],
             "causal": causal, "window": window, "rows_with_no_key": dead,
             "lse_max_abs_err": lse_err, "err": err, "tol": BWD_TOL,
             "ms": cuda_ms(lambda: flash_attention_bwd(
                 q, k, v, out, lse, dout, causal=causal, window=window),
                 5 if sq * skv > 1 << 22 else 50)}
    return entry, (q, k, v, out, lse, dout)


def sdpa_bwd(q, k, v, dout, causal: bool):
    """The yardstick of K5's backward: autograd's backward of
    ``scaled_dot_product_attention`` (fp32, ``is_causal``) at the same
    inputs, the forward run once outside the timed call."""
    import torch
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = sdpa(qs, ks, vs, is_causal=causal)
    return lambda: torch.autograd.grad(out, (qs, ks, vs), dout,
                                       retain_graph=True)


def train_lm(ctx) -> tuple:
    """The training path (``repro_torch.train``): K5's backward against its
    plain version at ``BWD_SHAPES``; (b) TRAIN_ARCH's first PARITY_LAYERS
    layers at full width, the loss and every gradient on the card against
    the CPU; (c) TRAIN_ARCH at full width taking TRAIN_STEPS AdamW steps;
    (d) the overfit of ``tests/test_serving_train.py`` on the card against
    the CPU.  Returns (the phase's line, its ``kernels`` rows)."""
    import copy
    import dataclasses
    import gc
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_ref)
    from repro_torch.launch.train import synthetic_lm_batch
    from repro_torch.models import init_params, loss_fn, param_count
    from repro_torch.train import make_train_step, train_state_init

    dev, smi = ctx["dev"], ctx["smi"]
    t_phase = time.perf_counter()
    cpu = torch.device("cpu")

    def counts():
        return {"flash_attention": dict(flash_attention.launches_by_mask),
                "flash_attention_windowed":
                    flash_attention.launches_windowed,
                "flash_attention_bwd": flash_attention_bwd.launches}

    def want(fwd, bwd):
        return {"flash_attention": {"causal": fwd, "non_causal": 0},
                "flash_attention_windowed": 0, "flash_attention_bwd": bwd}

    # ---- (a) the backward kernel against its plain version ------------
    checks, full_inputs = {}, None
    for i, (name, shape) in enumerate(BWD_SHAPES.items()):
        checks[name], inputs = bwd_check(dev, name, shape, SEED + i)
        if name == "stablelm_1p6b":
            full_inputs = inputs
        del inputs
    check(checks["masked_rows"]["rows_with_no_key"] > 0,
          "masked_rows has no row without a key")
    q, k, v, out, lse, dout = full_inputs
    full = BWD_SHAPES["stablelm_1p6b"]
    bwd_fn = lambda: flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=True)
    lib_fn = sdpa_bwd(q, k, v, dout, True)
    bwd_dev = device_ms({"flash_attention_bwd": bwd_fn,
                         "sdpa_bwd": lib_fn}, 10)
    lim = bwd_bound(q, k, True, 0)
    plain_ms = cuda_ms(lambda: flash_attention_bwd_ref(
        *(t.transpose(1, 2) for t in (q, k, v, out)), lse,
        dout.transpose(1, 2), causal=True), 2)
    bwd_row = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
        "gradient_of": "K5: port only, the JAX package differentiates "
                       "plain jnp",
        "launches": 0, "max_abs_err": max(
            e["max_abs"] for e in checks["stablelm_1p6b"]["err"].values()),
        "ms": cuda_ms(bwd_fn, 10), "plain_ms": plain_ms,
        "bound_ms": lim[0], "bound_by": lim[1],
        "library_ms": cuda_ms(lib_fn, 10),
        "device_ms": bwd_dev["flash_attention_bwd"]["device_ms_per_call"],
        "library_device_ms": bwd_dev["sdpa_bwd"]["device_ms_per_call"],
        "shape": list(full)}
    k5_err = attn_err(k5_call(q, k, v, True, with_lse=True)()[0],
                      flash_plain(q, k, v, True))[0]
    k5_dev = k5_device_ms_at(q, k, v, True, with_lse=True)
    k5_rec = (q, k, v, k5_err, k5_dev)
    del full_inputs, out, lse, dout, lib_fn
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) PARITY_LAYERS layers at full width, card vs CPU ----------
    cfg = get_config(TRAIN_ARCH)
    cut = dataclasses.replace(cfg, num_layers=PARITY_LAYERS)
    t0 = time.perf_counter()
    m_cpu = init_params(cut, seed=SEED, device="cpu")
    m_card = copy.deepcopy(m_cpu).to(dev)
    init_s = time.perf_counter() - t0
    toks = torch.randint(0, cfg.vocab_size, (TRAIN_PARITY_BATCH,
                                             TRAIN_PARITY_SEQ + 1),
                         generator=torch.Generator().manual_seed(SEED))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    grads, losses, secs = {}, {}, {}
    zero_launches()
    for where, m in (("cpu", m_cpu), ("card", m_card)):
        m.requires_grad_(True)
        b = {key: t.to(m.device) for key, t in batch.items()}
        t0 = time.perf_counter()
        loss, _ = loss_fn(m, b)
        grads[where] = torch.autograd.grad(loss, list(m.parameters()))
        losses[where] = float(loss.detach())
        if where == "card":
            torch.cuda.synchronize()
        secs[where] = time.perf_counter() - t0
    parity_counts = counts()
    check(parity_counts == want(2 * PARITY_LAYERS, PARITY_LAYERS),
          f"parity launches {parity_counts}")
    loss_err = abs(losses["card"] - losses["cpu"]) / losses["cpu"]
    check(loss_err <= TRAIN_LOSS_TOL, f"parity loss {losses}")
    worst = ("", 0.0)
    for (pname, _), a, w in zip(m_cpu.named_parameters(), grads["card"],
                                grads["cpu"]):
        rel = float(torch.linalg.norm(a.cpu() - w)) / max(
            float(torch.linalg.norm(w)), 1e-30)
        worst = max(worst, (pname, rel), key=lambda x: x[1])
    check(worst[1] <= TRAIN_GRAD_TOL, f"parity gradient {worst}")
    parity = {"layers": PARITY_LAYERS, "tokens": [TRAIN_PARITY_BATCH,
                                                  TRAIN_PARITY_SEQ],
              "params": param_count(m_cpu), "init_s": init_s,
              "loss": losses, "loss_rel_err": loss_err,
              "loss_tol": TRAIN_LOSS_TOL,
              "worst_grad": {"param": worst[0], "rel_frobenius": worst[1]},
              "grad_tol": TRAIN_GRAD_TOL, "seconds": secs,
              "launches": parity_counts}
    del m_cpu, m_card, grads
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (c) full width, TRAIN_STEPS AdamW steps -----------------------
    allocated_before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = init_params(cfg, seed=SEED, device=dev)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_params = param_count(model)
    state = train_state_init(model)
    params = list(model.parameters())
    start = [p.detach().clone() for p in params]
    step = make_train_step(cfg, peak_lr=TRAIN_LR)
    rng = np.random.default_rng(SEED)
    batches = [synthetic_lm_batch(rng, cfg, TRAIN_BATCH, TRAIN_SEQ + 1,
                                  device=dev)
               for _ in range(TRAIN_STEPS + 1)]
    metrics, step_s = [], []
    zero_launches()
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batches[i])
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        metrics.append(m)
        if i == 0:
            check(all(torch.equal(p, s) for p, s in zip(params, start)),
                  "step 0 (lr 0) moved a parameter")
    full_counts = counts()
    layers = cfg.num_layers
    check(full_counts == want(2 * layers * TRAIN_STEPS, layers * TRAIN_STEPS),
          f"full-width launches {full_counts}")
    unmoved = [n for (n, p), s in zip(model.named_parameters(), start)
               if torch.equal(p, s)]
    check(not unmoved, f"parameters not moved by step 2: {unmoved}")
    check(all(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"])
              and m["grad_norm"] > 0 for m in metrics),
          f"non-finite or zero metrics {metrics}")
    ln_v = math.log(cfg.vocab_size)
    check(abs(metrics[0]["loss"] - ln_v) <= 0.5,
          f"step 0 loss {metrics[0]['loss']}, ln(vocab) {ln_v}")
    peak = torch.cuda.max_memory_allocated()
    del start
    holder = [state]

    def one_step():
        holder[0], _ = step(holder[0], batches[TRAIN_STEPS])

    prof = profiled(one_step, events=True)
    split = {"k5_forward": 0.0, "k5_backward": 0.0, "gemm": 0.0, "rest": 0.0}
    for ev, (_, ms) in prof.pop("events").items():
        low = ev.lower()
        key = ("k5_forward" if "flash_fwd" in ev else
               "k5_backward" if "flash_bwd" in ev else
               "gemm" if "gemm" in low or "gemv" in low else "rest")
        split[key] += ms
    steady = step_s[1:]
    full_width = {
        "arch": cfg.name, "layers": layers, "d_model": cfg.d_model,
        "heads": [cfg.num_heads, cfg.head_dim], "d_ff": cfg.d_ff,
        "vocab": cfg.vocab_size, "params": n_params,
        "param_bytes": n_params * 4, "tokens": [TRAIN_BATCH, TRAIN_SEQ],
        "peak_lr": TRAIN_LR, "draw_s": draw_s,
        "allocated_before_bytes": allocated_before,
        "metrics": metrics, "ln_vocab": ln_v, "step_s": step_s,
        "s_per_step_1_2": sum(steady) / len(steady),
        "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * len(steady) / sum(steady),
        "max_memory_allocated": peak, "launches": full_counts,
        "profiled_step": {**prof, "device_ms_split": split}}
    del state, holder, one_step, model, params, batches, step
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (d) the overfit, card vs CPU ----------------------------------
    small = cfg.reduced(num_layers=2, d_model=128)
    toks = np.random.default_rng(0).integers(0, small.vocab_size, (2, 33))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(torch.int32),
             "labels": torch.from_numpy(toks[:, 1:]).to(torch.int32)}
    losses, fit_s = {}, {}
    for where, device in (("cpu", cpu), ("card", dev)):
        state = train_state_init(init_params(small, seed=SEED,
                                             device="cpu").to(device))
        step = make_train_step(small, peak_lr=TRAIN_LR,
                               total_steps=OVERFIT_TOTAL)
        b = {key: t.to(device) for key, t in batch.items()}
        zero_launches()
        t0 = time.perf_counter()
        losses[where] = []
        for _ in range(OVERFIT_STEPS):
            state, m = step(state, b)
            losses[where].append(m["loss"])
        fit_s[where] = time.perf_counter() - t0
        fit_counts = counts()
    check(fit_counts == want(2 * 2 * OVERFIT_STEPS, 2 * OVERFIT_STEPS),
          f"overfit launches {fit_counts}")
    fit = losses["card"]
    check(fit[-1] < 0.7 * fit[0], f"no overfit on the card: {fit[::8]}")
    drift = max(abs(a - w) / (1 + abs(w))
                for a, w in zip(fit, losses["cpu"]))
    check(drift <= OVERFIT_TOL, f"overfit card vs CPU drift {drift}")
    overfit = {"arch": small.name, "steps": OVERFIT_STEPS,
               "total_steps": OVERFIT_TOTAL, "losses_card": fit,
               "losses_cpu_first_last": [losses["cpu"][0],
                                         losses["cpu"][-1]],
               "max_drift": drift, "tol": OVERFIT_TOL, "seconds": fit_s,
               "launches": fit_counts}

    bwd_row["launches_by_phase"] = {
        "train_lm_full_width": full_counts["flash_attention_bwd"],
        "train_lm_parity": parity_counts["flash_attention_bwd"],
        "train_lm_overfit": fit_counts["flash_attention_bwd"]}
    bwd_row["launches"] = sum(bwd_row["launches_by_phase"].values())
    q, k, v, k5_err, k5_dev = k5_rec
    fwd_by_phase = {
        "train_lm_full_width": full_counts["flash_attention"]["causal"]}
    k5_train = k5_row("flash_attention_stablelm_1p6b_train", q, k, v, True,
                      sum(fwd_by_phase.values()), k5_err, k5_dev,
                      with_lse=True)
    k5_train["launches_by_phase"] = fwd_by_phase
    line = {"phase": "train_lm", "nvidia_smi": smi,
            "bwd_checks": checks, "bwd_full_width": bwd_row,
            "bwd_vs_sdpa_device": bwd_dev, "parity": parity,
            "full_width": full_width, "overfit": overfit,
            "phase_s": time.perf_counter() - t_phase}
    return line, [bwd_row, k5_train]


def main() -> int:
    import gc
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
    bwd_ptx = bwd_ptxas(_build.ptxas_report.get("flash_attention_bwd"))
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "python": sys.version.split()[0], "torch": torch.__version__,
          "cuda": torch.version.cuda, "build_s": build_s,
          "build_s_per_kernel": per_kernel_s,
          "flash_attention_ptxas": k5_ptxas, "topk_tiled_ptxas": topk_ptxas,
          "decode_attention_ptxas": k6_ptxas,
          "flash_attention_bwd_ptxas": bwd_ptx,
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

    finished = []                 # each batch's (ids, scores), for baselines

    def finish_logged(state, finish=index.search_finish):
        out = finish(state)
        finished.append((np.array(out[0]), np.array(out[1])))
        return out

    index.search_finish = finish_logged
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
    del index.search_finish
    main_ids = np.concatenate([ids for ids, _ in finished])
    main_vals = np.concatenate([vals for _, vals in finished])

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
    check(len(finished) == BATCHES and main_ids.tolist()
          == [r.chunk_ids for r in flat], "the logged retrieval is not the "
          "responses'")

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

    # ---- the assigned dense configs: yi-9b behind the main index --------
    dense, dense_calls = dense_archs({
        "ds": ds, "cost": cost, "dev": dev, "smi": smi, "index": index,
        "main_ids": main_ids, "main_vals": main_vals})
    emit(dense)

    # ---- gemma3-12b: sliding-window layers behind the main index --------
    swa, swa_calls = swa_gemma3({
        "ds": ds, "cost": cost, "dev": dev, "smi": smi, "index": index,
        "main_ids": main_ids, "main_vals": main_vals})
    emit(swa)

    # ---- the MoE configs: olmoe-1b-7b behind the main index -------------
    moe, moe_calls = moe_archs({
        "ds": ds, "cost": cost, "dev": dev, "smi": smi, "index": index,
        "main_ids": main_ids, "main_vals": main_vals})
    emit(moe)

    # ---- rwkv6-1.6b: the attention-free generator behind the main index -
    rwkv = rwkv6_arch({
        "ds": ds, "cost": cost, "dev": dev, "smi": smi, "index": index,
        "main_ids": main_ids, "main_vals": main_vals})
    emit(rwkv)

    # ---- zamba2-2.7b: Mamba2 layers and one shared attention block -------
    (q5, k5_, _), _ = rec_flash.first[True]
    (q6, k6_, _, _), _ = rec_dec.first[None]
    hybrid = hybrid_zamba2({
        "ds": ds, "cost": cost, "dev": dev, "smi": smi, "index": index,
        "main_ids": main_ids, "main_vals": main_vals,
        "main_shapes": {"k5": [list(q5.shape), list(k5_.shape)],
                        "k6": [list(q6.shape), list(k6_.shape)]}})
    emit(hybrid)

    # ---- the Table 4 baselines on the main path's corpus ----------------
    base, flat_call = baselines({"ds": ds, "cost": cost, "dev": dev,
                                 "main_ids": main_ids, "main_vals": main_vals,
                                 "main_centroids": index.centroids,
                                 "main_assign": assign})
    emit(base)

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
    ten = tenancy({"ds": ds, "cost": cost, "dev": dev, "gen": gen,
                   "main_centroids": index.centroids, "main_assign": assign})
    ten_call = ten.pop("record")
    emit(ten)
    dur, dur_lines, dur_calls = durability({
        "ds": ds, "cost": cost, "dev": dev, "smi": smi,
        "main_centroids": index.centroids, "main_assign": assign})
    for line in dur_lines:
        emit(line)
    emit(dur)
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
         True),
        ("tenancy", ten["launches"], False),
        ("durability", dur["launches"], False),
        ("dense_archs", {n: dense["yi_9b"]["launches"][n]
                         for n in ("ivf_topk", "slab_topk")}, False),
        ("swa_gemma3", {n: swa["gemma3_12b"]["launches"][n]
                        for n in ("ivf_topk", "slab_topk")}, False),
        ("moe_archs", {n: moe["olmoe_1b_7b"]["launches"][n]
                       for n in ("ivf_topk", "slab_topk")}, False),
        ("rwkv6_arch", {n: rwkv["rwkv6_1p6b"]["launches"][n]
                        for n in ("ivf_topk", "slab_topk")}, False),
        ("hybrid_zamba2", hybrid["zamba2_2p7b"]["launches"], False),
        ("baselines", {"ivf_topk": base["ivf"]["launches"],
                       "ivf_topk_flat": base["flat"]["launches"]}, False)])

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

    # ivf_topk over the whole corpus (baselines' flat scan): 64-row tiles
    fe, fq = flat_call
    tolf = score_tol(fe, fq)
    kv, ki = topk_ip(fe, fq, K)
    pv, pi = topk_ip_ref(fe, fq, K)
    errf = float((kv - pv).abs().max())
    check(errf <= tolf, f"ivf_topk (flat) error {errf} > {tolf}")
    fullf = (fq.double() @ fe.double().T).cpu().numpy()
    nf = isolated_ids_equal(kv.cpu().numpy(), ki.cpu().numpy(),
                            pi.cpu().numpy(), fullf, tolf)
    for i in range(fq.shape[0]):
        s = topk_ip(fe, fq[i:i + 1], K)
        check(torch.equal(s[0][0], kv[i]) and torch.equal(s[1][0], ki[i]),
              "ivf_topk (flat) batch != sequential")
    report["ivf_topk_flat"] = {"max_abs_err": errf, "tol": tolf,
                               "ids_checked": nf}

    # slab_topk (fp32)
    report["slab_topk"] = check_slab_fp32(e2, q2, v2, k2, "slab_topk")
    ei, qi_ = rint(e2.shape, -3, 4), rint(q2.shape, -2, 3)
    a, b = slab_topk(ei, qi_, v2, k2), slab_topk_ref(ei, qi_, v2, k2)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "slab_topk integer inputs not bitwise equal to the plain version")
    ones = torch.ones_like(e2)
    a, b = slab_topk(ones, torch.ones_like(q2), v2, k2), \
        slab_topk_ref(ones, torch.ones_like(q2), v2, k2)
    check(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]),
          "slab_topk all-tie rows")
    ev, er = slab_topk(e2[:0], q2, v2[:, :0], k2)
    check(bool(torch.isinf(ev).all() and (er == ROW_PAD).all()),
          "slab_topk empty slab")
    a = slab_topk(ei[:5], qi_, v2[:, :5], k2)
    b = slab_topk_ref(ei[:5], qi_, v2[:, :5].contiguous(), 5)
    check(bool((a[1][:, 5:] == ROW_PAD).all()
               and torch.equal(a[1][:, :5], b[1])), "slab_topk k > N")
    # the fused call of tenancy (a)'s first batch: both tenants' clusters
    (et, qt, vt, kt), _ = ten_call
    report["slab_topk_tenancy"] = check_slab_fp32(et, qt, vt, kt,
                                                  "slab_topk (tenancy)")
    # the recovered indexes' first calls (durability (a) and (b))
    (ed, qd, vd, kd), _ = dur_calls["fp32"]
    report["slab_topk_durability"] = check_slab_fp32(
        ed, qd, vd, kd, "slab_topk (durability)")
    (ed, qd, vd, kd), kwd = dur_calls["int8"]
    report["slab_topk_int8_durability"] = check_quantized(
        "int8", ed, qd, vd, kd, kwd, rint)
    for mode in CODECS:
        (e, q, v, k), kw = rec_slab.first[mode]
        report[f"slab_topk_{mode}"] = check_quantized(mode, e, q, v, k, kw,
                                                      rint)
    report["slab_topk_wide_rows"] = check_wide_rows(dev, rint)
    report.update(check_attention(rec_flash, rec_dec, dense_calls,
                                  swa_calls, moe_calls, dev))
    emit({"phase": "kernels_checked",
          "ivf_topk_shape": [*e1.shape, q1.shape[0], k1],
          "ivf_topk_flat_shape": [*fe.shape, fq.shape[0], K],
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
                          lambda: torch.topk(q1 @ e1.T, k1)),
             "ivf_topk_flat": (lambda: topk_ip(fe, fq, K),
                               lambda: torch.topk(fq @ fe.T, K))}
    for mode, ((e, q, v, k), kw) in slab_inputs.items():
        calls["slab_topk" if mode == "fp32" else f"slab_topk_{mode}"] = (
            lambda e=e, q=q, v=v, k=k, kw=kw: slab_topk(e, q, v, k, **kw),
            topk_library(mode, e, q, v, k, kw))
    topk_dev = device_ms({f"{name}{tag}": fn for name, pair in calls.items()
                          for tag, fn in zip(("", "_library"), pair)}, 100)
    for name in calls:
        one_kernel_event(topk_dev, name, TILED_EVENTS[
            {"slab_topk": "slab_topk_fp32",
             "ivf_topk_flat": "ivf_topk"}.get(name, name)])
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
    (n, d), nq = fe.shape, fq.shape[0]
    bf = bound((n * d + nq * d) * 4 + nq * K * 8, 2 * nq * n * d)
    kernels.append(
        {"name": "ivf_topk_flat", "route": "cuda",
         "source": "src/repro_torch/csrc/ivf_topk.cu",
         "replaces": "src/repro/kernels/ivf_topk/kernel.py:98",
         "launches": n_path("ivf_topk_flat"), "max_abs_err": errf,
         "ms": cuda_ms(calls["ivf_topk_flat"][0], 200),
         "plain_ms": cuda_ms(lambda: topk_ip_ref(fe, fq, K), 5),
         "bound_ms": bf[0], "bound_by": bf[1],
         "library_ms": cuda_ms(calls["ivf_topk_flat"][1], 200),
         "device_ms": topk_dev["ivf_topk_flat"]["device_ms_per_call"],
         "library_device_ms": topk_dev["ivf_topk_flat_library"]
         ["device_ms_per_call"]})
    for mode, ((e, q, v, k), kw) in slab_inputs.items():
        name = "slab_topk" if mode == "fp32" else f"slab_topk_{mode}"
        if mode != "fp32":
            by_row[name] = {"codec_paths":
                            codecs[CODECS.index(mode)]["launches"][mode]}
            if mode == "int8":
                by_row[name]["tenancy"] = ten["int8"]["launches"][
                    "slab_topk"]["int8"]
                by_row[name]["durability"] = dur["launches"]["slab_topk"][
                    "int8"]
        n_launch = n_path(name)
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
    (q, k, v), kw = dense_calls["flash"]
    k5y_dev = k5_device_ms_at(q, k, v, kw["causal"])
    dense_n = dense["yi_9b"]["launches"]
    by_row["flash_attention_yi_9b"] = {
        "dense_archs": dense_n["flash_attention"]["causal"]}
    kernels.append(k5_row("flash_attention_yi_9b", q, k, v, kw["causal"],
                          n_path("flash_attention_yi_9b"),
                          report["flash_attention_yi_9b"]["max_abs_err"],
                          k5y_dev))
    (q, kc, vc, lens), _ = dense_calls["decode"]
    k6y_dev = decode_device_ms(q, kc, vc, lens)
    by_row["decode_attention_yi_9b"] = {
        "dense_archs": dense_n["decode_attention"]}
    kernels.append(k6_row("decode_attention_yi_9b", q, kc, vc, lens,
                          n_path("decode_attention_yi_9b"),
                          report["decode_attention_yi_9b"]["max_abs_err"],
                          k6y_dev))
    gemma_dev = {}
    swa_n = swa["gemma3_12b"]
    for kind in ("swa", "global"):
        name = f"flash_attention_gemma3_12b_{kind}"
        (q, k, v), kw = swa_calls["flash"][kind]
        gemma_dev[name] = k5_device_ms_at(q, k, v, kw["causal"],
                                          window=kw["window"])
        by_row[name] = {"swa_gemma3": swa_n["k5_launches"][kind]}
        kernels.append(k5_row(name, q, k, v, kw["causal"], n_path(name),
                              report[name]["max_abs_err"], gemma_dev[name],
                              window=kw["window"]))
    for kind in ("ring", "global"):
        name = f"decode_attention_gemma3_12b_{kind}"
        (q, kc, vc, lens), _ = swa_calls["decode"][kind]
        gemma_dev[name] = decode_device_ms(q, kc, vc, lens)
        by_row[name] = {"swa_gemma3": swa_n["k6_launches"][kind]}
        kernels.append(k6_row(name, q, kc, vc, lens, n_path(name),
                              report[name]["max_abs_err"], gemma_dev[name]))
    moe_dev = {}
    moe_n = moe["olmoe_1b_7b"]["launches"]
    name = "flash_attention_olmoe_1b_7b"
    (q, k, v), kw = moe_calls["flash"]
    moe_dev[name] = k5_device_ms_at(q, k, v, kw["causal"])
    by_row[name] = {"moe_archs": moe_n["flash_attention"]["causal"]}
    kernels.append(k5_row(name, q, k, v, kw["causal"], n_path(name),
                          report[name]["max_abs_err"], moe_dev[name]))
    name = "decode_attention_olmoe_1b_7b"
    (q, kc, vc, lens), _ = moe_calls["decode"]
    moe_dev[name] = decode_device_ms(q, kc, vc, lens)
    by_row[name] = {"moe_archs": moe_n["decode_attention"]}
    kernels.append(k6_row(name, q, kc, vc, lens, n_path(name),
                          report[name]["max_abs_err"], moe_dev[name]))
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
          "k5_yi_9b_vs_sdpa_device": k5y_dev,
          "k6_yi_9b_vs_sdpa_device": k6y_dev,
          "gemma3_12b_vs_sdpa_device": gemma_dev,
          "olmoe_1b_7b_vs_sdpa_device": moe_dev,
          "k2_cold_vs_warm_l2": cold_l2_device_ms(
              calls["slab_topk"][0], TILED_EVENTS["slab_topk_fp32"])})
    t_first = LEAD_IN_LOST[0][0]
    emit({"phase": "profiler_lead_in", "lead_in": LEAD_IN,
          "spin_cycles": LEAD_IN_CYCLES, "windows": len(LEAD_IN_LOST),
          "lost_max": max(lost for _, lost in LEAD_IN_LOST),
          "s_since_first_window_and_lost": [
              [round(t - t_first, 1), lost] for t, lost in LEAD_IN_LOST]})

    # ---- training: the last phase, with the generators freed ------------
    del engine, gen, ctx
    gc.collect()
    torch.cuda.empty_cache()
    train, train_rows = train_lm({"dev": dev, "smi": smi})
    emit(train)
    kernels += train_rows

    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
