"""End-to-end serving example on the PyTorch port (``repro_torch``): serve a
small generator behind the EdgeRAG index, with requests queued by the
port's scheduler.

Pipeline (reduced generator config):
  synthetic BEIR-like corpus → EdgeRAG index (prune/store/cache)
  → retrieval (``ivf_topk`` / ``slab_topk`` kernels on the card)
  → context assembly → Sheared-LLaMA-family generator (prefill + decode
  with the attention kernels on the card) → tokens,
with ``RequestScheduler.run`` replaying a Poisson arrival trace and
reporting TTFT / SLO statistics under the edge cost model.

    PYTHONPATH=src python examples/torch_edge_serving.py [--requests 30]
    PYTHONPATH=src python examples/torch_edge_serving.py --device cpu

It runs on the card unless ``--device cpu`` is given; without a card the
default raises.
"""
import argparse

import numpy as np

from repro_torch import configs
from repro_torch.core import EdgeCostModel, EdgeRAGIndex
from repro_torch.data.synthetic import scaled_beir
from repro_torch.serving import GeneratorModel, RAGEngine, RequestScheduler


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="fever")
    ap.add_argument("--records", type=int, default=1500)
    ap.add_argument("--requests", type=int, default=30)
    ap.add_argument("--arrival-rate", type=float, default=2.0,
                    help="requests/sec (edge-time)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    ds = scaled_beir(args.dataset, n_records=args.records,
                     n_queries=args.requests)
    cost = EdgeCostModel()
    slo = ds.spec.slo_s
    index = EdgeRAGIndex(ds.embeddings.shape[1], ds.embedder, ds.get_chunks,
                         cost, slo_s=slo, device=args.device)
    index.build(ds.chunk_ids, ds.texts, nlist=max(32, ds.n // 32),
                embeddings=ds.embeddings)
    print(f"[index] {index.stats()}")

    generator = GeneratorModel(
        configs.get_config("sheared-llama-2.7b").reduced(num_layers=2,
                                                         d_model=256),
        max_prompt=64, device=args.device)
    engine = RAGEngine(index, generator, cost_model=cost, k=8, nprobe=8,
                       max_new_tokens=8)

    sched = RequestScheduler()
    rng = np.random.default_rng(0)
    t = 0.0
    for qi in range(args.requests):
        t += rng.exponential(1.0 / args.arrival_rate)
        sched.submit(arrival_s=t, query=f"query-{qi}",
                     query_emb=ds.query_embs[qi],
                     query_chars=int(ds.query_chars[qi]), slo_s=slo)

    responses = []

    def serve(req):
        resp = engine.answer(req.query, req.query_emb, ds.get_chunks)
        responses.append(resp)
        return resp.ttft_edge_s          # edge service time drives the queue

    done = sched.run(serve)
    ttfts = np.asarray([r.ttft_edge_s for r in responses])
    retr = np.asarray([r.retrieval.retrieval_s for r in responses])
    print(f"\n[serve] {len(done)} requests on {index.device}")
    print(f"  retrieval edge: mean={retr.mean()*1e3:.0f}ms "
          f"p95={np.percentile(retr, 95)*1e3:.0f}ms")
    print(f"  TTFT edge:      mean={ttfts.mean():.2f}s "
          f"p95={np.percentile(ttfts, 95):.2f}s")
    print(f"  e2e (incl. queueing) SLO hit rate: {sched.slo_hit_rate():.2f} "
          f"(slo={slo}s)")
    print(f"  cache: hit_rate={index.cache.hit_rate:.2f} "
          f"entries={len(index.cache)} "
          f"threshold={index.threshold.threshold*1e3:.0f}ms")
    print(f"  sample generation (token ids): {responses[0].output_tokens}")
    return done


if __name__ == "__main__":
    main()
