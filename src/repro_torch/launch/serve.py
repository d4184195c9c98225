"""Serving launcher of the port: the EdgeRAG pipeline end to end on PyTorch.

Mirrors ``repro.launch.serve`` (same flags and printout): builds a synthetic
BEIR-like corpus, indexes it with EdgeRAG (k-means, pruning, selective
storage, caching), retrieves and generates, reporting per-query TTFT
(edge-simulated and wall).  Runs on the card; ``--device cpu`` runs on the
CPU instead.

  python -m repro_torch.launch.serve --dataset fiqa --queries 40
  python -m repro_torch.launch.serve --arch yi-9b --device cpu
  python -m repro_torch.launch.serve --arch olmoe-1b-7b --device cpu
  python -m repro_torch.launch.serve --arch rwkv6-1.6b --device cpu
  python -m repro_torch.launch.serve --arch zamba2-2.7b --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import EdgeCostModel, EdgeRAGIndex
from repro_torch.data.synthetic import scaled_beir
from repro_torch.serving.engine import GeneratorModel, RAGEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="fever",
                    choices=["scidocs", "fiqa", "quora", "nq", "hotpotqa",
                             "fever"])
    ap.add_argument("--arch", default="sheared-llama-2.7b",
                    help="generator architecture: a registered config id "
                         "(the paper's models or configs.ASSIGNED_ARCHS), "
                         "served .reduced()")
    ap.add_argument("--records", type=int, default=2000)
    ap.add_argument("--queries", type=int, default=40)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--no-generator", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 means fp32

    ds = scaled_beir(args.dataset, n_records=args.records,
                     n_queries=args.queries)
    cost = EdgeCostModel()
    slo = ds.spec.slo_s if ds.spec else 1.0
    index = EdgeRAGIndex(ds.embeddings.shape[1], ds.embedder, ds.get_chunks,
                         cost, slo_s=slo, device=args.device)
    nlist = max(16, ds.n // 32)
    index.build(ds.chunk_ids, ds.texts, nlist=nlist,
                embeddings=ds.embeddings)
    print(f"indexed {ds.n} chunks into {nlist} clusters; "
          f"stats={index.stats()}")

    gen = None
    if not args.no_generator:
        gcfg = configs.get_config(args.arch).reduced()
        gen = GeneratorModel(gcfg, device=args.device)
    engine = RAGEngine(index, gen, cost_model=cost, k=args.k,
                       nprobe=args.nprobe)

    ttfts, walls = [], []
    for qi in range(args.queries):
        resp = engine.answer(f"query-{qi}", ds.query_embs[qi], ds.get_chunks)
        ttfts.append(resp.ttft_edge_s)
        walls.append(resp.ttft_wall_s)
        if qi < 3:
            print(f"q{qi}: retrieved {resp.chunk_ids[:5]}... "
                  f"edge_ttft={resp.ttft_edge_s:.3f}s "
                  f"wall={resp.ttft_wall_s:.3f}s "
                  f"gen_tokens={len(resp.output_tokens)}")
    ttfts = np.asarray(ttfts)
    print(f"\nTTFT edge-sim: mean={ttfts.mean():.3f}s "
          f"p50={np.percentile(ttfts, 50):.3f}s "
          f"p95={np.percentile(ttfts, 95):.3f}s; "
          f"wall mean={np.mean(walls):.3f}s")
    print(f"cache: {index.cache.hits} hits / {index.cache.misses} misses "
          f"(rate {index.cache.hit_rate:.2f}), "
          f"threshold={index.threshold.threshold*1e3:.0f}ms")
    print(f"resident index memory: {index.memory_bytes()/2**20:.1f} MiB; "
          f"storage: {index.storage_bytes()/2**20:.1f} MiB")


if __name__ == "__main__":
    main()
