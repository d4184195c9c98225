"""PQ recall at the port's codec-phase configuration, from both packages.

``chip_smoke.py``'s ``codec_paths`` phase reports recall@10 of the pq tier
against the fp32 index.  This script computes the same figure with the JAX
package (``repro``) and with the port (``repro_torch``, on the CPU) on the
same corpus, so a low recall can be put down to the configuration (an
``m``-byte code) or to the port's PQ training:

* ``index_recall``: recall@10 of ``search_batch`` under ``storage_codec="pq"``
  against an fp32 index with the same clustering, over the same batches as
  the smoke (the pq codec applies to the stored clusters only);
* ``exhaustive_adc_recall``: recall@10 of a brute-force ADC scan of the
  whole corpus (LUT sums) against exact inner products, with no IVF and no
  tiers, for each ``m`` in ``--adc-m``;
* ``quantization_error``: each package's mean squared reconstruction error
  of the corpus, and how far the two codebooks are apart.

Runs on the CPU only (JAX on its CPU backend, the port with
``device="cpu"``)::

    PYTHONPATH=src JAX_PLATFORMS=cpu python3 scripts/pq_recall_witness.py

It prints one JSON object.
"""
import argparse
import json
import time

import numpy as np


def recall(ids, ref_ids, k):
    return float(np.mean([len(set(a[:k]) & set(b[:k])) / k
                          for a, b in zip(ids, ref_ids)]))


def batches(index, query_embs, n_batches, batch, k, nprobe):
    out = []
    for b in range(n_batches):
        ids, _, _ = index.search_batch(
            query_embs[b * batch:(b + 1) * batch], k, nprobe)
        out.extend(list(map(list, np.asarray(ids))))
    return out


def exhaustive_adc_recall(pq_mod, cb, corpus, queries, k):
    exact = np.argsort(-(queries @ corpus.T), axis=1, kind="stable")[:, :k]
    codes = pq_mod.pq_encode(cb, corpus)
    luts = pq_mod.pq_luts(cb, queries)                    # (Q, m, 256)
    adc = np.zeros((len(queries), len(corpus)), np.float32)
    for j in range(cb.m):
        adc += luts[:, j, codes[:, j]]
    approx = np.argsort(-adc, axis=1, kind="stable")[:, :k]
    return recall(approx, exact, k)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", default="fiqa")
    ap.add_argument("--records", type=int, default=25_000)
    ap.add_argument("--dim", type=int, default=768)
    ap.add_argument("--nlist", type=int, default=125)
    ap.add_argument("--batches", type=int, default=4)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--nprobe", type=int, default=8)
    ap.add_argument("--adc-m", type=int, nargs="+", default=[8, 24])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro.core import EdgeCostModel as JaxCost
    from repro.core import EdgeRAGIndex as JaxIndex
    from repro.core import pq as jpq
    from repro.data.synthetic import scaled_beir as jax_beir
    from repro_torch.convert import index_state_from_numpy
    from repro_torch.core import EdgeCostModel, EdgeRAGIndex
    from repro_torch.core import pq as tpq
    from repro_torch.data.synthetic import scaled_beir

    t_start = time.perf_counter()
    n_q = (args.batches + 1) * args.batch
    jds = jax_beir(args.dataset, n_records=args.records, dim=args.dim,
                   n_queries=n_q, seed=args.seed)
    ds = scaled_beir(args.dataset, n_records=args.records, dim=args.dim,
                     n_queries=n_q, seed=args.seed)
    assert np.array_equal(ds.embeddings, jds.embeddings)
    assert np.array_equal(ds.query_embs, jds.query_embs)
    qn = args.batches * args.batch
    search = dict(n_batches=args.batches, batch=args.batch, k=args.k,
                  nprobe=args.nprobe)
    out = {"config": vars(args)}

    # the JAX package: fp32 and pq indexes from one build seed
    jix = {}
    for codec in ("fp32", "pq"):
        ix = JaxIndex(args.dim, jds.embedder, jds.get_chunks, JaxCost(),
                      slo_s=jds.spec.slo_s, storage_codec=codec)
        ix.build(jds.chunk_ids, jds.texts, nlist=args.nlist,
                 embeddings=jds.embeddings, seed=args.seed)
        jix[codec] = ix
    assert np.array_equal(jix["fp32"].centroids, jix["pq"].centroids)
    j_ids = {c: batches(ix, jds.query_embs, **search) for c, ix in jix.items()}

    # the port on the CPU, as chip_smoke.py does it on the card: an fp32
    # build, then the pq index loaded with its clustering (training its own
    # codebook on the corpus)
    t32 = EdgeRAGIndex(args.dim, ds.embedder, ds.get_chunks, EdgeCostModel(),
                       slo_s=ds.spec.slo_s, device="cpu")
    assign = t32.build(ds.chunk_ids, ds.texts, nlist=args.nlist,
                       embeddings=ds.embeddings, seed=args.seed)
    tpq_ix = EdgeRAGIndex(args.dim, ds.embedder, ds.get_chunks,
                          EdgeCostModel(), slo_s=ds.spec.slo_s,
                          storage_codec="pq", device="cpu")
    index_state_from_numpy(tpq_ix, t32.centroids, assign, ds.chunk_ids,
                           ds.texts, ds.embeddings)
    t_ids = {"fp32": batches(t32, ds.query_embs, **search),
             "pq": batches(tpq_ix, ds.query_embs, **search)}

    out["index_recall"] = {
        "jax": recall(j_ids["pq"], j_ids["fp32"], args.k),
        "port_cpu": recall(t_ids["pq"], t_ids["fp32"], args.k),
        "stored_clusters": {"jax": jix["pq"].stats()["stored_clusters"],
                            "port_cpu": tpq_ix.stats()["stored_clusters"]},
        "fp32_ids_jax_vs_port": recall(t_ids["fp32"], j_ids["fp32"], args.k)}

    jcb, tcb = jix["pq"].storage.pq, tpq_ix.storage.pq
    x = ds.embeddings
    out["quantization_error"] = {
        "m": int(jcb.m),
        "mean_jax": float(jpq.quantization_error(jcb, x).mean()),
        "mean_port_cpu": float(tpq.quantization_error(tcb, x).mean()),
        "mean_row_sq_norm": float((x * x).sum(1).mean()),
        "codebook_max_abs_diff": float(np.abs(np.asarray(jcb.codebooks)
                                              - tcb.codebooks).max()),
        "codes_equal_fraction": float(np.mean(
            jpq.pq_encode(jcb, x) == tpq.pq_encode(tcb, x)))}

    queries = ds.query_embs[:qn]
    adc = {}
    for m in args.adc_m:
        cb = jcb if m == jcb.m else jpq.train_pq(x, m=m, seed=args.seed)
        adc[f"jax_m{m}"] = exhaustive_adc_recall(jpq, cb, x, queries, args.k)
    adc[f"port_cpu_m{tcb.m}"] = exhaustive_adc_recall(tpq, tcb, x, queries,
                                                      args.k)
    out["exhaustive_adc_recall"] = adc
    out["seconds"] = time.perf_counter() - t_start
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
