"""The port's edge simulator against the JAX package's.

``repro_torch.serving.simulator`` replays the edge cost model in numpy on
the host (it never touches a tensor), so every figure it gives must equal
the JAX package's exactly: ``EdgeSimulator.run`` for each of the six
``BEIR_SPECS`` datasets and the five Table 4 configurations, at the default
settings and at other ``nlist``, ``nprobe``, ``cache_frac`` and ``slo_s``;
``simulate_ttft``; and ``zipf_over_tenants``' arrays and counts.  Then the
paper's orderings, as ``tests/test_serving_train.py`` checks them on the
JAX package, on the port's simulator.
"""
import dataclasses
import functools

import numpy as np
import pytest

from repro.serving.simulator import EdgeSimulator as JaxSimulator
from repro.serving.simulator import simulate_ttft as jax_simulate_ttft
from repro.serving.simulator import zipf_over_tenants as jax_zipf
from repro_torch.data.synthetic import BEIR_SPECS
from repro_torch.serving import (EdgeSimulator, TenantTrace, simulate_ttft,
                                 zipf_over_tenants)

CONFIGS = ["flat", "ivf", "ivf_gen", "ivf_gen_load", "edgerag"]
# (constructor keywords, run keywords) off the defaults
VARIANTS = {
    "nlist": (dict(nlist=300), {}),
    "nprobe": (dict(nprobe=3), {}),
    "cache_frac": ({}, dict(cache_frac=0.01)),
    "slo_s": ({}, dict(slo_s=0.25)),
}


@functools.cache
def _sims(dataset, variant=None):
    kw = VARIANTS[variant][0] if variant else {}
    return (EdgeSimulator(dataset, n_queries=200, seed=0, **kw),
            JaxSimulator(dataset, n_queries=200, seed=0, **kw))


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("dataset", list(BEIR_SPECS))
def test_run_equals_jax(dataset, cfg):
    port, ref = _sims(dataset)
    assert np.array_equal(port.trace, ref.trace)
    assert dataclasses.asdict(port.run(cfg)) == \
        dataclasses.asdict(ref.run(cfg))


@pytest.mark.parametrize("cfg", CONFIGS)
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dataset", ["scidocs", "fever"])
def test_run_variant_equals_jax(dataset, variant, cfg):
    port, ref = _sims(dataset, variant)
    run_kw = VARIANTS[variant][1]
    assert dataclasses.asdict(port.run(cfg, **run_kw)) == \
        dataclasses.asdict(ref.run(cfg, **run_kw))


def test_simulate_ttft_equals_jax():
    kw = dict(datasets=["scidocs", "nq"], n_queries=60, seed=4, nprobe=6)
    port, ref = simulate_ttft(**kw), jax_simulate_ttft(**kw)
    assert list(port) == list(ref)
    for ds in ref:
        assert list(port[ds]) == list(ref[ds]) == CONFIGS
        assert {c: dataclasses.asdict(r) for c, r in port[ds].items()} == \
            {c: dataclasses.asdict(r) for c, r in ref[ds].items()}


@pytest.mark.parametrize("args", [(1, 5, {}), (4, 300, dict(zipf_a=1.2)),
                                  (16, 1000, dict(zipf_a=2.0, seed=7,
                                                  gap_mean_s=0.01))])
def test_zipf_over_tenants_equals_jax(args):
    n_tenants, n_requests, kw = args
    port = zipf_over_tenants(n_tenants, n_requests, **kw)
    ref = jax_zipf(n_tenants, n_requests, **kw)
    assert isinstance(port, TenantTrace) and len(port) == len(ref)
    assert np.array_equal(port.arrival_s, ref.arrival_s)
    assert np.array_equal(port.tenant_ids, ref.tenant_ids)
    assert port.tenant_ids.dtype == ref.tenant_ids.dtype
    assert (port.n_tenants, port.zipf_a) == (ref.n_tenants, ref.zipf_a)
    assert port.counts() == ref.counts()


# ---------------------------------------------------------------------------
# the paper's orderings on the port's simulator
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dataset", ["fever", "nq"])
def test_sim_large_datasets_edgerag_beats_ivf(dataset):
    sim = EdgeSimulator(dataset, n_queries=200, seed=0)
    ivf = sim.run("ivf")
    er = sim.run("edgerag")
    assert er.mean_ttft_s < ivf.mean_ttft_s          # the paper's headline
    assert er.resident_bytes < 0.1 * ivf.resident_bytes   # pruning
    # flat thrashes catastrophically out of memory
    flat = sim.run("flat")
    assert flat.mean_ttft_s > ivf.mean_ttft_s


def test_sim_small_dataset_penalty_is_bounded():
    """scidocs/fiqa fit in memory: online generation must not win, but the
    cached EdgeRAG stays within ~2x of in-memory IVF (Fig. 13)."""
    sim = EdgeSimulator("fiqa", n_queries=200, seed=0)
    ivf = sim.run("ivf")
    er = sim.run("edgerag")
    gen = sim.run("ivf_gen")
    assert er.mean_ttft_s <= gen.mean_ttft_s + 1e-9  # caching only helps
    assert er.mean_ttft_s < 2.0 * ivf.mean_ttft_s


def test_sim_cache_improves_over_gen_load():
    sim = EdgeSimulator("fever", n_queries=300, seed=1)
    load = sim.run("ivf_gen_load")
    er = sim.run("edgerag")
    assert er.mean_ttft_s <= load.mean_ttft_s + 1e-9
    assert er.cache_hit_rate > 0.5                   # Table 2 reuse=2.41
