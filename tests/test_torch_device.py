"""Entry points run on the card unless asked for the CPU: without a CUDA
device they raise, and with ``device="cpu"`` they run.  Kernel wrappers
take their plain version only for CPU tensors."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import EdgeCostModel, EdgeRAGIndex  # noqa: E402
from repro_torch.core.kmeans import kmeans  # noqa: E402
from repro_torch.data import generate_dataset  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.ivf_topk import topk_ip  # noqa: E402
from repro_torch.kernels.slab_topk import slab_topk  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import init_params  # noqa: E402
from repro_torch.serving import GeneratorModel  # noqa: E402


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_cfg():
    return get_config("sheared-llama-2.7b").reduced(num_layers=2, d_model=64)


@pytest.mark.parametrize("entry", ["index", "kmeans", "model", "generator",
                                   "serve", "device"])
def test_entry_points_raise_without_cuda(no_cuda, entry):
    ds = generate_dataset(n_records=50, dim=8, n_topics=4, n_queries=2)
    calls = {
        "index": lambda: EdgeRAGIndex(8, ds.embedder, ds.get_chunks),
        "kmeans": lambda: kmeans(ds.embeddings, 4),
        "model": lambda: init_params(_tiny_cfg()),
        "generator": lambda: GeneratorModel(_tiny_cfg()),
        "serve": lambda: serve.main(["--records", "50", "--queries", "1"]),
        "device": lambda: resolve_device(None),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_entry_points_run_on_cpu_when_asked(no_cuda):
    ds = generate_dataset(n_records=200, dim=8, n_topics=6, n_queries=4)
    ix = EdgeRAGIndex(8, ds.embedder, ds.get_chunks, EdgeCostModel(),
                      slo_s=0.05, device="cpu")
    ix.build(ds.chunk_ids, ds.texts, nlist=6, embeddings=ds.embeddings)
    ids, vals, _ = ix.search_batch(ds.query_embs, 3, 2)
    assert ids.shape == (4, 3) and np.isfinite(vals).all()
    gen = GeneratorModel(_tiny_cfg(), device="cpu", max_prompt=8)
    assert len(gen.generate("hello world", 3)) == 3
    assert gen.prefill_wall_s > 0 and gen.decode_wall_s > 0


def test_kernel_wrappers_count_no_launch_on_cpu():
    e, q = torch.randn(20, 8), torch.randn(3, 8)
    virt = torch.zeros((3, 20), dtype=torch.int32) + torch.arange(
        20, dtype=torch.int32)
    before = topk_ip.launches, slab_topk.launches
    topk_ip(e, q, 4)
    slab_topk(e, q, virt, 4)
    assert (topk_ip.launches, slab_topk.launches) == before
    with pytest.raises(ValueError):
        topk_ip(e, q.to("meta"), 4)
