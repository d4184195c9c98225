"""The port imports neither ``jax`` nor any module of the JAX package
``repro``: a subprocess imports every module of ``repro_torch`` and checks
``sys.modules``, and an AST scan of the package and ``chip_smoke.py``
finds no such import."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
# the assigned architectures' config modules the port registers
ARCH_MODULES = ("stablelm_1p6b", "starcoder2_7b", "yi_9b", "musicgen_large",
                "qwen2_vl_2b", "gemma3_12b", "olmoe_1b_7b",
                "granite_moe_3b_a800m", "rwkv6_1p6b", "zamba2_2p7b")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_or_repro():
    mods = list(_modules())
    for name in ("repro_torch.kernels.slab_topk.ops", "repro_torch.core.pq",
                 "repro_torch.core.storage",
                 "repro_torch.models.quantization",
                 "repro_torch.models.moe",
                 "repro_torch.models.rwkv6",
                 "repro_torch.models.mamba2",
                 "repro_torch.kernels.flash_attention.ops",
                 "repro_torch.kernels._attention",
                 "repro_torch.kernels.decode_attention.ops",
                 "repro_torch.kernels.decode_attention.ref",
                 "repro_torch.data.chunking", "repro_torch.data.embedder",
                 "repro_torch.serving.batching",
                 "repro_torch.serving.pipeline",
                 "repro_torch.serving.scheduler",
                 "repro_torch.serving.metrics",
                 "repro_torch.core.flat_index", "repro_torch.core.ivf_index",
                 "repro_torch.core.tenant",
                 "repro_torch.core.durability",
                 "repro_torch.serving.simulator",
                 *(f"repro_torch.configs.{m}" for m in ARCH_MODULES)):
        assert name in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "from repro_torch.kernels.decode_attention import (\n"
            "    decode_attention_q8, decode_attention_q8_ref)\n"
            "from repro_torch.models.quantization import (\n"
            "    QuantKV, dequantize_kv, init_quant_cache, quant_insert,\n"
            "    quantize_kv)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
            "             m.startswith(('jax.', 'jaxlib', 'repro.')) or\n"
            "             m == 'repro')\n"
            "assert not bad, bad\n"
            "print(len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def _imported_names(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_ast_scan_finds_no_jax_or_repro_import():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert all(PKG / "configs" / f"{m}.py" in files for m in ARCH_MODULES)
    for path in files:
        for name in _imported_names(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_durability_loads_no_jax():
    """``repro_torch.core.durability`` alone, in a fresh interpreter,
    loads neither ``jax`` nor the JAX package, and names no torch
    itself: durable state is host numpy."""
    code = ("import sys\n"
            "import repro_torch.core.durability as d\n"
            "assert d.recover and d.recover_router and d.WriteAheadLog\n"
            "bad = sorted(m for m in sys.modules if m in ('jax', 'repro')\n"
            "             or m.startswith(('jax.', 'jaxlib', 'repro.')))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    path = PKG / "core" / "durability.py"
    assert all(n.split(".")[0] != "torch" for n in _imported_names(path))


@pytest.mark.parametrize("name", ["scheduler", "metrics", "simulator"])
def test_serving_bookkeeping_imports_no_torch(name):
    """The scheduler, the metrics registry and the edge simulator are pure
    Python and numpy, as in the JAX package: none of these modules imports
    torch itself (the ``repro_torch.serving`` package does, through the
    engine)."""
    path = PKG / "serving" / f"{name}.py"
    assert all(n.split(".")[0] != "torch" for n in _imported_names(path))
