"""Build and load the port's hand-written CUDA kernels.

Each ``repro_torch/csrc/<name>.cu`` (with the headers beside it) is compiled
at first use by ``nvcc`` for Hopper (``sm_90a``) into a shared library with a
plain C interface, loaded with ``ctypes``.  Libraries go to ``build/kernels/``
at the root of the checkout (listed in ``.gitignore``) under a name that
hashes the sources and flags, so an edited source is rebuilt and an
unchanged one is reused.  :func:`build` starts one ``nvcc`` per source, all
at once; nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("ivf_topk", "slab_topk", "flash_attention", "decode_attention",
           "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
ptxas_report: Dict[str, List[str]] = {}   # name -> ptxas resource lines


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (CUDA_HOME or nvcc on PATH)")
    return nvcc


def _ptxas_lines(log: str) -> List[str]:
    """One line per kernel entry of ``ptxas -v``'s report: its mangled
    name, then its registers and its spills."""
    out, entry, spill = [], None, ""
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            entry, spill = ln.split("'")[1], ""
        elif "spill stores" in ln:
            spill = ln.strip()
        elif "registers" in ln and entry is not None:
            out.append(f"{entry}: {ln.split(':', 1)[1].strip()}; {spill}")
            entry = None
    return out


def _target(name: str) -> Path:
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns wall seconds per compiled name
    (empty when everything was built already); raises with the compiler's
    output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    seconds: Dict[str, float] = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name} (exit {proc.returncode}):\n{log}")
            continue
        ptxas_report[name] = _ptxas_lines(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = _libs[name] = ctypes.CDLL(str(_target(name)))
    return lib
