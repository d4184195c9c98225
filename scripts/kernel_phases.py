"""Where a launch of one of the port's split kernels spends its time, block
by block::

    python3 scripts/kernel_phases.py decode_attention
    python3 scripts/kernel_phases.py topk

Builds the kernel's source under ``src/repro_torch/csrc`` a second time with
``-DKERNEL_STAMPS`` (``csrc/stamps.cuh``): thread 0 of every block stamps
the card's global timer (ns) at the kernel's ``STAMP(k)`` points and its
SM, and lane 0 of a warp adds to a count the kernel chooses.  It runs that
build through the port's own wrapper and prints, per call, the median over
blocks of each phase of the kernel's ``PHASES`` row, over 5 launches:

* ``decode_attention`` (K6), at the main path's decode shape -- q (1, 1,
  32, 80) against a (1, 144, 32, 80) f32 cache at 129 valid rows -- and at
  a 4,096-row cache: ``staged`` (block start to its K / V rows and q in
  shared memory), ``warps`` (the warps' scores, softmax and P.V),
  ``partial`` (the warps' sums merged, the output or the partial written),
  ``ticket`` (to the merging block's ticket answered; merging blocks
  only), ``merge`` (its loads of the partials to its output);
* ``topk`` (K1-K4, ``ivf_topk.cu`` and ``slab_topk.cu``), at the calls
  ``chip_smoke.py`` saved to ``build/topk_inputs.pt`` (run it first):
  ``members`` (block start to its virt slice read and the active list
  made), ``scoring`` (the rows and queries or tables staged and scored),
  ``selection`` (each query's best candidates of the tile written),
  ``ticket``, ``merge`` (to thread 0's last write) and
  ``merge_all_warps`` (to the slowest warp's); its count,
  ``round_merges``, is the queries that the merge took through k rounds
  over every candidate in scratch.

Every row also has ``start_spread_ns`` (the last block's start after the
first's), the end of phase 3 in the last block (``last_pass_end_ns`` /
``last_selection_end_ns``) and ``span_ns`` (the last stamp), all from the
first block's start; ``blocks_per_sm``, how many SMs held 1, 2, ... of the
launch's blocks, and the median of the second phase over blocks on an SM
with that many (``warps_by_share_ns`` / ``scoring_by_share_ns``); and the
device ms a call of the stamped build and of the kernel as built, so that
the stamps' cost shows.  Needs a CUDA card and ``nvcc``; prints one JSON
line with the card's name and power limit.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAMP_BLOCKS = 1 << 14        # blocks x 8 stamps the build holds
RUNS = 5

# per kernel: its libraries, (phase, the stamp it starts at, the stamp it
# ends at), the name of phase 3's end, and of the count (None: none)
KERNELS = {
    "decode_attention": (("decode_attention",),
                         [("staged", 0, 1), ("warps", 1, 2),
                          ("partial", 2, 3), ("ticket", 3, 4),
                          ("merge", 4, 5)],
                         "last_pass_end_ns", None),
    "topk": (("ivf_topk", "slab_topk"),
             [("members", 0, 1), ("scoring", 1, 2), ("selection", 2, 3),
              ("ticket", 3, 4), ("merge", 4, 5), ("merge_all_warps", 4, 6)],
             "last_selection_end_ns", "round_merges"),
}


def stamped_libs(names):
    """{library: (its ops module, the built library's _lib(), the stamped
    one in its place)}, the stamped build taking the built one's
    signatures."""
    import importlib
    from repro_torch.kernels import _build
    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {}
    for name in names:
        ops = importlib.import_module(f"repro_torch.kernels.{name}.ops")
        path = out_dir / f"lib{name}_stamped.so"
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DKERNEL_STAMPS",
                        "-o", str(path), str(_build.CSRC / f"{name}.cu")],
                       check=True, capture_output=True)
        lib, built = ctypes.CDLL(str(path)), ops._lib()
        plain = built[0] if isinstance(built, tuple) else built
        for fn in [n for n in dir(plain) if n.startswith(name)]:
            getattr(lib, fn).argtypes = getattr(plain, fn).argtypes
            getattr(lib, fn).restype = getattr(plain, fn).restype
        lib.kernel_stamps_read.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
        swapped = (lib,) + built[1:] if isinstance(built, tuple) else lib
        libs[name] = (ops, built, swapped)
    return libs


def phase_row(cs, call, stamped, phases, end3, count):
    """The row of one call: device ms as built and stamped, then the
    phases of RUNS stamped launches."""
    import numpy as np
    import torch
    ops, built, swapped = stamped
    lib = swapped[0] if isinstance(swapped, tuple) else swapped
    row = {"device_ms": cs.device_ms({"k": call}, 100)["k"]
           ["device_ms_per_call"]}
    ops._lib = lambda: swapped
    try:
        row["stamped_device_ms"] = cs.device_ms({"k": call}, 100)["k"][
            "device_ms_per_call"]
        runs, counts, sms = [], [], []
        for _ in range(RUNS):
            lib.kernel_stamps_clear()
            call()
            torch.cuda.synchronize()
            buf = np.zeros(STAMP_BLOCKS * 8, np.uint64)
            lib.kernel_stamps_read(buf.ctypes.data, buf.nbytes)
            t = buf.reshape(-1, 8).astype(np.int64)
            t = t[t[:, 0] > 0]
            counts.append(int((t[:, 7] & 0xffffffff).sum()))
            sms.append(t[:, 7] >> 32)
            t = t[:, :7]
            runs.append(np.where(t > 0, t - t[:, :1].min(), -1))
    finally:
        ops._lib = lambda: built
    t = np.concatenate(runs)
    med = lambda a: float(np.median(a)) if len(a) else None
    row["blocks"] = int(len(t) // len(runs))
    row["start_spread_ns"] = med(np.array([r[:, 0].max() for r in runs]))
    for phase, a, b in phases:
        both = (t[:, a] >= 0) & (t[:, b] >= 0)
        row[f"{phase}_ns"] = med(t[both, b] - t[both, a])
    row[end3] = med(np.array([r[:, 3].max() for r in runs]))
    row["span_ns"] = med(np.array([r.max() for r in runs]))
    if count:
        row[count] = counts[0]
    share = {}
    for r, sm in zip(runs, sms):
        _, inv, cnt = np.unique(sm, return_inverse=True, return_counts=True)
        for n_sm, ns in zip(cnt[inv], r[:, 2] - r[:, 1]):
            share.setdefault(int(n_sm), []).append(int(ns))
    _, cnt = np.unique(sms[0], return_counts=True)
    row["blocks_per_sm"] = {int(c): int((cnt == c).sum())
                            for c in np.unique(cnt)}
    row[f"{phases[1][0]}_by_share_ns"] = {c: med(np.array(v))
                                          for c, v in sorted(share.items())}
    return row


def decode_calls(cs, torch, libs):
    """{name: (the call, its library)} at the two decode shapes."""
    from repro_torch.kernels.decode_attention import ops
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q = rand(1, 1, 32, 80)
    calls = {}
    for name, smax, length in (("main", 144, 129), ("long", 4096, 4096)):
        kc, vc = rand(1, smax, 32, 80), rand(1, smax, 32, 80)
        calls[name] = (lambda kc=kc, vc=vc, length=length:
                       ops.decode_attention(q, kc, vc, length),
                       libs["decode_attention"])
    return calls


def topk_calls(cs, torch, libs):
    """{name: (the call, its library)} at the recorded top-k calls."""
    from repro_torch.kernels.ivf_topk import ops as ivf_ops
    from repro_torch.kernels.slab_topk import ops as slab_ops
    saved = ROOT / "build" / cs.SLAB_INPUTS
    if not saved.exists():
        raise SystemExit(f"kernel_phases: no {saved}; run chip_smoke.py "
                         "first")
    calls = {}
    for mode, ((e, q, v, k), kw) in torch.load(saved,
                                               map_location="cuda").items():
        if mode == "ivf_topk":
            calls[mode] = (lambda e=e, q=q, k=k: ivf_ops.topk_ip(e, q, k),
                           libs["ivf_topk"])
        else:
            calls[f"slab_topk_{mode}"] = (
                lambda e=e, q=q, v=v, k=k, kw=kw: slab_ops.slab_topk(
                    e, q, v, k, **kw), libs["slab_topk"])
    return calls


CALLS = {"decode_attention": decode_calls, "topk": topk_calls}


def main() -> int:
    if len(sys.argv) != 2 or sys.argv[1] not in KERNELS:
        print(f"usage: kernel_phases.py {{{','.join(KERNELS)}}}",
              file=sys.stderr)
        return 2
    kernel = sys.argv[1]
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                # its helpers; it adds ROOT/src
    import torch
    if not torch.cuda.is_available():
        print("kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    names, phases, end3, count = KERNELS[kernel]
    libs = stamped_libs(names)
    result = {"nvidia_smi": cs.nvidia_smi(),
              "device": torch.cuda.get_device_name(0)}
    for name, (call, stamped) in CALLS[kernel](cs, torch, libs).items():
        result[name] = phase_row(cs, call, stamped, phases, end3, count)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
