"""Where a decode attention launch (K6) spends its time, block by block.

Builds ``src/repro_torch/csrc/decode_attention.cu`` a second time with
``-DDECODE_STAMPS``, in which thread 0 of every block stamps the card's
global timer (ns) at the kernel's ``STAMP`` points, runs that build through
the port's own wrapper at the main path's decode shape -- q (1, 1, 32, 80)
against a (1, 144, 32, 80) f32 cache at 129 valid rows -- and at a
4,096-row cache, and prints, per shape, the median over blocks of each
phase and the span of the launch:

* ``staged``: block start to its K / V rows and q in shared memory;
* ``warps``: the warps' scores, softmax and P.V;
* ``partial``: the warps' sums merged, the output or the partial written;
* ``ticket``: the last pass's end to the merging block's ticket answered
  (merging blocks only);
* ``merge``: the merging block's loads of the partials to its output.

It also gives the device ms a call of the stamped build and of the kernel
as built, so that the stamps' cost shows.  Needs a CUDA card and ``nvcc``;
prints one JSON line with the card's name and power limit::

    python3 scripts/decode_attention_phases.py
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
STAMP_BLOCKS = 1 << 13        # blocks x 8 stamps the build holds

# (phase, the stamp it starts at, the stamp it ends at)
PHASES = [("staged", 0, 1), ("warps", 1, 2), ("partial", 2, 3),
          ("ticket", 3, 4), ("merge", 4, 5)]


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                # its helpers; it adds ROOT/src
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_attention_phases: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import ops

    out_dir = _build.BUILD_DIR / "phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libdecode_attention_stamped.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-DDECODE_STAMPS",
                    "-o", str(lib_path),
                    str(_build.CSRC / "decode_attention.cu")], check=True,
                   capture_output=True)
    stamped = ctypes.CDLL(str(lib_path))
    built = ops._lib()
    for name in ("decode_attention", "decode_attention_scratch_bytes"):
        getattr(stamped, name).argtypes = getattr(built, name).argtypes
        getattr(stamped, name).restype = getattr(built, name).restype
    stamped.decode_stamps_read.argtypes = [ctypes.c_void_p,
                                           ctypes.c_longlong]

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q = rand(1, 1, 32, 80)
    result = {"nvidia_smi": cs.nvidia_smi(),
              "device": torch.cuda.get_device_name(0)}
    for name, smax, length in (("main", 144, 129), ("long", 4096, 4096)):
        kc, vc = rand(1, smax, 32, 80), rand(1, smax, 32, 80)
        call = lambda: ops.decode_attention(q, kc, vc, length)
        row = {"cache": list(kc.shape), "length": length,
               "device_ms": cs.device_ms({"k": call}, 100)["k"]
               ["device_ms_per_call"]}
        ops._lib = lambda: stamped
        try:
            row["stamped_device_ms"] = cs.device_ms({"k": call}, 100)["k"][
                "device_ms_per_call"]
            runs = []
            for _ in range(5):
                stamped.decode_stamps_clear()
                call()
                torch.cuda.synchronize()
                buf = np.zeros(STAMP_BLOCKS * 8, np.uint64)
                stamped.decode_stamps_read(buf.ctypes.data, buf.nbytes)
                t = buf.reshape(-1, 8).astype(np.int64)
                t = t[t[:, 0] > 0]
                runs.append(np.where(t > 0, t - t[:, :1].min(), -1))
        finally:
            ops._lib = lambda: built
        t = np.concatenate(runs)
        med = lambda a: float(np.median(a)) if len(a) else None
        row["blocks"] = int(len(t) // len(runs))
        row["start_spread_ns"] = med(np.array([r[:, 0].max() for r in runs]))
        for phase, a, b in PHASES:
            both = (t[:, a] >= 0) & (t[:, b] >= 0)
            row[f"{phase}_ns"] = med(t[both, b] - t[both, a])
        row["last_pass_end_ns"] = med(np.array([r[:, 3].max()
                                                for r in runs]))
        row["span_ns"] = med(np.array([r.max() for r in runs]))
        result[name] = row
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
