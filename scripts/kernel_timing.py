"""Device time of the port's one-launch top-k and decode attention kernels,
on one card, through ``chip_smoke.py``'s own measurements.  Each family is
an argument (default: both)::

    python3 scripts/kernel_timing.py [--src OTHER/src] [topk] [decode]

* ``topk``: K1 (``ivf_topk``) and K2 (fp32 ``slab_topk``) on the main path,
  K3 (fp16, int8) and K4 (pq) on the codec paths, at the calls that
  ``chip_smoke.py`` saved under the git-ignored ``build/``
  (``topk_inputs.pt``; run it first in the same call).  Per kernel:
  ``device_ms`` from ``device_ms`` (100 calls under the profiler, warm L2)
  with the device events a call.
* ``decode``: ``k6_main``, ``decode_device_ms`` at q (1, 1, 32, 80) against
  a (1, 144, 32, 80) f32 cache at 129 valid rows, the main path's decode
  shape (sheared-llama-2.7b, 128 prompt tokens and the first new one), K6
  beside ``scaled_dot_product_attention``; ``k7_main``, ``q8_device_ms``
  over that cache quantized to int8 by ``models.quantization.quantize_kv``
  (K7, K6 on the dequantized cache, the library composite); ``k6_long``,
  ``decode_long``, a 4,096-row cache, every row valid.

Beside the device ms, ``ms`` is a call's time from CUDA events over 200
calls, the wrapper included, and ``host_us`` the host's time to enqueue a
call (the median of 7 runs of 500 calls).

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that one call can time two checkouts -- a
parent unpacked into a git-ignored directory beside this one -- on one card,
in turns.  Needs a CUDA card; prints one JSON line, with the card's name and
power limit.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def host_us(fn, calls=500, repeats=7):
    """Median over ``repeats`` of the host's microseconds a call to enqueue
    ``calls`` calls back to back (the card, faster than the host here,
    drains them after each repeat)."""
    import torch
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return sorted(times)[repeats // 2]


def topk(cs, torch):
    """{name: (device ms of every event, the call)} at the recorded calls."""
    from repro_torch.kernels.ivf_topk import topk_ip
    from repro_torch.kernels.slab_topk import slab_topk
    saved = ROOT / "build" / cs.SLAB_INPUTS
    if not saved.exists():
        raise SystemExit(f"kernel_timing: no {saved}; run chip_smoke.py "
                         "first")
    runs = {}
    for name, ((e, q, v, k), kw) in torch.load(saved,
                                               map_location="cuda").items():
        if name == "ivf_topk":
            runs[name] = lambda e=e, q=q, k=k: topk_ip(e, q, k)
        else:
            runs[f"slab_topk_{name}"] = (
                lambda e=e, q=q, v=v, k=k, kw=kw: slab_topk(e, q, v, k, **kw))
    dev = cs.device_ms(runs, 100)
    return {name: ({"device_ms": dev[name]["device_ms_per_call"],
                    "events_per_call": dev[name]["events_per_call"]}, fn)
            for name, fn in runs.items()}


def decode(cs, torch):
    """The same for K6 / K7 at the main path's decode shape."""
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_q8)
    from repro_torch.models.quantization import quantize_kv
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q, kc, vc = rand(1, 1, 32, 80), rand(1, 144, 32, 80), rand(1, 144, 32, 80)
    ck, cv = quantize_kv(kc), quantize_kv(vc)
    runs = {"k6_main": (cs.decode_device_ms(q, kc, vc, 129),
                        lambda: decode_attention(q, kc, vc, 129)),
            "k7_main": (cs.q8_device_ms((q, ck, cv, 129)),
                        lambda: decode_attention_q8(q, ck.q, ck.scale, cv.q,
                                                    cv.scale, 129))}
    return {name: ({k: v["device_ms_per_call"] for k, v in dev_ms.items()
                    if k != "calls"}, fn)
            for name, (dev_ms, fn) in runs.items()}


FAMILIES = {"topk": (("ivf_topk", "slab_topk"), topk),
            "decode": (("decode_attention",), decode)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("families", nargs="*", choices=list(FAMILIES))
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    families = args.families or list(FAMILIES)

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                # its helpers; it adds ROOT/src
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("kernel_timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build([lib for f in families for lib in FAMILIES[f][0]])
    out = {"src": str(Path(repro_torch.__file__).resolve().parents[1]),
           "nvidia_smi": cs.nvidia_smi(),
           "device": torch.cuda.get_device_name(0),
           "build_s": time.perf_counter() - t0}
    for family in families:
        for name, (row, fn) in FAMILIES[family][1](cs, torch).items():
            row.update(ms=cs.cuda_ms(fn, 200), host_us=host_us(fn))
            out[name] = row
        if family == "decode":
            long = cs.decode_long(torch.device("cuda"))
            long.pop("profile")
            out["k6_long"] = long
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
