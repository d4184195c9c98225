"""Device time of the decode attention kernels (K6, K7) of one checkout's
port, on one card, beside ``scaled_dot_product_attention``, through
``chip_smoke.py``'s own measurements:

* ``k6_main``: ``decode_device_ms`` at q (1, 1, 32, 80) against a (1, 144,
  32, 80) f32 cache at 129 valid rows, the main path's decode shape
  (sheared-llama-2.7b, 128 prompt tokens and the first new one);
* ``k7_main``: ``q8_device_ms`` over that cache quantized to int8 by
  ``models.quantization.quantize_kv`` (K7, K6 on the dequantized cache,
  the library composite);
* ``k6_long``: ``decode_long``, a 4,096-row cache, every row valid.

``--src`` names the ``src`` directory whose ``repro_torch`` is timed
(default: this checkout's), so that one call can time two checkouts -- a
parent unpacked into a git-ignored directory beside this one -- on one card,
in turns::

    python3 scripts/decode_attention_timing.py --src /path/to/parent/src

Beside the device ms, ``ms`` is K6's / K7's time a call from CUDA events
and ``host_us`` the host's time to enqueue a call (the median of 7 runs of
500 calls).  Needs a CUDA card; prints one JSON line, with the card's name
and power limit.
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                # its helpers; it adds ROOT/src
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch
    if not torch.cuda.is_available():
        print("decode_attention_timing: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_q8)
    from repro_torch.models.quantization import quantize_kv

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.build(["decode_attention"])
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(0)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    q, kc, vc = rand(1, 1, 32, 80), rand(1, 144, 32, 80), rand(1, 144, 32, 80)
    ck, cv = quantize_kv(kc), quantize_kv(vc)
    k6 = lambda: decode_attention(q, kc, vc, 129)
    k7 = lambda: decode_attention_q8(q, ck.q, ck.scale, cv.q, cv.scale, 129)
    runs = {"k6_main": (cs.decode_device_ms(q, kc, vc, 129), k6),
            "k7_main": (cs.q8_device_ms((q, ck, cv, 129)), k7)}
    out = {"src": str(Path(repro_torch.__file__).resolve().parents[1]),
           "nvidia_smi": cs.nvidia_smi(),
           "device": torch.cuda.get_device_name(0), "build_s": build_s}
    for name, (dev_ms, fn) in runs.items():
        out[name] = {k: v["device_ms_per_call"] for k, v in dev_ms.items()
                     if k != "calls"}
        out[name].update(ms=cs.cuda_ms(fn, 200), host_us=host_us(fn))
    long = cs.decode_long(dev)
    long.pop("profile")
    out["k6_long"] = long
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
