"""Time the Lagrange encode (B4) and flash attention (B6) wrappers of one
checkout of the port at their main shapes, beside the PyTorch call that
computes the same function on the same inputs.  Needs one CUDA card.

    python3 tools/kernel_ab.py --src <checkout>/src --label <name>

``--src`` goes first on ``sys.path``, so the ``repro_torch`` of any checkout
is timed by the same code: to compare a commit with its parent, unpack the
parent's ``src/repro_torch`` (``git archive``) into an ignored directory and
run this script once per checkout, one run after another on one card, in
the order A B B A.  Each run builds its own kernels (``build/`` beside that
``src``) and prints one JSON line: the card, the checkout, and per function

  one      CUDA events around a single call on an idle card, median of 20:
           the call's host work before its launch is counted too (how
           ``chip_smoke.py`` reports ``ms``);
  batched  CUDA events around 10 back-to-back calls over 10, median of 10:
           the card runs one launch while the host queues the next;
  device   the device time of the call's kernels from ``torch.profiler``,
           mean over 20 calls (null where the profiler records none);
  host_us  host time to issue one call, mean over 200 calls issued back to
           back without waiting for the card;
  bound    the least time the card could take: bytes over 3.35 TB/s or
           operations over the type's peak rate (H100 SXM).

Each kernel is first held to its plain version (B4 within 1e-5 (|g| |x|),
B6 bf16 within 2^-8 max|v| + 2^-8 |ref|); a miss raises.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores


def event_ms(torch, fn, calls: int, runs: int) -> float:
    """Median over ``runs`` of CUDA events around ``calls`` calls, over ``calls``."""
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    return statistics.median(times)


def device_ms(torch, fn, calls: int = 20) -> tuple[float | None, list[str]]:
    """Device time of one call's kernels, and their names, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return None, []
    names = sorted({e.name[:60] for e in kernels})
    return sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / calls, names


def host_us(torch, fn, calls: int = 200) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    issued = time.perf_counter() - t0
    torch.cuda.synchronize()
    return issued / calls * 1e6


def times(torch, fn) -> dict:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    dev, names = device_ms(torch, fn)
    return {"one": event_ms(torch, fn, 1, 20), "batched": event_ms(torch, fn, 10, 10),
            "device": dev, "host_us": host_us(torch, fn), "kernels": names}


def encode_row(torch, le) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(4)
    nr, k, cols = 150, 8, 180_000
    g = torch.randn((nr, k), generator=gen, device="cuda")
    x = torch.randn((k, cols), generator=gen, device="cuda")
    got = le.encode_matrix_cuda(g, x)
    bound = 1e-5 * (g.abs() @ x.abs())
    if bool(((got - le.encode_matrix_ref(g, x)).abs() > bound).any()):
        raise AssertionError("encode_matrix_cuda disagrees with its plain version")
    moved = 4 * (nr * k + k * cols + nr * cols)
    return {"name": "encode_matrix_cuda", "shape": [nr, k, cols],
            "bound_ms": max(moved / HBM_BYTES_PER_S, 2 * nr * k * cols / FP32_FLOP_PER_S) * 1e3,
            "kernel": times(torch, lambda: le.encode_matrix_cuda(g, x)),
            "library": "torch.matmul",
            "library_times": times(torch, lambda: torch.matmul(g, x))}


def flash_row(torch, fa) -> dict:
    gen = torch.Generator(device="cuda").manual_seed(9)
    b, hq, hkv, s, d = 4, 16, 8, 2048, 128
    # (B, H, S, D) views of (B, S, H, D) tensors, as the model's layer passes them
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
               .to(torch.bfloat16).transpose(1, 2) for h in (hq, hkv, hkv))
    got = fa.flash_attention_cuda(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True, block_q=1024)
    bound = 2.0 ** -8 * (v.float().abs().amax() + want.float().abs())
    if bool(((got.float() - want.float()).abs() > bound).any()):
        raise AssertionError("flash_attention_cuda disagrees with its plain version")
    del want, bound
    pairs = s * (s + 1) // 2
    moved = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    return {"name": "flash_attention_cuda", "shape": [[b, hq, s, d], [b, hkv, s, d]],
            "bound_ms": max(moved / HBM_BYTES_PER_S, 4 * d * pairs * b * hq / BF16_FLOP_PER_S) * 1e3,
            "kernel": times(torch, lambda: fa.flash_attention_cuda(q, k, v, causal=True)),
            "library": "scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
            "library_times": times(torch, lambda: sdpa(q, k, v, is_causal=True, enable_gqa=True))}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", required=True, help="a checkout's src directory")
    ap.add_argument("--label", required=True)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device is available", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lagrange_encode as le

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    rows = [encode_row(torch, le), flash_row(torch, fa)]
    print(json.dumps({"label": args.label, "package": repro_torch.__file__,
                      "gpu": smi.stdout.strip().splitlines()[0], "torch": torch.__version__,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
