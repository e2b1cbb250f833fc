"""Time the Lagrange encode (B4) and flash attention (B6) wrappers of one
checkout of the port at their main shapes, beside the PyTorch call that
computes the same function on the same inputs; the Poisson-binomial tails
through ``success_tails`` as the sweep engine calls them (B1: probabilities
(2, 256, 20 000, 15) with thresholds (1, 256, 1, 15); B2: 40 000 x 15 with a
static tuple), and the fused coded gradient (B5) through ``coded_gradient``
at the four shapes ``chip_smoke.py`` phase 6 times, beside two ``torch.bmm``;
and the exact GF(p) matmul
(B3) as the coded rounds call it: every product of the exact rounds through
``gf.matmul_gf`` / ``gf.bmm_gf`` (the degree-2 gradient on the transposed
view x~^T, as the round passes it), and one whole exact round of each degree (``coded_matmul_exact`` at EC2
scenario 1, ``coded_linear_gradient_modp`` at Fig. 3 scenario 3, the shapes
of ``chip_smoke.py`` phase 7).  Needs one CUDA card.

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
           operations over the type's peak rate (H100 SXM; for B3 the
           2.25 integer instructions a term of ``chip_smoke.py``'s bound
           at 128 a clock per SM), and for a round none.

Each kernel is first held to its plain version (B1 and B2 to the bit, B5
within 1e-5 (|x| (|x| |w| + |y|)), B4 within 1e-5 (|g| |x|),
B6 bf16 within 2^-8 max|v| + 2^-8 |ref|, the B3 products equal to the
limb route ``matmul_gf_dot`` to the bit); a miss raises.  A round has no
plain yardstick here: ``chip_smoke.py`` holds its result to the CPU route.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores
GF_INSTR_PER_TERM = 1 + 5 / 4  # one IMAD.WIDE a GF(p) term, a 5-instruction fold per four
INT_ISSUE_PER_S = 132 * 128 * 1.98e9   # integer issue: 132 SMs x 128 a clock x 1.98 GHz


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


def tails_rows(torch, pb) -> list[dict]:
    """B1 on the sweep engine's layout and B2 with a static tuple, through
    ``success_tails`` (the call the allocator makes)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    n = 15
    probs = torch.sort(torch.rand((2, 256, 20_000, n), generator=gen, device="cuda"),
                       dim=-1, descending=True).values
    w = torch.randint(-2, n + 2, (1, 256, 1, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    if not torch.equal(pb.success_tails(probs, w), pb.success_tails_ref(probs, w)):
        raise AssertionError("B1 differs from its plain version")
    small = probs.reshape(-1, n)[:40_000].contiguous()
    w_static = tuple(int(v) for v in w[0, 0, 0].tolist())
    if not torch.equal(pb.success_tails(small, w_static),
                       pb.success_tails_ref(small, w[0, 0, 0])):
        raise AssertionError("B2 differs from its plain version")
    rows = []
    for name, p, thresholds in (("B1 success_tails (2, 256, 20 000, 15), w (1, 256, 1, 15)",
                                 probs, w),
                                ("B2 success_tails (40 000, 15), static tuple", small,
                                 w_static)):
        w_bytes = 4 * (w.numel() if thresholds is w else n)
        rows.append({"name": name, "shape": list(p.shape),
                     "bound_ms": (8 * p.numel() + w_bytes) / HBM_BYTES_PER_S * 1e3,
                     "kernel": times(torch, lambda p=p, t=thresholds: pb.success_tails(p, t))})
    return rows


def gradient_rows(torch, cg) -> list[dict]:
    """B5 through ``coded_gradient`` beside two ``torch.bmm`` calls."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    out = []
    for nr, r_rows, c, p in ((150, 60, 3000, 1), (7, 13, 301, 3), (2, 4096, 8, 4),
                             (2, 65_536, 8, 1)):
        x = torch.randn((nr, r_rows, c), generator=gen, device="cuda")
        y = torch.randn((nr, r_rows, p), generator=gen, device="cuda")
        w = torch.randn((c, p), generator=gen, device="cuda")
        w_b = w.expand(nr, c, p)
        ax = x.abs()
        bound = 1e-5 * torch.bmm(ax.transpose(1, 2), torch.bmm(ax, w_b.abs()) + y.abs())
        if bool(((cg.coded_gradient(x, y, w) - cg.coded_gradient_ref(x, y, w)).abs()
                 > bound).any()):
            raise AssertionError(f"B5 {(nr, r_rows, c, p)} outside its float32 bound")
        moved = 4 * (nr * r_rows * c + nr * r_rows * p + c * p + nr * c * p)
        out.append({"name": f"B5 coded_gradient {(nr, r_rows, c, p)}",
                    "shape": [nr, r_rows, c, p],
                    "bound_ms": max(moved / HBM_BYTES_PER_S,
                                    4 * nr * r_rows * c * p / FP32_FLOP_PER_S) * 1e3,
                    "kernel": times(torch, lambda x=x, y=y, w=w: cg.coded_gradient(x, y, w)),
                    "library": "two torch.bmm (x w - y, then x^T resid)",
                    "library_times": times(torch, lambda x=x, y=y, w_b=w_b: torch.bmm(
                        x.transpose(1, 2), torch.bmm(x, w_b) - y))})
    return out


P = (1 << 31) - 1


def gf_rows(torch, gf, co, lg) -> list[dict]:
    """B3 through ``gf.matmul_gf`` / ``gf.bmm_gf`` at every product of the
    exact rounds, and one round of each degree."""
    gen = torch.Generator(device="cuda").manual_seed(16)
    residues = lambda *shape: torch.randint(0, P, shape, generator=gen, device="cuda",
                                            dtype=torch.int32)
    nr, rows, cols = 150, 60, 3000
    x_tilde = residues(nr, rows, cols)
    # (what, a, b): the deg-2 gradient's a is the transposed view the round
    # passes; the others are contiguous, as the round lays them out
    products = [
        ("encode (150, 120) @ (120, 75 000)", residues(150, 120), residues(120, 75_000)),
        ("deg-1 worker shards (3750, 3000) @ (3000, 8)", residues(3750, cols), residues(cols, 8)),
        ("deg-1 decode (120, 120) @ (120, 200)", residues(120, 120), residues(120, 200)),
        ("deg-2 residual (9000, 3000) @ (3000, 1)", x_tilde.reshape(nr * rows, cols),
         residues(cols, 1)),
        ("deg-2 gradient x~^T (150, 3000, 60) @ (150, 60, 1)", x_tilde.transpose(1, 2),
         residues(nr, rows, 1)),
        ("deg-2 decode (50, 99) @ (99, 3000)", residues(50, 99), residues(99, cols)),
    ]
    out = []
    for what, a, b in products:
        fn = (lambda a=a, b=b: gf.matmul_gf(a, b)) if a.dim() == 2 else \
             (lambda a=a, b=b: gf.bmm_gf(a, b))
        if not torch.equal(fn(), gf.matmul_gf_dot(a.contiguous(), b.contiguous())):
            raise AssertionError(f"B3 {what} differs from the limb route")
        batch = a.shape[0] if a.dim() == 3 else 1
        m, c, n = a.shape[-2], a.shape[-1], b.shape[-1]
        moved = 4 * batch * (m * c + c * n + m * n)
        terms = batch * m * c * n
        out.append({"name": "B3 " + what, "shape": [batch, m, c, n],
                    "bound_ms": max(moved / HBM_BYTES_PER_S,
                                    terms * GF_INSTR_PER_TERM / INT_ISSUE_PER_S) * 1e3,
                    "kernel": times(torch, fn)})
    del x_tilde, products
    rng = np.random.default_rng(16)
    on = torch.ones(nr, dtype=torch.bool, device="cuda")
    on[::7] = False                                    # 128 of 150 on time
    spec1 = lg.CodeSpec(15, 10, 120, 1)                # EC2 scenario 1, K* = 120
    x1 = rng.integers(0, P, size=(spec1.k, 25, cols), dtype=np.int32)
    w1 = torch.as_tensor(rng.integers(0, P, size=(cols, 8), dtype=np.int32), device="cuda")
    coded1 = co.encode_dataset_modp(spec1, x1, device="cuda")
    spec2 = lg.CodeSpec(15, 10, 50, 2)                 # Fig. 3 scenario 3, K* = 99
    x2 = rng.integers(0, P, size=(spec2.k, rows, cols), dtype=np.int32)
    y2 = rng.integers(0, P, size=(spec2.k, rows), dtype=np.int32)
    w2 = torch.as_tensor(rng.integers(0, P, size=(cols,), dtype=np.int32), device="cuda")
    coded2 = co.encode_dataset_modp(spec2, x2, y2, device="cuda")
    for what, fn in (("exact deg-1 round (coded_matmul_exact)",
                      lambda: co.coded_matmul_exact(coded1, w1, on)),
                     ("exact deg-2 round (coded_linear_gradient_modp)",
                      lambda: co.coded_linear_gradient_modp(coded2, w2, on))):
        if not bool(fn()[1]):
            raise AssertionError(f"{what}: 128 on-time chunks reported not ok")
        out.append({"name": what, "bound_ms": None, "kernel": times(torch, fn)})
    return out


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
    from repro_torch.core import coded_ops as co
    from repro_torch.core import lagrange as lg
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf
    from repro_torch.kernels import lagrange_encode as le
    from repro_torch.kernels import poisson_binomial as pb

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    rows = [*tails_rows(torch, pb), *gradient_rows(torch, cg), encode_row(torch, le),
            flash_row(torch, fa), *gf_rows(torch, gf, co, lg)]
    print(json.dumps({"label": args.label, "package": repro_torch.__file__,
                      "gpu": smi.stdout.strip().splitlines()[0], "torch": torch.__version__,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
