"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

  1. environment: the card's name and power limit (``nvidia-smi``), torch and
     CUDA versions, and the nvcc builds of every ``csrc/*.cu``, one nvcc
     process per source, all started together;
  2. each kernel entry point against its plain PyTorch version on the card,
     at the main path's shapes and at n = 15, 64, 100 (max |diff| <= 1e-5),
     with its time (CUDA events, median of warm runs), the plain version's
     time and the card's bound for the same work;
  3. the main path: ``sweeps.run("fig3", seeds=64)`` at the paper's scale
     (n = 15, K* = 99, M = 20 000 rounds, 4 chains, lea / static / oracle),
     held to the committed ``BENCH_fig3.json`` (|mean - value| <= 4.5 x the
     across-seed standard deviation, LEA above static everywhere); the
     per-row kernel's launch count must rise;
  4. the static-threshold entry: ``throughput.compare`` on Fig. 3 scenario 1;
     the static kernel's launch count must rise;
  5. a small fig3 run on the card and on the CPU from the same recorded
     draws: the per-round successes may differ in at most 0.1% of rounds
     (the kernel repeats the plain version's roundings, so 0 is expected);
  6. the coding kernels against their plain versions on the card, at the
     coded path's shapes and one ragged shape each: the exact GF(p) matmul
     (``matmul_gf_cuda``, ``bmm_gf_cuda``; equal to ``matmul_gf_dot`` to the
     bit, residues 0 and p-1 included), the Lagrange encode GEMM and the
     fused coded gradient (within the float32 reduction-order bound
     |diff| <= 1e-5 * (|A| |B|) elementwise), each timed beside its plain
     version, its bound and its library call or composition of calls;
  7. the coded path: the exact degree-1 round at the paper's EC2 scenario 1
     for every feasible LEA round of a 2 000-round rollout (the first 8
     rounds equal to the CPU plain route, one round equal to the numpy
     oracle on a 64-column slice), the exact degree-2 gradient on a Fig. 3
     scenario 3 rollout (first 6 rounds equal to the CPU plain route), and
     the float coded regression at k = 5, LEA vs static (every accepted
     round within 1e-2 relative of the uncoded gradient, LEA above static),
     and the same regression at k = 8, read and not checked (its per-round
     relative errors and the rounds the guard rejects); each part counts
     its launches before its cross-checks, and every coding kernel's count
     must rise;
  8. the ported example, ``repro_torch.examples.coded_regression.run()``;
  9. flash attention (B6) against its plain version ``flash_attention_ref``
     on the card: the serving prefill's shape q (4, 16, 2048, 128) against
     k, v (4, 8, 2048, 128) in bf16 and in float32, ragged Sq = Sk = 1000,
     non-causal, decode-aligned Sq = 16 < Sk = 2048, Sq > Sk with rows that
     must be 0, and the Mixtral attention widths (48 over 8 heads, 4096
     tokens) with a 1024-token window; inputs are the (B, H, S, D) views of
     (B, S, H, D) tensors, as the layer passes them.  bf16 within
     2^-8 max|v| + 2^-8 |ref| elementwise (P rounded to bf16 for P V, and
     the output's rounding), float32 within 1e-5 (P |V|); each timed beside
     its plain version, its bound and, where Sq = Sk and no window,
     ``scaled_dot_product_attention``;
 10. the LM serving path at full width: ``qwen3_0_6b`` (28 layers, d_model
     1024, vocab 151 936, already a multiple of the 128 it pads to, bf16,
     random weights from a seeded generator) with ``attn_impl="flash"`` serves 4 prompts of 2048
     tokens through ``make_prefill_step(cfg, max_len=2112)`` and 64 greedy
     ``make_serve_step`` steps; B6 must launch 28 times (one per layer) in
     the prefill, the flash prefill's logits must be no further from a
     float32 copy of the model than 1.5 x the dense bf16 prefill's plus
     5e-3, four decode steps must match a fresh flash prefill over the same
     prefix, and every logit must be finite; then one more prefill and 8
     decode steps run under ``torch.profiler`` for the device's busy share
     and the kernels that take the most device time.

It then prints the kernels' JSON record, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  It writes no file.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
SMS, BOOST_HZ = 132, 1.98e9    # H100 SXM: 132 SMs x 128 FP32 lanes x 2 x 1.98 GHz = 67e12
# The fewest integer instructions a GF(p) term needs on sm_90, whatever the
# kernel does: one IMAD.WIDE.U32 (acc += (uint64)a * b; four products below
# 2^62 fit a uint64, so a fold can wait four terms) and, once per four terms,
# a fold of the group's sum into a uint64 total, (s & p) + (s >> 31): LOP3,
# two SHF and a 64-bit add (IADD3, IADD3.X), 5 instructions.  The IMAD runs
# on the FMA pipe and the fold on the ALU pipe or, as IMAD forms (2^32 = 2
# mod p), on the FMA pipe: 64 lanes a clock per SM each (the CUDA
# programming guide's throughput table, compute capability 9.0), and the
# four schedulers issue 128 a clock per SM.  Shared between the two pipes,
# the 2.25 instructions a term bind at the issue rate.
GF_INSTR_PER_TERM = 1 + 5 / 4
INT_ISSUE_PER_S = SMS * 128 * BOOST_HZ
TOLERANCE = 1e-5
FP32_REL = 1e-5                # float32 reduction-order bound, times |A| |B|
P = (1 << 31) - 1
CSRC = "src/repro_torch/kernels/csrc/"
KERNELS = {   # wrapper: (source, TPU kernel it replaces)
    "success_tails_cuda_w": (CSRC + "poisson_binomial.cu",
                             "src/repro/kernels/poisson_binomial/kernel.py:147"),
    "success_tails_cuda": (CSRC + "poisson_binomial.cu",
                           "src/repro/kernels/poisson_binomial/kernel.py:117"),
    "matmul_gf_cuda": (CSRC + "gf_matmul.cu", "src/repro/kernels/gf/kernel.py:62"),
    "bmm_gf_cuda": (CSRC + "gf_matmul.cu", "src/repro/kernels/gf/kernel.py:62"),
    "encode_matrix_cuda": (CSRC + "lagrange_encode.cu",
                           "src/repro/kernels/lagrange_encode/kernel.py:36"),
    "coded_gradient_cuda": (CSRC + "coded_gradient.cu",
                            "src/repro/kernels/coded_gradient/kernel.py:40"),
    "flash_attention_cuda": (CSRC + "flash_attention.cu",
                             "src/repro/kernels/flash_attention/kernel.py:110"),
}
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor cores


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warm: int = 3, runs: int = 10) -> float:
    """Median of ``runs`` CUDA-event timings after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def bound_ms(probs: torch.Tensor, w: torch.Tensor, per_row: bool) -> tuple[float, str]:
    """Least time on the card: bytes moved once vs the DP's flops on this data.

    Per row the DP does n(n+1)/2 fused multiply-adds, n multiplies and n
    subtractions, plus one add per tail term of each feasible prefix (the
    counts max(w, 0)..i+1 this run's thresholds need).
    """
    rows, n = probs.shape
    w_bytes = rows * n * 4 if per_row else n * 4
    moved = rows * n * 4 + w_bytes + rows * n * 4
    i = torch.arange(n, device=w.device)
    lo = torch.clamp(w.to(torch.int64), min=0)
    adds = torch.where(w <= i + 1, i + 2 - lo, 0)
    tail_adds = int(adds.sum()) * (1 if per_row else rows)
    flops = rows * (n * (n + 1) + 2 * n) + tail_adds
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(rows: int, n: int, gen: torch.Generator):
    probs = torch.rand((rows, n), generator=gen, device="cuda")
    probs = torch.sort(probs, dim=-1, descending=True).values.contiguous()
    # thresholds <= 0, feasible, infeasible (> i~) and the n + 1 padding value
    w = torch.randint(-2, n + 2, (rows, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    w[:, -1] = n + 1
    return probs, w


def check_kernels(kernel_mod, ref) -> dict:
    """Phase 2: every entry point against the plain version, timed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    main_rows = 2 * 256 * 20_000          # (lea, oracle) x 256 rows x M rounds
    cases = [
        ("success_tails_cuda_w", main_rows, 15, True),
        ("success_tails_cuda", 2 * 20_000, 15, True),   # compare: (lea, oracle) x M
        ("success_tails_cuda_w", 1_000_000, 15, False),
        ("success_tails_cuda", 1_000_000, 15, False),
        ("success_tails_cuda_w", 1_000_000, 64, False),
        ("success_tails_cuda", 1_000_000, 64, False),
        ("success_tails_cuda_w", 100_000, 100, False),
        ("success_tails_cuda", 100_000, 100, False),
    ]
    record = {}
    for name, rows, n, main_shape in cases:
        probs, w = kernel_inputs(rows, n, gen)
        if name == "success_tails_cuda_w":
            run = lambda: kernel_mod.success_tails_cuda_w(probs, w)
            w_ref, per_row = w, True
        else:
            w_static = tuple(int(v) for v in w[0].tolist())
            run = lambda: kernel_mod.success_tails_cuda(probs, w_static)
            w_ref, per_row = w[0].contiguous(), False
        out = run()
        torch.cuda.synchronize()
        want = ref(probs, w_ref)
        torch.cuda.synchronize()
        if out.shape != want.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} n={n}: bad output {tuple(out.shape)}")
        err = float((out - want).abs().max())
        if err > TOLERANCE:
            raise AssertionError(f"{name} rows={rows} n={n}: max|diff| {err} > {TOLERANCE}")
        ms = time_ms(run)
        plain_ms = time_ms(lambda: ref(probs, w_ref), warm=1, runs=3)
        b_ms, b_by = bound_ms(probs, w_ref, per_row)
        log("kernel", name=name, rows=rows, n=n, main_shape=main_shape,
            max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.3f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            bound_share=f"{b_ms / ms:.3f}")
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main_shape:
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         shape=[rows, n])
        del probs, w, out, want
        torch.cuda.empty_cache()
    return record


def _bound(moved_bytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """Larger of the bytes' and the operations' least times, in ms."""
    t_bytes = moved_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def gf_residues(shape, gen: torch.Generator) -> torch.Tensor:
    """Random int32 residues on the card with 0, 1 and p-1 planted."""
    t = torch.randint(0, P, shape, generator=gen, device="cuda", dtype=torch.int32)
    t.view(-1)[:3] = torch.tensor([0, 1, P - 1], dtype=torch.int32, device="cuda")
    return t


def check_coding_kernels() -> dict:
    """Phase 6: B3, B4 and B5 against their plain versions, timed."""
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import gf
    from repro_torch.kernels import lagrange_encode as le

    if not gf.full_fp32_matmul():
        raise AssertionError("float32 matmuls must run in true float32 here")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    record = {}

    def keep(name, err, main, **timing):
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update(timing)

    # B3: (batch, m, c, n); the main shape of each wrapper first
    gf_cases = [
        ("matmul_gf_cuda", "encode", (1, 150, 120, 75_000), True),
        ("matmul_gf_cuda", "worker shards", (1, 3750, 3000, 8), False),
        ("matmul_gf_cuda", "decode", (1, 120, 120, 200), False),
        ("matmul_gf_cuda", "deg-2 residual", (1, 9000, 3000, 1), False),
        ("matmul_gf_cuda", "deg-2 decode", (1, 50, 99, 3000), False),
        ("matmul_gf_cuda", "ragged", (1, 37, 301, 19), False),
        ("bmm_gf_cuda", "deg-2 gradient", (150, 3000, 60, 1), True),
        ("bmm_gf_cuda", "ragged", (3, 37, 301, 5), False),
    ]
    for name, what, (batch, m, c, n), main in gf_cases:
        lead = () if name == "matmul_gf_cuda" else (batch,)
        a = gf_residues(lead + (m, c), gen)
        b = gf_residues(lead + (c, n), gen)
        a[..., 0, :] = P - 1                      # a row and a column of p-1
        b[..., :, 0] = P - 1
        kern = getattr(gf, name)
        run = lambda: kern(a, b)
        plain = lambda: gf.matmul_gf_dot(a, b)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if got.shape != want.shape or err != 0:
            raise AssertionError(f"{name} {what} {(batch, m, c, n)}: max|diff| {err}")
        ms = time_ms(run)
        plain_ms = time_ms(plain, warm=1, runs=3)
        b_ms, b_by = _bound(4 * batch * (m * c + c * n + m * n),
                            batch * m * c * n * GF_INSTR_PER_TERM, INT_ISSUE_PER_S)
        log("kernel", name=name, case=json.dumps(what), shape=(batch, m, c, n),
            max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, bound_share=f"{b_ms / ms:.3f}")
        keep(name, err, main, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
             bound_by=b_by, library_ms=None, composition_ms=plain_ms,
             composition="matmul_gf_dot: 8-bit limb split, one fp32 torch.matmul "
                         "per 256-wide K-chunk, 16 Mersenne rotations and adds",
             shape=[batch, m, c, n])
        del a, b, got, want

    # B4: (nr, k, cols)
    # (150, 8) is the float regression at k = 8, read in phase 7; (150, 5) the
    # one phase 7 checks
    for (nr, k, cols), main in (((150, 8, 180_000), True), ((150, 5, 180_000), False),
                                ((37, 5, 1001), False)):
        g = torch.randn((nr, k), generator=gen, device="cuda")
        x = torch.randn((k, cols), generator=gen, device="cuda")
        run = lambda: le.encode_matrix_cuda(g, x)
        plain = lambda: le.encode_matrix_ref(g, x)
        got, want = run(), plain()
        bound = FP32_REL * (g.abs() @ x.abs())
        diff = (got - want).abs()
        torch.cuda.synchronize()
        err = float(diff.max())
        if not bool(torch.isfinite(got).all()) or bool((diff > bound).any()):
            raise AssertionError(f"encode_matrix_cuda {(nr, k, cols)}: max|diff| {err}")
        ms = time_ms(run)
        plain_ms = time_ms(plain, warm=1, runs=3)
        library_ms = time_ms(lambda: torch.matmul(g, x))
        b_ms, b_by = _bound(4 * (nr * k + k * cols + nr * cols), 2 * nr * k * cols,
                            FP32_FLOP_PER_S)
        log("kernel", name="encode_matrix_cuda", shape=(nr, k, cols),
            max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{library_ms:.4f}", bound_ms=f"{b_ms:.4f}", bound_by=b_by,
            bound_share=f"{b_ms / ms:.3f}")
        keep("encode_matrix_cuda", err, main, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
             shape=[nr, k, cols])
        del g, x, got, want, bound, diff

    # B5: (nr, R, C, P)
    for (nr, r_rows, c, p), main in (((150, 60, 3000, 1), True), ((7, 13, 301, 3), False)):
        x = torch.randn((nr, r_rows, c), generator=gen, device="cuda")
        y = torch.randn((nr, r_rows, p), generator=gen, device="cuda")
        w = torch.randn((c, p), generator=gen, device="cuda")
        run = lambda: cg.coded_gradient_cuda(x, y, w)
        plain = lambda: cg.coded_gradient_ref(x, y, w)
        w_b = w.expand(nr, c, p)
        two_bmm = lambda: torch.bmm(x.transpose(1, 2), torch.bmm(x, w_b) - y)
        got, want = run(), plain()
        ax = x.abs()
        bound = FP32_REL * torch.bmm(ax.transpose(1, 2), torch.bmm(ax, w_b.abs()) + y.abs())
        diff = (got - want).abs()
        torch.cuda.synchronize()
        err = float(diff.max())
        if not bool(torch.isfinite(got).all()) or bool((diff > bound).any()):
            raise AssertionError(f"coded_gradient_cuda {(nr, r_rows, c, p)}: max|diff| {err}")
        ms = time_ms(run)
        plain_ms = time_ms(plain, warm=1, runs=3)
        composition_ms = time_ms(two_bmm)
        b_ms, b_by = _bound(4 * (nr * r_rows * c + nr * r_rows * p + c * p + nr * c * p),
                            4 * nr * r_rows * c * p, FP32_FLOP_PER_S)
        log("kernel", name="coded_gradient_cuda", shape=(nr, r_rows, c, p),
            max_abs_err=err, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            composition_ms=f"{composition_ms:.4f}", bound_ms=f"{b_ms:.4f}",
            bound_by=b_by, bound_share=f"{b_ms / ms:.3f}")
        keep("coded_gradient_cuda", err, main, ms=ms, plain_ms=plain_ms,
             bound_ms=b_ms, bound_by=b_by, library_ms=None,
             composition_ms=composition_ms,
             composition="two torch.bmm calls (x w - y, then x^T resid), TF32 off",
             shape=[nr, r_rows, c, p])
        del x, y, w, got, want, bound, diff, ax
    torch.cuda.empty_cache()
    return record


def coding_launches() -> dict[str, int]:
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import gf
    from repro_torch.kernels import lagrange_encode as le
    return {**gf.launch_counts(), **le.launch_counts(), **cg.launch_counts()}


def reset_all_launch_counts() -> None:
    from repro_torch.kernels import coded_gradient as cg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import gf
    from repro_torch.kernels import lagrange_encode as le
    from repro_torch.kernels import poisson_binomial as pb
    for mod in (pb, gf, le, cg, fa):
        mod.reset_launch_counts()


def _feasible_rounds(masks: torch.Tensor, kstar: int) -> list[int]:
    return torch.nonzero(masks.sum(dim=-1) >= kstar)[:, 0].tolist()


def exact_deg1(co, lg, throughput, LoadParams) -> None:
    """Phase 7a: the exact degree-1 round at EC2 scenario 1 (Sec. 6.2)."""
    spec = lg.CodeSpec(15, 10, 120, 1)                 # nr = 150, K* = 120
    rows, cols, d = 25, 3000, 8
    rng = np.random.default_rng(61)
    x = rng.integers(0, P, size=(spec.k, rows, cols), dtype=np.int32)
    w = rng.integers(0, P, size=(cols, d), dtype=np.int32)
    lp = LoadParams(15, 120, 10, 1)
    states, loads, feas = throughput.rollout(21, lp, [0.85] * 15, [0.6] * 15, 2000,
                                             strategies=("lea",), device="cuda")
    masks = co.chunk_on_time(states, loads[0], 10.0, 1.0, 2.5, spec.r)
    success = throughput.score_rollout(states, loads, feas, lp, 10.0, 1.0, 2.5)[:, 0]
    if not torch.equal((masks.sum(dim=-1) >= spec.recovery_threshold) & feas[0], success):
        raise AssertionError("chunk masks disagree with the engine's round success")
    rounds = _feasible_rounds(masks, spec.recovery_threshold)
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = co.encode_dataset_modp(spec, x, device="cuda")
    w_dev = torch.as_tensor(w, device="cuda")
    first, oks = [], []
    for m in rounds:
        out, ok = co.coded_matmul_exact(coded, w_dev, masks[m])
        oks.append(ok)
        if len(first) < 8:
            first.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = coding_launches()      # before the checks below launch more
    if not bool(torch.stack(oks).all()):
        raise AssertionError("an exact deg-1 round with >= K* results reported not ok")
    # the CPU plain route on the same data and the first 8 rounds
    coded_cpu = co.encode_dataset_modp(spec, x, device="cpu")
    if not torch.equal(coded.x_tilde.cpu(), coded_cpu.x_tilde):
        raise AssertionError("encode on the card differs from the CPU plain route")
    for m, out in zip(rounds, first):
        out_cpu, ok = co.coded_matmul_exact(coded_cpu, torch.as_tensor(w), masks[m].cpu())
        if not bool(ok) or not torch.equal(out.cpu(), out_cpu):
            raise AssertionError(f"exact deg-1 round {m}: card differs from the CPU")
    # the numpy oracle: the encode on a 64-column slice of the flat data, and
    # one whole round of the 64-column sub-problem
    g_np = lg.generator_matrix_modp(spec)
    x_flat = x.reshape(spec.k, -1)
    if not np.array_equal(coded.x_tilde.reshape(spec.nr, -1)[:, :64].cpu().numpy(),
                          lg.matmul_modp(g_np, x_flat[:, :64])):
        raise AssertionError("encode differs from numpy matmul_modp on the slice")
    x64, w64 = x[:, :, :64], w[:64]
    on = masks[rounds[0]]
    out64, ok = co.coded_matmul_exact(co.encode_dataset_modp(spec, x64, device="cuda"),
                                      torch.as_tensor(w64, device="cuda"), on)
    xt = lg.matmul_modp(g_np, x64.reshape(spec.k, -1))
    res = lg.matmul_modp(xt.reshape(spec.nr * rows, 64), w64).reshape(spec.nr, rows, d)
    rec = np.nonzero(on.cpu().numpy())[0][: spec.recovery_threshold]
    want = lg.matmul_modp(lg.decode_matrix_modp(spec, rec), res[rec])
    if not bool(ok) or not np.array_equal(out64.cpu().numpy().astype(np.int64), want):
        raise AssertionError("exact deg-1 round differs from the numpy oracle")
    log("exact_deg1", spec="CodeSpec(15,10,120,1)", x=(spec.k, rows, cols), w=(cols, d),
        rollout_rounds=2000, feasible_rounds=len(rounds),
        lea_throughput=f"{float(success.float().mean()):.4f}", wall_s=f"{wall:.3f}",
        ms_per_round=f"{wall / max(len(rounds), 1) * 1e3:.3f}",
        cpu_rounds_equal=len(first), numpy_slice_equal=True,
        launches=json.dumps(launches))
    return launches


def exact_deg2(co, lg, throughput, LoadParams) -> None:
    """Phase 7b: the exact degree-2 gradient at Sec. 6.1 (Fig. 3 scenario 3)."""
    spec = lg.CodeSpec(15, 10, 50, 2)                  # nr = 150, K* = 99
    rows, cols = 60, 3000
    rng = np.random.default_rng(62)
    x = rng.integers(0, P, size=(spec.k, rows, cols), dtype=np.int32)
    y = rng.integers(0, P, size=(spec.k, rows), dtype=np.int32)
    w = rng.integers(0, P, size=(cols,), dtype=np.int32)
    lp = LoadParams(15, 99, 10, 3)
    states, loads, _ = throughput.rollout(22, lp, [0.8] * 15, [0.533] * 15, 2000,
                                          strategies=("lea",), device="cuda")
    masks = co.chunk_on_time(states, loads[0], 10.0, 3.0, 1.0, spec.r)
    rounds = _feasible_rounds(masks, spec.recovery_threshold)
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = co.encode_dataset_modp(spec, x, y, device="cuda")
    w_dev = torch.as_tensor(w, device="cuda")
    first, oks = [], []
    for m in rounds:
        out, ok = co.coded_linear_gradient_modp(coded, w_dev, masks[m])
        oks.append(ok)
        if len(first) < 6:
            first.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = coding_launches()
    if not bool(torch.stack(oks).all()):
        raise AssertionError("an exact deg-2 round with >= K* results reported not ok")
    coded_cpu = co.encode_dataset_modp(spec, x, y, device="cpu")
    if not (torch.equal(coded.x_tilde.cpu(), coded_cpu.x_tilde)
            and torch.equal(coded.y_tilde.cpu(), coded_cpu.y_tilde)):
        raise AssertionError("deg-2 encode on the card differs from the CPU plain route")
    for m, out in zip(rounds, first):
        out_cpu, ok = co.coded_linear_gradient_modp(coded_cpu, torch.as_tensor(w),
                                                    masks[m].cpu())
        if not bool(ok) or not torch.equal(out.cpu(), out_cpu):
            raise AssertionError(f"exact deg-2 round {m}: card differs from the CPU")
    log("exact_deg2", spec="CodeSpec(15,10,50,2)", x=(spec.k, rows, cols),
        rollout_rounds=2000, feasible_rounds=len(rounds), wall_s=f"{wall:.3f}",
        ms_per_round=f"{wall / max(len(rounds), 1) * 1e3:.3f}",
        cpu_rounds_equal=len(first), launches=json.dumps(launches))
    return launches


def float_regression(co, lg, throughput, LoadParams, k: int = 5,
                     checked: bool = True) -> dict[str, int]:
    """Phase 7c: coded least-squares descent through B4 and B5, LEA vs static.

    ``checked`` (k = 5): every accepted round within 1e-2 relative of the
    uncoded gradient, the device decode on five rounds too, LEA above
    static.  CodeSpec(15, 10, 5, 2) has K* = 9 <= r, so every received set a
    round can have lies on one or two workers' strided Chebyshev nodes.  At
    k = 8 (K* = 15 > r, the size first planned) the received sets pair up
    nodes and the float32 decode amplifies round-off by a Lebesgue constant
    of 6.8e6; that run is read, not checked: it logs the per-round relative
    errors and the rounds the example's guard rejects.  Bad workers finish
    nothing in the deadline (mu_b * d < 1, ell_b = 0) and good ones are
    scarce (pi_g = 0.2), which is where LEA's allocation matters.  The step
    is a tenth of the example's: with 300 equations in 3000 unknowns the
    example's step drives the gradient to 1e-4 of its start within 60
    rounds, and a vanishing gradient makes the relative error of any float32
    gradient, coded or not, grow without bound.
    """
    spec = lg.CodeSpec(15, 10, k, 2)
    rows, cols, rounds = 60, 3000, 200
    mu_g, mu_b, dl = 10.0, 0.5, 1.0
    lp = LoadParams(15, spec.recovery_threshold, 10, 0)
    rng = np.random.default_rng(63)
    w_true = rng.normal(size=(cols,))
    x_np = rng.normal(size=(k, rows, cols))
    y_np = x_np @ w_true + 0.01 * rng.normal(size=(k, rows))
    x = torch.as_tensor(x_np, dtype=torch.float32, device="cuda")
    y = torch.as_tensor(y_np, dtype=torch.float32, device="cuda")
    strategies = ("lea", "static_equal")
    states, loads, feas = throughput.rollout(23, lp, [0.6] * 15, [0.9] * 15, rounds,
                                             strategies=strategies, device="cuda")
    success = throughput.score_rollout(states, loads, feas, lp, mu_g, mu_b, dl).cpu().numpy()
    on_time = co.chunk_on_time(states, loads, mu_g, mu_b, dl, spec.r).cpu().numpy()
    reset_all_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    coded = co.encode_dataset(spec, x, y)
    lr = 2e-3 / (k * rows)
    line, device_checks = {}, []
    for j, s in enumerate(strategies):
        cache = co.DecodeCache(spec)
        w = torch.zeros((cols,), dtype=torch.float32, device="cuda")
        rels, caught = [], []
        for m in range(rounds):
            if not success[m, j]:
                continue
            grad = co.coded_linear_gradient(coded, w, on_time[j, m], cache=cache)
            gnorm = float(torch.linalg.norm(grad))
            if not np.isfinite(gnorm) or gnorm > 1e4 * k * rows:   # the example's guard
                caught.append(m)
                continue
            true = co.uncoded_linear_gradient(x, y, w)
            rel = float(torch.linalg.norm(grad - true) / torch.linalg.norm(true))
            if checked and not rel <= 1e-2:
                raise AssertionError(f"{s} round {m}: decoded gradient rel err {rel}")
            if checked and len(rels) < 5:      # the device decode, checked below
                device_checks.append((s, m, w, on_time[j, m], true))
            rels.append(rel)
            w = w - lr * grad
        loss = float(torch.mean((x @ w - y) ** 2))
        rel_np = np.asarray(rels)
        line[s] = {"engine": float(throughput.timely_throughput(torch.as_tensor(success[:, j]))),
                   "accepted": len(rels) / rounds, "guard_caught_rounds": caught,
                   "rel_err_first10": [float(f"{v:.3g}") for v in rels[:10]],
                   "rel_err_median": float(np.median(rel_np)) if rels else None,
                   "rel_err_p90": float(np.quantile(rel_np, 0.9)) if rels else None,
                   "rel_err_max": float(rel_np.max()) if rels else None,
                   "rel_err_over_1e-2": int((rel_np > 1e-2).sum()),
                   "loss": loss, "decode_mats": len(cache)}
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = coding_launches()
    for s, m, w, mask, true in device_checks:
        dev_grad, ok = co.coded_linear_gradient_device(coded, w, torch.as_tensor(mask, device="cuda"))
        rel_dev = float(torch.linalg.norm(dev_grad - true) / torch.linalg.norm(true))
        if not bool(ok) or not rel_dev <= 1e-2:
            raise AssertionError(f"{s} round {m}: device decode rel err {rel_dev}")
    if checked and not line["lea"]["accepted"] > line["static_equal"]["accepted"]:
        raise AssertionError(f"LEA does not beat static in the coded regression: {line}")
    log("float_regression", spec=f"CodeSpec(15,10,{k},2)", checked=checked,
        x=(k, rows, cols), rounds=rounds, wall_s=f"{wall:.3f}",
        loss_at_zero=f"{float(torch.mean(y ** 2)):.2f}", launches=json.dumps(launches),
        **{s: json.dumps(v) for s, v in line.items()})
    return launches


def coded_path() -> dict[str, int]:
    """Phase 7: the coded-computing path.  Each part sets the counts to 0
    before its own work and reads them after it, before its cross-checks;
    returns their sum."""
    from repro_torch.core import coded_ops as co
    from repro_torch.core import lagrange as lg
    from repro_torch.core import throughput
    from repro_torch.core.lea import LoadParams

    parts = {"exact_deg1": lambda: exact_deg1(co, lg, throughput, LoadParams),
             "exact_deg2": lambda: exact_deg2(co, lg, throughput, LoadParams),
             "float_k5": lambda: float_regression(co, lg, throughput, LoadParams),
             "float_k8_read": lambda: float_regression(co, lg, throughput, LoadParams,
                                                       k=8, checked=False)}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_part = {name: part() for name, part in parts.items()}
    launches = {name: sum(c[name] for c in per_part.values())
                for name in coding_launches()}
    idle = [name for name, count in launches.items() if count < 1]
    if idle:
        raise AssertionError(f"the coded path never launched {idle}: {per_part}")
    log("coded_path", wall_s=f"{time.perf_counter() - t0:.3f}",
        launches=json.dumps(launches))
    return launches


def visible_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs the masks leave visible: what B6's work depends on."""
    pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(sk - 1, pos) if causal else np.full(sq, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window is not None else np.zeros(sq, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def check_flash_kernel() -> dict:
    """Phase 9: B6 against ``flash_attention_ref`` on the card, timed."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_ref

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    bf16, f32 = torch.bfloat16, torch.float32
    # (case, B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, main shape)
    cases = [
        ("prefill", 4, 16, 8, 2048, 2048, 128, bf16, True, None, True),
        ("prefill f32", 4, 16, 8, 2048, 2048, 128, f32, True, None, False),
        ("ragged", 4, 16, 8, 1000, 1000, 128, bf16, True, None, False),
        ("non-causal", 4, 16, 8, 2048, 2048, 128, bf16, False, None, False),
        ("decode-aligned", 4, 16, 8, 16, 2048, 128, bf16, True, None, False),
        ("sq>sk", 2, 16, 8, 300, 100, 128, bf16, True, None, False),
        # Mixtral's attention widths; the window cut from its 4096 so that
        # masking matters at 4096 tokens and the plain version fits
        ("mixtral window", 1, 48, 8, 4096, 4096, 128, bf16, True, 1024, False),
    ]
    record = {}
    for what, b, hq, hkv, sq, sk, d, dt, causal, window, main in cases:
        # (B, H, S, D) views of (B, S, H, D) tensors, as attention_train passes them
        q = torch.randn((b, sq, hq, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
        k = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
        v = torch.randn((b, sk, hkv, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
        run = lambda: flash_attention_cuda(q, k, v, causal=causal, window=window)
        plain = lambda: flash_attention_ref(q, k, v, causal=causal, window=window, block_q=1024)
        got, want = run(), plain()
        torch.cuda.synchronize()
        diff = (got.float() - want.float()).abs()
        if dt == f32:
            tol = "1e-5 (P|V|)"
            bound = FP32_REL * flash_attention_ref(q, k, v.abs(), causal=causal,
                                                   window=window, block_q=1024)
        else:
            tol = "2^-8 max|v| + 2^-8 |ref|"
            bound = 2.0 ** -8 * (v.float().abs().amax() + want.float().abs())
        err = float(diff.max())
        if got.shape != want.shape or not bool(torch.isfinite(got).all()) \
                or bool((diff > bound).any()):
            raise AssertionError(f"flash_attention_cuda {what}: max|diff| {err} ({tol})")
        zero_rows = max(sq - sk, 0) if causal else 0
        if zero_rows and bool(got[:, :, :zero_rows].any()):
            raise AssertionError(f"flash_attention_cuda {what}: rows with no key are not 0")
        ms = time_ms(run)
        plain_ms = time_ms(plain, warm=1, runs=3)
        library_ms = None
        if sq == sk and window is None:
            sdpa = torch.nn.functional.scaled_dot_product_attention
            library_ms = time_ms(lambda: sdpa(q, k, v, is_causal=causal, enable_gqa=True))
        pairs = visible_pairs(sq, sk, causal, window)
        moved = q.element_size() * (2 * b * hq * sq * d + 2 * b * hkv * sk * d)
        b_ms, b_by = _bound(moved, 4 * d * pairs * b * hq,
                            BF16_FLOP_PER_S if dt == bf16 else FP32_FLOP_PER_S)
        log("kernel", name="flash_attention_cuda", case=json.dumps(what),
            q=(b, hq, sq, d), kv=(b, hkv, sk, d), dtype=str(dt).split(".")[-1],
            causal=causal, window=window, zero_rows=zero_rows, max_abs_err=err,
            tolerance=json.dumps(tol), ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=None if library_ms is None else f"{library_ms:.4f}",
            bound_ms=f"{b_ms:.4f}", bound_by=b_by, bound_share=f"{b_ms / ms:.3f}")
        entry = record.setdefault("flash_attention_cuda", {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         library_ms=library_ms,
                         library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
                         shape=[[b, hq, sq, d], [b, hkv, sk, d]])
        del q, k, v, got, want, diff, bound
        torch.cuda.empty_cache()
    return record


def timed(fn):
    """(result, seconds) of ``fn()``, synchronised on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def serve_lm() -> int:
    """Phase 10: the LM serving path at full width; returns B6's launches
    in the main path's run (one flash prefill and the decode steps)."""
    import copy
    import dataclasses

    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api

    # float32 sums in every bf16 GEMM, as JAX's preferred_element_type asks
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    batch, prompt, steps = 4, 2048, 64
    checked_steps = (0, 21, 42, 63)
    cfg = get_config("qwen3_0_6b", attn_impl="flash")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(10)
    params = api.get_model(cfg).init_params(gen, cfg, device="cuda")
    n_params = sum(t.numel() for t in params.parameters())
    tokens = api.make_batch(cfg, ShapeCell("serve", prompt, batch, "prefill"), gen,
                            device="cuda")["tokens"]
    prefill = api.make_prefill_step(cfg, max_len=prompt + steps)
    serve = api.make_serve_step(cfg)

    # warm-up (cuBLAS handles, the allocator): one prefill and one step
    logits, cache = prefill(params, {"tokens": tokens})
    serve(params, cache, {"next_token": logits.argmax(-1)})
    del logits, cache
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- the main path: prefill, then greedy decode ---------------------------
    reset_all_launch_counts()
    (logits, cache), prefill_s = timed(lambda: prefill(params, {"tokens": tokens}))
    launches_prefill = fa.launch_counts()["flash_attention_cuda"]
    first_logits = logits
    fed, kept = [], {}

    def decode():
        nonlocal logits, cache
        for t in range(steps):
            tok = logits.argmax(-1)
            fed.append(tok)
            logits, cache = serve(params, cache, {"next_token": tok})
            if t in checked_steps:
                kept[t] = logits
    _, decode_s = timed(decode)
    launches = fa.launch_counts()["flash_attention_cuda"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if launches_prefill != cfg.n_layers or launches != cfg.n_layers:
        raise AssertionError(f"B6 launched {launches_prefill} times in the prefill and "
                             f"{launches} in all, not once per layer ({cfg.n_layers})")
    # 4. every logit finite
    if not all(bool(torch.isfinite(t).all()) for t in (first_logits, *kept.values())):
        raise AssertionError("non-finite logits on the serving path")

    # 2. flash vs dense, against a float32 copy of the model: the kernel must
    #    be no less accurate than the plain attention it replaces
    dense = api.make_prefill_step(cfg, max_len=prompt + steps, attn_impl="ref")
    dense_logits, dense_s = timed(lambda: dense(params, {"tokens": tokens})[0])
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = copy.deepcopy(params).to(torch.float32)
    ref32 = api.make_prefill_step(cfg32, max_len=prompt, attn_impl="ref")
    want = ref32(params32, {"tokens": tokens})[0]
    del params32
    torch.cuda.empty_cache()
    real = slice(0, cfg.vocab_size)
    err_flash = float((first_logits[:, real] - want[:, real]).abs().max())
    err_dense = float((dense_logits[:, real] - want[:, real]).abs().max())
    if not err_flash <= 1.5 * err_dense + 5e-3:
        raise AssertionError(f"flash prefill max|err| {err_flash} vs float32, dense bf16 "
                             f"{err_dense}: above 1.5 x dense + 5e-3")

    # 3. decode vs prefill: step t's logits against a fresh flash prefill over
    #    the prompt and the t + 1 tokens fed so far.  Both are bf16 evaluations
    #    of the same function, each about err_dense from float32, so they may
    #    differ by twice that; 0.02 covers the max over other positions.
    tol = 2 * err_dense + 0.02
    generated = torch.stack(fed, dim=1)                 # (B, steps)
    before = fa.launch_counts()["flash_attention_cuda"]
    worst = 0.0
    for t, got in kept.items():
        prefix = torch.cat([tokens, generated[:, :t + 1]], dim=1)
        fresh = api.make_prefill_step(cfg, max_len=prefix.shape[1])(params, {"tokens": prefix})[0]
        diff = float((got[:, real] - fresh[:, real]).abs().max())
        worst = max(worst, diff)
        if not diff <= tol:
            raise AssertionError(f"decode step {t}: max|decode - prefill| {diff} > {tol}")
    if fa.launch_counts()["flash_attention_cuda"] - before != cfg.n_layers * len(kept):
        raise AssertionError("a fresh prefill did not launch B6 once per layer")

    profile = profile_serving(prefill, serve, params, tokens)

    log("serve", config=cfg.name, params=n_params, layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.padded_vocab, dtype=cfg.dtype,
        batch=batch, prompt=prompt, decode_steps=steps,
        prefill_ms=f"{prefill_s * 1e3:.3f}", dense_prefill_ms=f"{dense_s * 1e3:.3f}",
        prefill_tokens_per_s=f"{batch * prompt / prefill_s:.0f}",
        decode_ms_per_step=f"{decode_s / steps * 1e3:.3f}",
        decode_tokens_per_s=f"{batch * steps / decode_s:.1f}",
        peak_memory_gib=f"{peak_gib:.2f}", flash_launches=launches,
        err_flash_vs_f32=err_flash, err_dense_vs_f32=err_dense,
        decode_vs_prefill_max=worst, decode_vs_prefill_tol=tol,
        checked_steps=json.dumps(list(kept)), gpu=json.dumps(nvidia_smi_line()))
    for part, line in profile.items():
        log("serve_profile", part=part, **line)
    return launches


def profile_serving(prefill, serve, params, tokens, steps: int = 8) -> dict:
    """Device busy share and the top kernels by device time of one prefill
    and of ``steps`` decode steps, from ``torch.profiler``'s kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def window(fn):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, wall = timed(fn)
        by_name: dict[str, float] = {}
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        for e in kernels:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
        busy_ms = sum(by_name.values()) / 1e3
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
        return {"wall_ms": f"{wall * 1e3:.3f}", "device_busy_ms": f"{busy_ms:.3f}",
                "kernel_launches": len(kernels),
                "idle_share": f"{1 - busy_ms / (wall * 1e3):.3f}",
                "top_kernels_ms": json.dumps({n[:60]: round(us / 1e3, 3) for n, us in top})}

    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, {"tokens": tokens})

    def run_decode():
        for _ in range(steps):
            state["logits"], state["cache"] = serve(
                params, state["cache"], {"next_token": state["logits"].argmax(-1)})

    return {"prefill": window(run_prefill), f"decode_{steps}_steps": window(run_decode)}


class RecordedDraws:
    """Hands out a Draws' numbers and keeps a CPU copy of each, in order, so
    the same numbers can be replayed to the CPU engine (phase 5)."""

    def __init__(self, inner):
        self.inner, self.calls = inner, []

    def _keep(self, t):
        self.calls.append(t.cpu())
        return t

    def initial(self, *a):
        return self._keep(self.inner.initial(*a))

    def steps(self, *a):
        return self._keep(self.inner.steps(*a))

    def static(self, *a):
        return self._keep(self.inner.static(*a))

    def single(self, *a):
        return self._keep(self.inner.single(*a))


class ReplayedDraws:
    def __init__(self, calls):
        self.calls = list(calls)

    def _next(self, *a):
        return self.calls.pop(0)

    initial = steps = static = single = _next


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from repro_torch import sweeps
    from repro_torch.core import throughput
    from repro_torch.core.lea import LoadParams
    from repro_torch.kernels import build
    from repro_torch.kernels.poisson_binomial import kernel as kernel_mod
    from repro_torch.kernels.poisson_binomial import success_tails_ref
    from repro_torch.random import torch_draws

    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    builds = build.build_all()
    log("env", gpu=json.dumps(smi), torch=torch.__version__,
        cuda=torch.version.cuda, build_all_s=f"{time.perf_counter() - t0:.2f}")
    for built in builds:
        log("build", source=built.name, build_s=f"{built.seconds:.2f}",
            library=built.path.name)
        for line in built.log.splitlines():
            if "registers" in line or "spill" in line:
                log("ptxas", source=built.name, line=json.dumps(line.strip()))

    record = check_kernels(kernel_mod, success_tails_ref)

    # -- phase 3: the main path ------------------------------------------------
    bench = json.loads((ROOT / "BENCH_fig3.json").read_text())
    strategies = ("lea", "static", "oracle")
    kernel_mod.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    results = sweeps.run("fig3", seeds=64)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches_main = kernel_mod.launch_counts()
    if launches_main["success_tails_cuda_w"] < 1:
        raise AssertionError(f"main path never launched the per-row kernel: {launches_main}")
    rounds = results[0].scenario.rounds
    rows = sum(r.seeds for r in results)
    for r, ref_row in zip(results, bench["results"]):
        line = {}
        for s in strategies:
            vals = np.asarray(r.per_seed[s])
            mean, sd = float(vals.mean()), float(vals.std(ddof=1))
            if not np.isfinite(vals).all() or abs(mean - ref_row[f"R_{s}"]) > 4.5 * sd:
                raise AssertionError(
                    f"{r.name} {s}: R={mean} vs BENCH_fig3 {ref_row[f'R_{s}']} "
                    f"(sd {sd})")
            line[f"R_{s}"] = f"{mean:.4f}"
            line[f"sd_{s}"] = f"{sd:.4f}"
        if not r.throughput["lea"] > r.throughput["static"]:
            raise AssertionError(f"{r.name}: LEA does not beat static")
        log("fig3", scenario=r.name, **line,
            lea_over_static=f"{r.throughput['lea'] / r.throughput['static']:.2f}x")
    log("main", wall_s=f"{wall:.3f}", rows=rows, rounds=rounds,
        row_rounds_per_s=f"{rows * rounds / wall:.0f}",
        dp_rows_per_s=f"{2 * rows * rounds / wall:.0f}",
        max_memory_gib=f"{torch.cuda.max_memory_allocated() / 2**30:.2f}",
        launches=json.dumps(launches_main))

    # -- phase 4: the static-threshold entry ------------------------------------
    kernel_mod.reset_launch_counts()
    t0 = time.perf_counter()
    cmp = throughput.compare(1, LoadParams(15, 99, 10, 3), [0.8] * 15,
                             [0.8] * 15, 10.0, 3.0, 1.0, 20_000)
    torch.cuda.synchronize()
    wall_cmp = time.perf_counter() - t0
    launches_static = kernel_mod.launch_counts()
    if launches_static["success_tails_cuda"] < 1:
        raise AssertionError(f"compare never launched the static kernel: {launches_static}")
    if not cmp["lea"] > cmp["static"]:
        raise AssertionError(f"compare: LEA does not beat static: {cmp}")
    log("compare", **{f"R_{s}": f"{v:.4f}" for s, v in cmp.items()},
        wall_s=f"{wall_cmp:.3f}", launches=json.dumps(launches_static))

    # -- phase 5: card and CPU agree on the same draws --------------------------
    group, = sweeps.build_groups(sweeps.expand("fig3", rounds=2000), seeds=4)
    recorder = RecordedDraws(torch_draws(7))
    on_card = sweeps.run_group(group, draws=recorder)
    on_cpu = sweeps.run_group(group, device="cpu",
                              draws=ReplayedDraws(recorder.calls))
    if on_card.shape != on_cpu.shape:
        raise AssertionError(f"shapes {on_card.shape} != {on_cpu.shape}")
    differ = int((on_card != on_cpu).any(axis=-1).sum())
    if differ > on_card.shape[0] * on_card.shape[1] // 1000:
        raise AssertionError(f"card and CPU differ in {differ} rounds")
    log("agree", rows=on_card.shape[0], rounds=on_card.shape[1],
        differing_rounds=differ)

    # -- phase 6: the coding kernels against their plain versions -------------
    record.update(check_coding_kernels())

    # -- phase 7: the coded path -------------------------------------------------
    launches_coded = coded_path()

    # -- phase 8: the ported example ---------------------------------------------
    from repro_torch.examples import coded_regression
    t0 = time.perf_counter()
    ex = coded_regression.run(device="cuda")
    torch.cuda.synchronize()
    log("example", wall_s=f"{time.perf_counter() - t0:.3f}",
        throughput=json.dumps(ex["throughput"]), loss=json.dumps(ex["loss"]),
        exact_checked=ex["exact_checked"])

    # -- phase 9: flash attention against its plain version ----------------------
    record.update(check_flash_kernel())

    # -- phase 10: the LM serving path -------------------------------------------
    launches_lm = serve_lm()

    kernels = []
    launches = {"success_tails_cuda_w": launches_main["success_tails_cuda_w"],
                "success_tails_cuda": launches_static["success_tails_cuda"],
                **launches_coded, "flash_attention_cuda": launches_lm}
    for name, (source, replaces) in KERNELS.items():
        entry = record[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry.get("library_ms"),
            "composition_ms": entry.get("composition_ms"),
            "composition": entry.get("composition"),
            "library": entry.get("library"),
            "shape": entry["shape"],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
