"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

  1. environment: the card's name and power limit (``nvidia-smi``), torch and
     CUDA versions, and the nvcc builds of every ``csrc/*.cu``, one nvcc
     process per source, all started together;
  2. each kernel entry point against its plain PyTorch version on the card,
     bit for bit: the per-row entry on the sweep engine's layout (probabilities
     (2, 256, 20 000, 15), thresholds (1, 256, 1, 15) read as they lie; also
     (2, 256, 2 000, 64)) and on (rows, n) thresholds, the static entry with a tuple, at
     n = 15, 64 and 100, and at the fault path's shapes (phase 11): the
     grid's probabilities (1, 72, 20 000, 15) with thresholds (1, 72, 1, 15),
     the executor's plan on one 8-worker row (1, 8) and on one 15-worker row
     (1, 15); each with its time, the plain version's time and the
     card's bound for the same work (distinct threshold rows counted once).
     Every time here and in phases 6 and 9 is taken twice, the
     same way for kernel, plain version and library call (``time_ms``): a
     single call between CUDA events (``ms``; on an idle card this counts
     the call's host work before its launch too) and 10 back-to-back calls
     over 10 (``*_batched``; host work hidden where it is shorter than the
     kernel), each the median of warm runs;
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
     bit, residues 0 and p-1 included) at every product of the exact rounds
     and of phase 11's per-packet decode,
     x~^T read as it lies, and any int32 (negative values, p) in place of
     residues, each timed through the kernel alone, through ``gf.matmul_gf`` /
     ``gf.bmm_gf`` and through the ``to_gf`` passes and copy the ops layer
     made before it read operands as they lie (``passes_ms``); the
     Lagrange encode GEMM (its
     streaming route at k = 8 and 5, the scalar stream at ragged columns,
     the tiled route at k = 64; each line names its route) and the fused
     coded gradient (within the float32 reduction-order bound
     |diff| <= 1e-5 * (|A| |B|) elementwise, and the same bits on two calls;
     (150, 60, 3000, 1), (7, 13, 301, 3), (2, 4096, 8, 4) and
     (2, 65 536, 8, 1) on the rows route, each line with its row plan, then
     the chunk route with its residual in shared memory and in global
     memory), each timed beside its plain version, its bound and its library
     call or composition of calls;
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
     must rise; the exact rounds print their ms per round and B3's launches,
     and no operand of theirs may be copied contiguous or pass through
     ``to_gf`` at x~'s size before B3 (``gf.operand_passes``);
  8. the ported examples, ``repro_torch.examples.coded_regression.run()``
     and ``repro_torch.examples.quickstart.run(rounds=500)``;
  9. flash attention (B6) against its plain version ``flash_attention_ref``
     on the card: the serving prefill's shape q (4, 16, 2048, 128) against
     k, v (4, 8, 2048, 128) in bf16, fp16 and float32, the same at D = 64,
     the SMOKE configs' D = 32, ragged Sq = Sk = 1000, non-causal,
     decode-aligned Sq = 16 < Sk = 2048, Sq > Sk with rows that must be 0,
     and the Mixtral attention widths (48 over 8 heads, 4096 tokens) with a
     1024-token window, and the head widths of the repo's other configs
     (phi-3-vision 96, zamba2 112, nemotron-4 and xLSTM 192) and D = 40;
     each line names the route its dtype and D take (wgmma, mma or ffma) and
     the instantiation that ran; inputs are the (B, H, S, D) views of (B, S, H, D)
     tensors, as the layer passes them.  bf16 and fp16 within
     eps max|v| + eps |ref| elementwise, eps the type's rounding unit (2^-8,
     2^-11: P rounded to the input type for P V, and the output's
     rounding), float32 within 1e-5 (P |V|); each timed beside its plain
     version, its bound and, where Sq = Sk and no window,
     ``scaled_dot_product_attention``; then Sk = 0 on every route must give
     zeros;
 10. the LM serving path at full width: ``qwen3_0_6b`` (28 layers, d_model
     1024, vocab 151 936, already a multiple of the 128 it pads to, bf16,
     random weights from a seeded generator) with ``attn_impl="flash"`` serves 4 prompts of 2048
     tokens through ``make_prefill_step(cfg, max_len=2112)`` and 64 greedy
     ``make_serve_step`` steps (which sum bf16 split-K partials in float32
     for their call and leave PyTorch's flag as they found it: checked);
     B6 must launch 28 times (one per layer) in
     the prefill, the flash prefill's logits must be no further from a
     float32 copy of the model than 1.5 x the dense bf16 prefill's plus
     5e-3, four decode steps must match a fresh flash prefill over the same
     prefix, and every logit must be finite; then one more prefill and 8
     decode steps run under ``torch.profiler`` for the device's busy share
     and the kernels that take the most device time;
 11. the fault-injection runtime (``repro_torch.faults``, ``runtime``):
     (a) ``sweeps.expand("packet_erasure", rounds=20_000)`` with 8 seeds a
     cell (72 rows, lea and static, ``preempt`` + ``packet_bernoulli`` with
     each row's parameters) through ``faults.sweep_faults``: B1 must launch,
     as many times as for one cell; no round recovered all-or-nothing may
     be lost by the conserving decode, which must recover more rounds over
     the faulted cells; each cell's LEA rates (all-or-nothing, conserving,
     partial only) within 4.5 sd of ``BENCH_faults.json`` (a 512-round,
     one-seed run: sd is the across-seed spread scaled to 512 rounds, not
     below a 512-round binomial sd); wall time, row-rounds/s and peak
     memory logged; (b) a 2 000-round, 4-seed grid on the card and on the
     CPU from the same recorded draws, fault stream included: outcomes may
     differ in at most 0.1% of rounds; (c) the exact per-packet decode at
     ``CodeSpec(15, 10, 50, 2)``, x (50, 60, 3000), on 250 rounds of the
     LEA masks of cell ``erasure_pre0.2_drop0.05``: every decodable block
     equal to the numpy oracle, one packet with no channel equal to
     ``coded_matmul_exact``, no operand pass of x~'s size, B3 launched;
     (d) the float per-packet decode at ``CodeSpec(15, 10, 5, 2)`` under
     two cells' channels (B4 launched): each block within the float32
     forward-error bound of the route of the uncoded X_j @ w (see
     ``faults_float_packets``), its relative error logged; (e) the retry/degrade executor
     under ``preempt`` at 0.35 (packets 4, 2 retries, partial serving) for
     30 rounds: the outcomes sum to 30 and B2 launches.

It then prints the kernels' JSON record, the ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  It writes no file.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from typing import NamedTuple
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


class Timing(NamedTuple):
    """Two times of one call, in ms, taken the same way for a kernel, its
    plain version and its library call."""
    one: float        # CUDA events around a single call on an idle card: the
                      # call's host work before its launch is counted too
    batched: float    # CUDA events around ``batch`` back-to-back calls, over
                      # ``batch``: the card runs one launch while the host
                      # queues the next, so host work is hidden where it is
                      # shorter than the kernel


def time_ms(fn, warm: int = 3, runs: int = 10, batch: int = 10) -> Timing:
    """Both :class:`Timing` s of ``fn``, each the median of ``runs``
    timings, after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()

    def median_of(calls: int) -> float:
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

    return Timing(median_of(1), median_of(batch))


def timing_fields(b_ms: float | None = None, **times: Timing | None) -> dict[str, str | None]:
    """Log fields of named timings: ``<name>`` the single call and
    ``<name>_batched`` the back-to-back one, and the bound's share of the
    kernel's ``ms`` by each."""
    fields: dict[str, str | None] = {}
    for name, t in times.items():
        fields[name] = None if t is None else f"{t.one:.4f}"
        fields[f"{name}_batched"] = None if t is None else f"{t.batched:.4f}"
    if b_ms is not None:
        fields["bound_ms"] = f"{b_ms:.4g}"
        fields["bound_share"] = f"{b_ms / times['ms'].one:.3g}"
        fields["bound_share_batched"] = f"{b_ms / times['ms'].batched:.3g}"
    return fields


def timing_entry(**times: Timing | None) -> dict[str, float | None]:
    """The kernels line's numbers of named timings: ``<name>`` the single
    call, ``<name>_batched`` the back-to-back one."""
    entry: dict[str, float | None] = {}
    for name, t in times.items():
        entry[name] = None if t is None else t.one
        entry[f"{name}_batched"] = None if t is None else t.batched
    return entry


def bound_ms(probs: torch.Tensor, w: torch.Tensor) -> tuple[float, str]:
    """Least time on the card: bytes moved once vs the DP's flops on this data.

    Bytes: probs read and out written once, and each distinct threshold row
    (the elements of ``w`` as the caller holds it, before any broadcast) read
    once.  Per row the DP does n(n+1)/2 fused multiply-adds, n multiplies and
    n subtractions, plus one add per tail term of each feasible prefix (the
    counts max(w, 0)..i+1 this run's thresholds need; a threshold row shared
    by many rows counts once for each).
    """
    n = probs.shape[-1]
    rows = probs.numel() // n
    w_rows = max(w.numel() // n, 1)
    moved = 2 * probs.numel() * 4 + w.numel() * 4
    i = torch.arange(n, device=w.device)
    lo = torch.clamp(w.to(torch.int64), min=0)
    adds = torch.where(w <= i + 1, i + 2 - lo, 0)
    tail_adds = int(adds.sum()) * (rows // w_rows)
    flops = rows * (n * (n + 1) + 2 * n) + tail_adds
    t_bytes = moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_inputs(lead: tuple[int, ...], n: int, w_lead: tuple[int, ...],
                  gen: torch.Generator):
    """Probabilities (*lead, n), sorted descending, and int32 thresholds
    (*w_lead, n) to broadcast against them."""
    probs = torch.rand(lead + (n,), generator=gen, device="cuda")
    probs = torch.sort(probs, dim=-1, descending=True).values.contiguous()
    # thresholds <= 0, feasible, infeasible (> i~) and the n + 1 padding value
    w = torch.randint(-2, n + 2, w_lead + (n,), generator=gen, device="cuda",
                      dtype=torch.int32)
    w[..., -1] = n + 1
    return probs, w


def check_kernels(kernel_mod, ref) -> dict:
    """Phase 2: every entry point against the plain version, bit for bit, timed."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    engine = (2, 256, 20_000)                 # (lea, oracle) x 256 rows x M rounds
    main_rows = 2 * 256 * 20_000
    # (entry point, layout, probs' leading shape, n, main shape); "engine" is
    # the sweep's thresholds (1, 256, 1, n) read as they lie, "per-row" a
    # (rows, n) tensor of thresholds, "static" a tuple
    cases = [
        ("success_tails_cuda_w", "engine", engine, 15, True),
        ("success_tails_cuda", "static", (2 * 20_000,), 15, True),   # compare: (lea, oracle) x M
        ("success_tails_cuda_w", "per-row", (main_rows,), 15, False),
        ("success_tails_cuda_w", "engine", (2, 256, 2_000), 64, False),
        ("success_tails_cuda_w", "per-row", (1_000_000,), 15, False),
        ("success_tails_cuda", "static", (1_000_000,), 15, False),
        ("success_tails_cuda_w", "per-row", (1_000_000,), 64, False),
        ("success_tails_cuda", "static", (1_000_000,), 64, False),
        ("success_tails_cuda_w", "per-row", (100_000,), 100, False),
        ("success_tails_cuda", "static", (100_000,), 100, False),
        # the fault path (phase 11): the 72-row packet_erasure grid's rollout,
        # phase 11e's executor plan (8 workers), a 15-worker executor's plan
        ("success_tails_cuda_w", "engine", (1, 72, 20_000), 15, False),
        ("success_tails_cuda", "static", (1,), 8, False),
        ("success_tails_cuda", "static", (1,), 15, False),
    ]
    record = {}
    for name, layout, lead, n, main_shape in cases:
        w_lead = (1, lead[1], 1) if layout == "engine" else lead if layout == "per-row" else ()
        probs, w = kernel_inputs(lead, n, w_lead, gen)
        if name == "success_tails_cuda_w":
            run = lambda: kernel_mod.success_tails_cuda_w(probs, w)
        else:
            w_static = tuple(int(v) for v in w.tolist())
            run = lambda: kernel_mod.success_tails_cuda(probs, w_static)
        out = run()
        torch.cuda.synchronize()
        want = ref(probs, w)
        torch.cuda.synchronize()
        if out.shape != want.shape or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"{name} n={n}: bad output {tuple(out.shape)}")
        err = float((out - want).abs().max())
        if not torch.equal(out, want):
            raise AssertionError(f"{name} {layout} {lead} n={n}: not bit-equal to the plain "
                                 f"version, max|diff| {err}")
        ms = time_ms(run)
        plain_ms = time_ms(lambda: ref(probs, w), warm=1, runs=3)
        b_ms, b_by = bound_ms(probs, w)
        log("kernel", name=name, thresholds=layout, probs=lead + (n,), w=tuple(w.shape),
            rows=probs.numel() // n, n=n, main_shape=main_shape, max_abs_err=err,
            bit_equal=True, bound_by=b_by, **timing_fields(b_ms, ms=ms, plain_ms=plain_ms))
        entry = record.setdefault(name, {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main_shape:
            entry.update(timing_entry(ms=ms, plain_ms=plain_ms), bound_ms=b_ms,
                         bound_by=b_by, kernel_route=layout,
                         shape=[list(probs.shape), list(w.shape)])
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


# int32 values B3's loaders must reduce mod p: 2^32 = 2 (mod p)
INT32_EDGES = [-(2**31), -1, P, -P, -2, 0, 1, P - 1]


def any_int32(shape, gen: torch.Generator) -> torch.Tensor:
    """Random int32 of both signs on the card, the edges planted."""
    t = torch.randint(-(2**31), 2**31 - 1, shape, generator=gen, device="cuda",
                      dtype=torch.int32)
    t.view(-1)[:len(INT32_EDGES)] = torch.tensor(INT32_EDGES, dtype=torch.int32, device="cuda")
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

    # B3: (batch, m, c, n), a's layout, the values; the main shape of each
    # wrapper first.  The exact rounds' products (core/coded_ops.py): the
    # deg-1 worker shards and decode, the deg-2 residual, x~^T r (x~^T the
    # transposed view the round passes) and decode; the encode of each.
    gf_cases = [
        ("matmul_gf_cuda", "encode", (1, 150, 120, 75_000), "rows", "residues", True),
        ("matmul_gf_cuda", "deg-1 worker shards", (1, 3750, 3000, 8), "rows", "residues", False),
        ("matmul_gf_cuda", "deg-1 decode", (1, 120, 120, 200), "rows", "residues", False),
        ("matmul_gf_cuda", "deg-2 residual", (1, 9000, 3000, 1), "rows", "residues", False),
        ("matmul_gf_cuda", "deg-2 decode", (1, 50, 99, 3000), "rows", "residues", False),
        ("matmul_gf_cuda", "per-packet decode", (1, 50, 99, 15), "rows", "residues", False),
        ("matmul_gf_cuda", "ragged", (1, 37, 301, 19), "rows", "residues", False),
        ("matmul_gf_cuda", "any int32", (1, 300, 600, 8), "rows", "int32", False),
        ("bmm_gf_cuda", "deg-2 gradient, x~^T as it lies", (150, 3000, 60, 1), "transposed",
         "residues", True),
        ("bmm_gf_cuda", "deg-2 gradient, contiguous", (150, 3000, 60, 1), "rows", "residues",
         False),
        ("bmm_gf_cuda", "ragged", (3, 37, 301, 5), "rows", "residues", False),
        ("bmm_gf_cuda", "any int32, transposed", (7, 130, 33, 3), "transposed", "int32", False),
    ]
    for name, what, (batch, m, c, n), layout, values, main in gf_cases:
        lead = () if name == "matmul_gf_cuda" else (batch,)
        draw = gf_residues if values == "residues" else any_int32
        if layout == "transposed":               # a (B, m, c) view of a (B, c, m) tensor
            a = draw(lead + (c, m), gen).transpose(-1, -2)
        else:
            a = draw(lead + (m, c), gen)
        b = draw(lead + (c, n), gen)
        if values == "residues":
            a[..., 0, :] = P - 1                  # a row and a column of p-1
            b[..., :, 0] = P - 1
        kern = getattr(gf, name)
        ops = gf.matmul_gf if name == "matmul_gf_cuda" else gf.bmm_gf
        run = lambda: kern(a, b)
        through_ops = lambda: ops(a, b)
        # what the ops layer ran before it read int32 operands as they lie
        passes = lambda: kern(gf.to_gf(a).contiguous(), gf.to_gf(b).contiguous())
        plain = lambda: gf.matmul_gf_dot(gf.to_gf(a), gf.to_gf(b))
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        if got.shape != want.shape or err != 0 or not torch.equal(through_ops(), got):
            raise AssertionError(f"{name} {what} {(batch, m, c, n)}: max|diff| {err}")
        ms = time_ms(run)
        ops_ms = time_ms(through_ops)
        passes_ms = time_ms(passes)
        plain_ms = time_ms(plain, warm=1, runs=3)
        b_ms, b_by = _bound(4 * batch * (m * c + c * n + m * n),
                            batch * m * c * n * GF_INSTR_PER_TERM, INT_ISSUE_PER_S)
        log("kernel", name=name, case=json.dumps(what), shape=(batch, m, c, n),
            a_strides=tuple(a.stride()), values=values, max_abs_err=err, bound_by=b_by,
            **timing_fields(b_ms, ms=ms, ops_ms=ops_ms, passes_ms=passes_ms,
                            plain_ms=plain_ms))
        keep(name, err, main, **timing_entry(ms=ms, plain_ms=plain_ms, library_ms=None,
                                             composition_ms=plain_ms),
             bound_ms=b_ms, bound_by=b_by,
             composition="matmul_gf_dot: 8-bit limb split, one fp32 torch.matmul "
                         "per 256-wide K-chunk, 16 Mersenne rotations and adds",
             shape=[batch, m, c, n])
        del a, b, got, want

    # B4: (nr, k, cols)
    # (150, 8) is the float regression at k = 8, read in phase 7; (150, 5) the
    # one phase 7 checks
    # (37, 5, 1001) the ragged stream route; (150, 64, 18 000) the tiled route
    for (nr, k, cols), main in (((150, 8, 180_000), True), ((150, 5, 180_000), False),
                                ((37, 5, 1001), False), ((150, 64, 18_000), False)):
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
            route=le.encode_route(k, cols), max_abs_err=err, bound_by=b_by,
            **timing_fields(b_ms, ms=ms, plain_ms=plain_ms, library_ms=library_ms))
        keep("encode_matrix_cuda", err, main,
             **timing_entry(ms=ms, plain_ms=plain_ms, library_ms=library_ms),
             bound_ms=b_ms, bound_by=b_by,
             library="torch.matmul", kernel_route=le.encode_route(k, cols),
             shape=[nr, k, cols])
        del g, x, got, want, bound, diff

    # B5: (nr, R, C, P), each on the route its shape takes (gradient_route):
    # the paper's shape and the three others on the rows route, then the
    # chunk route with its residual in shared memory opted in past 48 KB and,
    # past what a block may have, in global memory
    for (nr, r_rows, c, p), main in (((150, 60, 3000, 1), True), ((7, 13, 301, 3), False),
                                     ((2, 4096, 8, 4), False), ((2, 65_536, 8, 1), False),
                                     ((1, 200, 4, 70), False), ((1, 6000, 4, 16), False)):
        x = torch.randn((nr, r_rows, c), generator=gen, device="cuda")
        y = torch.randn((nr, r_rows, p), generator=gen, device="cuda")
        w = torch.randn((c, p), generator=gen, device="cuda")
        run = lambda: cg.coded_gradient_cuda(x, y, w)
        plain = lambda: cg.coded_gradient_ref(x, y, w)
        w_b = w.expand(nr, c, p)
        two_bmm = lambda: torch.bmm(x.transpose(1, 2), torch.bmm(x, w_b) - y)
        got, want = run(), plain()
        again = run()
        ax = x.abs()
        bound = FP32_REL * torch.bmm(ax.transpose(1, 2), torch.bmm(ax, w_b.abs()) + y.abs())
        diff = (got - want).abs()
        torch.cuda.synchronize()
        err = float(diff.max())
        if not bool(torch.isfinite(got).all()) or bool((diff > bound).any()):
            raise AssertionError(f"coded_gradient_cuda {(nr, r_rows, c, p)}: max|diff| {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"coded_gradient_cuda {(nr, r_rows, c, p)}: two calls differ")
        ms = time_ms(run)
        plain_ms = time_ms(plain, warm=1, runs=3)
        composition_ms = time_ms(two_bmm)
        b_ms, b_by = _bound(4 * (nr * r_rows * c + nr * r_rows * p + c * p + nr * c * p),
                            4 * nr * r_rows * c * p, FP32_FLOP_PER_S)
        route = cg.gradient_route(r_rows, c, p)
        if route == "rows":
            plan = cg.row_plan(nr, r_rows, c, p, cg.kernel.row_vec(c, p, True))
            where = {"plan": json.dumps(plan._asdict())}
        else:
            where = {"residual": cg.residual_path(r_rows, p)}
        log("kernel", name="coded_gradient_cuda", shape=(nr, r_rows, c, p), route=route,
            **where, max_abs_err=err, same_bits_twice=True, bound_by=b_by,
            **timing_fields(b_ms, ms=ms, plain_ms=plain_ms, composition_ms=composition_ms))
        keep("coded_gradient_cuda", err, main,
             **timing_entry(ms=ms, plain_ms=plain_ms, library_ms=None,
                            composition_ms=composition_ms),
             bound_ms=b_ms, bound_by=b_by, kernel_route=route,
             composition="two torch.bmm calls (x w - y, then x^T resid), TF32 off",
             shape=[nr, r_rows, c, p])
        del x, y, w, got, again, want, bound, diff, ax
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


def no_x_tilde_passes(passes: dict[str, int], coded) -> dict[str, int]:
    """``passes`` (``gf.operand_passes`` over the exact rounds) if no B3
    operand was copied contiguous and none of x~'s size went through
    ``to_gf``; raises otherwise."""
    if passes["contiguous"] or passes["largest"] >= coded.x_tilde.numel():
        raise AssertionError(f"the exact rounds passed over x~ before B3: {passes}")
    return passes


def exact_deg1(co, lg, throughput, LoadParams) -> None:
    """Phase 7a: the exact degree-1 round at EC2 scenario 1 (Sec. 6.2)."""
    from repro_torch.kernels import gf
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
    gf.reset_operand_passes()
    for m in rounds:
        out, ok = co.coded_matmul_exact(coded, w_dev, masks[m])
        oks.append(ok)
        if len(first) < 8:
            first.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = coding_launches()      # before the checks below launch more
    passes = no_x_tilde_passes(gf.operand_passes(), coded)
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
        launches=json.dumps(launches), operand_passes=json.dumps(passes))
    return launches


def exact_deg2(co, lg, throughput, LoadParams) -> None:
    """Phase 7b: the exact degree-2 gradient at Sec. 6.1 (Fig. 3 scenario 3)."""
    from repro_torch.kernels import gf
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
    gf.reset_operand_passes()
    for m in rounds:
        out, ok = co.coded_linear_gradient_modp(coded, w_dev, masks[m])
        oks.append(ok)
        if len(first) < 6:
            first.append(out)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = coding_launches()
    passes = no_x_tilde_passes(gf.operand_passes(), coded)
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
        cpu_rounds_equal=len(first), launches=json.dumps(launches),
        operand_passes=json.dumps(passes))
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
    from repro_torch.kernels.flash_attention import (flash_attention_cuda,
                                                      flash_attention_ref, flash_route,
                                                      head_dim_instance)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(9)
    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    # (case, B, Hq, Hkv, Sq, Sk, D, dtype, causal, window, main shape)
    cases = [
        ("prefill", 4, 16, 8, 2048, 2048, 128, bf16, True, None, True),
        ("prefill fp16", 4, 16, 8, 2048, 2048, 128, f16, True, None, False),
        ("prefill f32", 4, 16, 8, 2048, 2048, 128, f32, True, None, False),
        ("prefill d64", 4, 16, 8, 2048, 2048, 64, bf16, True, None, False),
        ("smoke width d32", 4, 4, 2, 1000, 1000, 32, bf16, True, None, False),
        ("ragged", 4, 16, 8, 1000, 1000, 128, bf16, True, None, False),
        ("non-causal", 4, 16, 8, 2048, 2048, 128, bf16, False, None, False),
        ("decode-aligned", 4, 16, 8, 16, 2048, 128, bf16, True, None, False),
        ("sq>sk", 2, 16, 8, 300, 100, 128, bf16, True, None, False),
        # Mixtral's attention widths; the window cut from its 4096 so that
        # masking matters at 4096 tokens and the plain version fits
        ("mixtral window", 1, 48, 8, 4096, 4096, 128, bf16, True, 1024, False),
        # the head widths of the repo's other configs (mma.sync and FFMA
        # instantiations past the wgmma route's 64 and 128), at their heads
        ("phi-3-vision d96", 1, 32, 32, 2048, 2048, 96, bf16, True, None, False),
        ("zamba2 d112", 1, 32, 32, 2048, 2048, 112, bf16, True, None, False),
        ("nemotron-4 d192", 1, 96, 8, 1024, 1024, 192, bf16, True, None, False),
        ("nemotron-4 d192 fp16", 1, 96, 8, 1024, 1024, 192, f16, True, None, False),
        ("xlstm d192 f32", 1, 4, 4, 2048, 2048, 192, f32, True, None, False),
        ("d40, the next instantiation up", 2, 8, 8, 1000, 1000, 40, bf16, True, None, False),
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
        else:     # eps: the type's rounding unit
            eps_log2 = -8 if dt == bf16 else -11
            tol = f"2^{eps_log2} max|v| + 2^{eps_log2} |ref|"
            bound = 2.0 ** eps_log2 * (v.float().abs().amax() + want.float().abs())
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
                            FP32_FLOP_PER_S if dt == f32 else BF16_FLOP_PER_S)
        route = flash_route(dt, d)
        log("kernel", name="flash_attention_cuda", case=json.dumps(what), route=route,
            instantiation=d if route == "wgmma" else head_dim_instance(d),
            q=(b, hq, sq, d), kv=(b, hkv, sk, d), dtype=str(dt).split(".")[-1],
            causal=causal, window=window, zero_rows=zero_rows, max_abs_err=err,
            tolerance=json.dumps(tol),
            tolerance_used=f"{float((diff / bound.clamp_min(1e-30)).max()):.3f}",
            bound_by=b_by,
            **timing_fields(b_ms, ms=ms, plain_ms=plain_ms, library_ms=library_ms))
        entry = record.setdefault("flash_attention_cuda", {"max_abs_err": 0.0})
        entry["max_abs_err"] = max(entry["max_abs_err"], err)
        if main:
            entry.update(timing_entry(ms=ms, plain_ms=plain_ms, library_ms=library_ms),
                         bound_ms=b_ms, bound_by=b_by,
                         library="scaled_dot_product_attention(is_causal=True, enable_gqa=True)",
                         kernel_route=route, shape=[[b, hq, sq, d], [b, hkv, sk, d]])
        del q, k, v, got, want, diff, bound
        torch.cuda.empty_cache()
    for dt, d in ((bf16, 128), (f16, 64), (bf16, 32), (f32, 128)):   # no keys: all zero
        q = torch.randn((2, 4, 37, d), generator=gen, device="cuda").to(dt)
        k = torch.empty((2, 2, 0, d), dtype=dt, device="cuda")
        got = flash_attention_cuda(q, k, k, causal=True)
        if got.shape != q.shape or bool(got.any()):
            raise AssertionError(f"flash_attention_cuda Sk = 0 {dt} D = {d}: not all 0")
        log("kernel_no_keys", route=flash_route(dt, d), dtype=str(dt).split(".")[-1], d=d,
            zeros=True)
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
    # the step functions set the bf16 split-K flag for their call only
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction

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
    if torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction != flag:
        raise AssertionError("a step function left the bf16 split-K flag changed")
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
        checked_steps=json.dumps(list(kept)), bf16_split_k_flag_outside_steps=flag,
        gpu=json.dumps(nvidia_smi_line()))
    for part, line in profile.items():
        log("serve_profile", part=part, **line)
    return launches


def profile_window(fn) -> dict:
    """Wall time, device busy time and share idle, kernel launches and the
    top kernels by device time of ``fn()``, from ``torch.profiler``'s
    kernel events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

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


def profile_serving(prefill, serve, params, tokens, steps: int = 8) -> dict:
    """:func:`profile_window` of one prefill and of ``steps`` decode steps."""
    state = {}

    def run_prefill():
        state["logits"], state["cache"] = prefill(params, {"tokens": tokens})

    def run_decode():
        for _ in range(steps):
            state["logits"], state["cache"] = serve(
                params, state["cache"], {"next_token": state["logits"].argmax(-1)})

    return {"prefill": profile_window(run_prefill),
            f"decode_{steps}_steps": profile_window(run_decode)}


def fault_grid(scenarios, seeds: int, device: str):
    """``sweep_faults``' arguments for a ``packet_erasure`` grid, ``seeds``
    rows a cell (cell-major): the channel ``preempt`` + ``packet_bernoulli``
    with each row's (p_preempt, p_drop), as ``benchmarks/bench_faults.py``
    builds them."""
    from repro_torch import faults
    from repro_torch.core.lea import PoolLoad

    lp, meta = scenarios[0].lp, [dict(sc.meta) for sc in scenarios]
    col = lambda key: torch.tensor([m[key] for m in meta for _ in range(seeds)],
                                   dtype=torch.float32, device=device)
    rows = lambda attr: torch.tensor([getattr(sc, attr) for sc in scenarios
                                      for _ in range(seeds)], dtype=torch.float32,
                                     device=device)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=device)
    pool = PoolLoad(kstar=i32(lp.kstar), ell_g=i32(lp.ell_g), ell_b=i32(lp.ell_b),
                    mask=torch.ones(lp.n, dtype=torch.bool, device=device))
    channel = faults.make_channel([("preempt", {"p_preempt": col("p_preempt")}),
                                   ("packet_bernoulli", {"p_drop": col("p_drop")})])
    sc = scenarios[0]
    args = (pool, rows("p_gg"), rows("p_bb"), sc.mu_g, sc.mu_b, sc.deadline, channel,
            meta[0]["k1star"])
    geometry = dict(rounds=sc.rounds, strategies=("lea", "static"), r=meta[0]["r"],
                    packets=meta[0]["packets"], p1=meta[0]["p1"])
    return args, geometry


def faults_grid() -> dict[str, int]:
    """Phase 11a: the packet_erasure grid at the paper's M, 8 seeds a cell,
    held to ``BENCH_faults.json``; returns B1's launches."""
    from repro_torch import faults, sweeps
    from repro_torch.kernels import poisson_binomial as pb
    from repro_torch.random import torch_draws

    seeds = 8
    scenarios = sweeps.expand("packet_erasure", rounds=20_000)
    args, geometry = fault_grid(scenarios, seeds, "cuda")
    rounds = geometry["rounds"]
    reset_all_launch_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out, wall = timed(lambda: faults.sweep_faults(torch_draws(11), *args, **geometry))
    launches = pb.launch_counts()["success_tails_cuda_w"]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # one cell alone (its first seed's row), the same geometry
    one_args, _ = fault_grid(scenarios[:1], 1, "cuda")
    reset_all_launch_counts()
    faults.sweep_faults(torch_draws(12), *one_args, **geometry)
    torch.cuda.synchronize()
    launches_one = pb.launch_counts()["success_tails_cuda_w"]
    # a second, warmed call of the whole grid, timed beside the first
    _, wall_warm = timed(lambda: faults.sweep_faults(torch_draws(11), *args, **geometry))
    if launches < 1 or launches != launches_one:
        raise AssertionError(f"B1 launched {launches} times for the grid, {launches_one} "
                             "for one cell")
    aon, con, part = (x.cpu().numpy() for x in out)
    if aon.shape != (len(scenarios) * seeds, rounds, 2):
        raise AssertionError(f"outcomes of shape {aon.shape}")
    if (aon & ~con).any() or (part & con).any():
        raise AssertionError("a round recovered all-or-nothing is not recovered conserving, "
                             "or partial overlaps full")
    metas = [dict(sc.meta) for sc in scenarios]
    faulted = np.repeat([m["p_preempt"] > 0 or m["p_drop"] > 0 for m in metas], seeds)
    gain = int(con[faulted].sum()) - int(aon[faulted].sum())
    if not gain > 0:
        raise AssertionError(f"conserve does not beat all-or-nothing: gain {gain}")
    bench = {c["name"]: c for c in json.loads((ROOT / "BENCH_faults.json").read_text())["results"]}
    scale = (rounds / 512) ** 0.5       # the committed run: 512 rounds, one seed
    lea_col = geometry["strategies"].index("lea")
    columns = {"recovered_aon": aon, "recovered_conserve": con,
               "recovered_partial_only": part}
    for i, sc in enumerate(scenarios):
        rows = slice(i * seeds, (i + 1) * seeds)
        line = {}
        for name, arr in columns.items():
            per_seed = arr[rows, :, lea_col].mean(axis=1)
            mean, sd = float(per_seed.mean()), float(per_seed.std(ddof=1))
            want = bench[sc.name][name]
            # the sd of a 512-round rate: the across-seed spread scaled to 512
            # rounds, not below the binomial sd of 512 independent rounds
            # (8 seeds can understate a spread; 1/512 where the rate is 0)
            q = min(max(mean, 1 / 512), 1 - 1 / 512)
            sd512 = max(sd * scale, (q * (1 - q) / 512) ** 0.5)
            z = abs(mean - want) / sd512
            if not np.isfinite(per_seed).all() or z > 4.5:
                raise AssertionError(f"{sc.name} {name}: {mean} vs BENCH_faults {want} "
                                     f"(sd at 512 rounds {sd512})")
            line[name] = f"{mean:.4f}"
            line[f"{name}_bench"] = want
            line[f"{name}_z"] = f"{z:.2f}"
        log("faults_cell", cell=sc.name, **line)
    log("faults_grid", rows=len(scenarios) * seeds, rounds=rounds, wall_s=f"{wall:.3f}",
        row_rounds_per_s=f"{len(scenarios) * seeds * rounds / wall:.0f}",
        wall_warm_s=f"{wall_warm:.3f}",
        row_rounds_per_s_warm=f"{len(scenarios) * seeds * rounds / wall_warm:.0f}",
        peak_memory_gib=f"{peak_gib:.2f}", b1_launches=launches,
        b1_launches_one_cell=launches_one, conserve_gain_rounds=gain,
        containment=True, gpu=json.dumps(nvidia_smi_line()))
    log("faults_profile", part="grid",
        **profile_window(lambda: faults.sweep_faults(torch_draws(11), *args, **geometry)))
    return {"success_tails_cuda_w": launches}


def faults_agree() -> None:
    """Phase 11b: the fault grid on the card and on the CPU from the same
    recorded draws, the fault stream included."""
    from repro_torch import faults, sweeps
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws

    scenarios = sweeps.expand("packet_erasure", rounds=2000)
    recorder = RecordedDraws(torch_draws(13))
    args, geometry = fault_grid(scenarios, 4, "cuda")
    on_card = faults.sweep_faults(recorder, *args, **geometry)
    cpu_args, _ = fault_grid(scenarios, 4, "cpu")
    on_cpu = faults.sweep_faults(ReplayedDraws(recorder.calls), *cpu_args, **geometry,
                                 device="cpu")
    differ = {}
    for field in faults.FaultOutcomes._fields:
        a, b = getattr(on_card, field).cpu(), getattr(on_cpu, field)
        if a.shape != b.shape:
            raise AssertionError(f"{field}: shapes {tuple(a.shape)} != {tuple(b.shape)}")
        differ[field] = int((a != b).any(dim=-1).sum())
    limit = on_cpu.full_aon.shape[0] * on_cpu.full_aon.shape[1] // 1000
    if max(differ.values()) > limit:
        raise AssertionError(f"card and CPU differ in {differ} rounds (limit {limit})")
    log("faults_agree", rows=on_cpu.full_aon.shape[0], rounds=on_cpu.full_aon.shape[1],
        fault_calls=sum(1 for c in recorder.kinds if c == "fault"),
        differing_rounds=json.dumps(differ), limit=limit)


def fault_masks(cell: str, rounds: int, lp, mu_b: float, seed: int, packets: int = 4):
    """The LEA column's (rounds, nr, packets) conserving masks of one
    ``packet_erasure`` cell's channel, on a one-row rollout with load
    parameters ``lp`` (and the cell's chain, speeds and deadline), plus the
    all-or-nothing masks at one packet with no channel."""
    from repro_torch import faults, sweeps
    from repro_torch.core import throughput
    from repro_torch.core.lea import pool_load
    from repro_torch.random import torch_draws

    sc, = [s for s in sweeps.expand("packet_erasure", rounds=rounds) if s.name == cell]
    meta = dict(sc.meta)
    draws = torch_draws(seed)
    states, loads, _ = throughput.rollout_pool(draws, pool_load(lp, device="cuda"), sc.p_gg,
                                               sc.p_bb, rounds, ("lea",))
    channel = faults.make_channel([("preempt", {"p_preempt": meta["p_preempt"]}),
                                   ("packet_bernoulli", {"p_drop": meta["p_drop"]})])
    trace = faults.apply_channel(draws, channel, faults.base_trace(
        1, rounds, lp.n, meta["r"], packets, sc.deadline, device="cuda"))
    masks = faults.packet_on_time(states[None], loads, sc.mu_g, mu_b, sc.deadline,
                                  meta["r"], packets, trace=trace)[0]
    whole = faults.packet_on_time(states[None], loads, sc.mu_g, mu_b, sc.deadline,
                                  meta["r"], 1, conserve=False)[0]
    return masks, whole


def faults_exact_packets() -> dict[str, int]:
    """Phase 11c: the exact per-packet decode at the paper's widths; returns
    B3's launches."""
    from repro_torch import faults
    from repro_torch.core import coded_ops as co
    from repro_torch.core import lagrange as lg
    from repro_torch.core.lea import LoadParams
    from repro_torch.kernels import gf

    spec = lg.CodeSpec(15, 10, 50, 2)                  # nr = 150, K* = 99
    rows, cols, packets, rounds = 60, 3000, 4, 250
    rng = np.random.default_rng(64)
    x = rng.integers(0, P, size=(spec.k, rows, cols), dtype=np.int32)
    w = rng.integers(0, P, size=(cols,), dtype=np.int32)
    masks, whole = fault_masks("erasure_pre0.2_drop0.05", rounds, LoadParams(15, 99, 10, 3),
                               3.0, seed=14, packets=packets)
    coded = co.encode_dataset_modp(spec, x, device="cuda")
    w_dev = torch.as_tensor(w, device="cuda")
    reset_all_launch_counts()
    gf.reset_operand_passes()
    outs, oks = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for m in range(rounds):
        out, ok = faults.coded_matmul_exact_packets(coded, w_dev, masks[m])
        outs.append(out)
        oks.append(ok)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = gf.launch_counts()["matmul_gf_cuda"]
    passes = no_x_tilde_passes(gf.operand_passes(), coded)
    if launches < 1:
        raise AssertionError("the exact per-packet decode never launched B3")
    want = lg.matmul_modp(x.reshape(-1, cols).astype(np.int64),
                          w.astype(np.int64)[:, None]).reshape(spec.k, rows)
    rp = rows // packets
    ok_np = torch.stack(oks).cpu().numpy()
    for m in range(rounds):
        got = outs[m].cpu().numpy().astype(np.int64)
        for q in np.nonzero(ok_np[m])[0]:
            block = slice(q * rp, (q + 1) * rp)
            if not np.array_equal(got[:, block], want[:, block]):
                raise AssertionError(f"round {m} packet {q}: differs from the numpy oracle")
    if not ok_np.any():
        raise AssertionError("no packet block was decodable in any round")
    # one packet, no channel: the per-packet path is coded_matmul_exact
    for m in range(8):
        one, ok1 = faults.coded_matmul_exact_packets(coded, w_dev, whole[m])
        ref, ok_ref = co.coded_matmul_exact(coded, w_dev, whole[m, :, 0])
        if bool(ok1[0]) != bool(ok_ref) or not torch.equal(one, ref):
            raise AssertionError(f"round {m}: one packet differs from coded_matmul_exact")
    log("faults_exact_packets", spec="CodeSpec(15,10,50,2)", x=(spec.k, rows, cols),
        packets=packets, rounds=rounds, decodable_blocks=int(ok_np.sum()),
        rounds_all_blocks=int(ok_np.all(axis=1).sum()), bit_equal_numpy=True,
        one_packet_equals_exact=8, b3_launches=launches,
        ms_per_round=f"{wall / rounds * 1e3:.3f}", operand_passes=json.dumps(passes))

    def twenty_rounds():
        for m in range(20):
            faults.coded_matmul_exact_packets(coded, w_dev, masks[m])
    log("faults_profile", part="exact_packets_20_rounds", **profile_window(twenty_rounds))
    return {"matmul_gf_cuda": launches}


def float_route_bound(spec, x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, float]:
    """The float32 forward-error bound of the per-packet float route.

    The route computes D @ ((G @ X) @ w)[received]: G rounded from float64
    (one rounding an entry), D's entries products of K* - 1 quotients
    (at most 4 K* roundings), then sums over k, cols and K* terms.  So each
    decoded element lies within gamma_n (|D| @ A[received]) of the exact
    X_j @ w, where A = |G| @ (|X| @ |w|) (the magnitudes the results sum)
    and gamma_n = n u / (1 - n u), u = 2^-24, n = cols + 5 (k + K*).
    Returns (A as (nr, rows) float64, gamma_n).
    """
    from repro_torch.core import lagrange as lg

    n = x.shape[-1] + 5 * (spec.k + spec.recovery_threshold)
    u = 2.0 ** -24
    g = lg.generator_matrix(spec, torch.float64, device=x.device)
    mags = torch.einsum("krc,c->kr", x.abs().double(), w.abs().double())
    return g.abs() @ mags, n * u / (1 - n * u)


def faults_float_packets() -> dict[str, int]:
    """Phase 11d: the float per-packet decode under two cells' channels,
    through B4's encode; returns B4's launches.

    Checked: every element of every decodable block lies within the float32
    forward-error bound of the route (:func:`float_route_bound`) of the
    uncoded X_j @ w.  The bound grows with |D|: a preempted worker conserves
    a prefix of its chunks, so a block's received set mixes two workers'
    strided Chebyshev nodes (and, under drops, any K* nodes), where the
    float32 decode at k = 5 can lose every digit and |D| is large; on the
    well-conditioned blocks it is tight enough to fail a wrong decode.  The
    line logs the share of the bound used, the relative errors' quantiles,
    the blocks above 1e-2, and how many blocks the check would fail if each
    decoded its received rows shifted by one (a wrong decode).
    """
    from repro_torch import faults
    from repro_torch.core import coded_ops as co
    from repro_torch.core import lagrange as lg
    from repro_torch.core.lea import LoadParams
    from repro_torch.kernels import lagrange_encode as le

    spec = lg.CodeSpec(15, 10, 5, 2)                   # K* = 9 <= r
    kstar = spec.recovery_threshold
    rows, cols, rounds, packets = 60, 3000, 100, 4
    rng = np.random.default_rng(65)
    x = torch.as_tensor(rng.normal(size=(spec.k, rows, cols)), dtype=torch.float32,
                        device="cuda")
    w = torch.as_tensor(rng.normal(size=(cols,)), dtype=torch.float32, device="cuda")
    reset_all_launch_counts()
    coded = co.encode_dataset(spec, x)
    torch.cuda.synchronize()
    launches = le.launch_counts()["encode_matrix_cuda"]
    if launches < 1:
        raise AssertionError("the float per-packet path never launched B4")
    want = torch.einsum("krc,c->kr", x.double(), w.double())
    mags, gamma = float_route_bound(spec, x, w)
    results = torch.tensordot(coded.x_tilde, w, dims=1)           # (nr, rows)
    rp = rows // packets
    for cell in ("erasure_pre0.2_drop0", "erasure_pre0.2_drop0.05"):
        masks, _ = fault_masks(cell, rounds, LoadParams(15, kstar, 10, 0), 0.5, seed=15)
        rels, used, tight, caught = [], 0.0, 0, 0
        for m in range(rounds):
            out, ok = faults.coded_matmul_packets(coded, w, masks[m])
            for q in torch.nonzero(ok)[:, 0].tolist():
                block = slice(q * rp, (q + 1) * rp)
                received = co.received_indices(masks[m][:, q], kstar)
                d = lg.decode_matrix_jax(spec, received)
                bound = gamma * (d.abs().double() @ mags[received][:, block])
                diff = (out[:, block].double() - want[:, block]).abs()
                if bool((diff > bound).any()):
                    raise AssertionError(
                        f"{cell} round {m} packet {q}: the block misses X_j @ w by "
                        f"{float(diff.max())}, over the float32 bound of the route")
                used = max(used, float((diff / bound).max()))
                tight += bool((bound <= 1e-2 * want[:, block].abs().max()).all())
                shifted = d @ results[torch.roll(received, 1)][:, block]
                caught += bool(((shifted.double() - want[:, block]).abs() > bound).any())
                rels.append(float(torch.linalg.norm(out[:, block].double() - want[:, block])
                                  / torch.linalg.norm(want[:, block])))
        if not rels:
            raise AssertionError(f"{cell}: no float packet block was decodable")
        rels = np.asarray(rels)
        log("faults_float_packets", cell=cell, spec="CodeSpec(15,10,5,2)",
            x=(spec.k, rows, cols), rounds=rounds, decodable_blocks=len(rels),
            within_route_bound=True, gamma_n=f"{gamma:.3e}", bound_used_max=f"{used:.3e}",
            blocks_bound_below_1e_2=tight, shifted_decodes_failing_check=caught,
            rel_err_vs_uncoded_median=f"{np.median(rels):.3e}",
            rel_err_vs_uncoded_p90=f"{np.quantile(rels, 0.9):.3e}",
            rel_err_vs_uncoded_max=f"{rels.max():.3e}",
            blocks_over_1e_2=int((rels > 1e-2).sum()), b4_launches=launches)
    return {"encode_matrix_cuda": launches}


def faults_executor() -> dict[str, int]:
    """Phase 11e: the retry/degrade executor on the card, as the JAX
    package's fault benchmark runs it; returns B2's launches."""
    from repro_torch import faults
    from repro_torch.kernels import poisson_binomial as pb
    from repro_torch.runtime.fault_tolerance import (OUTCOMES, CodedDataParallelExecutor,
                                                     CodedDPConfig)

    cfg = CodedDPConfig(packets=4, max_retries=2, allow_partial=True, p1=1)
    ex = CodedDataParallelExecutor(
        cfg, lambda params, shard: {k: torch.zeros_like(v) for k, v in params.items()},
        draws=0, channel=faults.make_channel([("preempt", {"p_preempt": 0.35})]))
    params = {"w": torch.zeros(2, device="cuda")}
    batch = {"x": torch.zeros((cfg.k, 2), device="cuda")}
    reset_all_launch_counts()
    t0 = time.perf_counter()
    for _ in range(30):
        grads, info = ex.round(params, batch)
        if (grads is None) != (info["outcome"] == "dropped"):
            raise AssertionError(f"round {ex.rounds}: gradient and outcome disagree: {info}")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = pb.launch_counts()["success_tails_cuda"]
    if sum(ex.outcomes.values()) != ex.rounds or ex.rounds != 30:
        raise AssertionError(f"outcomes {ex.outcomes} do not sum to {ex.rounds} rounds")
    if launches < 1:
        raise AssertionError("the executor never launched B2")
    log("faults_executor", n_workers=cfg.n_workers, r=cfg.r, k=cfg.k, packets=cfg.packets,
        max_retries=cfg.max_retries, p_preempt=0.35, rounds=ex.rounds,
        outcomes=json.dumps({k: ex.outcomes[k] for k in OUTCOMES}),
        b2_launches=launches, ms_per_round=f"{wall / 30 * 1e3:.3f}")

    def ten_rounds():
        for _ in range(10):
            ex.round(params, batch)
    log("faults_profile", part="executor_10_rounds", **profile_window(ten_rounds))
    return {"success_tails_cuda": launches}


def faults_path() -> dict[str, int]:
    """Phase 11: the fault-injection runtime.  Each part sets the counts to
    0 before its own work and reads them after it; returns the launches."""
    launches = faults_grid()
    faults_agree()
    launches.update(faults_exact_packets())
    launches.update(faults_float_packets())
    launches.update(faults_executor())
    log("faults_path", launches=json.dumps(launches))
    return launches


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
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws

    smi = nvidia_smi_line()
    print(smi, flush=True)
    t0 = time.perf_counter()
    builds = build.build_all()
    log("env", gpu=json.dumps(smi), torch=torch.__version__,
        cuda=torch.version.cuda, build_all_s=f"{time.perf_counter() - t0:.2f}")
    for built in builds:
        log("build", source=built.name, build_s=f"{built.seconds:.2f}",
            library=built.path.name)
        kernel = ""
        for line in built.log.splitlines():
            entry = re.search(r"Compiling entry function '(\w+)'", line)
            if entry:   # the mangled name less its namespace: flash_wgmma_kernelI13__nv_bfloat16Li128...
                kernel = re.sub(r"^_Z(N\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+)?\d+", "", entry.group(1))[:60]
            elif "registers" in line or "spill" in line or "C7514" in line:
                log("ptxas", source=built.name, kernel=kernel, line=json.dumps(line.strip()))
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    log("wgmma_smem", **{f"d{d}_bytes": fa_kernel.wgmma_smem_bytes(d)
                         for d in fa_kernel.WGMMA_HEAD_DIMS})

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

    # -- phase 8: the ported examples --------------------------------------------
    from repro_torch.examples import coded_regression, quickstart
    t0 = time.perf_counter()
    ex = coded_regression.run(device="cuda")
    torch.cuda.synchronize()
    log("example", wall_s=f"{time.perf_counter() - t0:.3f}",
        throughput=json.dumps(ex["throughput"]), loss=json.dumps(ex["loss"]),
        exact_checked=ex["exact_checked"])
    t0 = time.perf_counter()
    qs = quickstart.run(device="cuda", rounds=500, echo=lambda line: None)
    torch.cuda.synchronize()
    log("example_quickstart", wall_s=f"{time.perf_counter() - t0:.3f}",
        rows=json.dumps(qs["lines"]))

    # -- phase 9: flash attention against its plain version ----------------------
    record.update(check_flash_kernel())

    # -- phase 10: the LM serving path -------------------------------------------
    launches_lm = serve_lm()

    # -- phase 11: the fault-injection runtime ------------------------------------
    launches_faults = faults_path()

    kernels = []
    launches = {"success_tails_cuda_w": launches_main["success_tails_cuda_w"],
                "success_tails_cuda": launches_static["success_tails_cuda"],
                **launches_coded, "flash_attention_cuda": launches_lm}
    by_path = {"fig3": {"success_tails_cuda_w": launches_main["success_tails_cuda_w"]},
               "compare": {"success_tails_cuda": launches_static["success_tails_cuda"]},
               "coded": launches_coded, "serve": {"flash_attention_cuda": launches_lm},
               "faults": launches_faults}
    for name, (source, replaces) in KERNELS.items():
        entry = record[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {path: counts[name] for path, counts in by_path.items()
                                 if name in counts},
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"],
            "library_ms": entry.get("library_ms"),
            "ms_batched": entry["ms_batched"],
            "plain_ms_batched": entry["plain_ms_batched"],
            "library_ms_batched": entry.get("library_ms_batched"),
            "composition_ms": entry.get("composition_ms"),
            "composition": entry.get("composition"),
            "library": entry.get("library"),
            "kernel_route": entry.get("kernel_route"),
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
