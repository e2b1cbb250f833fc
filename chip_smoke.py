"""On-card smoke test of the PyTorch / CUDA port (``src/repro_torch``).

Run from the root of a checkout, on a machine with one NVIDIA H100::

    python3 chip_smoke.py

Phases, one line each (any failure raises and exits non-zero):

  1. environment: the card's name and power limit (``nvidia-smi``), torch and
     CUDA versions, and the nvcc build of ``csrc/poisson_binomial.cu``;
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
     (the kernel repeats the plain version's roundings, so 0 is expected).

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
TOLERANCE = 1e-5
SOURCE = "src/repro_torch/kernels/csrc/poisson_binomial.cu"
REPLACES = {
    "success_tails_cuda_w": "src/repro/kernels/poisson_binomial/kernel.py:147",
    "success_tails_cuda": "src/repro/kernels/poisson_binomial/kernel.py:117",
}


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
    built = build.build("poisson_binomial")
    ptxas = [ln.strip() for ln in built.log.splitlines()
             if "registers" in ln or "spill" in ln]
    log("env", gpu=json.dumps(smi), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=f"{built.seconds:.2f}",
        library=built.path.name)
    for line in ptxas:
        log("ptxas", line=json.dumps(line))

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

    kernels = []
    launches = {"success_tails_cuda_w": launches_main["success_tails_cuda_w"],
                "success_tails_cuda": launches_static["success_tails_cuda"]}
    for name in ("success_tails_cuda_w", "success_tails_cuda"):
        entry = record[name]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": entry["max_abs_err"], "ms": entry["ms"],
            "plain_ms": entry["plain_ms"], "bound_ms": entry["bound_ms"],
            "bound_by": entry["bound_by"], "library_ms": None,
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
