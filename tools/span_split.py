"""Where one benchmark cell's sweeps spend their time, by the program's
spans, and what the spans cost.  Needs one CUDA card (``--device cpu``
runs the same steps on the CPU, for a rehearsal; its times are no device's).

    python3 tools/span_split.py --workload lea_sim.fig3_sweep [--seed N]
        [--untraced 4] [--traced 2] [--calls 100000] [--out FILE]

From the root of a checkout.  Set-up is the cell's own
(``portbench/drivers``): the traffic of ``portbench/workloads/<cell>.json``,
one warm sweep.  Then, with the profiler off, ``--calls`` entries and
exits of ``obs.profiling.phase`` on the device are timed (the off-cost a
span), ``--untraced`` sweeps are timed on the host clock, each ending
synchronised, and ``--traced`` sweeps run under ``torch.profiler`` (the
on-cost: traced against untraced sweeps a second).  One JSON line: the
card and its power limit, the costs, and a sweep's share of each span
(calls, host ms, device ms launched inside it, idle device ms under it),
the device ms outside every span, the idle ms outside every span, the
busy share and the host waits.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def _sync(dev):
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def phase_us(dev, calls: int) -> float:
    """Host µs of one entry and exit of ``phase`` with no profiler running."""
    from repro_torch.obs.profiling import phase

    for _ in range(1000):
        with phase("static_wait", dev):
            pass
    t0 = time.perf_counter()
    for _ in range(calls):
        with phase("static_wait", dev):
            pass
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 77)
    ap.add_argument("--untraced", type=int, default=4)
    ap.add_argument("--traced", type=int, default=2)
    ap.add_argument("--calls", type=int, default=100_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--overrides", default="{}", help="JSON: traffic parameters to update")
    ap.add_argument("--out", help="append the line to this file too")
    args = ap.parse_args(argv)

    import torch

    from portbench import run
    from portbench.work import idle, trace
    from repro_torch.obs.provenance import provenance

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("refused: no CUDA device", file=sys.stderr)
        return 2
    _, config, traffic = run.cell_parts(run.benchmark(), args.workload)
    traffic = {**traffic, **json.loads(args.overrides)}
    driver = run.load_driver(traffic)(config, traffic, args.seed, dev)
    driver.setup()
    _sync(dev)
    span_us = phase_us(dev, args.calls)

    t0 = time.perf_counter()
    for j in range(args.untraced):
        driver.job(j)
    _sync(dev)
    untraced_s = (time.perf_counter() - t0) / args.untraced

    with trace.Tracer() as tracer:
        for j in range(args.untraced, args.untraced + args.traced):
            driver.job(j)
    got = trace.read(tracer.events)
    under = idle.idle_under(tracer.events)
    per = lambda x: round(x / args.traced, 4)
    spans = {name: {"calls": per(s["calls"]), "host_ms": per(s["host_ms"]),
                    "device_ms": per(s["device_ms"]),
                    "idle_ms": per(under.get(name, 0.0))}
             for name, s in sorted(got["spans"].items())}
    calls = sum(s["calls"] for s in got["spans"].values()) / args.traced
    line = {
        "workload": args.workload, "seed": args.seed,
        "card": {k: provenance(device=dev)[k] for k in ("device", "power_limit_w")},
        "sweep_s_untraced": round(untraced_s, 5),
        "sweep_s_traced": round(tracer.window_s / args.traced, 5),
        "sweeps_per_s_untraced": round(1 / untraced_s, 4),
        "sweeps_per_s_traced": round(args.traced / tracer.window_s, 4),
        "phase_us_off": round(span_us, 4), "spans_per_sweep": calls,
        "off_cost_share": round(span_us * 1e-6 * calls / untraced_s, 6),
        "spans": spans,
        "unspanned_ms": per(got["unspanned_ms"]), "unspanned_ops": per(got["unspanned_ops"]),
        "idle_outside_ms": per(under[""]),
        "busy_share": round(got["busy_s"] / tracer.window_s, 5),
        "syncs": per(got["syncs"]), "device_ops": per(got["ops"]),
        "device_ms": per(sum(got["by_kernel"].values())),
    }
    text = json.dumps(line)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
