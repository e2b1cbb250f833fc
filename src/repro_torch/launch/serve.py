"""Streaming coded-serving CLI: a thin front end over :mod:`repro_torch.serving`.

Runs the serving loop — a continuous arrival process (default the paper
Sec. 6.2 shift-exponential gaps), a request queue on the device, EDF
water-filling multi-job allocation and admission control — on one worker
pool, and prints the timely-throughput / latency accounting::

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --rounds 2000 \\
      --process shift_exp --arrival-const 0.2 --arrival-mean 0.8 \\
      --deadline-rel 2 --admit-threshold 0.5 --reserve-cap 0.7

The flags are the JAX package's ``repro.launch.serve`` flags plus
``--device`` (default ``cuda``; without a GPU pass ``--device cpu``).  Any
registered arrival process is legal (``--process poisson --rate 1.5``,
``--process mmpp ...``); ``--admit-threshold 0 --reserve-cap big`` is
admit-all.  Exit is 0 unless the accounting identities fail.

``--progress`` (a progress line on stderr) and ``--tap-log FILE`` (one JSON
line a tap event) stream the serving loop's block aggregates while it runs,
every ``--tap-stride`` rounds (default ``rounds // 8``), as in the JAX
package.  The JAX CLI's persistent compile cache (``REPRO_COMPILE_CACHE``,
``enable_compile_cache``) belongs to the speed slice (ROADMAP A5) and is
left out: the port compiles nothing per configuration.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch import serving
from repro_torch.core import CodeSpec, LoadParams
from repro_torch.device import resolve_device
from repro_torch.obs import metrics as _metrics
from repro_torch.obs import taps as _taps


def _build_process(args):
    if args.process == "shift_exp":
        return serving.make_process(
            "shift_exp", t_const=args.arrival_const, mean=args.arrival_mean
        )
    if args.process == "poisson":
        return serving.make_process("poisson", rate=args.rate)
    if args.process == "mmpp":
        return serving.make_process(
            "mmpp", rate_lo=args.rate_lo, rate_hi=args.rate_hi
        )
    if args.process == "constant":
        return serving.make_process("constant", per_round=args.per_round)
    raise SystemExit(
        f"unknown arrival process {args.process!r}; registered: "
        f"{', '.join(serving.process_names())}"
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fast run (CI gate)")
    ap.add_argument("--rounds", type=int, default=1000)
    # pool (paper Sec. 6.2 simulation scale by default)
    ap.add_argument("--n", type=int, default=15)
    ap.add_argument("--r", type=int, default=10)
    ap.add_argument("--k", type=int, default=50)
    ap.add_argument("--deg-f", type=int, default=1)
    ap.add_argument("--mu-g", type=float, default=10.0)
    ap.add_argument("--mu-b", type=float, default=3.0)
    ap.add_argument("--deadline", type=float, default=1.0)
    ap.add_argument("--p-gg", type=float, default=0.8)
    ap.add_argument("--p-bb", type=float, default=0.7)
    # arrivals (registered processes; shift_exp is the paper's model)
    ap.add_argument("--process", default="shift_exp")
    ap.add_argument("--arrival-const", type=float, default=0.2,
                    help="shift_exp: constant gap component, in rounds")
    ap.add_argument("--arrival-mean", type=float, default=0.8,
                    help="shift_exp: mean of the exponential gap component")
    ap.add_argument("--rate", type=float, default=1.0, help="poisson rate")
    ap.add_argument("--rate-lo", type=float, default=0.3)
    ap.add_argument("--rate-hi", type=float, default=3.0)
    ap.add_argument("--per-round", type=int, default=1)
    # service / admission
    ap.add_argument("--deadline-rel", type=int, default=1,
                    help="per-request deadline, in rounds after arrival")
    ap.add_argument("--capacity", type=int, default=4)
    ap.add_argument("--grace", type=int, default=0)
    ap.add_argument("--strategies", default="lea",
                    help="comma-separated policy names")
    ap.add_argument("--admit-threshold", type=float, default=0.5)
    ap.add_argument("--reserve-cap", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=0)
    # live observability (repro_torch.obs taps)
    ap.add_argument("--progress", action="store_true",
                    help="stream tap events; stderr progress line mid-run")
    ap.add_argument("--tap-stride", type=int, default=None,
                    help="rounds per tap block (default rounds // 8)")
    ap.add_argument("--tap-log", default=None, metavar="FILE",
                    help="append tap events to this JSONL file")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda)")
    return ap


def main(argv=None, draws=None, echo=print) -> dict:
    """Run the CLI on ``argv``; returns the per-strategy summary dict.

    ``draws`` replaces the default source (a
    :class:`~repro_torch.random.TorchDraws` seeded with ``--seed``): a
    :class:`~repro_torch.random.Draws` that also answers
    :class:`~repro_torch.random.ArrivalDraws`.
    """
    args = parser().parse_args(argv)
    if args.smoke:
        args.rounds = min(args.rounds, 64)
    dev = resolve_device(args.device)

    spec = CodeSpec(args.n, args.r, args.k, deg_f=args.deg_f)
    lp = LoadParams(
        n=args.n, kstar=spec.recovery_threshold,
        ell_g=int(min(args.mu_g * args.deadline, args.r)),
        ell_b=int(args.mu_b * args.deadline),
    )
    strategies = tuple(args.strategies.split(","))
    echo(f"pool   : n={args.n} workers, K*={lp.kstar}, "
         f"loads ({lp.ell_g}/{lp.ell_b}), strategies={strategies}")

    req = serving.RequestSpec(
        kstar=lp.kstar, ell_g=lp.ell_g, ell_b=lp.ell_b,
        deadline_rel=args.deadline_rel,
        admit_threshold=args.admit_threshold, reserve_cap=args.reserve_cap,
    )
    tap = bool(args.progress or args.tap_log)
    stride = args.tap_stride
    if tap and stride is None:
        stride = max(args.rounds // 8, 1)
    progress = _metrics.ProgressLine(total=args.rounds, enabled=args.progress,
                                     label="serve")
    handlers = [("serve.progress", progress)] if args.progress else []
    if args.tap_log:
        handlers.append(("serve.jsonl", _metrics.JsonlSink(args.tap_log)))
    for hname, h in handlers:
        _taps.add_tap(hname, h)
    try:
        out = serving.simulate_serving(
            args.seed if draws is None else draws, torch.ones(args.n, dtype=torch.bool),
            [args.p_gg] * args.n, [args.p_bb] * args.n,
            args.mu_g, args.mu_b, args.deadline, req, _build_process(args),
            rounds=args.rounds, strategies=strategies,
            capacity=args.capacity, grace=args.grace, tap=tap, tap_stride=stride,
            device=dev,
        )
        out = type(out)(*(x.cpu().numpy() for x in out))
    finally:
        for hname, _ in handlers:
            _taps.remove_tap(hname)
        progress.close()

    summary = {}
    arr = int(out.arrivals[0])
    for j, name in enumerate(strategies):
        adm = int(out.admitted[j])
        on_t = int(out.served_on_time[j])
        late = int(out.served_late[j])
        exp = int(out.expired[j])
        rej = int(out.rejected[j])
        fly = int(out.in_flight[j])
        if not (arr == adm + rej and adm == on_t + late + exp + fly):
            raise AssertionError(f"{name}: accounting identities fail: {arr} arrivals, "
                                 f"{adm} admitted, {rej} shed, {on_t}/{late}/{exp}/{fly} "
                                 "on time / late / expired / in flight")
        ev = out.events[j]
        sj = out.sojourn[j]
        lat = sj[(ev == serving.EVENT_ON_TIME) | (ev == serving.EVENT_LATE)]
        pct = (np.percentile(lat, [50, 95, 99]) if lat.size
               else np.zeros(3))
        echo(f"{name:>7}: {arr} arrivals | {adm} admitted ({rej} shed) | "
             f"{on_t} on time, {late} late, {exp} expired, {fly} in flight")
        echo(f"{'':>7}  timely throughput {on_t / max(arr, 1):.3f} | "
             f"sojourn p50/p95/p99 = "
             f"{pct[0]:.0f}/{pct[1]:.0f}/{pct[2]:.0f} rounds")
        summary[name] = {
            "arrivals": arr, "admitted": adm, "served_on_time": on_t,
            "served_late": late, "expired": exp, "rejected": rej,
            "in_flight": fly,
            "timely_throughput": on_t / max(arr, 1),
            "latency_p50": float(pct[0]), "latency_p95": float(pct[1]),
            "latency_p99": float(pct[2]),
        }
    echo("OK")
    return summary


if __name__ == "__main__":
    main()
