"""Readings of a cell's correctness numbers for the program and the control.

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 [--jobs N]

For each seed: the cell's set-up, ``N`` jobs of the timed path (default:
the traffic's ``checked_jobs``), then the numbers compared twice: the
program against the reference (the lower reading's runs), and the control
against the reference (the reference put in the program's place in the
precision below the one the configuration states: bfloat16 for the
float32 engine).  One JSON line a seed.  The benchmark's own runs do
not run this; it is how the limits in ``workloads/<cell>.json`` were set.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from portbench import run


def readings(cell: str, seed: int, jobs: int | None, device="cuda", overrides=None) -> dict:
    bench = run.benchmark()
    _, config, traffic = run.cell_parts(bench, cell)
    traffic = {**traffic, **(overrides or {})}
    driver = run.load_driver(traffic)(config, traffic, seed, device)
    driver.setup()
    if jobs is None:
        jobs = traffic["checked_jobs"]
    t0 = time.perf_counter()
    for j in range(jobs):
        driver.job(j)
    driver.finish()
    window_s = time.perf_counter() - t0
    driver.release()
    program, _ = driver.check(jobs)
    control, _ = driver.check(jobs, control=True)
    return {"cell": cell, "seed": seed, "jobs": jobs, "window_s": window_s,
            "program": dict(program), "control": dict(control),
            "limits": traffic["limits"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--jobs", type=int, default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(run.ROOT / "src"))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(args.workload, seed, args.jobs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
