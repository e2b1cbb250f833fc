"""Run one benchmark cell once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Everything about a cell is found by name:
the cell in ``BENCHMARK.json``, its traffic in ``portbench/workloads/<cell>.json``,
the traffic's driver in ``portbench/drivers/<driver>.py``, its configuration
in ``portbench/configs/<config>.json`` and each per-layer metric's reader in
``portbench/metrics/<metric>.py``.

A run: set-up (inputs and weights from the seed, every shape warmed, kernels
built on a first run) -> the window (jobs back to back until ``--seconds``
have passed; it closes when the last job begun in it ends) -> the peak
memory read -> the program's state freed -> the reference recomputes a
sample of the window's answers drawn from the seed -> one JSON line on
standard output, the numbers compared beside their limits last on standard
error.  With ``--trace 1`` the first ``trace_jobs`` jobs of the window run
under ``torch.profiler`` and the line carries the cell's per-layer metrics
instead of its end-to-end ones.

The run refuses, with no result line, when there is no CUDA device or too
few, and when JAX or the JAX package has been loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
NAME_CHARS = 120        # a device operation's name in the breakdown, cut


def load_module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_parts(bench: dict, cell: str) -> tuple[dict, dict, dict]:
    """``(workload entry, configuration, traffic)`` of a cell, by name."""
    entry = {w["name"]: w for w in bench["workloads"]}.get(cell)
    if entry is None:
        raise KeyError(f"no cell {cell!r} in BENCHMARK.json")
    config = json.loads((HERE / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((HERE / "workloads" / f"{cell}.json").read_text())
    if traffic["traffic"] != entry["traffic"]:
        raise ValueError(f"{cell}: the workload file holds traffic {traffic['traffic']!r}, "
                         f"BENCHMARK.json {entry['traffic']!r}")
    return entry, config, traffic


def metrics_for(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics the cell reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules(names=None) -> list[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    loaded in this process), each compared whole."""
    names = sys.modules if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def load_driver(traffic: dict):
    return load_module(HERE / "drivers" / f"{traffic['driver']}.py",
                       f"portbench_driver_{traffic['driver']}").Driver


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device="cuda",
             overrides: dict | None = None, start: float | None = None, min_jobs: int = 1):
    """One run of ``cell``: ``(the result line's object, the numbers
    compared as (name, value, limit))``.  ``overrides`` update the
    traffic's parameters and the window lasts at least ``min_jobs`` jobs
    (both for tests at small sizes); ``start`` is when set-up began."""
    import torch

    from portbench.work import trace as tr

    start = time.perf_counter() if start is None else start
    bench = benchmark()
    entry, config, traffic = cell_parts(bench, cell)
    traffic = {**traffic, **(overrides or {})}
    driver = load_driver(traffic)(config, traffic, seed, device)
    cuda = torch.device(device).type == "cuda"

    driver.setup()
    if cuda:
        torch.cuda.synchronize()
    # the profiler's start-up (seconds, on the card) stays out of the window
    tracer = tr.Tracer().__enter__() if trace else None
    t_win = time.perf_counter()
    setup_s = t_win - start

    done = units = 0
    traced = trace_window_s = None
    deadline = t_win + seconds
    while True:
        units += driver.job(done)
        done += 1
        if tracer is not None and done == traffic["trace_jobs"]:
            driver.finish()
            t_stop = time.perf_counter()
            tracer.__exit__(None, None, None)
            traced, trace_window_s, tracer = tr.read(tracer.events), tracer.window_s, None
            deadline += time.perf_counter() - t_stop     # writing and reading the trace
        if tracer is None and time.perf_counter() >= deadline and done >= min_jobs:
            break
    driver.finish()
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_win
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    driver.release()
    if cuda:
        torch.cuda.empty_cache()
    numbers, failed = driver.check(done)
    checks = [(name, value, traffic["limits"][name]) for name, value in numbers]
    correct = all(value <= limit for _, value, limit in checks)

    if trace:
        ctx = {"trace": traced, "window_s": trace_window_s, "jobs": traffic["trace_jobs"],
               "work": driver.work(), "peak_bytes": peak}
        metrics = {}
        for m in metrics_for(bench, cell, "per_layer"):
            reader = load_module(HERE / "metrics" / f"{m['name']}.py",
                                 "portbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = {"setup_s": setup_s, **driver.end_to_end(units, window_s)}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in metrics_for(bench, cell, "end_to_end")}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": entry["chips"], "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": done, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace:
        dev.update(busy_s=traced["busy_s"], window_s=trace_window_s)
        result["breakdown"] = {
            "device_ops": [[name[:NAME_CHARS], s] for name, s in tr.top_ops(traced)],
            "idle_gaps": [[name[:NAME_CHARS], s] for name, s in traced["idle_gaps"]]}
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in checks}
    return result, checks


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench.run",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT / "src"))
    import torch

    chips = cell_parts(benchmark(), args.workload)[0]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"refused: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result, checks = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              start=T0)
    found = forbidden_modules()       # after the window and the reference
    if found:
        print(f"refused: modules loaded in the run: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, value, limit in checks:
        print(f"check {name} = {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
