"""The device's idle time split by the program span the host was in.

:func:`idle_under` reads the same Chrome-trace events as
:func:`portbench.work.trace.read`.  Over the interval from the first
device operation's start to the last one's end, every instant in which no
device operation runs is idle.  For each ``repro.*`` span name it adds the
idle ms that fall inside that name's host intervals (nested spans each
count theirs, as ``device_ms`` counts the work launched inside them), and
under the key ``""`` the idle ms inside no ``repro.*`` interval.  So
``idle_under[""]`` plus the idle ms inside the union of all spans is the
interval's whole idle time.
"""

from __future__ import annotations

from portbench.work.trace import DEVICE_CATS


def _merged(ivals) -> list[tuple[float, float]]:
    """Sorted, disjoint union of ``(start, end)`` intervals."""
    out: list[list[float]] = []
    for a, b in sorted(ivals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _overlap(xs, ys) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        total += max(hi - lo, 0.0)
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_under(events: list[dict]) -> dict[str, float]:
    """Idle device ms under each ``repro.*`` span name, and under ``""``
    the idle ms outside every span (see the module docstring)."""
    spans: dict[str, list[tuple[float, float]]] = {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        name, cat = e.get("name", ""), e.get("cat", "")
        if cat == "user_annotation" and name.startswith("repro."):
            spans.setdefault(name, []).append((e["ts"], e["ts"] + e["dur"]))
        elif cat in DEVICE_CATS:
            device.append((e["ts"], e["ts"] + e["dur"]))
    busy = _merged(device)
    idle = [(a[1], b[0]) for a, b in zip(busy, busy[1:])]
    total = sum(b - a for a, b in idle)
    out = {name: _overlap(idle, _merged(ivals)) / 1e3 for name, ivals in spans.items()}
    every = _merged(iv for ivals in spans.values() for iv in ivals)
    out[""] = (total - _overlap(idle, every)) / 1e3
    return out
