"""Static FLOP/byte cost rows of the engine's pool-path entry points.

The JAX package's module of this name walks the compiled HLO text of each
entry point (trip counts, fusions, collectives).  The port reads no HLO:
it runs eagerly, one PyTorch operation at a time, so its cost is the sum
over the operations it dispatches.  :class:`OpCounter` is a
``TorchDispatchMode`` that sees each ATen operation once, as it runs, on
the card or on the CPU alike:

  * ``mm`` / ``bmm`` / ``matmul`` / ``addmm`` / ``baddbmm`` count 2 M N K
    as ``matmul_flops``;
  * a reduction (``sum``, ``any``, ``amax``, ...) counts its input
    elements as ``other_flops``, as the JAX walker counts ``reduce``;
  * every other operation that writes an output counts the output's
    elements as ``other_flops``; views (an output aliasing an input) and
    allocations (``empty*``, which write nothing) count nothing;
  * ``hbm_bytes`` is each operation's input plus output bytes: every eager
    operation materialises its output, so none is fused away;
  * ``collective_bytes`` is 0: one process, one device.

``torch.utils.flop_counter`` alone would count no operation of this engine,
which has no matmul.  On the card the engine's Poisson-binomial DP is a
``ctypes`` launch of the CUDA kernel (B1) that no dispatch mode sees: the
counter registers a launch observer with the kernel's wrapper and adds each
launch's own bytes and operations (``kernel.launch_work``: inputs read and
output written once, the DP's operations on that data) to ``other_flops``
and ``hbm_bytes``, and to :attr:`Costs.kernel_flops` / ``kernel_bytes``.
Entry points run on the card unless ``device="cpu"`` is asked for; there
the DP's plain version runs as PyTorch operations and is counted as such.
The numbers are not expected to equal the JAX package's: XLA fuses,
eager mode does not.

CLI::

    PYTHONPATH=src python -m repro_torch.launch.hlo_cost [targets] [--list] [--json] [--device cpu]
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.device import resolve_device

_MATMULS = {"mm", "bmm", "matmul", "addmm", "baddbmm"}
_ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"}
_REDUCTIONS = {"sum", "mean", "prod", "any", "all", "amax", "amin", "max", "min",
               "argmax", "argmin", "norm", "logsumexp", "var", "std"}


@dataclasses.dataclass
class Costs:
    matmul_flops: float = 0.0
    other_flops: float = 0.0          # kernel_flops included
    hbm_bytes: float = 0.0            # kernel_bytes included
    collective_bytes: float = 0.0
    per_collective: dict = dataclasses.field(default_factory=dict)
    kernel_launches: int = 0          # B1 launches observed (on the card)
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0

    @property
    def flops(self) -> float:
        return self.matmul_flops + self.other_flops


def _tensors(tree) -> list[torch.Tensor]:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _is_view(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _matmul_flops(name: str, ins: list[torch.Tensor], out: torch.Tensor) -> float:
    a, b = (ins[1], ins[2]) if name in ("addmm", "baddbmm") else (ins[0], ins[1])
    return 2.0 * out.numel() * a.shape[-1] if a.dim() and b.dim() else 0.0


class OpCounter(TorchDispatchMode):
    """Adds every dispatched ATen operation's cost, and every B1 launch's,
    to :attr:`costs`."""

    def __init__(self):
        super().__init__()
        self.costs = Costs()
        self._paused = False

    def __enter__(self):
        from repro_torch.kernels.poisson_binomial import kernel as pb

        pb.add_launch_observer(self.kernel_launch)
        return super().__enter__()

    def __exit__(self, *exc):
        from repro_torch.kernels.poisson_binomial import kernel as pb

        pb.remove_launch_observer(self.kernel_launch)
        return super().__exit__(*exc)

    def kernel_launch(self, probs: torch.Tensor, w: torch.Tensor) -> None:
        """Add one B1 launch's bytes and operations; the operations that
        count them are not themselves counted."""
        from repro_torch.kernels.poisson_binomial import kernel as pb

        self._paused = True
        try:
            moved, ops = pb.launch_work(probs, w)
        finally:
            self._paused = False
        c = self.costs
        c.kernel_launches += 1
        c.kernel_flops += ops
        c.kernel_bytes += moved
        c.other_flops += ops
        c.hbm_bytes += moved

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self._paused or _is_view(func):
            return out
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _ALLOCATIONS:
            return out
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        c = self.costs
        if name in _MATMULS and outs:
            c.matmul_flops += _matmul_flops(name, ins, outs[0])
        elif name in _REDUCTIONS:
            c.other_flops += sum(t.numel() for t in ins[:1])
        else:
            c.other_flops += sum(t.numel() for t in outs)
        c.hbm_bytes += _nbytes(ins) + _nbytes(outs)
        return out


# ---------------------------------------------------------------------------
# the engine's pool-path entry points at the JAX module's small shapes
# ---------------------------------------------------------------------------

_ENTRY_ROUNDS = 16
_ENTRY_N = 8


def _run_simulate_strategies_pool(dev: torch.device) -> None:
    from repro_torch.core import throughput
    from repro_torch.core.lea import PoolLoad

    n = _ENTRY_N
    pool = PoolLoad(kstar=20, ell_g=5, ell_b=1,
                    mask=torch.ones(n, dtype=torch.bool, device=dev))
    throughput.simulate_strategies_pool(
        0, pool, torch.full((n,), 0.8, device=dev), torch.full((n,), 0.7, device=dev),
        5.0, 1.0, 1.0, rounds=_ENTRY_ROUNDS, strategies=("lea", "static"), device=dev)


def _run_sweep_faults(dev: torch.device) -> None:
    from repro_torch import faults
    from repro_torch.core.lea import PoolLoad

    n, b = _ENTRY_N, 2
    i32 = dict(dtype=torch.int32, device=dev)
    pool = PoolLoad(kstar=torch.full((b,), 20, **i32),
                    ell_g=torch.full((b,), 5, **i32),
                    ell_b=torch.full((b,), 1, **i32),
                    mask=torch.ones((b, n), dtype=torch.bool, device=dev))
    channel = faults.make_channel(
        [("preempt", {"p_preempt": torch.full((b,), 0.2, device=dev)})])
    faults.sweep_faults(
        0, pool, torch.full((b, n), 0.8, device=dev), torch.full((b, n), 0.7, device=dev),
        5.0, 1.0, 1.0, channel, 10, rounds=_ENTRY_ROUNDS, strategies=("lea", "static"),
        r=2, packets=2, device=dev)


def _run_sweep_serving(dev: torch.device) -> None:
    from repro_torch import serving

    n, b = _ENTRY_N, 2
    i32 = dict(dtype=torch.int32, device=dev)
    spec = serving.RequestSpec(
        kstar=torch.full((b,), 20, **i32),
        ell_g=torch.full((b,), 5, **i32),
        ell_b=torch.full((b,), 1, **i32),
        deadline_rel=torch.full((b,), 2, **i32),
        admit_threshold=torch.zeros(b, device=dev),
        reserve_cap=torch.full((b,), serving.ADMIT_ALL_CAP, device=dev),
    )
    process = serving.make_process("poisson", rate=torch.full((b,), 1.0, device=dev))
    serving.sweep_serving(
        0, torch.ones((b, n), dtype=torch.bool, device=dev),
        torch.full((b, n), 0.8, device=dev), torch.full((b, n), 0.7, device=dev),
        5.0, 1.0, 1.0, spec, process, rounds=_ENTRY_ROUNDS, strategies=("lea",),
        capacity=2, grace=0, device=dev)


# name -> runner(device); the names ARE the engine's pool-path entry points
ENTRY_POINTS = {
    "simulate_strategies_pool": _run_simulate_strategies_pool,
    "sweep_faults": _run_sweep_faults,
    "sweep_serving": _run_sweep_serving,
}


def entry_point_names() -> tuple[str, ...]:
    return tuple(sorted(ENTRY_POINTS))


def count(fn) -> Costs:
    """The :class:`Costs` of the operations ``fn()`` dispatches and the B1
    launches it makes."""
    with OpCounter() as counter:
        fn()
    return counter.costs


def entry_costs(name: str, device=None) -> Costs:
    """:class:`Costs` of entry point ``name`` run once at the reference
    small shapes on ``device`` (default the card)."""
    if name not in ENTRY_POINTS:
        raise KeyError(
            f"unknown entry point {name!r}; available: "
            f"{', '.join(entry_point_names())}"
        )
    dev = resolve_device(device)
    return count(lambda: ENTRY_POINTS[name](dev))


def cost_row(name: str, costs: Costs) -> dict:
    """The JSON-able row of ``costs`` under the JAX package's keys
    (rounds-normalised columns included)."""
    flops = costs.flops
    return {
        "target": name,
        "rounds": _ENTRY_ROUNDS,
        "n": _ENTRY_N,
        "matmul_flops": costs.matmul_flops,
        "other_flops": costs.other_flops,
        "flops": flops,
        "hbm_bytes": costs.hbm_bytes,
        "collective_bytes": costs.collective_bytes,
        "per_collective": dict(costs.per_collective),
        "flops_per_round": flops / _ENTRY_ROUNDS,
        "hbm_bytes_per_round": costs.hbm_bytes / _ENTRY_ROUNDS,
        "arithmetic_intensity": flops / max(costs.hbm_bytes, 1.0),
    }


def estimate_entry(name: str, device=None) -> dict:
    """Run entry point ``name`` at the reference small shapes on ``device``
    (default the card) and return its cost row."""
    return cost_row(name, entry_costs(name, device))


def main(argv: list[str] | None = None) -> None:
    import argparse
    import json

    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.hlo_cost",
        description=(
            "Static FLOP/byte cost rows of the engine's pool-path entry "
            "points, counted over the PyTorch operations each dispatches and "
            "the Poisson-binomial kernel launches it makes on the card.  The "
            "JAX module's --hlo-file is left out: the port compiles no HLO to "
            "read."
        ),
    )
    parser.add_argument(
        "targets", nargs="*",
        help=f"entry points to count (default: all of "
             f"{', '.join(entry_point_names())})",
    )
    parser.add_argument("--list", action="store_true",
                        help="print the known entry points and exit")
    parser.add_argument("--json", action="store_true",
                        help="emit one JSON document instead of CSV rows")
    parser.add_argument("--device", default="cuda",
                        help="where the entry points run (default: cuda; cpu counts "
                             "the DP's plain version in place of the kernel)")
    args = parser.parse_args(argv)

    if args.list:
        print("\n".join(entry_point_names()))
        return
    targets = args.targets or list(entry_point_names())
    unknown = [t for t in targets if t not in ENTRY_POINTS]
    if unknown:
        raise SystemExit(
            f"unknown entry point(s): {', '.join(unknown)}\n"
            f"available: {', '.join(entry_point_names())}"
        )
    rows = [estimate_entry(t, args.device) for t in targets]

    if args.json:
        print(json.dumps(rows, indent=2, allow_nan=False))
        return
    cols = ("target", "flops", "matmul_flops", "hbm_bytes",
            "collective_bytes", "arithmetic_intensity")
    print(",".join(cols))
    for row in rows:
        print(",".join(
            f"{row[c]:.3f}" if isinstance(row.get(c), float) else str(row.get(c, ""))
            for c in cols
        ))


if __name__ == "__main__":
    main()
