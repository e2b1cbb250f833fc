"""Multi-pod dry run of the port (``repro/launch/dryrun.py``): every
(architecture x input shape) cell on the production mesh, one rank of it,
with no device and no data -- memory, cost and collective numbers per rank.

JAX lowers and compiles each cell for 256 (or 512) fake host devices.  The
port has no compiler to ask, so this process plays rank 0 of the production
mesh under a fake process group
(``torch.testing._internal.distributed.fake_pg``: collectives return at
once), with every tensor on the ``meta`` device (``api.abstract_*``,
``api.input_specs``), laid out by the sharding rules, and runs the cell's
step function once eagerly under :class:`~repro_torch.launch.hlo_cost.OpCounter`:

  * ``memory``: the exact bytes of this rank's pieces of the arguments
    (parameters or train state, batch, cache) and outputs; ``alias_bytes``
    counts the outputs written in place (the train state, the decode
    cache); ``temp_bytes`` is 0 -- an eager run frees its intermediates
    as it goes, and the meta run measures none;
  * ``cost``: the counter's FLOPs and bytes over the rank's local
    operations (B6 on meta tensors counted by its own launch-work formula);
  * ``collectives``: the operand bytes of every collective the step issues
    (DTensor's redistributions and ``models.sharding``'s all-reduces);
  * ``roofline``: against the data-sheet numbers of one NVIDIA H100 80GB
    HBM3 (SXM, 700 W): 989 TFLOP/s dense bf16, 3.35 TB/s HBM, 900 GB/s
    NVLink.  These are data-sheet peaks, not measurements.

``lower_s`` is the seconds spent placing the cell's tensors, ``compile_s``
the seconds of the counted meta run (there is no compile step).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_0_6b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out experiments/dryrun
  ... add --multi-pod for the (2,16,16) pod mesh.
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback

import torch

from repro_torch.configs.base import SHAPE_CELLS, get_config, list_configs
from repro_torch.launch import hlo_cost
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import api
from repro_torch.models.sharding import is_dtensor, use_mesh

# NVIDIA H100 80GB HBM3 (SXM, 700 W) data sheet: dense bf16, HBM, NVLink.
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 900e9

# long_500k needs sub-quadratic attention; these archs have a mechanism
# (SSM state / rolling SWA window); pure full-attention archs are N/A
# (documented in DESIGN.md §6).
LONG_CTX_ARCHS = {"zamba2_7b", "xlstm_125m", "mixtral_8x22b"}


def model_flops(cfg, cell) -> float:
    """Analytic useful FLOPs per step: 6ND train / 2ND forward (MoE: active)."""
    n = cfg.active_params() if cfg.n_experts else cfg.n_params()
    if cell.kind == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n * tokens
    if cell.kind == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * cell.global_batch      # decode: one token per sequence


def runnable(arch: str, cell_name: str) -> tuple[bool, str]:
    if cell_name == "long_500k" and arch not in LONG_CTX_ARCHS:
        return False, "N/A: pure full-attention arch; no sub-quadratic mechanism (DESIGN §6)"
    return True, ""


def join_fake_group(world_size: int) -> None:
    """Make this process rank 0 of a ``world_size``-rank fake group (once)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a group of {dist.get_world_size()} ranks is already joined")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if hasattr(tree, "_fields"):
        return [t for f in tree._fields for t in _leaves(getattr(tree, f))]
    if hasattr(tree, "tensors"):
        return list(tree.tensors().values())
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [t for v in tree for t in _leaves(v)]
    return []


def local_bytes(tree) -> int:
    """Bytes of this rank's pieces of every tensor in ``tree``."""
    total = 0
    for t in _leaves(tree):
        piece = t.to_local() if is_dtensor(t) else t
        total += piece.numel() * piece.element_size()
    return total


def lower_cell(arch: str, cell_name: str, multi_pod: bool,
               overrides: dict | None = None) -> dict:
    """Place + run + count one cell; returns the result record."""
    cfg = get_config(arch, **(overrides or {}))
    cell = SHAPE_CELLS[cell_name]
    join_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    n_dev = mesh.size()
    rec: dict = {
        "arch": arch, "cell": cell_name,
        "mesh": "x".join(map(str, mesh.shape)),
        "devices": int(n_dev),
    }
    t0 = time.time()
    with use_mesh(mesh):
        specs = api.input_specs(cfg, cell)
        batch = api.distribute_tree(specs, api.batch_shardings(cfg, mesh, specs))
        if cell.kind == "train":
            state_abs = api.abstract_state(cfg)
            state_sh = api.state_shardings(cfg, mesh, state_abs)
            state = api.distribute_tree(state_abs, state_sh)
            step = api.make_train_step(cfg, grad_shardings=state_sh.params)
            args, run = (state, batch), lambda: step(state, batch)
            aliased = state
        elif cell.kind == "prefill":
            params_abs = api.abstract_params(cfg)
            params = api.distribute_tree(params_abs,
                                         api.param_shardings(cfg, mesh, params_abs))
            step = api.make_prefill_step(cfg, max_len=cell.seq_len)
            args, run = (params, batch), lambda: step(params, batch)
            aliased = None
        else:  # decode
            params_abs = api.abstract_params(cfg)
            params = api.distribute_tree(params_abs,
                                         api.param_shardings(cfg, mesh, params_abs))
            cache_abs = api.abstract_cache(cfg, cell.global_batch, cell.seq_len)
            cache = api.distribute_tree(cache_abs, api.cache_shardings(cfg, mesh, cache_abs))
            step = api.make_serve_step(cfg)
            args, run = (params, cache, batch), lambda: step(params, cache, batch)
            aliased = cache
        rec["lower_s"] = round(time.time() - t0, 1)
        t1 = time.time()
        counter = hlo_cost.OpCounter()
        with counter:
            out = run()
        rec["compile_s"] = round(time.time() - t1, 1)

    # ---- analyses --------------------------------------------------------
    arg_b, out_b = local_bytes(args), local_bytes(out)
    alias_b = local_bytes(aliased) if aliased is not None else 0
    rec["memory"] = {"argument_bytes": arg_b, "output_bytes": out_b, "temp_bytes": 0,
                     "alias_bytes": alias_b, "per_device_total": arg_b + out_b - alias_b}
    c = counter.costs
    rec["cost"] = {"matmul_flops": c.matmul_flops, "other_flops": c.other_flops,
                   "flops": c.flops, "bytes_accessed": c.hbm_bytes,
                   "b6_launches": c.kernel_launches}
    rec["collectives"] = {"per_op_bytes": {k: int(v) for k, v in c.per_collective.items()},
                          "total_bytes": int(c.collective_bytes)}

    # ---- roofline terms (per-rank seconds against the H100 data sheet) ------
    mf = model_flops(get_config(arch), cell)
    compute_t = c.flops / PEAK_FLOPS_BF16
    memory_t = c.hbm_bytes / HBM_BW
    collective_t = c.collective_bytes / NVLINK_BW
    dom = max(
        ("compute", compute_t), ("memory", memory_t), ("collective", collective_t),
        key=lambda kv: kv[1],
    )[0]
    rec["roofline"] = {
        "per_device_flops": c.flops,
        "per_device_bytes": c.hbm_bytes,
        "per_device_collective_bytes": int(c.collective_bytes),
        "compute_s": compute_t,
        "memory_s": memory_t,
        "collective_s": collective_t,
        "dominant": dom,
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(c.flops * n_dev, 1.0),
        "bound_s": max(compute_t, memory_t, collective_t),
        "peaks": "NVIDIA H100 80GB HBM3 data sheet (SXM, 700 W): 989e12 FLOP/s bf16, "
                 "3.35e12 B/s HBM, 900e9 B/s NVLink",
    }
    return rec


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--override", action="append", default=[],
                    help="config override key=value (repeatable) — §Perf iterations")
    ap.add_argument("--tag", default=None, help="suffix for the output json")
    args = ap.parse_args(argv)

    overrides = {}
    for ov in args.override:
        k, v = ov.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            pass
        overrides[k] = v

    cells = []
    if args.all:
        for a in list_configs():
            for c in SHAPE_CELLS:
                cells.append((a, c))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]

    os.makedirs(args.out, exist_ok=True)
    pod_tag = "multipod" if args.multi_pod else "pod"
    if args.tag:
        pod_tag = f"{pod_tag}__{args.tag}"
    failures = []
    for arch, cell in cells:
        out_path = os.path.join(args.out, f"{arch}__{cell}__{pod_tag}.json")
        if args.skip_existing and os.path.exists(out_path):
            print(f"[skip-existing] {arch} x {cell}")
            continue
        ok, why = runnable(arch, cell)
        if not ok:
            rec = {"arch": arch, "cell": cell, "skipped": why}
            print(f"[SKIP] {arch} x {cell}: {why}")
        else:
            print(f"[dryrun] {arch} x {cell} ({pod_tag}) "
                  f"{overrides if overrides else ''}...", flush=True)
            try:
                rec = lower_cell(arch, cell, args.multi_pod, overrides)
                rec["overrides"] = overrides
                r = rec["roofline"]
                print(
                    f"  ok: run={rec['compile_s']}s "
                    f"mem/dev={rec['memory']['per_device_total']/2**30:.2f}GiB "
                    f"compute={r['compute_s']*1e3:.2f}ms mem={r['memory_s']*1e3:.2f}ms "
                    f"coll={r['collective_s']*1e3:.2f}ms dom={r['dominant']} "
                    f"useful={r['useful_flops_ratio']:.2f}",
                    flush=True,
                )
            except Exception as e:
                rec = {"arch": arch, "cell": cell, "error": str(e),
                       "traceback": traceback.format_exc()}
                failures.append((arch, cell, str(e)[:200]))
                print(f"  FAIL: {e}", flush=True)
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=2)
    if failures:
        print(f"\n{len(failures)} failures:")
        for a, c, e in failures:
            print(f"  {a} x {c}: {e}")
        raise SystemExit(1)
    print("\nall cells ok")


if __name__ == "__main__":
    main()
