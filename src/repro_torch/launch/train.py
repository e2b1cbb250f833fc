"""End-to-end trainer: data pipeline -> (coded-DP | plain) train loop with
checkpoint/restart, LEA straggler mitigation, and optional gradient
compression (``repro/launch/train.py``).

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke --steps 20
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3_0_6b \\
      --batch 8 --seq 1024 --steps 100 --ckpt-dir ckpt --coded-dp

The flags are the JAX package's plus ``--device`` (default ``cuda``; without
a GPU pass ``--device cpu``).  Resume is automatic: re-running with the same
``--ckpt-dir`` picks up the latest checkpoint, the data cursor and the LEA
estimator counts.  ``--coded-dp`` runs each step's gradient through
:class:`~repro_torch.runtime.fault_tolerance.CodedDataParallelExecutor`
(on the card each round's plan launches the Poisson-binomial kernel);
``REPRO_COMPILE_CACHE=<dir>`` moves the kernel libraries into ``<dir>``
(:func:`repro_torch.launch.cache.enable_compile_cache`, called first).
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import get_config, get_smoke_config
from repro_torch.data import DataPipeline
from repro_torch.device import resolve_device
from repro_torch.launch.cache import enable_compile_cache
from repro_torch.models import api
from repro_torch.optim import adamw_update, cosine_warmup
from repro_torch.runtime.compression import make_compressor
from repro_torch.runtime.fault_tolerance import CodedDataParallelExecutor, CodedDPConfig


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coded-dp", action="store_true",
                    help="LEA-coded microbatch DP with simulated worker dynamics")
    ap.add_argument("--dp-workers", type=int, default=8)
    ap.add_argument("--dp-r", type=int, default=4)
    ap.add_argument("--dp-shards", type=int, default=8)
    ap.add_argument("--compress", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    enable_compile_cache()
    dev = resolve_device(args.device)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    cfg = dataclasses.replace(cfg, microbatch=1)
    model = api.get_model(cfg)

    pipe = DataPipeline(cfg.vocab_size, args.batch, args.seq, seed=args.seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    state = api.init_state(cfg, gen, device=dev)
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    def on_device(batch):
        return {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}

    def grad_fn(params, batch):
        with api.float32_split_k_sums():
            return api.loss_and_grads(params, batch, cfg)[1]

    def loss_of(params, batch) -> float:
        with torch.no_grad(), api.float32_split_k_sums():
            return float(model.train_loss(params, batch, cfg))

    executor = None
    if args.coded_dp:
        executor = CodedDataParallelExecutor(
            CodedDPConfig(n_workers=args.dp_workers, r=args.dp_r, k=args.dp_shards),
            grad_fn, draws=args.seed, device=dev,
        )

    comp_state = None
    comp_init = comp_apply = None
    if args.compress != "none":
        comp_init, comp_apply = make_compressor(args.compress)

    start_step = 0
    if mgr is not None:
        s, restored, meta = mgr.restore_latest(state)
        if s is not None:
            state = restored
            start_step = s
            pipe.restore(meta["pipeline"])
            if executor is not None and "lea" in meta:
                executor.load_state_dict(meta["lea"])
            print(f"[resume] step {s}")

    history = []
    t0 = time.time()
    for step in range(start_step, args.steps):
        batch = on_device(pipe.next())
        grads = None
        if executor is not None:
            grads, info = executor.round(state.params, batch)
            if grads is None:
                history.append({"step": step, "missed_deadline": True})
                print(f"step {step}: deadline MISS "
                      f"(on-time workers {info['on_time_workers']})")
        else:
            grads = grad_fn(state.params, batch)
        if grads is not None:
            if comp_apply is not None:
                if comp_state is None:
                    comp_state = comp_init(grads)
                grads, comp_state = comp_apply(grads, comp_state)
            lr = cosine_warmup(step + 1, peak_lr=args.lr, warmup=5, total=args.steps)
            state, metrics = adamw_update(state, grads, lr)
            loss = loss_of(state.params, batch)
            history.append({"step": step, "loss": loss})
            print(f"step {step}: loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        # checkpoint regardless of deadline misses (a miss must not stall FT)
        if mgr is not None and (step + 1) % args.ckpt_every == 0:
            meta = {"pipeline": pipe.state.to_dict()}
            if executor is not None:
                meta["lea"] = executor.state_dict()
            mgr.save_async(step + 1, state, extra_meta=meta)
    if mgr is not None:
        mgr.wait()
    out = {
        "history": history,
        "steps_done": len([h for h in history if "loss" in h]),
        "wall_s": time.time() - t0,
    }
    if executor is not None:
        out["timely_throughput"] = executor.timely_throughput
        print(f"timely computation throughput: {executor.timely_throughput:.3f}")
    return out


if __name__ == "__main__":
    main()
