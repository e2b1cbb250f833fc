"""LM training example on the public API — the port of the JAX package's
``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm             # the card
    PYTHONPATH=src python -m repro_torch.examples.train_lm --cpu       # the CPU

Runs the full trainer (:mod:`repro_torch.launch.train`: checkpointing,
LEA-coded DP and compression are its flags) on the reduced ``--smoke``
config and asserts that the loss falls.  The full-width run drops
``--smoke``::

    python -m repro_torch.launch.train --arch qwen3_0_6b --steps 1000 ...
"""

from __future__ import annotations

import argparse

from repro_torch.device import resolve_device
from repro_torch.launch import train as train_mod


def run(device=None, arch: str = "qwen3_0_6b", steps: int = 30) -> dict:
    """``launch.train.main`` at the example's settings on ``device`` (``None``
    means ``"cuda"``); returns its result and raises ``AssertionError`` if the
    loss does not fall."""
    dev = resolve_device(device)
    out = train_mod.main([
        "--arch", arch, "--smoke",
        "--steps", str(steps),
        "--batch", "8", "--seq", "64", "--lr", "3e-3",
        "--device", str(dev),
    ])
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    if not losses[-1] < losses[0]:
        raise AssertionError("training must reduce the loss")
    out["losses"] = losses
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args(argv)
    out = run("cpu" if args.cpu else None, args.arch, args.steps)
    losses = out["losses"]
    print(f"first loss {losses[0]:.4f} -> last loss {losses[-1]:.4f} "
          f"({out['wall_s']:.1f}s)")
    print("OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
