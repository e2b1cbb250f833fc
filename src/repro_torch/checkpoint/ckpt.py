"""Atomic, async checkpointing with resume (``repro/checkpoint/ckpt.py``).

The JAX package's on-disk layout, leaf names included, so a checkpoint
written by either package restores into the other::

  <dir>/step_<n>.tmp/ -> (atomic rename) -> <dir>/step_<n>/
    arrays.npz   one array a leaf, ``a0``, ``a1``, ... (bf16 stored as
                 ``uint16`` views)
    meta.json    ``step``, ``names`` (JAX's ``keystr`` of each leaf's
                 path, e.g. ``.params['blocks']['wq']``), ``dtypes`` and
                 the caller's extra entries (pipeline cursor, LEA counts)

A tree is a tensor, a dict (dotted keys stand for nested
dicts, as the trainer's flat gradient and moment dicts do), a NamedTuple
(``TrainState``) or a module with ``tensors()`` / ``from_tensors``
(``models.lm.ParamTree``: the decoder LM, encoder-decoder, hybrid and xLSTM
parameters);
leaves are taken in JAX's order.

Fault-tolerance contract:
  * the writer never leaves a half-written visible checkpoint (tmp + rename);
  * ``latest_step`` ignores tmp/corrupt dirs, so a crash mid-write simply
    falls back to the previous checkpoint;
  * the async thread is joined before the next save (one in flight), and
    the tensors are copied to the host on the caller's thread first.
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.optim.adamw import jax_order


def _key(name: str) -> str:
    """JAX's ``keystr`` of a dotted name: ``['key']`` for a dict key, ``[i]``
    for a tuple position (xLSTM's ``blocks.0.w_up``)."""
    return "".join(f"[{part}]" if part.isdigit() else f"['{part}']"
                   for part in name.split("."))


def _named_leaves(tree, prefix: str = "") -> list[tuple[str, object]]:
    if tree is None:
        return []
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [leaf for field in tree._fields
                for leaf in _named_leaves(getattr(tree, field), f"{prefix}.{field}")]
    if hasattr(tree, "tensors"):
        tree = tree.tensors()
    if isinstance(tree, dict):
        return [leaf for name in jax_order(tree)
                for leaf in _named_leaves(tree[name], prefix + _key(name))]
    raise TypeError(f"not a checkpoint tree: {type(tree).__name__}")


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken from the iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(getattr(like, f), leaves) for f in like._fields))
    if hasattr(like, "tensors"):
        named = like.tensors()
        out = type(like).from_tensors({name: next(leaves) for name in jax_order(named)})
        if any(t.requires_grad for t in named.values()):
            out.trainable()
        return out
    return {name: _rebuild(like[name], leaves) for name in jax_order(like)}


def _host(leaf: torch.Tensor) -> tuple[np.ndarray, str]:
    """A host copy of one leaf, never a view of it (the optimizer updates
    the state's tensors in place), and its dtype name."""
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _host_tree(tree) -> tuple[list[str], list[np.ndarray], list[str]]:
    named = _named_leaves(tree)
    hosted = [_host(leaf) for _, leaf in named]
    return [n for n, _ in named], [a for a, _ in hosted], [d for _, d in hosted]


def _write(directory: str, step: int, names, arrays, dtypes, extra_meta) -> str:
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **{f"a{i}": a for i, a in enumerate(arrays)})
    meta = {"step": step, "names": names, "dtypes": dtypes, **(extra_meta or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def save(directory: str, step: int, tree, *, extra_meta: dict | None = None) -> str:
    """Blocking atomic save.  Returns the final path."""
    return _write(directory, step, *_host_tree(tree), extra_meta)


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    best = None
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            p = os.path.join(directory, name, "meta.json")
            if os.path.exists(p):
                try:
                    s = int(name.split("_", 1)[1])
                except ValueError:
                    continue
                best = s if best is None else max(best, s)
    return best


def _to_tensor(arr: np.ndarray, saved_dtype: str, like: torch.Tensor) -> torch.Tensor:
    if saved_dtype == "bfloat16" and arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=like.device, dtype=like.dtype)


def restore(directory: str, step: int, like_tree):
    """Restore into the structure, dtypes and devices of ``like_tree``;
    returns ``(tree, meta)``.  A checkpoint whose leaf names differ from the
    tree's raises ``ValueError``."""
    path = os.path.join(directory, f"step_{step}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    named = _named_leaves(like_tree)
    names = [n for n, _ in named]
    if names != meta["names"]:
        raise ValueError(
            "checkpoint structure mismatch: "
            f"{set(names) ^ set(meta['names'])}"
        )
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [_to_tensor(data[f"a{i}"], meta["dtypes"][i], like)
                  for i, (_, like) in enumerate(named)]
    return _rebuild(like_tree, iter(leaves)), meta


class CheckpointManager:
    """Async save + retention (the newest ``keep``) + auto-resume."""

    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        os.makedirs(directory, exist_ok=True)

    def save_async(self, step: int, tree, *, extra_meta: dict | None = None) -> None:
        self.wait()
        # copy to the host BEFORE backgrounding: the caller updates in place
        hosted = _host_tree(tree)

        def work():
            try:
                _write(self.dir, step, *hosted, extra_meta)
                self._gc()
            except Exception as e:       # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join the save in flight; raise what it raised, if anything."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            error, self._error = self._error, None
            raise error

    def _gc(self) -> None:
        steps = sorted(
            int(n.split("_", 1)[1])
            for n in os.listdir(self.dir)
            if n.startswith("step_") and not n.endswith(".tmp")
            and os.path.exists(os.path.join(self.dir, n, "meta.json"))
        )
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"), ignore_errors=True)

    def restore_latest(self, like_tree):
        """``(step, tree, meta)`` of the newest checkpoint, or three
        ``None`` when there is none."""
        self.wait()
        s = latest_step(self.dir)
        if s is None:
            return None, None, None
        tree, meta = restore(self.dir, s, like_tree)
        return s, tree, meta


__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
