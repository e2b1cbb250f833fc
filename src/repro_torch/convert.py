"""Carry the JAX package's inputs across: numpy arrays in, port tensors out.

The JAX package's "weights" are its scenario batches, load parameters and
estimator states, for the coded-computing half its encoded datasets, and
for the LM zoo its parameter trees (:func:`model_params`) and training states
(:func:`train_state`).  Hand their leaves over as numpy arrays
(``np.asarray`` of each JAX array) and :func:`to_torch` rebuilds the port's
counterpart on a chosen device, so both packages run the same scenarios on
the same data.  Objects are read by field name, so nothing of the JAX
package is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coded_ops import CodedDataset, CodedDatasetModp
from repro_torch.core.lagrange import CodeSpec
from repro_torch.core.lea import EstimatorState, LoadParams, PoolLoad
from repro_torch.device import resolve_device
from repro_torch.models.api import get_model
from repro_torch.models.lm import ParamTree
from repro_torch.optim import TrainState
from repro_torch.sweeps.registry import ScenarioBatch

_DTYPES = {
    "p_gg": torch.float32, "p_bb": torch.float32, "mu_g": torch.float32,
    "mu_b": torch.float32, "deadline": torch.float32, "kstar": torch.int32,
    "ell_g": torch.int32, "ell_b": torch.int32, "worker_mask": torch.bool,
    "mask": torch.bool, "counts": torch.float32, "prev_state": torch.int32,
    "seen_prev": torch.bool, "seeds": torch.int64,
}


def _leaf(obj, name: str, dev) -> torch.Tensor:
    return torch.as_tensor(np.array(getattr(obj, name)), dtype=_DTYPES[name],
                           device=dev)


def scenario_batch(batch, device=None, seeds=None) -> ScenarioBatch:
    """A :class:`ScenarioBatch` from an object with the JAX package's batch
    fields (its ``keys`` are dropped: the port draws through a ``Draws``).
    ``seeds`` (B, 2) sets the rows' seed pairs; zeros when omitted."""
    dev = resolve_device(device)
    fields = {name: _leaf(batch, name, dev) for name in ScenarioBatch._fields
              if name != "seeds"}
    rows = fields["p_gg"].shape[0]
    fields["seeds"] = (torch.zeros((rows, 2), dtype=torch.int64, device=dev)
                       if seeds is None else
                       torch.as_tensor(np.asarray(seeds), dtype=torch.int64,
                                       device=dev))
    return ScenarioBatch(**fields)


def pool_load(pool, device=None) -> PoolLoad:
    """A :class:`PoolLoad` from the fields of the JAX package's ``PoolLoad``."""
    dev = resolve_device(device)
    return PoolLoad(*(_leaf(pool, name, dev) for name in PoolLoad._fields))


def load_params(lp) -> LoadParams:
    """The port's static :class:`LoadParams` with the same four integers."""
    return LoadParams(n=int(lp.n), kstar=int(lp.kstar), ell_g=int(lp.ell_g),
                      ell_b=int(lp.ell_b))


def estimator_state(state, device=None) -> EstimatorState:
    """An :class:`EstimatorState` from the JAX package's estimator fields."""
    dev = resolve_device(device)
    return EstimatorState(*(_leaf(state, name, dev)
                            for name in EstimatorState._fields))


def code_spec(spec) -> CodeSpec:
    """The port's :class:`CodeSpec` with the same four integers."""
    return CodeSpec(n=int(spec.n), r=int(spec.r), k=int(spec.k),
                    deg_f=int(spec.deg_f))


def coded_dataset(obj, device=None) -> CodedDataset | CodedDatasetModp:
    """A :class:`CodedDataset` (float ``x_tilde``) or
    :class:`CodedDatasetModp` (integer ``x_tilde``, int32 residues) from an
    object with the JAX package's fields ``spec``, ``x_tilde`` and
    ``y_tilde`` (``None`` or an array), given as numpy arrays."""
    dev = resolve_device(device)
    spec = code_spec(obj.spec)
    x = np.array(obj.x_tilde)
    y = None if obj.y_tilde is None else np.array(obj.y_tilde)
    if x.dtype.kind in "iu":
        as_t = lambda a: torch.as_tensor(a.astype(np.int32), device=dev)
        return CodedDatasetModp(spec=spec, x_tilde=as_t(x),
                                y_tilde=None if y is None else as_t(y))
    if x.dtype.kind != "f":
        raise TypeError(f"x_tilde must be float or integer, got {x.dtype}")
    return CodedDataset(spec=spec, x_tilde=torch.as_tensor(x, device=dev),
                        y_tilde=None if y is None else torch.as_tensor(y, device=dev))


def _lm_tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":     # ml_dtypes: exact through float32
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def _named(tree, prefix: str = "") -> dict:
    """A JAX parameter tree's leaves by the port's dotted names: dict keys,
    and tuple positions for xLSTM's ``blocks`` (``blocks.0.w_up``)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for key, sub in items:
        out.update(_named(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def model_params(np_params: dict, cfg, device=None) -> ParamTree:
    """The port's parameter module for ``cfg``'s family (as ``get_model``
    dispatches: :class:`DecoderLM` for dense, MoE and the vision stub
    (``patch_proj``), :class:`EncDecLM`, :class:`HybridLM`, :class:`XLSTMLM`)
    from the JAX ``init_params`` tree given as numpy
    arrays (``jax.tree.map(np.asarray, params)``): the same names, layouts
    and dtypes, tensor for tensor (bf16 through float32, exactly).  Names
    and shapes are held to those the port's own ``init_params`` makes for
    ``cfg`` (on the meta device); any difference raises ``ValueError``."""
    dev = resolve_device(device)
    like = get_model(cfg).init_params(None, cfg, device="meta")
    want = {name: tuple(t.shape) for name, t in like.tensors().items()}
    leaves = _named(np_params)
    got = {name: tuple(np.shape(a)) for name, a in leaves.items()}
    if got != want:
        diff = sorted(set(got.items()) ^ set(want.items()))[:6]
        raise ValueError(f"{cfg.name}: parameter names or shapes do not match the "
                         f"config (first differences, given and expected: {diff})")
    return type(like).from_tensors({name: _lm_tensor(a, dev) for name, a in leaves.items()})


def train_state(np_state, cfg, device=None) -> TrainState:
    """The port's :class:`TrainState` from the JAX package's ``TrainState``
    given as numpy arrays: ``params``, ``m`` and ``v`` each through
    :func:`model_params` (the moments keep their dtype, bf16 for nemotron),
    the parameters made trainable, ``step`` an int32 0-d tensor."""
    dev = resolve_device(device)
    moment = lambda tree: model_params(tree, cfg, dev).tensors()
    return TrainState(
        params=model_params(np_state.params, cfg, dev).trainable(),
        m={name: t.detach() for name, t in moment(np_state.m).items()},
        v={name: t.detach() for name, t in moment(np_state.v).items()},
        step=torch.tensor(int(np.asarray(np_state.step)), dtype=torch.int32, device=dev),
    )


def to_torch(obj, device=None):
    """Dispatch on the object's fields: a scenario batch, a pool load, an
    estimator state, an encoded dataset or load parameters."""
    if hasattr(obj, "x_tilde"):
        return coded_dataset(obj, device)
    if hasattr(obj, "worker_mask"):
        return scenario_batch(obj, device)
    if hasattr(obj, "mask"):
        return pool_load(obj, device)
    if hasattr(obj, "counts"):
        return estimator_state(obj, device)
    if all(hasattr(obj, f) for f in ("n", "kstar", "ell_g", "ell_b")):
        return load_params(obj)
    raise TypeError(f"no port counterpart for {type(obj).__name__}")


__all__ = ["code_spec", "coded_dataset", "estimator_state", "load_params",
           "model_params", "pool_load", "scenario_batch", "to_torch", "train_state"]
