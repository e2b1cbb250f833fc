"""Carry the JAX package's inputs across: numpy arrays in, port tensors out.

The JAX package's "weights" are its scenario batches, load parameters and
estimator states, and — for the coded-computing half — its encoded
datasets.  Hand their leaves over as numpy arrays (``np.asarray`` of each
JAX array) and :func:`to_torch` rebuilds the port's counterpart on a chosen
device, so both packages run the same scenarios on the same data.  Objects are
read by field name, so nothing of the JAX package is imported here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.coded_ops import CodedDataset, CodedDatasetModp
from repro_torch.core.lagrange import CodeSpec
from repro_torch.core.lea import EstimatorState, LoadParams, PoolLoad
from repro_torch.device import resolve_device
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
           "pool_load", "scenario_batch", "to_torch"]
