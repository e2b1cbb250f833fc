"""Coded computation ops: encode-once, evaluate-per-round, decode-on-K*.

The operations the paper's system executes each round (Sec. 3.1 and the
Sec. 2.1 regression example):

  * :func:`coded_matmul`          — f(X_j) = X_j @ w           (deg f = 1)
  * :func:`coded_linear_gradient` — f(X_j,y_j) = X_jᵀ(X_j w−y) (deg f = 2)

Both follow the paper's protocol: the dataset is Lagrange-encoded once
(:func:`encode_dataset`), each round every worker evaluates f on (a prefix
of) its r stored encoded chunks, and the master decodes from the K* first
results.  On-time-ness comes in as a boolean mask (from the scheduler or
the engine's rollout, :func:`chunk_on_time`).

Decode paths, as in the JAX package's ``core/coded_ops.py``:

  * eager (:func:`coded_matmul`, :func:`coded_linear_gradient`): the decode
    matrix is built on the host in float64 (memoised by :class:`DecodeCache`)
    and a short pattern raises ``TimeoutError``;
  * device (:func:`coded_matmul_device`, :func:`coded_linear_gradient_device`):
    the received set is a static-shape gather (:func:`received_indices`) and
    the decode matrix is built in float32 on the results' device; they return
    ``(out, ok)`` with ``ok`` False when fewer than K* results were on time.
    The JAX package jit-compiles these; here they are eager PyTorch.

Exact GF(p) path: :func:`encode_dataset_modp` / :func:`coded_matmul_exact` /
:func:`coded_linear_gradient_modp` / :class:`ModpDecodeCache` run the
encode -> worker shard -> erasure-aware decode round in exact Mersenne-31
arithmetic (:mod:`repro_torch.kernels.gf`), equal to the numpy
``lagrange.*_modp`` oracle to the last bit.  On the card every GF(p)
product is the hand-written ``gf_matmul`` kernel.

**One deliberate difference from the JAX package.** There the defaults are
plain: ``encode_dataset(encode_fn=lagrange.encode)`` and
``coded_linear_gradient(gradient_fn=None)`` -> a vmapped
:func:`chunk_gradient`, and the Pallas kernels come in only when a caller
passes them.  Here the defaults ARE the routed kernel ops:
``encode_fn=kernels.lagrange_encode.encode`` and ``gradient_fn=None`` ->
``kernels.coded_gradient.coded_gradient``.  On the CPU those routes take
their plain versions, which compute what the JAX defaults compute (to
float32 round-off); on the card they launch the kernels.  The routed
gradient raises the Pallas wrapper's footprint ``ValueError`` on chunks
larger than its 12 MiB budget, where the JAX default would not.

Devices: the ops follow their tensors.  :func:`encode_dataset_modp` given
numpy arrays puts them on ``device`` (``None`` means ``"cuda"``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import gf
from repro_torch.kernels.coded_gradient import coded_gradient
from repro_torch.kernels.lagrange_encode import encode as encode_routed
from repro_torch.obs.profiling import phase as _phase

from .lagrange import (CodeSpec, decode_matrix, decode_matrix_jax,
                       decode_matrix_modp_device, generator_matrix,
                       generator_matrix_modp_device)


@dataclasses.dataclass
class CodedDataset:
    """Encoded dataset as stored across workers: chunk v lives on worker v//r."""

    spec: CodeSpec
    x_tilde: torch.Tensor            # (nr, rows, cols)
    y_tilde: torch.Tensor | None     # (nr, rows) or None

    @property
    def nr(self) -> int:
        return self.spec.nr


def encode_dataset(
    spec: CodeSpec,
    x_chunks: torch.Tensor,
    y_chunks: torch.Tensor | None = None,
    encode_fn=encode_routed,
) -> CodedDataset:
    """Encode (k, rows, cols) data chunks (and optionally (k, rows) targets).

    ``encode_fn(g, data)`` defaults to the routed Lagrange-encode op (the
    CUDA kernel on the card); the generator is built on ``x_chunks``'s
    device in its dtype.
    """
    if x_chunks.shape[0] != spec.k:
        raise ValueError(f"expected {spec.k} chunks, got {x_chunks.shape[0]}")
    g = generator_matrix(spec, x_chunks.dtype, device=x_chunks.device)
    x_t = encode_fn(g, x_chunks)
    y_t = encode_fn(g, y_chunks) if y_chunks is not None else None
    return CodedDataset(spec=spec, x_tilde=x_t, y_tilde=y_t)


def received_indices(on_time: torch.Tensor, kstar: int) -> torch.Tensor:
    """Indices of the K* lexicographically-first on-time chunks (static shape).

    The master needs *any* K* on-time results (Defn. 4.1); it takes the
    first K* in chunk order.  The caller guarantees >= K* are on time.  The
    stable sort runs on an int8 view (0 = on time), because stable sorting of
    a bool tensor is not reliable on every backend.
    """
    on_time = torch.as_tensor(on_time)
    late = (~on_time.to(torch.bool)).to(torch.int8)
    return torch.argsort(late, dim=-1, stable=True)[..., :kstar]


def _received_or_raise(spec: CodeSpec, on_time) -> np.ndarray:
    """First-K* received indices, or ``TimeoutError`` on a short pattern."""
    if isinstance(on_time, torch.Tensor):
        on_time = on_time.cpu().numpy()
    on_time = np.asarray(on_time)
    got = int(np.count_nonzero(on_time))
    if got < spec.recovery_threshold:
        raise TimeoutError(
            f"round failed: {got} < K*={spec.recovery_threshold} on-time results"
        )
    return np.nonzero(on_time)[0][: spec.recovery_threshold]


class DecodeCache:
    """Host-side memo of decode matrices keyed on the received chunk set.

    On-time patterns recur across rounds (worker states are discrete), so
    the O(K*^2 k) decode-matrix build is paid once per distinct received
    set.  Not thread-safe; one cache per CodedDataset/spec.
    """

    def __init__(self, spec: CodeSpec):
        self.spec = spec
        self._mats: dict[tuple, torch.Tensor] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._mats)

    def matrix(self, received: np.ndarray, dtype=torch.float32,
               device=None) -> torch.Tensor:
        # dtype and device are part of the key: a hit must not hand back a
        # matrix of another precision, or on another device, than the
        # caller's results
        dev = resolve_device(device)
        key = (str(dtype), str(dev), *(int(v) for v in received))
        mat = self._mats.get(key)
        if mat is None:
            self.misses += 1
            mat = decode_matrix(self.spec, received, dtype, device=dev)
            self._mats[key] = mat
        else:
            self.hits += 1
        return mat

    def from_on_time(self, on_time, dtype=torch.float32, device=None):
        """(received indices, decode matrix) for the first-K* on-time chunks.

        Raises ``TimeoutError`` when fewer than K* chunks arrived (same
        convention as :func:`coded_matmul` and the modp twin).
        """
        received = _received_or_raise(self.spec, on_time)
        return received, self.matrix(received, dtype, device)


def _worker_results(x_tilde: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Every chunk's f(X~_v) = X~_v @ w: (nr, rows, cols) x (cols, *d)."""
    return torch.tensordot(x_tilde, w, dims=1)


def coded_matmul(
    coded: CodedDataset, w: torch.Tensor, on_time,
    cache: DecodeCache | None = None,
) -> torch.Tensor:
    """Decode f(X_j) = X_j @ w from on-time encoded evaluations.

    ``on_time`` is a concrete (nr,) bool mask from the scheduler.  Returns
    (k, rows[, ...]).  Pass a :class:`DecodeCache` to memoise the decode
    matrix across rounds; use :func:`coded_matmul_device` for the path with
    no host decode.
    """
    spec = coded.spec
    # one shared short-pattern gate for every eager path: all raise the same
    # TimeoutError before any compute
    received = _received_or_raise(spec, on_time)
    results = _worker_results(coded.x_tilde, w)
    if cache is not None:
        d = cache.matrix(received, results.dtype, results.device)
    else:
        d = decode_matrix(spec, received, results.dtype, device=results.device)
    idx = torch.as_tensor(received, device=results.device)
    return torch.tensordot(d, results[idx], dims=1)


def _decode_on_time(spec: CodeSpec, results: torch.Tensor, on_time
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """Device decode: (nr, *dims) results + (nr,) bool -> ((k, *dims), ok).
    The ``decode`` span covers the decode-matrix build and the decode."""
    with _phase("decode", results.device):
        kstar = spec.recovery_threshold
        on_time = torch.as_tensor(on_time, device=results.device)
        received = received_indices(on_time, kstar)
        d = decode_matrix_jax(spec, received)
        gathered = results[received]                           # (K*, *dims)
        ok = on_time.sum() >= kstar
        return torch.tensordot(d.to(results.dtype), gathered, dims=1), ok


def coded_matmul_device(
    coded: CodedDataset, w: torch.Tensor, on_time
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`coded_matmul` with the decode matrix built on the device.

    Returns ``(decoded, ok)``; ``decoded`` is meaningful only where ``ok``.
    """
    results = _worker_results(coded.x_tilde, w)
    return _decode_on_time(coded.spec, results, on_time)


def chunk_gradient(x_tilde_v: torch.Tensor, y_tilde_v: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Per-chunk degree-2 evaluation f(X̃,ỹ) = X̃ᵀ(X̃ w − ỹ) — worker-side op."""
    resid = x_tilde_v @ w - y_tilde_v
    return x_tilde_v.T @ resid


def _check_gradient_dataset(coded: CodedDataset) -> None:
    if coded.y_tilde is None:
        raise ValueError("dataset was encoded without targets")
    if coded.spec.deg_f != 2:
        raise ValueError("linear-model gradient is a degree-2 polynomial; spec.deg_f must be 2")


def coded_linear_gradient(
    coded: CodedDataset, w: torch.Tensor, on_time, gradient_fn=None,
    cache: DecodeCache | None = None,
) -> torch.Tensor:
    """Full least-squares gradient sum_j X_jᵀ(X_j w − y_j) via LCC (deg f = 2).

    ``gradient_fn(x_tilde, y_tilde, w) -> (nr, cols)`` defaults to the
    routed fused-gradient op (the CUDA kernel on the card).  Pass a
    :class:`DecodeCache` to memoise decode matrices across rounds; use
    :func:`coded_linear_gradient_device` for the path with no host decode.
    """
    spec = coded.spec
    _check_gradient_dataset(coded)
    received = _received_or_raise(spec, on_time)   # shared TimeoutError gate
    if gradient_fn is None:
        gradient_fn = coded_gradient
    results = gradient_fn(coded.x_tilde, coded.y_tilde, w)       # (nr, cols)
    if cache is not None:
        d = cache.matrix(received, results.dtype, results.device)
    else:
        d = decode_matrix(spec, received, results.dtype, device=results.device)
    idx = torch.as_tensor(received, device=results.device)
    per_chunk = torch.tensordot(d, results[idx], dims=1)          # (k, cols)
    return per_chunk.sum(dim=0)


def coded_linear_gradient_device(
    coded: CodedDataset, w: torch.Tensor, on_time, gradient_fn=None
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`coded_linear_gradient` with the decode matrix built on the
    device.  Returns ``(gradient, ok)``; meaningful only where ``ok``."""
    spec = coded.spec
    _check_gradient_dataset(coded)
    if gradient_fn is None:
        gradient_fn = coded_gradient
    results = gradient_fn(coded.x_tilde, coded.y_tilde, w)       # (nr, cols)
    per_chunk, ok = _decode_on_time(spec, results, on_time)
    return per_chunk.sum(dim=0), ok


def uncoded_linear_gradient(x_chunks: torch.Tensor, y_chunks: torch.Tensor,
                            w: torch.Tensor) -> torch.Tensor:
    """Oracle: sum_j X_jᵀ(X_j w − y_j) computed directly on the raw data
    (every chunk's :func:`chunk_gradient` in one batched pair of products)."""
    resid = torch.matmul(x_chunks, w) - y_chunks               # (k, rows[, d])
    return torch.einsum("krc,kr...->c...", x_chunks, resid)


# ---------------------------------------------------------------------------
# Exact GF(p) path: encode -> worker matmul -> decode, on the device
# ---------------------------------------------------------------------------
#
# The float path above is the ML adaptation; this is the paper's protocol —
# exact arithmetic over the finite field F = GF(2^31 - 1), where the MDS
# guarantee is exact and conditioning does not exist.  Every result equals
# the numpy ``matmul_modp``/``decode_matrix_modp`` pipeline to the bit.


@dataclasses.dataclass
class CodedDatasetModp:
    """Exact-path encoded dataset: int32 residues in [0, p), chunk v on
    worker v//r (same placement as the float :class:`CodedDataset`).
    ``y_tilde`` carries encoded targets for the exact degree-2 gradient."""

    spec: CodeSpec
    x_tilde: torch.Tensor                 # (nr, rows, cols) int32 residues
    y_tilde: torch.Tensor | None = None   # (nr, rows) int32 residues, or None

    @property
    def nr(self) -> int:
        return self.spec.nr


def _on_device(x, device) -> torch.Tensor:
    """A tensor stays where it is unless ``device`` is given; numpy and
    lists go to ``device`` (``None`` means ``"cuda"``)."""
    if isinstance(x, torch.Tensor) and device is None:
        return x
    return torch.as_tensor(x, device=resolve_device(device))


def encode_dataset_modp(
    spec: CodeSpec, x_chunks, y_chunks=None, *, device=None
) -> CodedDatasetModp:
    """Exact encode: (k, rows, cols) int residues -> (nr, rows, cols).

    The generator is built on the device (:func:`generator_matrix_modp_device`)
    and applied with one exact GF(p) GEMM (the ``gf_matmul`` kernel on the
    card).  Inputs must be integers; they are reduced into [0, p).
    ``y_chunks`` (k, rows) targets are encoded alongside for the exact
    degree-2 gradient (:func:`coded_linear_gradient_modp`).
    """
    x_chunks = _on_device(x_chunks, device)
    if x_chunks.shape[0] != spec.k:
        raise ValueError(f"expected {spec.k} chunks, got {x_chunks.shape[0]}")
    g = generator_matrix_modp_device(spec, device=x_chunks.device)
    flat = x_chunks.reshape(spec.k, -1)
    x_t = gf.from_gf(gf.matmul_gf(g, flat)).reshape(
        (spec.nr,) + tuple(x_chunks.shape[1:]))
    y_t = None
    if y_chunks is not None:
        y_chunks = _on_device(y_chunks, x_chunks.device)
        if y_chunks.shape[0] != spec.k:
            raise ValueError(f"expected {spec.k} target chunks, got {y_chunks.shape[0]}")
        y_t = gf.from_gf(gf.matmul_gf(g, y_chunks.reshape(spec.k, -1))).reshape(
            (spec.nr,) + tuple(y_chunks.shape[1:]))
    return CodedDatasetModp(spec=spec, x_tilde=x_t, y_tilde=y_t)


class ModpDecodeCache:
    """Host-side memo of EXACT decode matrices keyed on the erasure pattern.

    The mod-p twin of :class:`DecodeCache`: received sets recur across
    rounds and each distinct pattern pays the GF(p) basis build (gather +
    Fermat inversion) once.  Matrices are the int32 residues of
    :func:`decode_matrix_modp_device`; no dtype in the key (the field has
    one integer representation), the device is.
    """

    def __init__(self, spec: CodeSpec):
        self.spec = spec
        self._mats: dict[tuple, torch.Tensor] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._mats)

    def matrix(self, received: np.ndarray, device=None) -> torch.Tensor:
        dev = resolve_device(device)
        key = (str(dev), *(int(v) for v in received))
        mat = self._mats.get(key)
        if mat is None:
            self.misses += 1
            mat = decode_matrix_modp_device(
                self.spec, torch.as_tensor(np.asarray(received), device=dev))
            self._mats[key] = mat
        else:
            self.hits += 1
        return mat

    def from_on_time(self, on_time, device=None):
        """(received indices, exact decode matrix) for the first K* on-time.

        Raises ``TimeoutError`` when fewer than K* chunks arrived, matching
        the eager float path (:func:`coded_matmul`).
        """
        received = _received_or_raise(self.spec, on_time)
        return received, self.matrix(received, device)


def _decode_on_time_modp(spec: CodeSpec, results: torch.Tensor, on_time
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact decode: (nr, *dims) residues + (nr,) bool -> ((k, *dims), ok).
    The ``decode`` span covers the decode-matrix build and the decode."""
    with _phase("decode", results.device):
        kstar = spec.recovery_threshold
        on_time = torch.as_tensor(on_time, device=results.device)
        received = received_indices(on_time, kstar)
        d = decode_matrix_modp_device(spec, received)
        gathered = results[received]                    # (K*, *dims)
        ok = on_time.sum() >= kstar
        out = gf.from_gf(gf.matmul_gf(d, gathered.reshape(kstar, -1)))
        return out.reshape((spec.k,) + tuple(results.shape[1:])), ok


def coded_matmul_exact(
    coded: CodedDatasetModp, w, on_time
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact f(X_j) = X_j @ w mod p from on-time evaluations, on the device.

    The paper's round over its finite field: every worker evaluates its
    stored shards (one exact GF(p) GEMM across all chunks), the master
    gathers the K* lexicographically-first on-time results and decodes
    through the erasure-pattern decode matrix built on the device.  Feed
    ``on_time`` the chunk masks of an engine rollout (:func:`chunk_on_time`).
    Returns ``(decoded (k, rows[, d]), ok)``: equal to the numpy
    ``matmul_modp``/``decode_matrix_modp`` pipeline whenever ``ok``; short
    rounds return ``ok=False`` (the eager paths raise ``TimeoutError``).
    """
    w = _on_device(w, coded.x_tilde.device)
    squeeze = w.dim() == 1
    w2 = w[:, None] if squeeze else w                      # (cols, d)
    nr, rows = coded.x_tilde.shape[0], coded.x_tilde.shape[1]
    flat = coded.x_tilde.reshape(nr * rows, -1)            # (nr*rows, cols)
    results = gf.from_gf(gf.matmul_gf(flat, w2))           # (nr*rows, d)
    results = results.reshape(nr, rows, w2.shape[1])
    out, ok = _decode_on_time_modp(coded.spec, results, on_time)
    return (out[..., 0] if squeeze else out), ok


def coded_linear_gradient_modp(
    coded: CodedDatasetModp, w, on_time
) -> tuple[torch.Tensor, torch.Tensor]:
    """EXACT least-squares gradient sum_j X_jᵀ(X_j w − y_j) over GF(p).

    The finite-field twin of :func:`coded_linear_gradient_device`:

      1. every worker shard evaluates its chunk gradient X̃_vᵀ(X̃_v w − ỹ_v)
         with GF(p) matmuls (the transposed product over all nr chunks is
         ONE batched ``bmm_gf`` — one kernel launch on the card);
      2. the master gathers the K* lexicographically-first on-time results
         and decodes through the erasure-pattern decode matrix;
      3. the per-chunk decoded gradients are summed mod p.

    ``w`` is (cols,) or (cols, d) int residues.  Returns ``(gradient, ok)``
    with ``gradient`` (cols[, d]) int32 residues, equal to the numpy
    ``matmul_modp``/``decode_matrix_modp`` pipeline whenever ``ok``.
    """
    spec = coded.spec
    if coded.y_tilde is None:
        raise ValueError("dataset was encoded without targets")
    if spec.deg_f != 2:
        raise ValueError("linear-model gradient is a degree-2 polynomial; spec.deg_f must be 2")
    w = _on_device(w, coded.x_tilde.device)
    squeeze = w.dim() == 1
    w2 = w[:, None] if squeeze else w                      # (cols, d)
    nr, rows, cols = coded.x_tilde.shape
    d = w2.shape[1]
    flat = coded.x_tilde.reshape(nr * rows, cols)
    xw = gf.matmul_gf(flat, w2).reshape(nr, rows, d)
    resid = gf.sub_gf(xw, gf.to_gf(coded.y_tilde)[..., None])    # (nr, rows, d)
    xt = coded.x_tilde.transpose(1, 2)                     # (nr, cols, rows)
    grads = gf.from_gf(gf.bmm_gf(xt, resid))               # (nr, cols, d)
    per_chunk, ok = _decode_on_time_modp(spec, grads, on_time)
    total = gf.to_gf(per_chunk.to(torch.int64).sum(dim=0))  # (cols, d), exact
    return (total[..., 0] if squeeze else total), ok


def chunk_on_time(states: torch.Tensor, loads: torch.Tensor, mu_g, mu_b,
                  deadline, r: int) -> torch.Tensor:
    """Engine trajectory -> per-chunk on-time masks: (..., n) -> (..., n*r).

    Worker i evaluates a *prefix* of its r stored chunks (two-level loads),
    so when its whole load meets the deadline its first ``loads_i`` chunks
    arrive, else none.  The rule is the engine's own, bit for bit
    (``throughput._score_block``): float32 speeds, and
    ``loads / speeds <= deadline + 1e-9`` with the deadline cast to float32
    before the tolerance is added — which makes round success equivalent to
    ``sum(chunk mask) >= K*``.  Broadcasts over leading axes: the rollout's
    (M, n) states and (S, M, n) loads give every round's pattern at once.
    """
    dev = states.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    speeds = torch.where(states == 1, f32(mu_g), f32(mu_b))
    on_time = loads.to(torch.float32) / speeds <= f32(deadline) + 1e-9
    done = torch.where(on_time, loads, 0)                  # (..., n)
    nr = done.shape[-1] * r
    slot = torch.arange(nr, device=dev) % r
    return slot < torch.repeat_interleave(done, r, dim=-1)


__all__ = [
    "CodedDataset", "CodedDatasetModp", "DecodeCache", "ModpDecodeCache",
    "chunk_gradient", "chunk_on_time", "coded_linear_gradient",
    "coded_linear_gradient_device", "coded_linear_gradient_modp",
    "coded_matmul", "coded_matmul_device", "coded_matmul_exact",
    "encode_dataset", "encode_dataset_modp", "received_indices",
    "uncoded_linear_gradient",
]
