"""Lagrange Coded Computing (LCC) — the data-encoding layer of LEA.

The coding scheme of Sec. 3.1 of the paper (following Yu et al. 2019):

* ``lagrange`` branch (``nr >= k*deg_f - 1``): the dataset ``X_1..X_k`` is
  interpolated by a degree-(k-1) polynomial ``u`` with ``u(beta_j) = X_j``;
  the encoded chunks are ``X~_v = u(alpha_v)``.  Because ``f`` has total
  degree ``deg_f``, ``h(z) = f(u(z))`` has degree ``(k-1)*deg_f`` and the
  master interpolates ``h`` from any ``K* = (k-1)*deg_f + 1`` on-time
  results, then reads off ``f(X_j) = h(beta_j)``.

* ``repetition`` branch (``nr < k*deg_f - 1``): every chunk is replicated
  ``floor(nr/k)`` or ``ceil(nr/k)`` times; ``K* = nr - floor(nr/k) + 1``
  results always hold at least one copy of each chunk.

Two numeric paths, as in the JAX package's ``core/lagrange.py``:

  * float32/float64 with Chebyshev interpolation nodes (conditioning
    bounded) — the ML-facing ops;
  * exact arithmetic over GF(p), p = 2^31 - 1 — the paper's finite field F.
    The numpy ``*_modp`` functions are the host oracle (copied from the JAX
    package; they stay the ground truth); the ``*_modp_device`` functions
    build the same matrices as int32 tensors through
    :mod:`repro_torch.kernels.gf`, equal to the last bit.

Devices: functions that build a matrix from the spec alone take
``device=None``, which means ``"cuda"`` (pass ``"cpu"`` to run there);
functions given a tensor of received indices build on that tensor's device.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import gf

# Mersenne prime 2^31 - 1.  Products of two residues fit in int64 and sums of
# up to ~4e9 residues fit in int64, so exact mod-p linear algebra is safe.
FIELD_P = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """Static description of one coded-computing instance."""

    n: int        # number of workers
    r: int        # encoded chunks stored per worker
    k: int        # number of data chunks
    deg_f: int    # total degree of the polynomial f evaluated each round

    @property
    def nr(self) -> int:
        return self.n * self.r

    @property
    def mode(self) -> str:
        return "lagrange" if self.nr >= self.k * self.deg_f - 1 else "repetition"

    @property
    def recovery_threshold(self) -> int:
        """K*, eq. (15)/(16) of the paper."""
        if self.mode == "lagrange":
            return (self.k - 1) * self.deg_f + 1
        return self.nr - self.nr // self.k + 1

    def chunk_owner(self, v: int) -> int:
        """Worker that stores encoded chunk v (worker i holds [i*r, (i+1)*r))."""
        return v // self.r

    def worker_chunks(self, i: int) -> range:
        return range(i * self.r, (i + 1) * self.r)


def recovery_threshold(n: int, r: int, k: int, deg_f: int) -> int:
    return CodeSpec(n, r, k, deg_f).recovery_threshold


# ---------------------------------------------------------------------------
# Interpolation nodes (float path)
# ---------------------------------------------------------------------------

def beta_points_np(k: int) -> np.ndarray:
    """Chebyshev nodes of the first kind on [-1, 1] — well-conditioned betas."""
    j = np.arange(k)
    return np.cos(np.pi * (2 * j + 1) / (2 * k))


def alpha_points_np(nr: int) -> np.ndarray:
    """nr mutually-distinct evaluation points (Chebyshev grid of size nr)."""
    v = np.arange(nr)
    return np.cos(np.pi * (2 * v + 1) / (2 * nr))


def beta_points(k: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(beta_points_np(k).astype(np.float32), dtype=dtype,
                           device=resolve_device(device))


def alpha_points(nr: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(alpha_points_np(nr).astype(np.float32), dtype=dtype,
                           device=resolve_device(device))


def _lagrange_basis(eval_pts: np.ndarray, nodes: np.ndarray) -> np.ndarray:
    """Matrix M[e, j] = prod_{l != j} (eval_e - nodes_l) / (nodes_j - nodes_l).

    Computed in float64 on the host regardless of the target dtype (the
    matrices are tiny — (nr, k) / (k, K*); the data they multiply is large).
    """
    eval_pts = np.asarray(eval_pts, dtype=np.float64)
    nodes = np.asarray(nodes, dtype=np.float64)
    e = eval_pts[:, None, None]                    # (E,1,1)
    nj = nodes[None, :, None]                      # (1,J,1)
    nl = nodes[None, None, :]                      # (1,1,J)
    num = e - nl                                   # (E,J,J) broadcast of (e - n_l)
    den = nj - nl                                  # (1,J,J)
    J = nodes.shape[0]
    eye = np.eye(J, dtype=bool)[None]
    num = np.where(eye, 1.0, np.broadcast_to(num, (eval_pts.shape[0], J, J)))
    den = np.where(eye, 1.0, np.broadcast_to(den, (1, J, J)))
    return np.prod(num / den, axis=-1)             # (E, J)


def chunk_alpha_indices(spec: CodeSpec) -> np.ndarray:
    """Chunk v -> index into the alpha grid, STRIDED across workers.

    Worker i stores chunks [i*r, (i+1)*r) and always evaluates a *prefix* of
    them (two-level loads, Lemma 4.4).  Mapping worker i's j-th chunk to grid
    position j*n + i spreads any union of per-worker prefixes uniformly over
    the Chebyshev grid, keeping the real-valued decode well-conditioned.
    """
    v = np.arange(spec.nr)
    worker, j = v // spec.r, v % spec.r
    return j * spec.n + worker


def _repetition_generator_np(spec: CodeSpec) -> np.ndarray:
    """0/1 replication matrix: chunk v holds X_{v mod k}."""
    g = np.zeros((spec.nr, spec.k))
    g[np.arange(spec.nr), np.arange(spec.nr) % spec.k] = 1.0
    return g


def _repetition_decode_np(spec: CodeSpec, received: np.ndarray) -> np.ndarray:
    """0/1 selection of the first received copy of each chunk."""
    d = np.zeros((spec.k, received.shape[0]))
    src = received % spec.k
    for j in range(spec.k):
        hits = np.nonzero(src == j)[0]
        if hits.size == 0:
            raise ValueError(
                f"received set misses every copy of chunk {j} — violates K* guarantee"
            )
        d[j, hits[0]] = 1.0
    return d


def _check_received(spec: CodeSpec, received) -> np.ndarray:
    """Exactly K* distinct received chunk indices, as int64."""
    received = np.asarray(received, dtype=np.int64)
    kstar = spec.recovery_threshold
    if received.shape[0] != kstar:
        raise ValueError(f"need exactly K*={kstar} received indices, got {received.shape[0]}")
    if len(np.unique(received)) != kstar:
        raise ValueError("received chunk indices must be distinct")
    return received


def generator_matrix(spec: CodeSpec, dtype=torch.float32, device=None) -> torch.Tensor:
    """(nr, k) encoding matrix G with X~ = G @ X (rows = encoded chunks).

    Lagrange branch: G[v, j] = Lagrange basis at alpha_{idx(v)}.
    Repetition branch: 0/1 replication matrix, chunk v holds X_{v mod k}.
    """
    dev = resolve_device(device)
    if spec.mode == "lagrange":
        alphas = alpha_points_np(spec.nr)[chunk_alpha_indices(spec)]
        g = _lagrange_basis(alphas, beta_points_np(spec.k)).astype(np.float32)
        return torch.as_tensor(g, device=dev).to(dtype)
    return torch.as_tensor(_repetition_generator_np(spec), dtype=dtype, device=dev)


def encode(generator: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Encode stacked data chunks: (k, *dims) -> (nr, *dims)."""
    return torch.tensordot(generator, data, dims=1)


def decode_matrix(
    spec: CodeSpec, received: Sequence[int] | np.ndarray, dtype=torch.float32,
    device=None,
) -> torch.Tensor:
    """(k, K*) decode matrix D for a given set of received chunk indices.

    Lagrange branch: interpolate h(z)=f(u(z)) (degree (k-1)*deg_f) through
    the received alphas and evaluate at the betas:
    f(X) = D @ f(X~)[received].  Requires len(received) == K*.

    Repetition branch: 0/1 selection of the first on-time copy of each chunk.
    """
    received = _check_received(spec, received)
    dev = resolve_device(device)
    if spec.mode == "lagrange":
        alphas = alpha_points_np(spec.nr)[chunk_alpha_indices(spec)[received]]
        betas = beta_points_np(spec.k)
        d = _lagrange_basis(betas, alphas).astype(np.float32)
        return torch.as_tensor(d, device=dev).to(dtype)
    return torch.as_tensor(_repetition_decode_np(spec, received), dtype=dtype,
                           device=dev)


def decode(decode_mat: torch.Tensor, results: torch.Tensor) -> torch.Tensor:
    """Decode: (k, K*) @ (K*, *dims) -> (k, *dims)."""
    return torch.tensordot(decode_mat, results, dims=1)


# ---------------------------------------------------------------------------
# Device-resident decode path (received set as a tensor — no host round-trip)
# ---------------------------------------------------------------------------

def _lagrange_basis_device(eval_pts: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """Float32 tensor counterpart of :func:`_lagrange_basis` (the JAX
    package's ``_lagrange_basis_jax``): M[e, j] = prod_{l != j}
    (eval_e - nodes_l) / (nodes_j - nodes_l), on the device of ``nodes``.

    The product over l is ``torch.prod``, whose order may differ from XLA's
    ``jnp.prod``: results agree to float32 round-off, not to the bit.
    """
    nodes = nodes.to(torch.float32)
    eval_pts = eval_pts.to(nodes.device, torch.float32)
    j = nodes.shape[0]
    e = eval_pts[:, None, None]                    # (E,1,1)
    nj = nodes[None, :, None]                      # (1,J,1)
    nl = nodes[None, None, :]                      # (1,1,J)
    eye = torch.eye(j, dtype=torch.bool, device=nodes.device)[None]
    num = torch.where(eye, 1.0, e - nl)            # (E,J,J)
    den = torch.where(eye, 1.0, nj - nl)
    return torch.prod(num / den, dim=-1)           # (E, J)


def decode_matrix_jax(spec: CodeSpec, received: torch.Tensor) -> torch.Tensor:
    """(k, K*) float32 decode matrix from a (K*,) received-index tensor,
    built on that tensor's device (the name is the JAX package's).

    A static-shape gather picks the received alpha points and the Lagrange
    basis is evaluated on the device — no host construction per round.
    Validity (distinct indices, repetition coverage) is the caller's
    contract, exactly the K* guarantee of Defn. 4.1; rows that would be
    unrecoverable come back as zeros rather than raising.
    """
    received = torch.as_tensor(received).to(torch.int64)
    dev = received.device
    kstar = spec.recovery_threshold
    if received.shape != (kstar,):
        raise ValueError(f"received must have shape ({kstar},), got {tuple(received.shape)}")
    if spec.mode == "lagrange":
        alpha_grid = torch.as_tensor(
            alpha_points_np(spec.nr)[chunk_alpha_indices(spec)].astype(np.float32),
            device=dev)
        alphas = alpha_grid[received]              # (K*,) gather
        betas = torch.as_tensor(beta_points_np(spec.k).astype(np.float32), device=dev)
        return _lagrange_basis_device(betas, alphas)
    # repetition: select the first received copy of each chunk j (j = v mod k)
    src = received % spec.k                        # (K*,)
    pos = torch.arange(kstar, device=dev)
    hit = src[None, :] == torch.arange(spec.k, device=dev)[:, None]   # (k, K*)
    first = torch.where(hit, pos[None, :], kstar).min(dim=1).values   # (k,)
    return (pos[None, :] == first[:, None]).to(torch.float32)


# ---------------------------------------------------------------------------
# Exact GF(p) path: numpy host oracle (the ground truth)
# ---------------------------------------------------------------------------

def _mod_inv(a: np.ndarray, p: int = FIELD_P) -> np.ndarray:
    """Vectorized modular inverse via Fermat: a^(p-2) mod p."""
    a = np.asarray(a, dtype=np.int64) % p
    result = np.ones_like(a)
    base = a.copy()
    e = p - 2
    while e:
        if e & 1:
            result = (result * base) % p
        base = (base * base) % p
        e >>= 1
    return result


def _lagrange_basis_modp(eval_pts: np.ndarray, nodes: np.ndarray, p: int = FIELD_P) -> np.ndarray:
    eval_pts = np.asarray(eval_pts, dtype=np.int64) % p
    nodes = np.asarray(nodes, dtype=np.int64) % p
    E, J = eval_pts.shape[0], nodes.shape[0]
    out = np.ones((E, J), dtype=np.int64)
    for l in range(J):
        num = (eval_pts[:, None] - nodes[l]) % p          # (E,1)
        den = (nodes[None, :] - nodes[l]) % p             # (1,J)
        num = np.broadcast_to(num, (E, J)).copy()
        den = np.broadcast_to(den, (E, J)).copy()
        skip = np.zeros((E, J), dtype=bool)
        skip[:, l] = True
        num[skip] = 1
        den[skip] = 1
        out = (out * ((num * _mod_inv(den, p)) % p)) % p
    return out


def generator_matrix_modp(spec: CodeSpec, p: int = FIELD_P) -> np.ndarray:
    """Exact (nr, k) generator over GF(p); alphas/betas = 0..nr-1 / nr..nr+k-1."""
    if spec.mode != "lagrange":
        return _repetition_generator_np(spec).astype(np.int64)
    alphas = np.arange(spec.nr, dtype=np.int64)[chunk_alpha_indices(spec)]
    betas = np.arange(spec.nr, spec.nr + spec.k, dtype=np.int64)
    return _lagrange_basis_modp(alphas, betas, p)


def decode_matrix_modp(
    spec: CodeSpec, received: Sequence[int] | np.ndarray, p: int = FIELD_P
) -> np.ndarray:
    received = np.asarray(received, dtype=np.int64)
    if spec.mode != "lagrange":
        # the float decode's checks and its 0/1 matrix, as integers
        return _repetition_decode_np(spec, _check_received(spec, received)).astype(np.int64)
    alphas = np.arange(spec.nr, dtype=np.int64)[chunk_alpha_indices(spec)[received]]
    betas = np.arange(spec.nr, spec.nr + spec.k, dtype=np.int64)
    return _lagrange_basis_modp(betas, alphas, p)


def matmul_modp(a: np.ndarray, b: np.ndarray, p: int = FIELD_P) -> np.ndarray:
    """Exact (m, c) @ (c, *dims) mod p.  Products of residues stay < 2^63."""
    a = np.asarray(a, dtype=np.int64) % p
    b = np.asarray(b, dtype=np.int64) % p
    trailing = b.shape[1:]
    b2 = b.reshape(b.shape[0], -1)
    # per-term product mod p (each < p), then sum over the contraction axis
    # (< 2^32 terms each < 2^31 fits int64), then one final mod.
    terms = (a[:, :, None] * b2[None, :, :]) % p      # (m, c, flat)
    out = np.sum(terms, axis=1) % p
    return out.reshape((a.shape[0],) + trailing)


# ---------------------------------------------------------------------------
# Exact GF(p) path on the device (repro_torch.kernels.gf)
# ---------------------------------------------------------------------------

def _alpha_grid_modp(spec: CodeSpec) -> np.ndarray:
    """The strided integer alpha grid of the exact path: chunk v -> idx(v)."""
    return np.arange(spec.nr, dtype=np.int32)[chunk_alpha_indices(spec)]


def generator_matrix_modp_device(spec: CodeSpec, device=None) -> torch.Tensor:
    """Device-built exact (nr, k) generator over GF(p) — int32 residues.

    Equal (as integers) to the numpy :func:`generator_matrix_modp`: the same
    integer alphas/betas, the same field.
    """
    dev = resolve_device(device)
    if spec.mode != "lagrange":
        return torch.as_tensor(generator_matrix_modp(spec), dtype=torch.int32,
                               device=dev)
    alphas = torch.as_tensor(_alpha_grid_modp(spec), device=dev)
    betas = torch.arange(spec.nr, spec.nr + spec.k, dtype=torch.int32, device=dev)
    return gf.from_gf(gf.lagrange_basis_gf(alphas, betas))


def decode_matrix_modp_device(spec: CodeSpec, received: torch.Tensor) -> torch.Tensor:
    """Exact (..., k, K*) decode matrices from (..., K*) received rows, built
    on the device of ``received``.

    A gather picks the surviving alpha points and the GF(p) Lagrange basis is
    inverted on the device (Fermat), so erasure patterns straight from the
    engine's Markov trajectories decode with no host sync.  Leading axes
    batch over patterns.  Validity is the caller's contract, as for
    :func:`decode_matrix_jax`.
    """
    received = torch.as_tensor(received).to(torch.int64)
    dev = received.device
    kstar = spec.recovery_threshold
    if received.shape[-1] != kstar:
        raise ValueError(f"received rows must hold K*={kstar} indices, "
                         f"got {tuple(received.shape)}")
    if spec.mode == "lagrange":
        alpha_grid = torch.as_tensor(_alpha_grid_modp(spec), device=dev)
        alphas = alpha_grid[received]                      # (..., K*) gather
        betas = torch.arange(spec.nr, spec.nr + spec.k, dtype=torch.int32,
                             device=dev)
        return gf.from_gf(gf.lagrange_basis_gf(betas, alphas))
    # repetition: 0/1 selection of the first received copy of each chunk
    src = received % spec.k                                # (..., K*)
    pos = torch.arange(kstar, device=dev)
    hit = src[..., None, :] == torch.arange(spec.k, device=dev)[:, None]  # (..., k, K*)
    first = torch.where(hit, pos, kstar).min(dim=-1).values           # (..., k)
    return (pos == first[..., None]).to(torch.int32)


__all__ = [
    "FIELD_P", "CodeSpec", "alpha_points", "alpha_points_np", "beta_points",
    "beta_points_np", "chunk_alpha_indices", "decode", "decode_matrix",
    "decode_matrix_jax", "decode_matrix_modp", "decode_matrix_modp_device",
    "encode", "generator_matrix", "generator_matrix_modp",
    "generator_matrix_modp_device", "matmul_modp", "recovery_threshold",
]
