"""The fused allocation (``allocate_masked_cuda``) on the CPU: its algorithm,
its views and its route.

The kernel itself only runs on the card (``test_torch_cuda.py``).  Here a
plain PyTorch mirror of its per-row algorithm -- ranks by the pairwise
count, the values scattered into rank order, the DP padded past the valid
pool, the first maximum by a strict ``>`` over ascending prefixes, the loads
-- is held bit for bit to the composition ``allocate_masked`` runs on CPU
tensors (stable sort, B1's plain version, ``argmax``) and to the JAX
package's ``allocate_masked``; the wrapper's two views (the probabilities'
rows as they lie, the pool rows over them) are read back by the kernel's
own index arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lea as jlea
from repro_torch import convert
from repro_torch.core import lea
from repro_torch.kernels.poisson_binomial import (ALLOCATE_MAX_N, allocate_masked_cuda,
                                                  launch_counts, reset_launch_counts,
                                                  success_tails_ref)
from repro_torch.kernels.poisson_binomial.kernel import pool_rows, row_view

WIDTHS = [1, 15, 16, 17, 33, 64]
CASES = ["all_ties", "near_ties", "random", "masked_anywhere", "all_masked",
         "infeasible", "per_row_kstar"]
ROWS = 96


def fused_mirror(p, mask, w, ell_g, ell_b):
    """The fused kernel's per-row algorithm in plain PyTorch: ``(loads,
    i_star)``."""
    n = p.shape[-1]
    shape = torch.broadcast_shapes(p.shape, mask.shape, w.shape)
    p, mask, w = (t.expand(shape) for t in (p, mask, w))
    pe = torch.where(mask, p, -1.0)
    idx = torch.arange(n)
    p_i, p_j = pe[..., :, None], pe[..., None, :]
    rank = ((p_j > p_i) | ((p_j == p_i) & (idx[None, :] < idx[:, None]))).sum(-1)
    n_valid = mask.sum(-1, keepdim=True)
    s = torch.zeros_like(pe).scatter(-1, rank, torch.where(rank < n_valid, pe, 0.0))
    tails = success_tails_ref(s, w)
    best, arg = tails[..., 0], torch.zeros(shape[:-1], dtype=torch.int64)
    for i in range(1, n):
        better = tails[..., i] > best
        best = torch.where(better, tails[..., i], best)
        arg = torch.where(better, i, arg)
    loads = torch.where(rank <= arg[..., None], ell_g[..., None], ell_b[..., None])
    return torch.where(mask, loads, 0).to(torch.int32), arg + 1


def _rows(case: str, n: int, rows: int, rng):
    """``(p (rows, n) float32, PoolLoad with per-row fields)`` of a case."""
    if case == "all_ties":
        p = np.full((rows, n), 0.5, np.float32)
    elif case == "near_ties":
        p = (0.5 + rng.integers(-2, 3, (rows, n)) * np.float32(6e-8)).astype(np.float32)
    else:
        p = rng.choice(np.float32([0.5, 0.25, 0.75, 1 / 3, 0.9]), (rows, n)) \
            if rows % 2 else rng.uniform(0, 1, (rows, n)).astype(np.float32)
    if case in ("masked_anywhere", "infeasible", "per_row_kstar", "all_ties", "near_ties"):
        mask = rng.random((rows, n)) < 0.7        # a serving segment: any subset
    elif case == "all_masked":
        mask = np.zeros((rows, n), bool)
    else:
        mask = np.arange(n)[None] < rng.integers(0, n + 1, rows)[:, None]
    ell_b = rng.integers(1, 4, rows)
    ell_g = ell_b + rng.integers(1, 8, rows)
    if case == "infeasible":                      # beyond every prefix
        kstar = mask.sum(-1) * ell_g + rng.integers(1, 5, rows)
    elif case == "per_row_kstar":
        kstar = rng.integers(-3, n * 10, rows)
    else:
        kstar = np.full(rows, max(1, 6 * n))
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    return torch.from_numpy(p), lea.PoolLoad(kstar=i32(kstar), ell_g=i32(ell_g),
                                             ell_b=i32(ell_b), mask=torch.from_numpy(mask))


def _thresholds(pool: lea.PoolLoad, n: int) -> torch.Tensor:
    n_valid = pool.mask.to(torch.int32).sum(-1)
    return lea.prefix_thresholds_traced(pool.kstar, pool.ell_g, pool.ell_b, n_valid, n)


@pytest.mark.parametrize("n", WIDTHS)
@pytest.mark.parametrize("case", CASES)
def test_fused_mirror_equals_the_composition_bit_for_bit(case, n):
    rng = np.random.default_rng(1000 * n + CASES.index(case))
    p, pool = _rows(case, n, ROWS + n % 7, rng)
    loads, i_star = fused_mirror(p, pool.mask, _thresholds(pool, n), pool.ell_g, pool.ell_b)
    want_loads, want_i, feasible = lea.allocate_masked(p, pool)
    assert loads.dtype == want_loads.dtype == torch.int32
    assert i_star.dtype == want_i.dtype == torch.int64
    assert torch.equal(loads, want_loads) and torch.equal(i_star, want_i)
    if case == "infeasible":
        assert not bool(feasible.any())
    if case == "all_masked":
        assert not bool(loads.any()) and bool((i_star == 1).all())


@pytest.mark.parametrize("n", WIDTHS)
def test_fused_mirror_equals_the_jax_package(n):
    rng = np.random.default_rng(2000 + n)
    parts = [_rows(case, n, 24, rng) for case in CASES]
    p = torch.cat([x for x, _ in parts])
    pool = lea.PoolLoad(*(torch.cat([getattr(q, f) for _, q in parts])
                          for f in lea.PoolLoad._fields))
    loads, i_star = fused_mirror(p, pool.mask, _thresholds(pool, n), pool.ell_g, pool.ell_b)
    jpool = jlea.PoolLoad(*(jnp.asarray(t.numpy()) for t in pool))
    jloads, jistar, jfeas = map(np.array, jlea.allocate_masked(jnp.asarray(p.numpy()), jpool))
    np.testing.assert_array_equal(loads.numpy(), jloads)
    np.testing.assert_array_equal(i_star.numpy(), jistar)
    feas = lea.allocate_masked(p, convert.pool_load(jpool, device="cpu"))[2]
    np.testing.assert_array_equal(feas.numpy(), jfeas)


def test_fused_mirror_on_the_engine_layout():
    """The sweep engine's call: p (S, B, m, n) a slice of the rounds, the
    pool (1, B, 1, .) -- loads and i* equal the composition's."""
    rng = np.random.default_rng(3)
    s, b, rounds, n = 2, 5, 40, 15
    full = torch.from_numpy(rng.choice(np.float32([0.5, 0.25, 0.75]), (s, b, rounds, n)))
    p = full[:, :, 7:29]
    nv = rng.integers(0, n + 1, b)
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)[None, :, None]
    pool = lea.PoolLoad(kstar=i32(rng.integers(1, 99, b)), ell_g=i32(np.full(b, 10)),
                        ell_b=i32(np.full(b, 3)),
                        mask=torch.from_numpy(np.arange(n)[None] < nv[:, None])[None, :, None])
    loads, i_star = fused_mirror(p, pool.mask, _thresholds(pool, n), pool.ell_g, pool.ell_b)
    want_loads, want_i, _ = lea.allocate_masked(p, pool)
    assert torch.equal(loads, want_loads) and torch.equal(i_star, want_i)


# ---------------------------------------------------------------------------
# the wrapper's views, read back by the kernel's index arithmetic
# ---------------------------------------------------------------------------

def _offsets(geometry, rows):
    """row_offset(g, r) of the kernel for every r in ``rows``."""
    off = np.zeros(len(rows), dtype=np.int64)
    for div, size, stride in geometry.axes:
        off += (rows // div) % size * stride
    return off


def _layout(name: str, rng):
    """``(p as the engine hands it over, mask, w, ell_g, ell_b)``."""
    i32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32)
    if name == "engine slice":
        s, b, rounds, n = 2, 3, 400, 15
        p = torch.rand(s, b, rounds, n)[:, :, 33:33 + 230]
        pool = (rng.random((1, b, 1, n)) < 0.8, rng.integers(-2, 17, (1, b, 1, n)),
                rng.integers(4, 9, (1, b, 1)), rng.integers(1, 4, (1, b, 1)))
    elif name == "serving segments":
        b, q, n = 7, 5, 15
        p = torch.rand(b, n)[:, None, :].expand(b, q, n)
        pool = (rng.random((b, q, n)) < 0.5, rng.integers(-2, 17, (b, q, n)),
                rng.integers(4, 9, (b, q)), rng.integers(1, 4, (b, q)))
    elif name == "scalar pool":
        n = 15
        p = torch.rand(300, n)
        pool = (np.ones(n, bool), rng.integers(-2, 17, n), np.int32(10), np.int32(3))
    elif name == "per-row, n = 33":
        n = 33
        p = torch.rand(200, n)
        pool = (rng.random((200, n)) < 0.5, rng.integers(-2, 35, (200, n)),
                rng.integers(4, 9, 200), rng.integers(1, 4, 200))
    elif name == "six strided axes":   # more than the view takes: copied
        n = 15
        p = torch.rand(2, 2, 2, 2, 2, 3, n).permute(5, 4, 3, 2, 1, 0, 6)
        pool = (np.ones(n, bool), rng.integers(-2, 17, n), np.int32(10), np.int32(3))
    else:   # "transposed": last stride not 1, the wrapper copies it contiguous
        n = 15
        p = torch.rand(n, 50).T
        pool = (rng.random((50, n)) < 0.5, rng.integers(-2, 17, (50, n)),
                rng.integers(4, 9, 50), rng.integers(1, 4, 50))
    mask, w, eg, eb = pool
    return p, torch.as_tensor(mask), i32(w), i32(eg), i32(eb)


LAYOUTS = ["engine slice", "serving segments", "scalar pool", "per-row, n = 33",
           "six strided axes", "transposed"]


@pytest.mark.parametrize("name", LAYOUTS)
def test_allocate_views_read_each_layout_as_it_lies(name):
    p, mask, w, eg, eb = _layout(name, np.random.default_rng(LAYOUTS.index(name)))
    n = p.shape[-1]
    rows_t = pool_rows(n, w, mask, eg, eb)
    assert rows_t.dtype == torch.int32 and rows_t.shape[-1] == 2 * n + 2
    if p.stride(-1) != 1:
        p = p.contiguous()
    p, pg = row_view(p, tuple(p.shape))
    rows_t, pv = row_view(rows_t, tuple(p.shape[:-1]) + (2 * n + 2,))
    assert len(pg.axes) <= 4 and len(pv.axes) <= 4
    assert p.is_contiguous() == (name in ("six strided axes", "transposed", "scalar pool",
                                          "per-row, n = 33"))
    rows = np.arange(pg.rows, dtype=np.int64)
    assert pg.rows == p.numel() // n and pg.last_stride == 1
    base = torch.as_strided(p, (p.untyped_storage().nbytes() // 4,), (1,), 0).numpy()
    off = p.storage_offset() + _offsets(pg, rows)[:, None] + np.arange(n)
    np.testing.assert_array_equal(base[off], p.reshape(-1, n).numpy())
    # a pool row is read at row_offset(pv, (r // rep) * rep)
    want = torch.cat([x.to(torch.int32).expand(p.shape[:-1] + (k,)) for x, k in
                      ((w, n), (mask, n), (eg[..., None], 1), (eb[..., None], 1))], -1)
    flat = rows_t.reshape(-1).numpy()
    voff = _offsets(pv, rows // pv.rep * pv.rep)[:, None] \
        + np.arange(2 * n + 2) * pv.last_stride
    np.testing.assert_array_equal(flat[voff], want.reshape(-1, 2 * n + 2).numpy())
    # a block of THREADS rows touches at most (THREADS - 1) // rep + 2 pool rows
    for threads in (128, 64):
        for row0 in range(0, pg.rows, threads):
            last = min(row0 + threads, pg.rows) - 1
            assert last // pv.rep - row0 // pv.rep + 1 <= min(threads,
                                                              (threads - 1) // pv.rep + 2)


def test_allocate_views_of_a_contiguous_block_are_one_range():
    """In the engine's slice most blocks' rows are one contiguous range (the
    kernel's 16-byte path); a block across a round boundary is not."""
    p = torch.rand(2, 3, 400, 15)[:, :, 33:33 + 230]
    _, pg = row_view(p, tuple(p.shape))
    contiguous = []
    for row0 in range(0, pg.rows, 128):
        rows = np.arange(row0, min(row0 + 128, pg.rows))
        off = _offsets(pg, rows)
        contiguous.append(bool((off == off[0] + (rows - row0) * 15).all()))
    assert contiguous.count(True) >= len(contiguous) // 2 and not all(contiguous)


# ---------------------------------------------------------------------------
# the route and the wrapper's refusals
# ---------------------------------------------------------------------------

def test_allocate_masked_cuda_refuses_cpu_tensors():
    p = torch.rand(4, 15)
    one = torch.ones(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        allocate_masked_cuda(p, torch.ones(4, 15, dtype=torch.bool),
                             torch.ones(4, 15, dtype=torch.int32), one, one)


def test_cpu_allocation_takes_the_composition_and_launches_nothing():
    reset_launch_counts()
    rng = np.random.default_rng(9)
    for n in (15, ALLOCATE_MAX_N + 1):
        p, pool = _rows("random", n, 20, rng)
        lea.allocate_masked(p, pool)
    assert launch_counts()["allocate_masked_cuda"] == 0
    assert set(launch_counts().values()) == {0}
