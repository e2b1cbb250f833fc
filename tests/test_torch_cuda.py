"""The CUDA kernels of the port against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without a GPU they skip.  They
import neither JAX nor the JAX package, so they run on the machine with the
card::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels.poisson_binomial import (launch_counts, success_tails,
                                                  success_tails_cuda,
                                                  success_tails_cuda_w,
                                                  success_tails_ref)


def _probs(rng, b, n):
    return np.sort(rng.uniform(0, 1, (b, n)).astype(np.float32), axis=-1)[:, ::-1].copy()



@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 33, 64, 100])
def test_cuda_kernel_matches_plain_version(cuda_device, n):
    rng = np.random.default_rng(n)
    p = torch.from_numpy(_probs(rng, 4096, n)).to(cuda_device)
    w = torch.from_numpy(rng.integers(-2, n + 2, (4096, n)).astype(np.int32)).to(cuda_device)
    before = launch_counts()
    got_w = success_tails_cuda_w(p, w)
    got_s = success_tails_cuda(p, tuple(w[0].tolist()))
    torch.cuda.synchronize()
    assert launch_counts()["success_tails_cuda_w"] == before["success_tails_cuda_w"] + 1
    assert launch_counts()["success_tails_cuda"] == before["success_tails_cuda"] + 1
    torch.testing.assert_close(got_w, success_tails_ref(p, w), rtol=0, atol=0)
    torch.testing.assert_close(got_s, success_tails_ref(p, w[0]), rtol=0, atol=0)


# the fig3 sweep's layout: probabilities (S, B, m, n), thresholds (1, B, 1, n)
# read as they lie; 1000 rows a (s, b) and 4 x 3 x 1000 rows in all, not a
# multiple of a block (128 rows, 64 at n > 32)
@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 15, 33, 64, 100])
@pytest.mark.parametrize("m", [1000, 37])
def test_tails_kernel_reads_the_engine_layout_bit_equal(cuda_device, n, m):
    rng = np.random.default_rng(100 * n + m)
    s, b = 4, 3
    p = torch.from_numpy(_probs(rng, s * b * m, n).reshape(s, b, m, n)).to(cuda_device)
    w = torch.from_numpy(rng.integers(-2, n + 2, (1, b, 1, n)).astype(np.int32)).to(cuda_device)
    before = launch_counts()
    got = success_tails(p, w)
    got_s = success_tails(p, tuple(w[0, 0, 0].tolist()))
    torch.cuda.synchronize()
    assert launch_counts()["success_tails_cuda_w"] == before["success_tails_cuda_w"] + 1
    assert launch_counts()["success_tails_cuda"] == before["success_tails_cuda"] + 1
    want = success_tails_ref(p, torch.broadcast_to(w, p.shape).contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(got_s, success_tails_ref(p, w[0, 0, 0]), rtol=0, atol=0)
    # a transposed threshold view and probabilities that are not 16-byte aligned
    wt = torch.from_numpy(rng.integers(-2, n + 2, (n, b)).astype(np.int32)).to(cuda_device).T
    flat = torch.empty(p.numel() + 1, device=cuda_device)
    flat[1:] = p.reshape(-1)
    p_off = flat[1:].view(p.shape)
    torch.testing.assert_close(success_tails(p_off, wt[:, None]),
                               success_tails_ref(p, wt[:, None].contiguous()),
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_dispatcher_launches_the_kernel_for_cuda_tensors(cuda_device):
    rng = np.random.default_rng(1)
    p = torch.from_numpy(_probs(rng, 300, 15)).to(cuda_device)
    w = torch.from_numpy(rng.integers(-2, 17, (300, 15)).astype(np.int32)).to(cuda_device)
    before = launch_counts()
    out = success_tails(p[None], w[None])
    assert out.shape == (1, 300, 15) and out.device.type == "cuda"
    assert launch_counts()["success_tails_cuda_w"] == before["success_tails_cuda_w"] + 1


# ---------------------------------------------------------------------------
# the fused allocation: allocate_masked in one launch, bit-equal to the
# composition (stable sort, B1, argmax) on the card
# ---------------------------------------------------------------------------

def _estimates(shape, gen, device):
    """LEA-like predictions: smoothed count ratios (many exact ties), a
    quarter of the rows all 0.5 (round 0)."""
    a = torch.randint(0, 12, shape, generator=gen, device=device)
    b = torch.randint(0, 12, shape, generator=gen, device=device)
    p = (a + 1).float() / (a + b + 2).float()
    p[..., ::4, :] = 0.5
    return p


def _pool(lead, n, gen, device, prefix=True):
    """A PoolLoad over ``lead`` pool rows: per-row K* (some infeasible, some
    always met), loads (ell_g, ell_b), prefix or arbitrary masks, and a few
    all-masked rows."""
    from repro_torch.core.lea import PoolLoad
    ri = lambda lo, hi: torch.randint(lo, hi, lead, generator=gen, device=device,
                                      dtype=torch.int32)
    if prefix:
        nv = torch.randint(0, n + 1, lead + (1,), generator=gen, device=device)
        mask = torch.arange(n, device=device) < nv
    else:
        mask = torch.rand(lead + (n,), generator=gen, device=device) < 0.6
    ell_b = ri(1, 4)
    ell_g = ell_b + ri(1, 8)
    return PoolLoad(kstar=ri(-3, 10 * n), ell_g=ell_g, ell_b=ell_b, mask=mask)


def _composed(p, pool):
    from repro_torch.core import lea
    n = p.shape[-1]
    n_valid = pool.mask.to(torch.int32).sum(dim=-1)
    w = lea.prefix_thresholds_traced(pool.kstar, pool.ell_g, pool.ell_b, n_valid, n)
    return lea._allocate_composed(p, pool.mask, n_valid, w, pool.ell_g, pool.ell_b)


ALLOCATE_SHAPES = {   # (S, B, rounds of the tensor, rounds taken, n)
    "fig3 block (2, 1024, 2330, 15) of 4660 rounds": (2, 1024, 4660, 2330, 15),
    "fault_grid (1, 288, 20000, 15)": (1, 288, 20_000, 20_000, 15),
    "n = 16, ragged": (2, 5, 301, 201, 16),
    "n = 17, ragged": (2, 5, 301, 201, 17),
    "n = 32, ragged": (2, 5, 301, 201, 32),
    "n = 33, ragged": (2, 5, 301, 201, 33),
    "n = 64, ragged": (2, 5, 301, 201, 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(ALLOCATE_SHAPES))
def test_fused_allocation_is_bit_equal_to_the_composition(cuda_device, case):
    """The engine's call: p (S, B, m, n) a slice of the rounds, the pool
    (1, B, 1, .) read as it lies; loads, i* and feasible equal the sort +
    B1 + argmax composition's, in one launch."""
    from repro_torch.core import lea
    s, b, rounds, m, n = ALLOCATE_SHAPES[case]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(len(case))
    full = _estimates((s, b, rounds, n), gen, cuda_device)
    p = full[:, :, rounds - m:]
    row = _pool((b,), n, gen, cuda_device)
    pool = lea.PoolLoad(kstar=row.kstar[None, :, None], ell_g=row.ell_g[None, :, None],
                        ell_b=row.ell_b[None, :, None], mask=row.mask[None, :, None, :])
    before = launch_counts()
    loads, i_star, feasible = lea.allocate_masked(p, pool)
    assert launch_counts()["allocate_masked_cuda"] == before["allocate_masked_cuda"] + 1
    assert launch_counts()["success_tails_cuda_w"] == before["success_tails_cuda_w"]
    want_loads, want_i = _composed(p, pool)
    torch.cuda.synchronize()
    assert loads.dtype == torch.int32 and i_star.dtype == torch.int64
    assert loads.shape == p.shape and i_star.shape == feasible.shape == p.shape[:-1]
    assert torch.equal(loads, want_loads) and torch.equal(i_star, want_i)
    del full, p, loads, want_loads
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [15, 33])
def test_fused_allocation_at_serving_segments_equals_the_cpu(cuda_device, n):
    """allocate_queue's segment masks (any subset of the pool, p broadcast
    over the slots): the card's fused route equals the CPU composition."""
    from repro_torch.core import lea
    gen = torch.Generator(device="cpu")
    gen.manual_seed(n)
    b, q = 96, 6
    p = _estimates((b, n), gen, "cpu")
    pool_mask = torch.rand((b, n), generator=gen) < 0.9
    active = torch.rand((b, q), generator=gen) < 0.7
    ri = lambda lo, hi: torch.randint(lo, hi, (b, q), generator=gen, dtype=torch.int32)
    ell_b = ri(1, 4)
    args = (p, pool_mask, active, ri(1, 5 * n), ell_b + ri(1, 8), ell_b,
            torch.argsort(torch.rand((b, q), generator=gen), dim=-1))
    want = lea.allocate_queue(*args)
    got = lea.allocate_queue(*(t.to(cuda_device) for t in args))
    for g, w_ in zip(got, want, strict=True):
        assert torch.equal(g.cpu(), w_)
    # any subset a slot, p a stride-0 view over the slots, against the card's
    # own composition
    p_card = p.to(cuda_device)[:, None].expand(b, q, n)
    pool = _pool((b, q), n, torch.Generator(device=cuda_device), cuda_device, prefix=False)
    loads, i_star, _ = lea.allocate_masked(p_card, pool)
    want_loads, want_i = _composed(p_card, pool)
    assert torch.equal(loads, want_loads) and torch.equal(i_star, want_i)


@pytest.mark.cuda
def test_fig3_sweep_allocates_in_one_fused_launch_a_block(cuda_device):
    """A fig3 sweep at round_chunk 500: one fused launch a block and no
    launch of B1 alone (pb_tails_regs)."""
    from repro_torch import sweeps
    group, = sweeps.build_groups(sweeps.expand("fig3", rounds=2000), seeds=4)
    before = launch_counts()
    sweeps.run_group(group, round_chunk=500)
    after = launch_counts()
    assert after["allocate_masked_cuda"] - before["allocate_masked_cuda"] == 4
    assert after["success_tails_cuda_w"] == before["success_tails_cuda_w"]
    assert after["success_tails_cuda"] == before["success_tails_cuda"]


@pytest.mark.cuda
@pytest.mark.parametrize("n,fused", [(15, True), (65, False)])
def test_allocation_route_follows_the_width(cuda_device, n, fused):
    """n = 15: one fused launch and no launch of B1 alone; n = 65 (past
    ALLOCATE_MAX_N): no fused launch and one of B1 in the composition (sort
    + B1's pb_tails_smem), which still equals the CPU's."""
    from repro_torch.core import lea
    gen = torch.Generator(device="cpu")
    gen.manual_seed(n)
    p = _estimates((3, 40, n), gen, "cpu")
    pool = _pool((3, 40), n, gen, "cpu", prefix=False)
    before = launch_counts()
    got = lea.allocate_masked(p.to(cuda_device), lea.PoolLoad(*(t.to(cuda_device)
                                                                 for t in pool)))
    after = launch_counts()
    launched = {k: after[k] - before[k]
                for k in ("allocate_masked_cuda", "success_tails_cuda_w")}
    assert launched == ({"allocate_masked_cuda": 1, "success_tails_cuda_w": 0} if fused
                        else {"allocate_masked_cuda": 0, "success_tails_cuda_w": 1})
    for g, w_ in zip(got, lea.allocate_masked(p, pool), strict=True):
        assert torch.equal(g.cpu(), w_)


# ---------------------------------------------------------------------------
# the coding kernels: exact GF(p) matmul, Lagrange encode, fused gradient
# ---------------------------------------------------------------------------

P = (1 << 31) - 1


def _residues(rng, shape):
    x = rng.integers(0, P, size=shape, dtype=np.int64)
    flat = x.reshape(-1)
    flat[: min(3, flat.size)] = [0, 1, P - 1][: min(3, flat.size)]
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,n", [(1, 1, 1), (37, 301, 19), (150, 120, 700),
                                   (600, 300, 8), (900, 300, 1), (5, 0, 3)])
def test_gf_matmul_kernel_is_exact(cuda_device, m, c, n):
    from repro_torch.kernels import gf
    rng = np.random.default_rng(m + c + n)
    a, b = _residues(rng, (m, c)).to(cuda_device), _residues(rng, (c, n)).to(cuda_device)
    if c:
        a[0, :] = P - 1
        b[:, 0] = P - 1
    before = gf.launch_counts()["matmul_gf_cuda"]
    got = gf.matmul_gf(a, b)
    torch.cuda.synchronize()
    assert gf.launch_counts()["matmul_gf_cuda"] == before + 1
    assert torch.equal(got, gf.matmul_gf_dot(a, b))
    assert torch.equal(got.cpu(), gf.matmul_gf_ref(a.cpu(), b.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("lead,m,c,n", [((3,), 37, 301, 5), ((2, 2), 64, 70, 65),
                                        ((15,), 300, 60, 1)])
def test_gf_bmm_kernel_is_one_exact_launch(cuda_device, lead, m, c, n):
    from repro_torch.kernels import gf
    rng = np.random.default_rng(c)
    a = _residues(rng, lead + (m, c)).to(cuda_device)
    b = _residues(rng, lead + (c, n)).to(cuda_device)
    before = gf.launch_counts()["bmm_gf_cuda"]
    got = gf.bmm_gf(a, b)
    torch.cuda.synchronize()
    assert gf.launch_counts()["bmm_gf_cuda"] == before + 1
    assert torch.equal(got, gf.matmul_gf_dot(a, b))


# int32 values the kernel's loaders must reduce: 2^32 = 2 (mod p), so a
# uint32 reading of a negative value is not its residue
_RAW_EDGES = [-(2**31), -1, P, -P, -2, 2**31 - 2, 0, 1]


def _raw_int32(rng, shape):
    """Any int32 values, mixed signs, with the edges planted at the front."""
    x = rng.integers(-(2**31), 2**31, size=shape, dtype=np.int64)
    flat = x.reshape(-1)
    flat[: min(len(_RAW_EDGES), flat.size)] = _RAW_EDGES[: flat.size]
    return torch.from_numpy(x.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("m,c,n", [(37, 301, 19), (300, 600, 8), (900, 300, 1), (64, 70, 65)])
def test_gf_matmul_kernel_reduces_any_int32(cuda_device, m, c, n):
    from repro_torch.kernels import gf
    rng = np.random.default_rng(m * c + n)
    a, b = _raw_int32(rng, (m, c)).to(cuda_device), _raw_int32(rng, (c, n)).to(cuda_device)
    gf.reset_operand_passes()
    got = gf.matmul_gf(a, b)
    assert gf.operand_passes() == {"to_gf": 0, "contiguous": 0, "largest": 0}
    assert torch.equal(got, gf.matmul_gf_dot(gf.to_gf(a), gf.to_gf(b)))
    assert torch.equal(gf.matmul_gf_cuda(a, b), got)


@pytest.mark.cuda
@pytest.mark.parametrize("nr,rows,cols,d", [(150, 60, 300, 1), (7, 33, 130, 3), (4, 600, 70, 9)])
def test_gf_kernel_reads_the_transposed_round_operand_as_it_lies(cuda_device, nr, rows, cols, d):
    """x~^T r as the deg-2 round passes it: x~^T a transposed view, read
    through its strides with no copy and no to_gf pass, bit-equal to the
    limb route on canonical copies; the same on batch-strided views."""
    from repro_torch.kernels import gf
    rng = np.random.default_rng(nr + rows + cols + d)
    x = _raw_int32(rng, (2 * nr, rows, cols)).to(cuda_device)
    r = _raw_int32(rng, (2 * nr, rows, d)).to(cuda_device)
    for xv, rv in ((x[:nr], r[:nr]), (x[::2], r[1::2])):
        xt = xv.transpose(1, 2)
        gf.reset_operand_passes()
        before = gf.launch_counts()["bmm_gf_cuda"]
        got = gf.bmm_gf(xt, rv)
        assert gf.launch_counts()["bmm_gf_cuda"] == before + 1
        assert gf.operand_passes() == {"to_gf": 0, "contiguous": 0, "largest": 0}
        assert torch.equal(got, gf.matmul_gf_dot(gf.to_gf(xt), gf.to_gf(rv)))
    # a view with no unit-stride inner axis is copied first, and is exact too
    odd = x[:, ::2, ::3]                                  # (2 nr, rows / 2, cols / 3)
    w = _raw_int32(rng, (2 * nr, odd.shape[2], d)).to(cuda_device)
    gf.reset_operand_passes()
    got = gf.bmm_gf(odd, w)
    assert gf.operand_passes() == {"to_gf": 0, "contiguous": odd.numel(),
                                   "largest": odd.numel()}
    assert torch.equal(got, gf.matmul_gf_dot(gf.to_gf(odd), gf.to_gf(w)))


@pytest.mark.cuda
@pytest.mark.parametrize("nr,k,cols", [(150, 5, 18_000), (37, 5, 1001), (150, 120, 513),
                                       (150, 8, 18_002), (13, 16, 1003), (150, 64, 2048),
                                       (5, 64, 1001)])
def test_encode_kernel_within_fp32_bound(cuda_device, nr, k, cols):
    from repro_torch.kernels import lagrange_encode as le
    gen = torch.Generator(device=cuda_device).manual_seed(nr + k)
    g = torch.randn((nr, k), generator=gen, device=cuda_device)
    x = torch.randn((k, cols), generator=gen, device=cuda_device)
    before = le.launch_counts()["encode_matrix_cuda"]
    got = le.encode_matrix(g, x)
    assert le.launch_counts()["encode_matrix_cuda"] == before + 1
    bound = 1e-5 * (g.abs() @ x.abs())
    assert bool(((got - le.encode_matrix_ref(g, x)).abs() <= bound).all())


# path: the route, and for the chunk route where its residual lives
@pytest.mark.cuda
@pytest.mark.parametrize("nr,r_rows,c,p,path", [
    (150, 60, 3000, 1, "rows"), (7, 13, 301, 3, "rows"), (4, 1, 33, 2, "rows"),
    (2, 4096, 8, 4, "rows"), (2, 65_536, 8, 1, "rows"),
    (3, 37, 130, 2, "rows"),          # R split 32 + 5 over a cluster of 2
    (2, 16, 4096, 1, "rows"),         # the widest C the rows route takes at P = 1
    (3, 0, 8, 1, "rows"),             # no rows: zeros
    (2, 16, 4100, 1, "chunk/shared"),
    (1, 200, 4, 70, "chunk/shared"),  # 56 KB: shared memory opted in
    (1, 6000, 4, 16, "chunk/global")])  # 375 KB: past what a block may have, through L2
def test_coded_gradient_kernel_within_fp32_bound(cuda_device, nr, r_rows, c, p, path):
    from repro_torch.kernels import coded_gradient as cg
    route = cg.gradient_route(r_rows, c, p)
    assert (route if route == "rows" else f"chunk/{cg.residual_path(r_rows, p)}") == path
    gen = torch.Generator(device=cuda_device).manual_seed(c)
    x = torch.randn((nr, r_rows, c), generator=gen, device=cuda_device)
    y = torch.randn((nr, r_rows, p), generator=gen, device=cuda_device)
    w = torch.randn((c, p), generator=gen, device=cuda_device)
    before = cg.launch_counts()["coded_gradient_cuda"]
    got = cg.coded_gradient(x, y, w)
    assert cg.launch_counts()["coded_gradient_cuda"] == before + 1
    ax = x.abs()
    bound = 1e-5 * (ax.transpose(1, 2) @ (ax @ w.abs() + y.abs()))
    assert bool(((got - cg.coded_gradient_ref(x, y, w)).abs() <= bound).all())
    assert torch.equal(cg.coded_gradient(x, y, w), got)     # the same bits twice
    if route == "rows" and c % 4 == 0 and x.numel():
        # x 4 bytes off a 16-byte boundary: the rows route copies 4 bytes at a time
        flat = torch.empty(x.numel() + 1, device=cuda_device)
        flat[1:] = x.reshape(-1)
        x_off = flat[1:].view(x.shape)
        assert bool(((cg.coded_gradient(x_off, y, w) - got).abs() <= 2 * bound).all())
    # the one refusal left is the JAX wrapper's working-set check
    with pytest.raises(ValueError, match="VMEM budget"):
        cg.coded_gradient_cuda(torch.zeros((1, 1100, 3000), device=cuda_device),
                               torch.zeros((1, 1100, 1), device=cuda_device),
                               torch.zeros((3000, 1), device=cuda_device))


@pytest.mark.cuda
def test_exact_coded_round_on_the_card_equals_the_cpu(cuda_device):
    from repro_torch.core import coded_ops, lagrange
    spec = lagrange.CodeSpec(5, 3, 4, 2)
    rng = np.random.default_rng(0)
    x = rng.integers(0, P, size=(4, 6, 9))
    y = rng.integers(0, P, size=(4, 6))
    w = rng.integers(0, P, size=(9,))
    on = np.ones(spec.nr, bool)
    on[[1, 4]] = False
    got = coded_ops.coded_linear_gradient_modp(
        coded_ops.encode_dataset_modp(spec, x, y, device=cuda_device), w, on)
    want = coded_ops.coded_linear_gradient_modp(
        coded_ops.encode_dataset_modp(spec, x, y, device="cpu"), w, on)
    assert bool(got[1]) and bool(want[1])
    assert torch.equal(got[0].cpu(), want[0])


# ---------------------------------------------------------------------------
# flash attention (B6) and the LM serving path
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Sk, D, causal, window); in 16 bits D = 64 ... 192 in
# multiples of 8 take the wgmma route (96, 112 and 72 on its 128-wide
# instantiation, 136 and 192 on its 192-wide one with 64-key tiles), every
# other D the mma.sync route; float32 the FFMA route.  D = 96, 112, 192 are
# the repo's configs' head widths, 40 runs the next mma instantiation up
# (64), 20 is read element by element
FLASH_CASES = [(2, 4, 2, 100, 100, 64, True, None),
               (1, 8, 1, 200, 300, 128, False, None),
               (2, 4, 4, 257, 257, 32, True, 50),
               (2, 4, 2, 300, 300, 128, True, None),     # Sq, Sk not multiples of 128
               (1, 4, 2, 300, 100, 128, True, None),     # Sq > Sk: 200 rows exactly 0
               (2, 4, 2, 500, 500, 128, True, 100),      # sliding window
               (2, 4, 1, 250, 250, 64, False, None),
               (1, 8, 4, 16, 2048, 128, True, None),     # decode-aligned Sq = 16 < Sk
               (2, 4, 2, 130, 130, 96, True, None),
               (1, 4, 2, 200, 200, 112, True, 64),
               (2, 2, 1, 100, 150, 192, False, None),
               (1, 4, 4, 70, 70, 40, True, None),
               (1, 2, 1, 50, 50, 20, True, None),
               (1, 2, 2, 90, 90, 256, True, None),
               # the wide heads on the wgmma route: ragged Sq = Sk, Sq > Sk (rows
               # with no key exactly 0), a window, a GQA group of 8, decode-aligned
               (2, 4, 2, 300, 300, 112, True, None),
               (2, 4, 2, 300, 300, 192, True, None),
               (1, 4, 2, 300, 100, 112, True, None),
               (1, 4, 2, 300, 100, 192, True, None),
               (2, 4, 2, 500, 500, 192, True, 100),
               (1, 16, 2, 256, 256, 112, True, None),
               (1, 16, 2, 256, 256, 192, True, None),
               (1, 8, 4, 16, 2048, 112, True, None),
               (1, 8, 4, 16, 2048, 192, True, None),
               (1, 4, 2, 150, 150, 72, True, None),
               (1, 4, 2, 150, 150, 136, False, None)]
# the 16-bit types' rounding unit, which scales their bound
FLASH_EPS = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES, ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32, torch.float16], ids=str)
def test_flash_attention_kernel_matches_plain_version(cuda_device, case, dtype):
    from repro_torch.kernels import flash_attention as fa
    b, hq, hkv, sq, sk, d, causal, window = case
    gen = torch.Generator(device=cuda_device).manual_seed(sq + d)
    # (B, H, S, D) views of (B, S, H, D) tensors, as attention_train passes them
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=cuda_device)
               .to(dtype).transpose(1, 2)
               for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))
    before = fa.launch_counts()["flash_attention_cuda"]
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    assert fa.launch_counts()["flash_attention_cuda"] == before + 1
    want = fa.flash_attention_ref(q, k, v, causal=causal, window=window)
    diff = (got.float() - want.float()).abs()
    if dtype == torch.float32:        # reduction order: 1e-5 (P |V|)
        bound = 1e-5 * fa.flash_attention_ref(q, k, v.abs(), causal=causal, window=window)
    else:                             # P rounded to the input type, and the output's rounding
        bound = FLASH_EPS[dtype] * (v.float().abs().amax() + want.float().abs())
    assert got.stride() == q.stride()
    assert bool((diff <= bound).all()), float(diff.max())
    if causal and sq > sk:                # rows that see no key: the l == 0 guard
        assert not bool(got[:, :, :sq - sk].any())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 72, 96, 112, 128, 136, 192])
def test_wgmma_instances_fit_the_devices_shared_memory(cuda_device, d):
    """Each wgmma instantiation's dynamic shared memory is at most what the
    device lets a block opt in to (227 KB on the H100)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    optin = torch.cuda.get_device_properties(cuda_device).shared_memory_per_block_optin
    assert 0 < fk.wgmma_smem_bytes(d) <= optin


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 128), (torch.float16, 64),
                                     (torch.bfloat16, 32), (torch.float32, 128)], ids=str)
def test_flash_attention_with_no_keys_is_zero(cuda_device, dtype, d):
    """Sk = 0: every row sees no key, so the output is 0 on every route, as
    in the plain version (the wgmma route's TMA takes no empty extent)."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((2, 4, 37, d), device=cuda_device).to(dtype)
    k = v = torch.empty((2, 2, 0, d), dtype=dtype, device=cuda_device)
    got = fa.flash_attention(q, k, v, causal=True)
    want = fa.flash_attention_ref(q, k, v, causal=True)
    assert got.shape == q.shape and not bool(got.any()) and not bool(want.any())


@pytest.mark.cuda
def test_lm_smoke_serving_on_the_card_matches_the_cpu(cuda_device):
    """qwen3 SMOKE (float32) through the flash prefill and 4 decode steps:
    the card within 1e-4 of the CPU (float32 sums in other orders through
    two layers, logits of order 0.5)."""
    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    cfg = get_smoke_config("qwen3_0_6b", attn_impl="flash")
    params = api.get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg,
                                            device="cpu")
    tokens = api.make_batch(cfg, ShapeCell("c", 40, 3, "prefill"),
                            torch.Generator().manual_seed(1), device="cpu")["tokens"]
    prefill, serve = api.make_prefill_step(cfg, max_len=48), api.make_serve_step(cfg)
    on_card = copy.deepcopy(params).to(cuda_device)
    before = fa.launch_counts()["flash_attention_cuda"]
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    got, cache = prefill(on_card, {"tokens": tokens.to(cuda_device)})
    assert torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction == flag
    assert fa.launch_counts()["flash_attention_cuda"] == before + cfg.n_layers
    want, cache_cpu = prefill(params, {"tokens": tokens})
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    for _ in range(4):
        tok = want.argmax(-1)
        got, cache = serve(on_card, cache, {"next_token": tok.to(cuda_device)})
        want, cache_cpu = serve(params, cache_cpu, {"next_token": tok})
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def _erasure_args(device, rounds, seeds):
    from repro_torch import faults, sweeps
    from repro_torch.core.lea import pool_load
    scen = sweeps.expand("packet_erasure", rounds=rounds)
    meta = [dict(s.meta) for s in scen]
    col = lambda key: torch.tensor([m[key] for m in meta for _ in range(seeds)],
                                   dtype=torch.float32, device=device)
    p = lambda attr: torch.tensor([getattr(s, attr) for s in scen for _ in range(seeds)],
                                  dtype=torch.float32, device=device)
    channel = faults.make_channel([("preempt", {"p_preempt": col("p_preempt")}),
                                   ("packet_bernoulli", {"p_drop": col("p_drop")})])
    args = (pool_load(scen[0].lp, device=device), p("p_gg"), p("p_bb"), scen[0].mu_g,
            scen[0].mu_b, scen[0].deadline, channel, meta[0]["k1star"])
    return args, dict(rounds=rounds, strategies=("lea", "static"), r=meta[0]["r"],
                      packets=meta[0]["packets"], p1=meta[0]["p1"])


@pytest.mark.cuda
def test_fault_sweep_on_the_card_matches_the_replayed_cpu_run(cuda_device):
    """The packet_erasure grid (300 rounds, 2 seeds a cell) on the card and
    on the CPU from the same draws: the same outcomes (argmax ties could
    flip a round; the DP kernel repeats the plain version's roundings, so
    none is expected), the fused allocation launched once and B1 alone
    not at all."""
    from repro_torch import faults
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws
    recorder = RecordedDraws(torch_draws(3, cuda_device))
    args, geometry = _erasure_args(cuda_device, 300, 2)
    before = launch_counts()
    on_card = faults.sweep_faults(recorder, *args, **geometry, device=cuda_device)
    assert launch_counts()["allocate_masked_cuda"] == before["allocate_masked_cuda"] + 1
    assert launch_counts()["success_tails_cuda_w"] == before["success_tails_cuda_w"]
    cpu_args, _ = _erasure_args("cpu", 300, 2)
    on_cpu = faults.sweep_faults(ReplayedDraws(recorder.calls), *cpu_args, **geometry,
                                 device="cpu")
    for got, want in zip(on_card, on_cpu):
        assert int((got.cpu() != want).any(dim=-1).sum()) <= 300 * 18 // 1000
    assert not bool((on_card.full_aon & ~on_card.full_conserve).any())


@pytest.mark.cuda
@pytest.mark.parametrize("packets,d", [(4, 1), (3, 2), (1, 1)])
def test_exact_packet_decode_on_a_strided_row_block_is_the_plain_route(cuda_device,
                                                                        packets, d):
    """coded_matmul_exact_packets on the card (B3 on the row-block views'
    gathers, x~ read as it lies) equals the CPU plain route bit for bit."""
    from repro_torch import faults
    from repro_torch.core import coded_ops, lagrange
    from repro_torch.kernels import gf
    rng = np.random.default_rng(packets * 10 + d)
    spec = lagrange.CodeSpec(15, 10, 50, 2)
    x = rng.integers(0, (1 << 31) - 1, size=(spec.k, 12, 257), dtype=np.int32)
    w = rng.integers(0, (1 << 31) - 1, size=(257, d), dtype=np.int32)
    masks = rng.random((6, spec.nr, packets)) < 0.8
    card = coded_ops.encode_dataset_modp(spec, x, device=cuda_device)
    cpu = coded_ops.encode_dataset_modp(spec, x, device="cpu")
    w_card = torch.as_tensor(w, device=cuda_device)
    gf.reset_operand_passes()
    before = gf.launch_counts()["matmul_gf_cuda"]
    for m in masks:
        got, ok = faults.coded_matmul_exact_packets(card, w_card, torch.as_tensor(m, device=cuda_device))
        want, ok_cpu = faults.coded_matmul_exact_packets(cpu, torch.as_tensor(w), torch.as_tensor(m))
        assert torch.equal(ok.cpu(), ok_cpu)
        assert torch.equal(got.cpu(), want)
    assert gf.launch_counts()["matmul_gf_cuda"] == before + len(masks) * (1 + packets)
    passes = gf.operand_passes()
    assert passes["contiguous"] == 0 and passes["largest"] < card.x_tilde.numel()


@pytest.mark.cuda
def test_executor_plans_a_15_worker_row_through_b2(cuda_device):
    """The executor's plan is one static-threshold launch on a (1, 15) row,
    with the CPU plain route's loads."""
    from repro_torch.core import lea
    from repro_torch.runtime.fault_tolerance import CodedDPConfig, _plan_round
    cfg = CodedDPConfig(n_workers=15, r=10, k=50)
    lp = cfg.load_params
    rng = np.random.default_rng(15)
    counts = torch.as_tensor(rng.integers(0, 20, (15, 4)).astype(np.float32))
    prev = torch.as_tensor(rng.integers(0, 2, 15).astype(np.int32))
    live = torch.as_tensor(rng.random(15) < 0.9)
    for seen in (False, True):
        est = lea.EstimatorState(counts=counts, prev_state=prev, seen_prev=torch.tensor(seen))
        card = lea.EstimatorState(*(t.to(cuda_device) for t in est))
        before = launch_counts()["success_tails_cuda"]
        loads, i_star = _plan_round(card, live.to(cuda_device), lp)
        torch.cuda.synchronize()
        assert launch_counts()["success_tails_cuda"] == before + 1
        want, want_i = _plan_round(est, live, lp)
        assert torch.equal(loads.cpu(), want) and int(i_star) == int(want_i)
        assert not bool(loads.cpu()[~live].any())


@pytest.mark.cuda
def test_thompson_on_the_card_matches_the_replayed_cpu_run(cuda_device):
    """``thompson``'s Beta draws come from the card's own generator (a
    stream of their own, so lea and static see the same uniforms as
    without it); replayed on the CPU, the same successes."""
    from repro_torch.core import throughput
    from repro_torch.core.lea import LoadParams
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws
    args = (LoadParams(15, 99, 10, 3), [0.8] * 15, [0.7] * 15, 10.0, 3.0, 1.0, 2000)
    recorder = RecordedDraws(torch_draws(5, cuda_device))
    got = throughput.simulate_strategies(recorder, *args, ("lea", "thompson", "static"),
                                         device=cuda_device)
    want = throughput.simulate_strategies(ReplayedDraws(recorder.calls), *args,
                                          ("lea", "thompson", "static"), device="cpu")
    assert int((got.cpu() != want).any(dim=-1).sum()) <= 2
    alone = throughput.simulate_strategies(torch_draws(5, cuda_device), *args,
                                           ("lea", "static"), device=cuda_device)
    assert torch.equal(got[:, [0, 2]], alone)
    assert 0.0 < float(got[:, 1].float().mean()) <= 1.0


def _arrival_args(device, rounds, seeds, controlled):
    """The arrival_grid as sweep_serving's arguments, ``seeds`` rows a cell."""
    from repro_torch import serving, sweeps
    scen = sweeps.expand("arrival_grid", rounds=rounds)
    lp, meta = scen[0].lp, [dict(s.meta) for s in scen]
    rows = len(scen) * seeds
    col = lambda key, dtype: torch.tensor([m[key] for m in meta for _ in range(seeds)],
                                          dtype=dtype, device=device)
    chain = lambda attr: torch.tensor([getattr(s, attr) for s in scen for _ in range(seeds)],
                                      dtype=torch.float32, device=device)
    thr = col("admit_threshold", torch.float32) if controlled else torch.zeros(rows, device=device)
    cap = (col("reserve_cap", torch.float32) if controlled
           else torch.full((rows,), serving.ADMIT_ALL_CAP, device=device))
    spec = serving.RequestSpec(kstar=lp.kstar, ell_g=lp.ell_g, ell_b=lp.ell_b,
                               deadline_rel=col("deadline_rel", torch.int32),
                               admit_threshold=thr, reserve_cap=cap)
    args = (torch.ones((rows, lp.n), dtype=torch.bool, device=device), chain("p_gg"),
            chain("p_bb"), scen[0].mu_g, scen[0].mu_b, scen[0].deadline, spec,
            serving.make_process("poisson", rate=col("rate", torch.float32)))
    return args, dict(rounds=rounds, strategies=("lea", "oracle"), capacity=meta[0]["capacity"],
                      grace=meta[0]["grace"], device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("controlled", [False, True])
def test_serving_on_the_card_matches_the_replayed_cpu_run(cuda_device, controlled):
    """The arrival grid (200 rounds, 2 seeds a cell, lea and oracle) on the
    card and on the CPU from the same draws: every ServingOutcomes field
    equal (B1 repeats the plain version's roundings, so no allocation tie
    flips); the fused allocation launched once a round and B1 once (the
    admission gate); no sync inside the round loop."""
    from repro_torch import serving
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws
    from repro_torch.serving import engine
    recorder = RecordedDraws(torch_draws(4, cuda_device))
    args, kwargs = _arrival_args(cuda_device, 200, 2, controlled)
    loop = engine._round_loop

    def strict(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    before = launch_counts()
    engine._round_loop = strict
    try:
        on_card = serving.sweep_serving(recorder, *args, **kwargs)
    finally:
        engine._round_loop = loop
    assert launch_counts()["allocate_masked_cuda"] == before["allocate_masked_cuda"] + 200
    assert launch_counts()["success_tails_cuda_w"] == before["success_tails_cuda_w"] + 1
    cpu_args, cpu_kwargs = _arrival_args("cpu", 200, 2, controlled)
    on_cpu = serving.sweep_serving(ReplayedDraws(recorder.calls), *cpu_args, **cpu_kwargs)
    for field in serving.ServingOutcomes._fields:
        assert torch.equal(getattr(on_card, field).cpu(), getattr(on_cpu, field)), field


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["admission", "allocation"])
def test_tails_kernel_at_the_serving_shapes_is_bit_equal(cuda_device, shape):
    """B1 as the serving path calls it: the admission gate's (1, 96, M, 15)
    probabilities with (96, 1, 15) thresholds (stride 0 over the rounds),
    and a round's allocation, (96 x 6, 15) with per-row thresholds."""
    rng = np.random.default_rng(0 if shape == "admission" else 1)
    if shape == "admission":
        p = torch.from_numpy(_probs(rng, 96 * 300, 15).reshape(1, 96, 300, 15)).to(cuda_device)
        w = torch.from_numpy(rng.integers(-2, 17, (96, 1, 15)).astype(np.int32)).to(cuda_device)
    else:
        p = torch.from_numpy(_probs(rng, 96 * 6, 15)).to(cuda_device)
        w = torch.from_numpy(rng.integers(-2, 17, (96 * 6, 15)).astype(np.int32)).to(cuda_device)
    before = launch_counts()["success_tails_cuda_w"]
    got = success_tails(p, w)
    assert launch_counts()["success_tails_cuda_w"] == before + 1
    torch.testing.assert_close(got, success_tails_ref(p, w), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# observability: telemetry and taps on the card
# ---------------------------------------------------------------------------

def _strict_loop(engine):
    """The serving round loop with any sync inside it raising."""
    loop = engine._round_loop

    def strict(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    return loop, strict


@pytest.mark.cuda
@pytest.mark.parametrize("round_chunk", [None, 100])
def test_engine_telemetry_and_taps_on_the_card(cuda_device, round_chunk):
    """fig3 (256 rounds, 2 seeds): the successes with telemetry and taps on
    are the flags-off bits; the frame equals the CPU's on recorded draws;
    the last tap event of each row is the row's success sums."""
    from repro_torch import obs, sweeps
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws
    group, = sweeps.build_groups(sweeps.expand("fig3", rounds=256), seeds=2)
    off = sweeps.run_group(group, round_chunk=round_chunk, draws=torch_draws(9, cuda_device),
                           device=cuda_device)
    recorder = RecordedDraws(torch_draws(9, cuda_device))
    with obs.capture_taps() as events:
        on, frame = sweeps.run_group(group, round_chunk=round_chunk, draws=recorder,
                                     telemetry=True, tap=True, tap_stride=64,
                                     device=cuda_device)
    np.testing.assert_array_equal(off, on)
    last = {int(e["row"]): e for e in events}
    for r, e in last.items():
        np.testing.assert_array_equal(e["succ_so_far"], on[r].sum(0))
    cpu_succ, cpu_frame = sweeps.run_group(group, round_chunk=round_chunk, telemetry=True,
                                           draws=ReplayedDraws(recorder.calls), device="cpu")
    np.testing.assert_array_equal(on, cpu_succ)
    for field in ("prefix_size", "load_total", "received", "feasible"):
        np.testing.assert_array_equal(getattr(frame, field), getattr(cpu_frame, field))
    np.testing.assert_allclose(frame.est_err, cpu_frame.est_err, rtol=1e-6, atol=0)
    assert not frame.est_err[..., 1].any()


@pytest.mark.cuda
def test_fault_telemetry_and_taps_on_the_card(cuda_device):
    """The packet_erasure grid (200 rounds, 1 seed a cell): outcomes with the
    flags on are the flags-off bits; telemetry equals the CPU's on recorded
    draws; the tap totals equal the telemetry sums."""
    from repro_torch import faults, obs
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws
    args, geometry = _erasure_args(cuda_device, 200, 1)
    off = faults.sweep_faults(torch_draws(6, cuda_device), *args, **geometry, device=cuda_device)
    recorder = RecordedDraws(torch_draws(6, cuda_device))
    with obs.capture_taps() as events:
        on, tel = faults.sweep_faults(recorder, *args, **geometry, telemetry=True, tap=True,
                                      tap_stride=50, device=cuda_device)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    cpu_args, _ = _erasure_args("cpu", 200, 1)
    cpu_out, cpu_tel = faults.sweep_faults(ReplayedDraws(recorder.calls), *cpu_args, **geometry,
                                           telemetry=True, device="cpu")
    for a, b in zip(on, cpu_out):
        assert torch.equal(a.cpu(), b)
    for field, a, b in zip(faults.FaultTelemetry._fields, tel, cpu_tel):
        assert torch.equal(a.cpu(), b), field
    assert (tel.received_conserve >= tel.received_aon).all()
    for e in events[-on.full_aon.shape[0]:]:
        r = int(e["row"])
        assert int(e["preempted_so_far"]) == int(tel.preempted[r].sum())
        assert int(e["packets_lost_so_far"]) == int(tel.packets_lost[r].sum())


@pytest.mark.cuda
def test_serving_taps_on_the_card_sync_only_between_segments(cuda_device):
    """The arrival grid (200 rounds, 1 seed a cell) with telemetry and taps
    on: the round loop runs under set_sync_debug_mode("error") in every
    segment; outcomes equal the flags-off call; telemetry equals the CPU's
    on recorded draws; the events are boundaries x rows x strategies."""
    from repro_torch import obs, serving
    from repro_torch.random import RecordedDraws, ReplayedDraws, torch_draws
    from repro_torch.serving import engine
    args, kwargs = _arrival_args(cuda_device, 200, 1, True)
    off = serving.sweep_serving(torch_draws(8, cuda_device), *args, **kwargs)
    recorder = RecordedDraws(torch_draws(8, cuda_device))
    loop, strict = _strict_loop(engine)
    engine._round_loop = strict
    try:
        with obs.capture_taps() as events:
            on, tel = serving.sweep_serving(recorder, *args, **kwargs, telemetry=True, tap=True,
                                            tap_stride=50)
    finally:
        engine._round_loop = loop
    for field, a, b in zip(serving.ServingOutcomes._fields, off, on):
        assert torch.equal(a, b), field
    rows = on.arrivals.shape[0]
    assert len(events) == 4 * rows * 2
    cpu_args, cpu_kwargs = _arrival_args("cpu", 200, 1, True)
    cpu_out, cpu_tel = serving.sweep_serving(ReplayedDraws(recorder.calls), *cpu_args,
                                             **cpu_kwargs, telemetry=True)
    for field, a, b in zip(serving.ServingTelemetry._fields, tel, cpu_tel):
        assert torch.equal(a.cpu(), b), field
    assert torch.equal(on.in_flight, tel.occupancy[..., -1])


@pytest.mark.cuda
def test_chunked_sweep_on_the_card_launches_one_fused_allocation_a_block(cuda_device):
    """fig3 (16 rows x 2 000 rounds) at round_chunk 250: 8 blocks, 8
    launches of the fused allocation (B1's DP); with taps, 16 x 8 events and
    the same successes, both calls drawing from the group's generator."""
    from repro_torch import obs, sweeps
    group, = sweeps.build_groups(sweeps.expand("fig3", rounds=2000), seeds=4)
    before = launch_counts()["allocate_masked_cuda"]
    chunked = sweeps.run_group(group, round_chunk=250)
    assert launch_counts()["allocate_masked_cuda"] - before == 8
    with obs.capture_taps() as events:
        tapped = sweeps.run_group(group, round_chunk=250, tap=True)
    np.testing.assert_array_equal(tapped, chunked)
    assert len(events) == group.batch.rows * 8


@pytest.mark.cuda
def test_cost_rows_on_the_card_count_each_b1_launch(cuda_device):
    """The op-cost rows run on the card by default; every pool-path entry
    point launches B1's DP there (alone or in the fused allocation), and the
    counter adds each launch's work."""
    from repro_torch.launch import hlo_cost
    for name in hlo_cost.entry_point_names():
        before = sum(launch_counts().values())
        costs = hlo_cost.entry_costs(name)
        after = sum(launch_counts().values())
        assert costs.kernel_launches == after - before > 0, name
        assert 0 < costs.kernel_bytes <= costs.hbm_bytes, name
        assert 0 < costs.kernel_flops <= costs.other_flops, name
        row = hlo_cost.cost_row(name, costs)
        assert row["collective_bytes"] == 0 and row["flops"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("hq,hkv", [(24, 8), (32, 4)], ids=["llama3.2-3b", "yi-9b"])
def test_flash_attention_at_the_dense_family_gqa_groups(cuda_device, hq, hkv):
    """B6 at llama3.2-3b's GQA groups of 3 and yi-9b's of 8 (D = 128, bf16,
    causal, 2048 tokens: the wgmma route) within the bf16 bound of
    ``test_flash_attention_kernel_matches_plain_version``."""
    from repro_torch.kernels import flash_attention as fa
    gen = torch.Generator(device=cuda_device).manual_seed(hq)
    q, k, v = (torch.randn((1, 2048, h, 128), generator=gen, device=cuda_device)
               .to(torch.bfloat16).transpose(1, 2) for h in (hq, hkv, hkv))
    before = fa.launch_counts()["flash_attention_cuda"]
    got = fa.flash_attention(q, k, v, causal=True)
    assert fa.launch_counts()["flash_attention_cuda"] == before + 1
    assert fa.flash_route(q.dtype, 128) == "wgmma"
    want = fa.flash_attention_ref(q, k, v, causal=True)
    bound = FLASH_EPS[torch.bfloat16] * (v.float().abs().amax() + want.float().abs())
    assert bool(((got.float() - want.float()).abs() <= bound).all())


@pytest.mark.cuda
def test_flash_attention_under_grad_raises_on_the_card(cuda_device):
    """The card's output has no ``grad_fn``: a gradient would skip attention,
    so the call raises before launching."""
    from repro_torch.kernels import flash_attention as fa
    q = torch.randn((1, 4, 64, 128), device=cuda_device, dtype=torch.bfloat16,
                    requires_grad=True)
    k = v = torch.randn((1, 2, 64, 128), device=cuda_device, dtype=torch.bfloat16)
    before = fa.launch_counts()["flash_attention_cuda"]
    with pytest.raises(RuntimeError, match="no backward"):
        fa.flash_attention(q, k, v)
    assert fa.launch_counts()["flash_attention_cuda"] == before
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).shape == q.shape


@pytest.mark.cuda
def test_full_width_qwen3_train_step_on_the_card(cuda_device):
    """One ``make_train_step`` step of ``qwen3_0_6b`` at full width (remat,
    bf16 parameters, float32 moments, 4 microbatches) on 2 x 512 tokens:
    a finite loss near ln(vocab) at random init, and the parameters move."""
    import math
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.models import api
    cfg = get_config("qwen3_0_6b", microbatch=2)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = api.init_state(cfg, gen, device=cuda_device)
    before = state.params["embed"].detach().clone()
    batch = api.make_batch(cfg, ShapeCell("t", 512, 2, "train"), gen, device=cuda_device)
    state, metrics = api.make_train_step(cfg)(state, batch)
    loss = float(metrics["loss"])
    assert math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 1.0
    assert math.isfinite(float(metrics["grad_norm"])) and int(state.step) == 1
    assert not torch.equal(state.params["embed"].detach(), before)


# the new families' SMOKE configs (float32): zamba2 with a tail group,
# mixtral on 40 tokens, past its 32-token window, whisper over its 16 frames
# and phi-3-vision with its 8 patches first
ZOO_SMOKE = {"olmoe": ("olmoe_1b_7b", {}), "mixtral": ("mixtral_8x22b", {}),
             "zamba2-tail": ("zamba2_7b", dict(n_layers=5)), "xlstm": ("xlstm_125m", {}),
             "whisper": ("whisper_tiny", {}), "phi3v": ("phi_3_vision_4_2b", {})}


def _zoo_smoke(which, **extra):
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import api
    arch, over = ZOO_SMOKE[which]
    cfg = get_smoke_config(arch, **over, **extra)
    params = api.get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg,
                                            device="cpu")
    return cfg, params


@pytest.mark.cuda
@pytest.mark.parametrize("which", list(ZOO_SMOKE))
def test_zoo_smoke_serving_on_the_card_matches_the_cpu(cuda_device, which):
    """Each new family through the flash prefill and 4 decode steps: the card
    within 1e-4 of the CPU (float32 sums in other orders, logits of order
    0.5), B6 launched ``attention_calls`` times in the prefill (olmoe and
    mixtral 2, zamba2 3, xLSTM 0, whisper 6, phi-3-vision 2) and never in
    decode."""
    from repro_torch.configs import ShapeCell
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import api
    cfg, params = _zoo_smoke(which, attn_impl="flash")
    batch = api.make_batch(cfg, ShapeCell("c", 40, 3, "prefill"),
                           torch.Generator().manual_seed(1), device="cpu")
    prefill, serve = api.make_prefill_step(cfg, max_len=48), api.make_serve_step(cfg)
    on_card = copy.deepcopy(params).to(cuda_device)
    before = fa.launch_counts()["flash_attention_cuda"]
    got, cache = prefill(on_card, {k: t.to(cuda_device) for k, t in batch.items()})
    assert fa.launch_counts()["flash_attention_cuda"] == before + api.attention_calls(cfg)
    want, cache_cpu = prefill(params, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    for _ in range(4):
        tok = want.argmax(-1)
        got, cache = serve(on_card, cache, {"next_token": tok.to(cuda_device)})
        want, cache_cpu = serve(params, cache_cpu, {"next_token": tok})
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    assert fa.launch_counts()["flash_attention_cuda"] == before + api.attention_calls(cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["olmoe", "zamba2-tail", "xlstm", "whisper", "phi3v"])
def test_zoo_smoke_train_step_on_the_card_matches_the_cpu(cuda_device, which):
    """One ``make_train_step`` step of each new family on the card and on
    the CPU from the same state and batch: loss and gradient norm within
    rtol 1e-4 (float32 sums in other orders), finite parameters after it."""
    from repro_torch.configs import ShapeCell
    from repro_torch.models import api
    from repro_torch.optim import TrainState
    cfg, _ = _zoo_smoke(which)
    state = api.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    on_card = TrainState(params=copy.deepcopy(state.params).to(cuda_device),
                         m={k: t.to(cuda_device) for k, t in state.m.items()},
                         v={k: t.to(cuda_device) for k, t in state.v.items()},
                         step=state.step.to(cuda_device))
    batch = api.make_batch(cfg, ShapeCell("t", 16, 4, "train"),
                           torch.Generator().manual_seed(2), device="cpu")
    step = api.make_train_step(cfg)
    got_state, got = step(on_card, {k: t.to(cuda_device) for k, t in batch.items()})
    _, want = step(state, batch)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=1e-4, atol=0)
    assert all(bool(torch.isfinite(t).all()) for t in got_state.params.tensors().values())


@pytest.mark.cuda
def test_full_width_whisper_train_step_on_the_card(cuda_device):
    """One ``make_train_step`` step of ``whisper_tiny`` at full width (remat,
    bf16, 8 microbatches of one 448-token text over 1 500 frames): a finite
    loss near ln(vocab) at random init, the parameters move; prints a second
    step's time and peak memory."""
    import math
    import time
    from repro_torch.configs import ShapeCell, get_config
    from repro_torch.models import api
    cfg = get_config("whisper_tiny")
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    state = api.init_state(cfg, gen, device=cuda_device)
    before = state.params["embed"].detach().clone()
    batch = api.make_batch(cfg, ShapeCell("t", 448, 8, "train"), gen, device=cuda_device)
    step = api.make_train_step(cfg)
    state, metrics = step(state, batch)
    loss = float(metrics["loss"])
    assert math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 1.0
    assert math.isfinite(float(metrics["grad_norm"])) and int(state.step) == 1
    assert not torch.equal(state.params["embed"].detach(), before)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    second = float(metrics["loss"])                      # a host read: the step has ended
    print(f"[whisper_train_step] ms={(time.perf_counter() - t0) * 1e3:.1f} loss={second:.4f} "
          f"peak_memory_gib={torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"device={torch.cuda.get_device_name(0)!r}")
    assert math.isfinite(second)


# -- the multi-card slice: ranks sharing the one card over gloo ------------------

def _sharded_worker(rank: int, world: int, coord: str, device: str, out: str) -> None:
    """One rank of a (1 x 2) mesh on ``device``: the collectives the slice
    uses, yi's SMOKE prefill and 3 ``sharded_lse`` decode steps, and one
    qwen3 SMOKE train step; rank 0 saves the results."""
    import dataclasses
    import json as _json

    import torch.distributed as dist

    from repro_torch.configs import ShapeCell, get_smoke_config
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import api, sharding
    from repro_torch.models.sharding import full, use_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    torch.set_num_threads(1)
    lmesh.init_distributed(coordinator=coord, num_processes=world, process_id=rank)
    mesh = lmesh.make_host_mesh((1, world), ("data", "model"), device=device)
    res, probe = {}, {}
    x = torch.full((4,), float(rank + 1), device=device)
    d = sharding.distribute(torch.arange(8.0, device=device).reshape(4, 2),
                            sharding.named_sharding(mesh, "tp", None))
    probe["dtensor_all_gather"] = d.full_tensor().tolist() == [[0.0, 1.0], [2.0, 3.0],
                                                               [4.0, 5.0], [6.0, 7.0]]
    probe["all_reduce_max"] = sharding.all_reduce(x.clone(), "max", mesh, "model").tolist() \
        == [float(world)] * 4
    got = torch.zeros(4, device=device)
    if rank == 0:
        sharding.send_recv(x, 1, None, None, mesh, "model")
    elif rank == 1:
        sharding.send_recv(None, None, got, 0, mesh, "model")
        probe["send_recv"] = got.tolist() == [1.0] * 4
    res["probe"] = probe
    # weights and data drawn on the CPU, the same for both runs, then placed
    gen = torch.Generator().manual_seed(0)
    cfg = dataclasses.replace(get_smoke_config("yi_9b"), decode_attn="sharded_lse")
    params = api.get_model(cfg).init_params(gen, cfg, device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (2, 12), generator=gen,
                           dtype=torch.int32).to(device)
    params = api.distribute_tree(params, api.param_shardings(cfg, mesh, params), device=device)
    with use_mesh(mesh):
        logits, cache = api.make_prefill_step(cfg, max_len=16, attn_impl="flash")(
            params, {"tokens": tokens})
        outs = [full(logits)]
        for t in range(3):
            logits, cache = api.make_serve_step(cfg)(params, cache,
                                                     {"next_token": tokens[:, t]})
            outs.append(full(logits))
    res["serve"] = torch.stack(outs).cpu().tolist()
    tcfg = get_smoke_config("qwen3_0_6b")
    state = api.init_state(tcfg, torch.Generator().manual_seed(1), device="cpu")
    batch = api.make_batch(tcfg, ShapeCell("t", 32, 4, "train"),
                           torch.Generator().manual_seed(2), device="cpu")
    sh = api.state_shardings(tcfg, mesh, state)
    state = api.distribute_tree(state, sh, device=device)
    batch = api.distribute_tree(batch, api.batch_shardings(tcfg, mesh, batch), device=device)
    step = api.make_train_step(tcfg, peak_lr=1e-3, warmup=1, grad_shardings=sh.params)
    with use_mesh(mesh):
        state, metrics = step(state, batch)
        res["train_loss"] = float(full(metrics["loss"]))
        res["train_embed"] = full(state.params["embed"]).detach().cpu().tolist()
    if rank == 0:
        with open(out, "w") as f:
            _json.dump(res, f)
    res_all = [None] * world
    dist.all_gather_object(res_all, probe)
    if rank == 0:
        with open(out + ".probe", "w") as f:
            _json.dump(res_all, f)
    dist.barrier()
    dist.destroy_process_group()


def _run_sharded(device: str, tmp_path) -> tuple[dict, list]:
    import json as _json
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        coord = f"localhost:{sock.getsockname()[1]}"
    out = str(tmp_path / f"{device}.json")
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
    procs = [subprocess.Popen([sys.executable, __file__, "--sharded-worker", str(r), "2", coord,
                               device, out], env=dict(os.environ, PYTHONPATH=src),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    with open(out) as f, open(out + ".probe") as g:
        return _json.load(f), _json.load(g)


@pytest.fixture(scope="module")
def sharded_runs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tmp = tmp_path_factory.mktemp("sharded")
    return _run_sharded("cuda", tmp), _run_sharded("cpu", tmp)


@pytest.mark.cuda
def test_sharded_probe_on_the_card(sharded_runs):
    """The collectives of the multi-card slice on CUDA tensors over gloo, two
    ranks on the one card: DTensor's (staged) all-gather, the MAX
    all-reduce, the (staged) send / recv."""
    (_, probe), _ = sharded_runs
    assert probe[0] == {"dtensor_all_gather": True, "all_reduce_max": True}
    assert probe[1] == {"dtensor_all_gather": True, "all_reduce_max": True, "send_recv": True}


@pytest.mark.cuda
def test_sharded_smoke_serve_on_the_card_matches_cpu_ranks(sharded_runs):
    """yi's SMOKE flash prefill (B6 per rank) and 3 ``sharded_lse`` decode
    steps over (1 x 2) on the card, held to the same run on two CPU ranks
    (float32; 1e-4: the card's and the CPU's summation orders differ)."""
    (card, _), (cpu, _) = sharded_runs
    np.testing.assert_allclose(np.asarray(card["serve"]), np.asarray(cpu["serve"]),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_sharded_smoke_train_on_the_card_matches_cpu_ranks(sharded_runs):
    """One qwen3 SMOKE ``make_train_step(grad_shardings=)`` step over (1 x 2)
    on the card against two CPU ranks: the loss at 1e-4, the updated
    embedding at the JAX test's rtol 2e-2 / atol 2e-3."""
    (card, _), (cpu, _) = sharded_runs
    assert abs(card["train_loss"] - cpu["train_loss"]) <= 1e-4
    np.testing.assert_allclose(np.asarray(card["train_embed"]), np.asarray(cpu["train_embed"]),
                               rtol=2e-2, atol=2e-3)


# ---------------------------------------------------------------------------
# the static resampler's kernel: the plain version's loads, flags and draws
# ---------------------------------------------------------------------------

def _resample_kernel_and_plain(case, draws_for):
    """``_static_loads_batch`` on the card (the kernel) and the plain
    version driven by the same loop, each on fresh draws from
    ``draws_for()``: both results, both draw records, the kernel's counters
    and the count each route read before every try."""
    from _resample_cases import batch_args, drive, resampler_args

    from repro_torch.core import throughput
    from repro_torch.kernels import static_resample as sr
    from repro_torch.random import RecordedDraws

    draws = RecordedDraws(draws_for())
    sr.reset_launch_counts()
    sr.reset_engagement()
    got = throughput._static_loads_batch(draws, *batch_args(case))
    counts = {**sr.engagement(), **sr.launch_counts()}
    _, reads = drive(sr.StaticResampleCuda(*resampler_args(case)), draws_for(), case)
    plain_draws = RecordedDraws(draws_for())
    want, plain_reads = drive(sr.StaticResampleRef(*resampler_args(case)), plain_draws, case)
    torch.cuda.synchronize()
    return got, want, draws.calls, plain_draws.calls, counts, reads, plain_reads


def _assert_same_resampling(case, got, want, calls, plain_calls, counts, reads,
                            plain_reads):
    for (gl, gf), (wl, wf) in zip(got, want, strict=True):
        assert gl.is_cuda and gl.dtype == torch.int32 and gf.dtype == torch.bool
        assert torch.equal(gl, wl) and torch.equal(gf, wf)
    assert len(calls) == len(plain_calls)
    for a, b in zip(calls, plain_calls):
        assert torch.equal(a, b)
    assert reads == plain_reads
    tries = len(calls)
    b, m = case["pis"][0].shape[0], case["stop"] - case["start"]
    assert counts == {"tries": tries, "redraws": sum(reads[:tries]),
                      "slots": tries * len(case["pis"]) * b * m,
                      "static_resample_cuda": tries}


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["pool_mask_s2", "pool_s1", "scalars_s1", "scalars_s2",
                                  "pi_zero", "kstar_nonpositive", "all_masked_row",
                                  "one_row_short", "wide_s2_mask", "wide_s2_ragged"])
def test_static_resample_kernel_is_the_plain_version_to_the_bit(cuda_device, name):
    from _resample_cases import check_edges, resample_case

    from repro_torch.random import torch_draws

    case = resample_case(name, cuda_device)
    out = _resample_kernel_and_plain(case, lambda: torch_draws(23, cuda_device))
    _assert_same_resampling(case, *out)
    check_edges(name, case, out[0], len(out[2]))


@pytest.mark.cuda
def test_static_resample_kernel_at_the_fig3_block(cuda_device):
    """One (1 024, 2 330, 15) block of the fig3 sweep (the four chains' pi_g,
    a full mask, K* 99, loads (10, 3) per row) under the benchmark's keyed
    draws."""
    from portbench.draws import KeyedDraws
    from repro_torch.core import markov

    b, m, n, rounds = 1024, 2330, 15, 20_000
    chains = torch.tensor([(0.8, 0.8), (0.8, 0.7), (0.8, 0.533), (0.9, 0.6)],
                          dtype=torch.float32, device=cuda_device).repeat_interleave(256, 0)
    ones = torch.ones((b, n), device=cuda_device)
    pi_g = markov.stationary_good_prob(chains[:, :1] * ones, chains[:, 1:] * ones)
    rows = lambda v: torch.full((b,), v, dtype=torch.int32, device=cuda_device)
    case = dict(rounds=rounds, start=3 * m, stop=4 * m, pis=[pi_g], kstar=rows(99)[:, None],
                ell_g=rows(10)[:, None, None], ell_b=rows(3)[:, None, None],
                mask=torch.ones((b, n), dtype=torch.bool, device=cuda_device))
    out = _resample_kernel_and_plain(case, lambda: KeyedDraws(2**40 + 7, 3, cuda_device))
    _assert_same_resampling(case, *out)
    counts = out[4]
    assert 10 < counts["tries"] < 64
    print(f"[static_resample_fig3] {counts} share={counts['redraws'] / counts['slots']:.4f}")


@pytest.mark.cuda
def test_static_resample_kernel_refuses_what_it_does_not_take(cuda_device):
    from repro_torch.kernels.static_resample import StaticResampleCuda

    pi = torch.full((2, 15), 0.5, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        StaticResampleCuda([pi.double()], 4, 99, 10, 3)
    with pytest.raises(ValueError, match="CUDA kernel"):
        StaticResampleCuda([pi.cpu()], 4, 99, 10, 3)
    with pytest.raises(ValueError, match="strategies"):
        StaticResampleCuda([pi] * 9, 4, 99, 10, 3)
    with pytest.raises(ValueError, match="kstar"):
        StaticResampleCuda([pi], 4, torch.tensor([99, 99], device=cuda_device), 10, 3)
    with pytest.raises(ValueError, match="mask"):
        StaticResampleCuda([pi], 4, 99, 10, 3, torch.ones((2, 14), dtype=torch.bool,
                                                          device=cuda_device))
    resampler = StaticResampleCuda([pi], 4, 99, 10, 3)
    assert resampler.unfinished() == 8
    with pytest.raises(ValueError, match="contiguous"):
        resampler.redraw(torch.rand((2, 15, 4), device=cuda_device).transpose(1, 2))
    with pytest.raises(ValueError, match="float32"):
        resampler.redraw(torch.rand((2, 5, 15), device=cuda_device))


# ---------------------------------------------------------------------------
# the fault engine's packet counts: the kernel against the mask composition
# ---------------------------------------------------------------------------

def _counts_against_the_composition(inputs, r, packets):
    """The kernel's two count tensors on the card and the composition's on
    the CPU (the plain route, which divides as IEEE float32) from the same
    inputs, compared to the bit; one launch."""
    from _packet_cases import composition

    from repro_torch.kernels import packet_counts as pc
    before = pc.launch_counts()["packet_counts_cuda"]
    got = pc.decode_counts(*inputs[:5], r, packets, inputs[5])
    torch.cuda.synchronize()
    assert pc.launch_counts()["packet_counts_cuda"] == before + 1
    cpu = [x.cpu() for x in inputs[:5]]
    trace = None if inputs[5] is None else type(inputs[5])(*(x.cpu() for x in inputs[5]))
    want = composition(*cpu, r, packets, trace)
    for g, w in zip(got, want, strict=True):
        assert g.is_cuda and g.dtype == torch.int32 and g.shape == w.shape
        assert torch.equal(g.cpu(), w), int((g.cpu() != w).sum())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 2, 3])
@pytest.mark.parametrize("packets", [1, 3, 4, 8])
@pytest.mark.parametrize("r", [1, 4, 10])
@pytest.mark.parametrize("n", [1, 3, 15, 64])
def test_packet_counts_kernel_is_the_composition_to_the_bit(cuda_device, n, r, packets, s):
    """Both modes at every geometry: rows keeping every packet and none,
    loads 0 and r, crashed and preempted cutoffs, a masked worker
    (``tests/_packet_cases.py``)."""
    from _packet_cases import count_inputs
    inputs = count_inputs(cuda_device, s, n, r, packets, seed=n + 7 * r + 31 * packets + s)
    aon, con = _counts_against_the_composition(inputs, r, packets)
    assert bool((aon <= con).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,packets", [(15, 10, 4), (3, 3, 3), (64, 10, 8)])
def test_packet_counts_kernel_without_a_trace(cuda_device, n, r, packets):
    """No trace: cut at the deadline, every packet kept."""
    from _packet_cases import count_inputs
    _counts_against_the_composition(count_inputs(cuda_device, 2, n, r, packets, trace=False),
                                    r, packets)


@pytest.mark.cuda
@pytest.mark.parametrize("n,r,packets,offset,width", [
    (15, 10, 4, 0, 16), (15, 10, 4, 8, 8), (15, 10, 4, 1, 1), (5, 3, 3, 0, 4), (5, 3, 3, 2, 2),
    (33, 3, 3, 0, 1), (64, 10, 4, 4, 4)])
def test_packet_counts_kernel_reads_keep_at_every_load_width(cuda_device, n, r, packets,
                                                            offset, width):
    """keep laid in a buffer at a byte offset, so its address and the warps'
    offsets set the load's width (16, 8, 4, 2 or 1 bytes)."""
    from _packet_cases import count_inputs

    from repro_torch.faults import FaultTrace
    from repro_torch.kernels.packet_counts import vector_width
    inputs = count_inputs(cuda_device, 2, n, r, packets, seed=offset)
    keep = inputs[5].keep
    buf = torch.zeros(keep.numel() + 16, dtype=torch.bool, device=cuda_device)
    moved = buf[offset:offset + keep.numel()].view(keep.shape)
    moved.copy_(keep)
    assert moved.is_contiguous() and vector_width(n, r * packets, moved.data_ptr()) == width
    _counts_against_the_composition(inputs[:5] + (FaultTrace(inputs[5].t_cut, moved),),
                                    r, packets)


@pytest.mark.cuda
def test_packet_counts_kernel_at_degenerate_speeds_and_cutoffs(cuda_device):
    """Speeds 0 and negative (every packet by its own division), an infinite
    deadline, NaN cutoffs and loads outside [0, r]."""
    from _packet_cases import count_inputs
    states, loads, mu_g, mu_b, _, trace = count_inputs(cuda_device, 2, 15, 10, 4, seed=5)
    mu_b = torch.tensor([0.0, -2.0, 3.0, float("inf")], device=cuda_device)
    deadline = torch.tensor([1.0, 1.0, float("inf"), 0.5], device=cuda_device)
    t_cut = trace.t_cut.clone()
    t_cut[:, ::5, 3] = float("nan")
    loads = loads.clone()
    loads[:, :, 2::3, 0] = -1
    loads[:, :, 2::3, 1] = 12
    inputs = (states, loads, mu_g, mu_b, deadline, trace._replace(t_cut=t_cut))
    _counts_against_the_composition(inputs, 10, 4)


@pytest.mark.cuda
def test_fault_sweep_counts_packets_in_one_launch_a_call(cuda_device):
    """sweep_faults on the packet_erasure grid: one packet_counts_cuda
    launch a call, with or without telemetry and taps."""
    from repro_torch import faults, obs
    from repro_torch.kernels import packet_counts as pc
    from repro_torch.random import torch_draws
    args, geometry = _erasure_args(cuda_device, 200, 2)
    for kw in ({}, dict(telemetry=True), dict(tap=True, tap_stride=50)):
        before = pc.launch_counts()["packet_counts_cuda"]
        with obs.capture_taps():
            faults.sweep_faults(torch_draws(4, cuda_device), *args, **geometry, **kw,
                                device=cuda_device)
        torch.cuda.synchronize()
        assert pc.launch_counts()["packet_counts_cuda"] == before + 1, kw


@pytest.mark.cuda
def test_packet_counts_kernel_refuses_what_it_does_not_take(cuda_device):
    from _packet_cases import count_inputs

    from repro_torch.kernels.packet_counts import packet_counts_cuda
    states, loads, mu_g, mu_b, deadline, (t_cut, keep) = count_inputs(cuda_device, 2, 5, 3, 4)
    with pytest.raises(ValueError, match="keep must be contiguous"):
        packet_counts_cuda(states, loads, mu_g, mu_b, deadline, 3, 4, t_cut,
                           keep.transpose(-1, -2).contiguous().transpose(-1, -2))
    with pytest.raises(ValueError, match="int32"):
        packet_counts_cuda(states.long(), loads, mu_g, mu_b, deadline, 3, 4, t_cut, keep)
    with pytest.raises(ValueError, match="CUDA kernel"):
        packet_counts_cuda(states, loads, mu_g.cpu(), mu_b, deadline, 3, 4, t_cut, keep)
    with pytest.raises(ValueError, match="keep"):
        packet_counts_cuda(states, loads, mu_g, mu_b, deadline, 3, 5, t_cut, keep)


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "--sharded-worker":
        _sharded_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5],
                        sys.argv[6])
