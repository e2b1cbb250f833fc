"""The CUDA kernels of the port against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU and ``nvcc``; without a GPU they skip.  They
import neither JAX nor the JAX package, so they run on the machine with the
card::

    python -m pytest -m cuda tests/test_torch_cuda.py
"""

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
    torch.testing.assert_close(got_w, success_tails_ref(p, w), rtol=0, atol=1e-5)
    torch.testing.assert_close(got_s, success_tails_ref(p, w[0]), rtol=0, atol=1e-5)


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


@pytest.mark.cuda
@pytest.mark.parametrize("nr,k,cols", [(150, 5, 18_000), (37, 5, 1001), (150, 120, 513)])
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


@pytest.mark.cuda
@pytest.mark.parametrize("nr,r_rows,c,p", [(150, 60, 3000, 1), (7, 13, 301, 3), (4, 1, 33, 2)])
def test_coded_gradient_kernel_within_fp32_bound(cuda_device, nr, r_rows, c, p):
    from repro_torch.kernels import coded_gradient as cg
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
    with pytest.raises(ValueError, match="shared memory"):
        cg.coded_gradient_cuda(torch.zeros((1, 200, 4), device=cuda_device),
                               torch.zeros((1, 200, 70), device=cuda_device),
                               torch.zeros((4, 70), device=cuda_device))


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
