"""The CUDA kernel of the port against its plain PyTorch version, on the card.

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
