"""Flash attention (B6): the port's plain versions against the JAX package.

``flash_attention_ref`` is held to the Pallas kernel ``flash_attention_pallas``
run with ``interpret=True`` (what the CUDA kernel must compute, the zero rows
of its ``l == 0`` guard included), and ``attention_ref`` to the JAX
``attention_ref``.  Inputs come from a numpy seed; float32 within 1e-5, bf16
within one bf16 rounding (2^-7 relative) of the same float32 result.  The
CUDA kernel itself is held to ``flash_attention_ref`` on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref
from repro_torch.kernels import flash_attention as fa

F32_TOL = 1e-5
BF16_RTOL = 2.0 ** -7

# (Hq, Hkv, Sq, Sk, D, causal, window)
CASES = [
    (4, 4, 64, 64, 16, True, None),
    (4, 2, 100, 100, 64, True, None),
    (8, 1, 64, 64, 64, False, None),
    (4, 2, 100, 100, 16, False, None),
    (8, 1, 100, 100, 16, True, None),
    (4, 4, 100, 100, 64, True, 32),        # sliding window
    (4, 2, 16, 100, 64, True, None),       # Sq < Sk: decode-aligned queries
    (4, 2, 100, 40, 16, True, None),       # Sq > Sk: the first 60 rows see no key
    (4, 2, 64, 64, 96, True, None),        # the repo's head widths past 128 and between
    (2, 1, 50, 50, 112, True, None),       # instantiations: phi-3-vision 96, zamba2 112,
    (2, 2, 40, 40, 192, False, None),      # nemotron-4 / xlstm 192
]


def _inputs(seed, hq, hkv, sq, sk, d, b=2):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    return q, k, v


def _pallas(q, k, v, causal, window):
    return np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             causal=causal, window=window,
                                             interpret=True)).astype(np.float32)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_ref_matches_the_pallas_kernel_f32(case):
    hq, hkv, sq, sk, d, causal, window = case
    q, k, v = _inputs(sum(case[:5]), hq, hkv, sq, sk, d)
    want = _pallas(q, k, v, causal, window)
    got = fa.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=causal, window=window)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", [CASES[1], CASES[5], CASES[7]],
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_ref_matches_the_pallas_kernel_bf16(case):
    hq, hkv, sq, sk, d, causal, window = case
    q, k, v = _inputs(sum(case[:5]) + 1, hq, hkv, sq, sk, d)
    as_bf16 = lambda a: jnp.asarray(a, jnp.bfloat16)
    want = np.asarray(flash_attention_pallas(as_bf16(q), as_bf16(k), as_bf16(v), causal=causal,
                                             window=window, interpret=True)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = fa.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    # both round the same float32 softmax to bf16: at most one rounding apart
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_RTOL, atol=1e-6)


def test_rows_that_see_no_key_are_zero_in_the_kernel_and_nan_in_the_oracle():
    hq, hkv, sq, sk, d, causal, window = CASES[7]
    q, k, v = _inputs(7, hq, hkv, sq, sk, d)
    dead = sq - sk                             # query i sits at i + sk - sq < 0
    want = _pallas(q, k, v, causal, window)
    got = fa.flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    oracle = fa.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)))
    assert np.all(want[:, :, :dead] == 0) and bool((got[:, :, :dead] == 0).all())
    assert bool(torch.isnan(oracle[:, :, :dead]).all())
    assert bool(torch.isfinite(oracle[:, :, dead:]).all())
    np.testing.assert_allclose(oracle[:, :, dead:].numpy(), want[:, :, dead:],
                               rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[5], CASES[6]],
                         ids=lambda c: "-".join(map(str, c)))
def test_attention_ref_matches_jax(case):
    hq, hkv, sq, sk, d, causal, window = case
    q, k, v = _inputs(sum(case[:5]) + 2, hq, hkv, sq, sk, d)
    want = np.asarray(jax.jit(jax_attention_ref, static_argnames=("causal", "window"))(
        q, k, v, causal=causal, window=window))
    got = fa.attention_ref(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)


def test_query_blocks_and_a_given_scale_leave_the_result_unchanged():
    q, k, v = (torch.from_numpy(a) for a in _inputs(3, 4, 2, 100, 100, 16))
    whole = fa.flash_attention_ref(q, k, v, window=40, scale=0.3)
    blocked = fa.flash_attention_ref(q, k, v, window=40, scale=0.3, block_q=17)
    torch.testing.assert_close(blocked, whole, rtol=0, atol=0)
    want = _pallas(q.numpy(), k.numpy(), v.numpy(), True, 40)
    assert not np.allclose(whole.numpy(), want, atol=1e-3)      # 0.3 is not D^-1/2
    np.testing.assert_allclose(
        fa.flash_attention_ref(q, k, v, window=40, scale=16 ** -0.5).numpy(), want,
        rtol=F32_TOL, atol=F32_TOL)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    q, k, v = (torch.from_numpy(a) for a in _inputs(4, 4, 2, 64, 64, 16))
    before = fa.launch_counts()
    got = fa.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), v)
    torch.testing.assert_close(got, fa.flash_attention_ref(q, k, v), rtol=0, atol=0)
    assert fa.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA kernel called on a cpu tensor"):
        fa.flash_attention_cuda(q, k, v)


# ---------------------------------------------------------------------------
# the CUDA wrapper's Python side: the route and the TMA tensor maps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.float16, 128, "wgmma"),
    (torch.bfloat16, 64, "wgmma"), (torch.float16, 64, "wgmma"),
    (torch.bfloat16, 32, "mma"), (torch.float16, 16, "mma"),
    (torch.float32, 128, "ffma"), (torch.float32, 16, "ffma"),
    (torch.bfloat16, 96, "mma"), (torch.float32, 192, "ffma"),
    (torch.float16, 112, "mma"), (torch.bfloat16, 192, "mma"), (torch.bfloat16, 256, "mma"),
    (torch.bfloat16, 40, "mma"), (torch.float32, 40, "ffma"), (torch.float16, 1, "mma"),
    (torch.float32, 256, "ffma"),
], ids=str)
def test_the_route_follows_dtype_and_head_dimension_alone(dtype, d, want):
    from repro_torch.kernels.flash_attention.kernel import flash_route
    assert fa.flash_route(dtype, d) == flash_route(dtype, d) == want


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 0), (torch.float32, 320),
                                     (torch.float64, 64), (torch.int8, 128)], ids=str)
def test_the_route_refuses_what_no_kernel_takes(dtype, d):
    with pytest.raises(ValueError):
        fa.flash_route(dtype, d)


@pytest.mark.parametrize("d,want", [(1, 16), (16, 16), (17, 32), (40, 64), (64, 64),
                                    (96, 96), (112, 128), (129, 160), (192, 192),
                                    (200, 256), (256, 256)])
def test_a_head_dimension_runs_the_next_instantiation_up(d, want):
    from repro_torch.kernels.flash_attention.kernel import HEAD_DIMS
    assert fa.head_dim_instance(d) == want and want in HEAD_DIMS
    with pytest.raises(ValueError):
        fa.head_dim_instance(257)


@pytest.mark.parametrize("shape,dtype,takes,vectors", [
    ((2, 3, 40, 96), torch.bfloat16, True, True),       # whole 16-byte vectors
    ((2, 3, 40, 20), torch.bfloat16, True, False),      # 40-byte rows: element by element
    ((2, 3, 40, 3), torch.float32, True, False),
    ((2, 3, 40, 1), torch.float16, True, False),
], ids=["d96", "d20", "f32-d3", "d1"])
def test_rows_of_partial_vectors_are_read_element_by_element(shape, dtype, takes, vectors):
    from repro_torch.kernels.flash_attention.kernel import kernel_takes, vector_rows
    t = torch.zeros(shape, dtype=dtype)
    assert kernel_takes(t) == takes and vector_rows(t) == vectors
    if shape[-1] > 1:        # a head dimension that is not contiguous is never read
        assert not kernel_takes(torch.zeros(shape[:3] + (2 * shape[3],), dtype=dtype)[..., ::2])


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=str)
def test_tma_geometry_reads_the_layers_transposed_views(d, dtype):
    b, s, h = 3, 200, 8
    x = torch.zeros((b, s, h, d), dtype=dtype)          # (B, S, H, D) projection
    view = x.transpose(1, 2)                             # (B, H, S, D), no copy
    es = 2
    assert fa.tma_geometry(view) == (d, s, h, b, h * d * es, d * es, s * h * d * es, 64, 128)
    dense = view.contiguous()
    assert fa.tma_geometry(dense) == (d, s, h, b, d * es, s * d * es, h * s * d * es, 64, 128)


def test_tma_geometry_gives_extent_one_axes_their_dense_strides():
    x = torch.zeros((1, 5, 1, 64), dtype=torch.bfloat16).as_strided(
        (1, 1, 5, 64), (7, 3, 64, 1))                    # B = H = 1: odd strides, never followed
    assert fa.tma_geometry(x) == (64, 5, 1, 1, 128, 5 * 64 * 2, 5 * 64 * 2, 64, 128)


def _misaligned(d):
    flat = torch.zeros(2 * 3 * 40 * d + 8, dtype=torch.bfloat16)
    return flat[1:1 + 2 * 3 * 40 * d].view(2, 3, 40, d)   # base 2 bytes off


@pytest.mark.parametrize("make,what", [
    (lambda: torch.zeros((2, 3, 64, 40), dtype=torch.bfloat16).transpose(2, 3), "contiguous"),
    (lambda: _misaligned(64), "aligned"),
    (lambda: torch.zeros((2, 3, 40, 68), dtype=torch.bfloat16)[..., :64], "multiples of 16"),
    (lambda: torch.zeros((2, 3, 40, 96), dtype=torch.bfloat16), "multiple of 64"),
    (lambda: torch.zeros((2, 3, 0, 64), dtype=torch.bfloat16), "empty extent"),
    (lambda: torch.zeros((2, 3, 40, 64), dtype=torch.float32), "16-bit"),
], ids=["head-dim-strided", "misaligned-base", "odd-row-stride", "d96", "no-keys", "float32"])
def test_tma_geometry_refuses_views_tma_cannot_take(make, what):
    t = make()
    with pytest.raises(ValueError, match=what):
        fa.tma_geometry(t)


@pytest.mark.parametrize("make", [
    lambda: torch.zeros((2, 3, 64, 40), dtype=torch.bfloat16).transpose(2, 3),
    lambda: _misaligned(64),
    lambda: torch.zeros((2, 3, 40, 68), dtype=torch.bfloat16)[..., :64],
], ids=["head-dim-strided", "misaligned-base", "odd-row-stride"])
def test_views_tma_refuses_are_copied_before_the_kernel(make):
    """``flash_attention`` copies what ``kernel_takes`` refuses, so a view
    TMA cannot take never reaches the tensor map."""
    from repro_torch.kernels.flash_attention.kernel import kernel_takes
    from repro_torch.kernels.flash_attention.ops import kernel_view
    t = make()
    assert not kernel_takes(t)
    copy = kernel_view(t)
    assert kernel_takes(copy) and torch.equal(copy, t)
    fa.tma_geometry(copy)
