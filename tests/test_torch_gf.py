"""Parity of the port's exact GF(2^31 - 1) layer (``repro_torch.kernels.gf``
and the exact half of ``core.lagrange``) with the JAX package, on the CPU.

Residues are exact, so every GF(p) result must equal the JAX package's and
the numpy oracle's to the bit (compared as int64).  The JAX Pallas kernel
runs as the JAX package's own tests run it: ``interpret=True`` with small
blocks.  The float Lagrange matrices are held to float32 round-off.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import lagrange as jlag
from repro.kernels import gf as jgf
from repro.kernels.gf import ref as jref
from repro.kernels.gf.kernel import matmul_gf_pallas
from repro_torch.core import lagrange
from repro_torch.kernels import gf
from repro_torch.kernels.gf import ref

P = gf.FIELD_P
CPU = "cpu"


def _residues(rng, shape):
    """Random residues with 0, 1 and p-1 planted at the front."""
    x = rng.integers(0, P, size=shape, dtype=np.int64)
    flat = x.reshape(-1)
    flat[: min(3, flat.size)] = [0, 1, P - 1][: min(3, flat.size)]
    return x


def _i64(t):
    return np.asarray(t).astype(np.int64)


# ---------------------------------------------------------------------------
# field primitives
# ---------------------------------------------------------------------------

_BINARY = ["add_gf", "sub_gf", "mul_gf"]
_UNARY = ["inv_gf", "from_gf"]


@pytest.mark.parametrize("name", _BINARY + _UNARY)
def test_field_primitive_matches_jax(name):
    rng = np.random.default_rng(len(name))
    a = _residues(rng, (257,))
    b = _residues(rng, (257,))[::-1].copy()
    ja = jnp.asarray(a.astype(np.uint32))
    jb = jnp.asarray(b.astype(np.uint32))
    ta, tb = torch.from_numpy(a.astype(np.int32)), torch.from_numpy(b.astype(np.int32))
    if name in _BINARY:
        want, got = getattr(jref, name)(ja, jb), getattr(ref, name)(ta, tb)
    else:
        want, got = getattr(jref, name)(ja), getattr(ref, name)(ta)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_i64(got), _i64(want))


@pytest.mark.parametrize("s", [0, 1, 8, 16, 24, 30, 31, 48])
def test_rot_gf_matches_jax(s):
    x = _residues(np.random.default_rng(s), (300,))
    want = jref.rot_gf(jnp.asarray(x.astype(np.uint32)), s)
    np.testing.assert_array_equal(_i64(ref.rot_gf(torch.from_numpy(x), s)), _i64(want))


def test_fold_and_norm_match_jax_on_uint32():
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2**32, size=500, dtype=np.int64)
    u[:4] = [0, P, P + 1, 2**32 - 1]
    below_2p = u % (2 * P)
    np.testing.assert_array_equal(
        _i64(ref.fold31(torch.from_numpy(u))),
        _i64(jref.fold31(jnp.asarray(u.astype(np.uint32)))))
    np.testing.assert_array_equal(
        _i64(ref.norm31(torch.from_numpy(below_2p))),
        _i64(jref.norm31(jnp.asarray(below_2p.astype(np.uint32)))))


@pytest.mark.parametrize("dtype", [np.int32, np.int64, np.uint8, np.int8])
def test_to_gf_reduces_signed_ints_like_jax(dtype):
    info = np.iinfo(dtype)
    lo, hi = max(info.min, -(2**31) + 1), min(info.max, 2**31 - 1)
    x = np.random.default_rng(1).integers(lo, hi, size=200, endpoint=True).astype(dtype)
    x[:2] = [lo, hi]
    got = ref.to_gf(x)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(_i64(got), _i64(jref.to_gf(jnp.asarray(x))))
    np.testing.assert_array_equal(_i64(ref.to_gf(torch.from_numpy(x))), _i64(got))


# the edges of the kernel loaders' reduction: 2^32 = 2 (mod p), so no uint32
# reading of a negative value is its residue
_INT32_EDGES = [-(2**31), -(2**31) + 1, -P, -P + 1, -2, -1, 0, 1, 2, P - 2, P - 1, P]


@pytest.mark.parametrize("v", _INT32_EDGES)
def test_canonical_i32_equals_to_gf_on_the_edges(v):
    x = torch.tensor([v], dtype=torch.int32)
    got = ref.canonical_i32(x)
    assert got.dtype == torch.int32
    assert int(got) == int(ref.to_gf(x)) == v % P
    assert 0 <= int(got) < P


@settings(max_examples=300, deadline=None)
@given(v=st.integers(min_value=-(2**31), max_value=2**31 - 1))
def test_canonical_i32_equals_to_gf_on_any_int32(v):
    x = torch.tensor([v, -v - 1], dtype=torch.int32)         # -v - 1 stays in int32
    np.testing.assert_array_equal(_i64(ref.canonical_i32(x)), _i64(ref.to_gf(x)))


def test_canonical_i32_equals_jax_to_gf_on_a_block():
    x = np.random.default_rng(5).integers(-(2**31), 2**31, size=4096).astype(np.int32)
    x[: len(_INT32_EDGES)] = _INT32_EDGES
    got = ref.canonical_i32(torch.from_numpy(x))
    np.testing.assert_array_equal(_i64(got), _i64(jref.to_gf(jnp.asarray(x))))
    with pytest.raises(TypeError):
        ref.canonical_i32(torch.from_numpy(x.astype(np.int64)))


@pytest.mark.parametrize("bad", [np.zeros(3, np.float32), torch.zeros(3),
                                 torch.zeros(3, dtype=torch.bool)])
def test_to_gf_rejects_non_integers(bad):
    with pytest.raises(TypeError):
        ref.to_gf(bad)
    if isinstance(bad, np.ndarray):
        with pytest.raises(TypeError):
            jref.to_gf(bad)


# ---------------------------------------------------------------------------
# matmul_gf / bmm_gf on every CPU route
# ---------------------------------------------------------------------------

# c = 300 crosses one 256-wide K-chunk of the limb GEMM
_SHAPES = [(1, 1, 1), (5, 7, 3), (19, 37, 150), (8, 300, 9), (3, 513, 2)]


@pytest.mark.parametrize("m,c,n", _SHAPES)
def test_matmul_gf_routes_match_jax_and_numpy(m, c, n):
    rng = np.random.default_rng(m * 1000 + c + n)
    a, b = _residues(rng, (m, c)), _residues(rng, (c, n))
    want = jlag.matmul_modp(a, b)
    ja, jb = jgf.to_gf(a.astype(np.int32)), jgf.to_gf(b.astype(np.int32))
    np.testing.assert_array_equal(_i64(jgf.matmul_gf_dot(ja, jb)), want)
    np.testing.assert_array_equal(
        _i64(matmul_gf_pallas(ja, jb, block_m=8, block_n=128, block_k=16,
                              interpret=True)), want)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for route in (gf.matmul_gf, gf.matmul_gf_ref):
        got = route(ta, tb)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_i64(got), want, err_msg=route.__name__)
    got = gf.matmul_gf_dot(gf.to_gf(ta), gf.to_gf(tb))
    np.testing.assert_array_equal(_i64(got), want)


@pytest.mark.parametrize("lead,m,c,n", [((3,), 4, 300, 5), ((2, 2), 6, 11, 1)])
def test_bmm_gf_matches_jax_and_numpy(lead, m, c, n):
    rng = np.random.default_rng(c)
    a, b = _residues(rng, lead + (m, c)), _residues(rng, lead + (c, n))
    got = gf.bmm_gf(torch.from_numpy(a), torch.from_numpy(b))
    want_j = jgf.bmm_gf(a.astype(np.int32), b.astype(np.int32), impl="dot")
    np.testing.assert_array_equal(_i64(got), _i64(want_j))
    a2, b2 = a.reshape((-1, m, c)), b.reshape((-1, c, n))
    want = np.stack([jlag.matmul_modp(x, y) for x, y in zip(a2, b2)])
    np.testing.assert_array_equal(_i64(got).reshape(want.shape), want)


def test_matmul_gf_shape_errors():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        gf.matmul_gf(a, a)
    with pytest.raises(ValueError):
        gf.bmm_gf(a[None], a[None])


def test_limb_route_refuses_reduced_precision_matmuls():
    a = torch.from_numpy(_residues(np.random.default_rng(0), (4, 4)).astype(np.int32))
    before = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")       # TF32 allowed
        with pytest.raises(RuntimeError, match="true float32"):
            gf.matmul_gf_dot(a, a)
    finally:
        torch.set_float32_matmul_precision(before)
    assert gf.matmul_gf_dot(a, a).shape == (4, 4)


def _x_tilde(nr=5, rows=6, cols=9):
    rng = np.random.default_rng(nr + rows + cols)
    return torch.from_numpy(_residues(rng, (nr, rows, cols)).astype(np.int32))


@pytest.mark.parametrize("make,as_it_lies", [
    (lambda x: x, True),                                  # x~, contiguous
    (lambda x: x.transpose(1, 2), True),                  # x~^T: unit-stride rows
    (lambda x: x[::2], True),                             # a strided batch
    (lambda x: x[:, 1:, :7], True),                       # a window of rows and columns
    (lambda x: x.transpose(1, 2)[::2, 1:], True),
    (lambda x: x[:, ::2, ::2], False),                    # no unit-stride inner axis
    (lambda x: x.transpose(0, 2)[:, ::2], False),
], ids=["contiguous", "transposed", "batch-strided", "window", "transposed-strided",
        "both-strided", "batch-inner"])
def test_gf_kernel_layout_reads_views_as_they_lie_and_copies_the_rest(make, as_it_lies):
    from repro_torch.kernels.gf.kernel import kernel_layout, reads_as_it_lies
    from repro_torch.kernels.gf.ops import _card_operand
    t = make(_x_tilde())
    assert reads_as_it_lies(t) == as_it_lies
    laid = kernel_layout(t)
    assert torch.equal(laid, t)
    assert (laid is t) == as_it_lies
    if not as_it_lies:
        assert laid.is_contiguous()
    gf.reset_operand_passes()
    card = _card_operand(t)
    assert (card is t) == as_it_lies and torch.equal(card, t)
    copied = 0 if as_it_lies else t.numel()
    assert gf.operand_passes() == {"to_gf": 0, "contiguous": copied, "largest": copied}


def test_card_operands_of_other_integer_dtypes_go_through_to_gf():
    from repro_torch.kernels.gf.ops import _card_operand
    x = torch.tensor([[-1, P, 2**40, -(2**40) - 3]], dtype=torch.int64)
    gf.reset_operand_passes()
    got = _card_operand(x)
    assert got.dtype == torch.int32 and torch.equal(got, ref.to_gf(x))
    assert gf.operand_passes() == {"to_gf": 4, "contiguous": 0, "largest": 4}
    raw = torch.tensor([[-(2**31), -1, P]], dtype=torch.int32)
    assert _card_operand(raw) is raw                      # the kernel reduces int32 itself


def test_cpu_route_reduces_non_canonical_int32_views_like_numpy():
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(3, 40, 7)).astype(np.int32))
    x.view(-1)[: len(_INT32_EDGES)] = torch.tensor(_INT32_EDGES, dtype=torch.int32)
    r = torch.from_numpy(rng.integers(-(2**31), 2**31, size=(3, 40, 2)).astype(np.int32))
    gf.reset_operand_passes()
    got = gf.bmm_gf(x.transpose(1, 2), r)                # x~^T r, the deg-2 product
    x64, r64 = _i64(x) % P, _i64(r) % P
    want = np.stack([jlag.matmul_modp(a.T, b) for a, b in zip(x64, r64)])
    np.testing.assert_array_equal(_i64(got), want)
    assert gf.operand_passes() == {"to_gf": 0, "contiguous": 0, "largest": 0}   # the card only


def test_cuda_wrappers_refuse_cpu_tensors():
    a = torch.zeros((2, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA kernel"):
        gf.matmul_gf_cuda(a, a)
    with pytest.raises(ValueError, match="CUDA kernel"):
        gf.bmm_gf_cuda(a[None], a[None])


# ---------------------------------------------------------------------------
# Lagrange bases, generator and decode matrices
# ---------------------------------------------------------------------------

def test_lagrange_basis_gf_batched_matches_jax_and_numpy():
    rng = np.random.default_rng(9)
    x = rng.integers(0, P, size=7)
    nodes = np.stack([rng.choice(P, size=5, replace=False) for _ in range(6)]
                     ).reshape(2, 3, 5)
    got = gf.lagrange_basis_gf(torch.from_numpy(x), torch.from_numpy(nodes))
    assert got.shape == (2, 3, 7, 5) and got.dtype == torch.int32
    want_j = jgf.lagrange_basis_gf(jnp.asarray(x, jnp.int32), jnp.asarray(nodes, jnp.int32))
    np.testing.assert_array_equal(_i64(got), _i64(want_j))
    for idx in np.ndindex(2, 3):
        np.testing.assert_array_equal(
            _i64(got[idx]), jlag._lagrange_basis_modp(x, nodes[idx]))


_SPECS = [(5, 3, 4, 1), (4, 3, 3, 2), (3, 2, 5, 2)]   # the last: repetition


@pytest.mark.parametrize("spec_args", _SPECS)
def test_generator_matrices_match_jax(spec_args):
    spec, jspec = lagrange.CodeSpec(*spec_args), jlag.CodeSpec(*spec_args)
    assert spec.mode == jspec.mode and spec.recovery_threshold == jspec.recovery_threshold
    np.testing.assert_array_equal(lagrange.chunk_alpha_indices(spec),
                                  jlag.chunk_alpha_indices(jspec))
    g_np = lagrange.generator_matrix_modp(spec)
    np.testing.assert_array_equal(g_np, jlag.generator_matrix_modp(jspec))
    g_dev = lagrange.generator_matrix_modp_device(spec, device=CPU)
    assert g_dev.dtype == torch.int32
    np.testing.assert_array_equal(_i64(g_dev), _i64(jlag.generator_matrix_modp_device(jspec)))
    np.testing.assert_array_equal(_i64(g_dev), g_np)
    # float generator: the same float64 host basis rounded to float32
    np.testing.assert_array_equal(
        lagrange.generator_matrix(spec, device=CPU).numpy(),
        np.asarray(jlag.generator_matrix(jspec)))


@pytest.mark.parametrize("spec_args", _SPECS)
def test_decode_matrices_match_jax(spec_args):
    spec, jspec = lagrange.CodeSpec(*spec_args), jlag.CodeSpec(*spec_args)
    kstar = spec.recovery_threshold
    rng = np.random.default_rng(kstar)
    batch = np.stack([np.sort(rng.choice(spec.nr, size=kstar, replace=False))
                      for _ in range(4)])
    if spec.mode == "repetition":
        batch = np.stack([np.arange(spec.nr)[:kstar]] * 4)
    got = lagrange.decode_matrix_modp_device(spec, torch.from_numpy(batch))
    np.testing.assert_array_equal(
        _i64(got), _i64(jlag.decode_matrix_modp_device(jspec, jnp.asarray(batch, jnp.int32))))
    for rec, mat in zip(batch, got):
        np.testing.assert_array_equal(lagrange.decode_matrix_modp(spec, rec),
                                      jlag.decode_matrix_modp(jspec, rec))
        np.testing.assert_array_equal(_i64(mat), lagrange.decode_matrix_modp(spec, rec))
    rec = batch[0]
    np.testing.assert_array_equal(lagrange.decode_matrix(spec, rec, device=CPU).numpy(),
                                  np.asarray(jlag.decode_matrix(jspec, rec)))
    # float32 device basis: torch.prod and jnp.prod may multiply in other
    # orders, so within 1e-5 relative
    got_f = lagrange.decode_matrix_jax(spec, torch.from_numpy(rec))
    want_f = np.asarray(jlag.decode_matrix_jax(jspec, jnp.asarray(rec)))
    np.testing.assert_allclose(got_f.numpy(), want_f, rtol=1e-5, atol=1e-6)


def test_decode_matrix_rejects_bad_received_sets():
    spec = lagrange.CodeSpec(4, 3, 3, 2)
    with pytest.raises(ValueError, match="exactly K"):
        lagrange.decode_matrix(spec, [0, 1], device=CPU)
    with pytest.raises(ValueError, match="distinct"):
        lagrange.decode_matrix(spec, [0, 0, 1, 2, 3], device=CPU)


def test_float_points_and_encode_match_jax():
    np.testing.assert_array_equal(lagrange.beta_points(7, device=CPU).numpy(),
                                  np.asarray(jlag.beta_points(7)))
    np.testing.assert_array_equal(lagrange.alpha_points(9, device=CPU).numpy(),
                                  np.asarray(jlag.alpha_points(9)))
    rng = np.random.default_rng(2)
    g = rng.normal(size=(6, 3)).astype(np.float32)
    x = rng.normal(size=(3, 4, 5)).astype(np.float32)
    np.testing.assert_allclose(
        lagrange.encode(torch.from_numpy(g), torch.from_numpy(x)).numpy(),
        np.asarray(jlag.encode(jnp.asarray(g), jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    d = rng.normal(size=(3, 6)).astype(np.float32)
    np.testing.assert_allclose(
        lagrange.decode(torch.from_numpy(d), torch.from_numpy(x.reshape(6, 2, 5))).numpy(),
        np.asarray(jlag.decode(jnp.asarray(d), jnp.asarray(x.reshape(6, 2, 5)))),
        rtol=1e-6, atol=1e-6)
