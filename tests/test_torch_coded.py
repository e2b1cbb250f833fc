"""Parity of the port's coded-computing half (``repro_torch.core.coded_ops``,
the encode and coded-gradient kernels' plain versions, ``convert`` and the
ported regression example) with the JAX package, on the CPU.

Tolerances:
  * every GF(p) result equals the JAX package's to the bit;
  * the encode (B4) and fused-gradient (B5) plain versions are held to the
    Pallas kernels run in interpret mode within the float32 reduction-order
    bound 1e-5 * (|A| |B|), elementwise;
  * float decodes compare like with like (eager with eager, device with
    device); the decode amplifies float32 round-off of the chunk results by
    its conditioning, so at the small codes used here they agree to 1e-4
    relative.
"""

import os
import pathlib
import runpy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import coded_ops as jco
from repro.core import lagrange as jlag
from repro.core import throughput as jtp
from repro.core.lea import LoadParams as JLoadParams
from repro.kernels.coded_gradient import ops as jcg_ops
from repro.kernels.coded_gradient.kernel import coded_gradient_pallas
from repro.kernels.lagrange_encode import ops as jle_ops
from repro.kernels.lagrange_encode.kernel import encode_matrix_pallas
from repro_torch import convert
from repro_torch.core import coded_ops, lagrange, throughput
from repro_torch.core.lea import LoadParams
from repro_torch.examples import coded_regression
from repro_torch.kernels import coded_gradient, lagrange_encode
from test_torch_engine import JaxDraws, _key

ROOT = pathlib.Path(__file__).resolve().parents[1]
P = lagrange.FIELD_P
CPU = "cpu"


def _i64(t):
    return np.asarray(t).astype(np.int64)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------------------------
# B4 / B5 plain versions against the Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nr,k,cols", [(6, 3, 50), (150, 8, 300), (7, 5, 129),
                                       (10, 64, 300), (5, 17, 33), (3, 16, 7)])
def test_encode_plain_matches_pallas_interpret(nr, k, cols):
    rng = np.random.default_rng(nr + k)
    g = rng.normal(size=(nr, k)).astype(np.float32)
    x = rng.normal(size=(k, cols)).astype(np.float32)
    want = np.asarray(encode_matrix_pallas(jnp.asarray(g), jnp.asarray(x),
                                           block_n=128, interpret=True))
    bound = 1e-5 * (np.abs(g) @ np.abs(x)) + 1e-30
    for got in (lagrange_encode.encode_matrix_ref(_t(g), _t(x)),
                lagrange_encode.encode_matrix(_t(g), _t(x))):
        assert got.shape == (nr, cols) and got.dtype == torch.float32
        assert (np.abs(got.numpy() - want) <= bound).all()
    x3 = x.reshape(k, -1, cols // 2 if cols % 2 == 0 else cols)
    got3 = lagrange_encode.encode(_t(g), _t(x3))
    want3 = np.asarray(jle_ops.encode(jnp.asarray(g), jnp.asarray(x3), interpret=True))
    assert got3.shape == want3.shape
    np.testing.assert_allclose(got3.numpy(), want3, rtol=0, atol=float(bound.max()))


# (2, 4096, 8, 4): a 64 KB residual a chunk, past the 48 KB a block takes
# without opting in, which the JAX wrapper accepts; (3, 37, 130, 2): the rows
# route splits each chunk's 37 rows 32 + 5 over a cluster of two blocks
@pytest.mark.parametrize("nr,r_rows,c,p", [(4, 6, 9, 1), (3, 5, 7, 2), (5, 12, 130, 1),
                                           (2, 4096, 8, 4), (3, 37, 130, 2)])
def test_coded_gradient_plain_matches_pallas_interpret(nr, r_rows, c, p):
    rng = np.random.default_rng(nr * c)
    x = rng.normal(size=(nr, r_rows, c)).astype(np.float32)
    y = rng.normal(size=(nr, r_rows, p)).astype(np.float32)
    w = rng.normal(size=(c, p)).astype(np.float32)
    want = np.asarray(coded_gradient_pallas(jnp.asarray(x), jnp.asarray(y),
                                            jnp.asarray(w), interpret=True))
    ax = np.abs(x)
    bound = 1e-5 * (np.swapaxes(ax, 1, 2) @ (ax @ np.abs(w) + np.abs(y)))
    for got in (coded_gradient.coded_gradient_ref(_t(x), _t(y), _t(w)),
                coded_gradient.coded_gradient(_t(x), _t(y), _t(w))):
        assert got.shape == (nr, c, p)
        assert (np.abs(got.numpy() - want) <= bound).all()
    if p == 1:   # the ops wrapper's vector squeeze, in both packages
        got_v = coded_gradient.coded_gradient(_t(x), _t(y[..., 0]), _t(w[:, 0]))
        want_v = np.asarray(jcg_ops.coded_gradient(
            jnp.asarray(x), jnp.asarray(y[..., 0]), jnp.asarray(w[:, 0]), interpret=True))
        assert got_v.shape == want_v.shape == (nr, c)
        assert (np.abs(got_v.numpy() - want_v) <= bound[..., 0]).all()


# (R, C, P) -> route: the four shapes chip_smoke.py times, and both sides of
# the switch-over at each P tile (C * next_pow2(P) <= 4096 and P <= 8)
@pytest.mark.parametrize("r_rows,c,p,want", [
    (60, 3000, 1, "rows"), (13, 301, 3, "rows"), (4096, 8, 4, "rows"), (65_536, 8, 1, "rows"),
    (16, 4096, 1, "rows"), (16, 4097, 1, "chunk"), (16, 2048, 2, "rows"), (16, 2049, 2, "chunk"),
    (16, 1024, 3, "rows"), (16, 1025, 4, "chunk"), (16, 512, 8, "rows"), (16, 513, 5, "chunk"),
    (200, 4, 8, "rows"), (200, 4, 9, "chunk"), (200, 4, 70, "chunk"), (0, 8, 1, "rows")])
def test_gradient_route_follows_the_shape_alone(r_rows, c, p, want):
    assert coded_gradient.gradient_route(r_rows, c, p) == want


def _rows_route(x, y, w, plan):
    """The rows route's partition in numpy float32: block q of a chunk's
    cluster takes rows [q rows_per_block, (q + 1) rows_per_block), sums
    x_r^T (x_r w - y_r) over them, and the cluster adds the blocks'
    partials in rank order."""
    nr, r_rows, c = x.shape
    out = np.zeros((nr, c, w.shape[1]), np.float32)
    for v in range(nr):
        for q in range(plan.cluster):
            lo = min(r_rows, q * plan.rows_per_block)
            hi = min(r_rows, lo + plan.rows_per_block)
            part = np.zeros_like(out[v])
            for r in range(lo, hi):
                resid = x[v, r] @ w - y[v, r]
                part += np.outer(x[v, r], resid)
            out[v] += part
    return out


@pytest.mark.parametrize("nr,r_rows,c,p,vec", [(150, 60, 3000, 1, 4), (7, 13, 301, 3, 1),
                                               (2, 4096, 8, 4, 4), (2, 65_536, 8, 1, 4),
                                               (3, 37, 130, 2, 1), (4, 1, 33, 2, 1),
                                               (2, 16, 4096, 1, 4), (2, 16, 4096, 1, 1),
                                               (1, 10, 512, 8, 4), (3, 0, 8, 1, 4)])
def test_row_plan_covers_every_row_and_column_once(nr, r_rows, c, p, vec):
    vec = coded_gradient.kernel.row_vec(c, p, aligned=vec == 4)
    plan = coded_gradient.row_plan(nr, r_rows, c, p, vec)
    pt = coded_gradient.kernel.p_tile(p)
    assert plan.tc & (plan.tc - 1) == 0 and 1 <= plan.tc <= 256 and plan.tr * plan.tc == 256
    assert plan.k * plan.vec * pt <= 16 and 1 <= plan.cluster <= 8
    assert plan.rows_per_block % plan.tr == 0 and plan.rows_per_block * plan.cluster >= r_rows
    cols = sorted((tc + plan.tc * k) * vec + e for tc in range(plan.tc) for k in range(plan.k)
                  for e in range(vec) if (tc + plan.tc * k) * vec + e < c)
    assert cols == list(range(c))
    if (nr, r_rows, c, p) == (150, 60, 3000, 1):     # 600 blocks of 15 rows, 1 a step
        assert plan == (4, 256, 3, 1, 4, 15)
    if r_rows and nr * c <= 3000:
        rng = np.random.default_rng(c + p)
        x = rng.normal(size=(nr, r_rows, c)).astype(np.float32)
        y = rng.normal(size=(nr, r_rows, p)).astype(np.float32)
        w = rng.normal(size=(c, p)).astype(np.float32)
        ax = np.abs(x)
        bound = 1e-5 * (np.swapaxes(ax, 1, 2) @ (ax @ np.abs(w) + np.abs(y)))
        want = coded_gradient.coded_gradient_ref(_t(x), _t(y), _t(w)).numpy()
        assert (np.abs(_rows_route(x, y, w, plan) - want) <= bound).all()


def test_coded_gradient_footprint_raises_in_both_packages():
    x = np.zeros((1, 1100, 3000), np.float32)     # 13.2 MB > the 12 MiB budget
    y, w = np.zeros((1, 1100, 1), np.float32), np.zeros((3000, 1), np.float32)
    with pytest.raises(ValueError, match="VMEM budget"):
        coded_gradient_pallas(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w),
                              interpret=True)
    with pytest.raises(ValueError, match="VMEM budget"):
        coded_gradient.coded_gradient(_t(x), _t(y), _t(w))
    with pytest.raises(ValueError, match="CUDA kernel"):
        coded_gradient.coded_gradient_cuda(_t(x[:, :2]), _t(y[:, :2]), _t(w))
    with pytest.raises(ValueError, match="CUDA kernel"):
        lagrange_encode.encode_matrix_cuda(_t(w.T.copy()), _t(w))


@pytest.mark.parametrize("k,cols,aligned,want", [
    (8, 180_000, True, "stream"), (5, 180_000, True, "stream"), (16, 4, True, "stream"),
    (5, 1001, True, "stream_scalar"), (8, 180_000, False, "stream_scalar"),
    (1, 3, True, "stream_scalar"), (17, 1000, True, "tiled"), (64, 2048, True, "tiled"),
    (0, 100, True, "tiled"),
])
def test_encode_route_follows_k_columns_and_alignment(k, cols, aligned, want):
    assert lagrange_encode.encode_route(k, cols, aligned=aligned) == want


# ---------------------------------------------------------------------------
# the exact GF(p) rounds
# ---------------------------------------------------------------------------

def _masks(rng, nr, kstar, count):
    """``count`` random on-time masks with >= K* survivors, then one short."""
    masks = []
    for _ in range(count):
        m = np.zeros(nr, bool)
        m[rng.choice(nr, size=rng.integers(kstar, nr + 1), replace=False)] = True
        masks.append(m)
    short = np.zeros(nr, bool)
    short[: kstar - 1] = True
    return masks + [short]


@pytest.mark.parametrize("deg_f,d", [(1, 2), (1, 1), (2, 1), (2, 3)])
def test_exact_rounds_equal_jax_bit_for_bit(deg_f, d):
    spec_args = (4, 3, 3, deg_f)
    spec, jspec = lagrange.CodeSpec(*spec_args), jlag.CodeSpec(*spec_args)
    rng = np.random.default_rng(deg_f * 10 + d)
    rows, cols = 5, 7
    x = rng.integers(-P + 1, P, size=(spec.k, rows, cols))
    y = rng.integers(0, P, size=(spec.k, rows))
    x[0, 0, :3] = [0, P - 1, -1]
    w = rng.integers(0, P, size=(cols, d) if d > 1 else (cols,))
    coded = coded_ops.encode_dataset_modp(spec, x, y, device=CPU)
    jcoded = jco.encode_dataset_modp(jspec, jnp.asarray(x % P, jnp.int32),
                                     jnp.asarray(y, jnp.int32))
    np.testing.assert_array_equal(_i64(coded.x_tilde), _i64(jcoded.x_tilde))
    np.testing.assert_array_equal(_i64(coded.y_tilde), _i64(jcoded.y_tilde))
    run, jrun = ((coded_ops.coded_matmul_exact, jco.coded_matmul_exact)
                 if deg_f == 1 else
                 (coded_ops.coded_linear_gradient_modp, jco.coded_linear_gradient_modp))
    for on in _masks(rng, spec.nr, spec.recovery_threshold, 3):
        out, ok = run(coded, _t(w), _t(on))
        jout, jok = jrun(jcoded, jnp.asarray(w, jnp.int32), jnp.asarray(on))
        assert bool(ok) == bool(jok) == (on.sum() >= spec.recovery_threshold)
        if bool(ok):
            assert out.dtype == torch.int32
            np.testing.assert_array_equal(_i64(out), _i64(jout))


def test_exact_deg1_round_equals_numpy_oracle():
    spec = lagrange.CodeSpec(5, 3, 4, 1)
    rng = np.random.default_rng(4)
    x = rng.integers(0, P, size=(spec.k, 6, 9))
    w = rng.integers(0, P, size=(9, 2))
    coded = coded_ops.encode_dataset_modp(spec, x, device=CPU)
    on = _masks(rng, spec.nr, spec.recovery_threshold, 1)[0]
    out, ok = coded_ops.coded_matmul_exact(coded, w, on)
    xt = lagrange.matmul_modp(lagrange.generator_matrix_modp(spec), x.reshape(spec.k, -1))
    res = lagrange.matmul_modp(xt.reshape(spec.nr * 6, 9), w).reshape(spec.nr, 6, 2)
    rec = np.nonzero(on)[0][: spec.recovery_threshold]
    want = lagrange.matmul_modp(lagrange.decode_matrix_modp(spec, rec), res[rec])
    assert bool(ok)
    np.testing.assert_array_equal(_i64(out), want)
    np.testing.assert_array_equal(_i64(coded.x_tilde).reshape(spec.nr, -1), xt)


# ---------------------------------------------------------------------------
# the float path, like with like
# ---------------------------------------------------------------------------

def _float_data(spec, rows=6, cols=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(spec.k, rows, cols)).astype(np.float32)
    y = rng.normal(size=(spec.k, rows)).astype(np.float32)
    w = rng.normal(size=(cols,)).astype(np.float32)
    return rng, x, y, w


def test_encode_dataset_default_is_the_routed_plain_version():
    spec = lagrange.CodeSpec(4, 3, 3, 2)
    _, x, y, _ = _float_data(spec)
    routed = coded_ops.encode_dataset(spec, _t(x), _t(y))
    plain = coded_ops.encode_dataset(spec, _t(x), _t(y), encode_fn=lagrange.encode)
    jcoded = jco.encode_dataset(jlag.CodeSpec(4, 3, 3, 2), jnp.asarray(x), jnp.asarray(y))
    for got in (routed, plain):
        np.testing.assert_allclose(got.x_tilde.numpy(), np.asarray(jcoded.x_tilde),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got.y_tilde.numpy(), np.asarray(jcoded.y_tilde),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("deg_f", [1, 2])
def test_float_coded_ops_match_jax_like_with_like(deg_f):
    spec_args = (4, 3, 3, deg_f)
    spec, jspec = lagrange.CodeSpec(*spec_args), jlag.CodeSpec(*spec_args)
    rng, x, y, w = _float_data(spec, seed=deg_f)
    coded = coded_ops.encode_dataset(spec, _t(x), _t(y))
    jcoded = jco.encode_dataset(jspec, jnp.asarray(x), jnp.asarray(y))
    cache, jcache = coded_ops.DecodeCache(spec), jco.DecodeCache(jspec)
    tol = dict(rtol=1e-4, atol=1e-4)
    for on in _masks(rng, spec.nr, spec.recovery_threshold, 3)[:-1]:
        if deg_f == 1:
            eager = coded_ops.coded_matmul(coded, _t(w), on, cache=cache)
            jeager = jco.coded_matmul(jcoded, jnp.asarray(w), on, cache=jcache)
            dev, ok = coded_ops.coded_matmul_device(coded, _t(w), _t(on))
            jdev, jok = jco.coded_matmul_device(jcoded, jnp.asarray(w), jnp.asarray(on))
            want = np.einsum("krc,c->kr", x, w)
        else:
            eager = coded_ops.coded_linear_gradient(coded, _t(w), on, cache=cache)
            jeager = jco.coded_linear_gradient(jcoded, jnp.asarray(w), on, cache=jcache)
            dev, ok = coded_ops.coded_linear_gradient_device(coded, _t(w), _t(on))
            jdev, jok = jco.coded_linear_gradient_device(jcoded, jnp.asarray(w),
                                                         jnp.asarray(on))
            want = np.asarray(jco.uncoded_linear_gradient(
                jnp.asarray(x), jnp.asarray(y), jnp.asarray(w)))
            np.testing.assert_allclose(
                coded_ops.uncoded_linear_gradient(_t(x), _t(y), _t(w)).numpy(), want,
                rtol=1e-5, atol=1e-5)
        assert bool(ok) and bool(jok)
        np.testing.assert_allclose(eager.numpy(), np.asarray(jeager), **tol)
        np.testing.assert_allclose(dev.numpy(), np.asarray(jdev), **tol)
        np.testing.assert_allclose(eager.numpy(), want, rtol=1e-3, atol=1e-3)
    assert cache.misses == jcache.misses and cache.hits == jcache.hits


def test_decode_caches_hit_on_repeated_patterns():
    spec = lagrange.CodeSpec(4, 3, 3, 1)
    on = np.zeros(spec.nr, bool)
    on[[0, 4, 7, 9]] = True
    cache, mcache = coded_ops.DecodeCache(spec), coded_ops.ModpDecodeCache(spec)
    for _ in range(3):
        rec, d = cache.from_on_time(on, device=CPU)
        rec_m, dm = mcache.from_on_time(on, device=CPU)
    np.testing.assert_array_equal(rec, [0, 4, 7])
    np.testing.assert_array_equal(rec_m, rec)
    assert (cache.misses, cache.hits, len(cache)) == (1, 2, 1)
    assert (mcache.misses, mcache.hits, len(mcache)) == (1, 2, 1)
    np.testing.assert_array_equal(_i64(dm), lagrange.decode_matrix_modp(spec, rec))
    cache.matrix(rec, torch.float64, device=CPU)          # dtype is in the key
    assert cache.misses == 2


def test_short_rounds_raise_timeout_or_report_not_ok():
    spec_args = (4, 3, 3, 2)
    spec, jspec = lagrange.CodeSpec(*spec_args), jlag.CodeSpec(*spec_args)
    _, x, y, w = _float_data(spec)
    coded = coded_ops.encode_dataset(spec, _t(x), _t(y))
    jcoded = jco.encode_dataset(jspec, jnp.asarray(x), jnp.asarray(y))
    short = np.zeros(spec.nr, bool)
    short[:3] = True
    with pytest.raises(TimeoutError) as jerr:
        jco.coded_linear_gradient(jcoded, jnp.asarray(w), short)
    eager = [lambda: coded_ops.coded_linear_gradient(coded, _t(w), short),
             lambda: coded_ops.coded_matmul(coded, _t(w), short),
             lambda: coded_ops.DecodeCache(spec).from_on_time(short, device=CPU),
             lambda: coded_ops.ModpDecodeCache(spec).from_on_time(short, device=CPU)]
    for call in eager:
        with pytest.raises(TimeoutError) as err:
            call()
        assert str(err.value) == str(jerr.value)
    _, ok = coded_ops.coded_linear_gradient_device(coded, _t(w), _t(short))
    _, ok_m = coded_ops.coded_matmul_device(coded, _t(w), _t(short))
    assert not bool(ok) and not bool(ok_m)


def test_received_indices_match_jax():
    rng = np.random.default_rng(3)
    masks = rng.random((6, 30)) < 0.5
    masks[0] = True
    for on in masks:
        kstar = max(1, int(on.sum()) // 2)
        got = coded_ops.received_indices(_t(on), kstar)
        want = jco.received_indices(jnp.asarray(on), kstar)
        np.testing.assert_array_equal(_i64(got), _i64(want))
    batched = coded_ops.received_indices(_t(masks), 3)
    assert batched.shape == (6, 3)


# ---------------------------------------------------------------------------
# erasure patterns from the engine
# ---------------------------------------------------------------------------

LP = LoadParams(n=15, kstar=99, ell_g=10, ell_b=3)


@pytest.mark.parametrize("deadline", [1.0, 0.7])
def test_chunk_on_time_matches_jax_and_engine_success(deadline):
    p = ([0.8] * 15, [0.533] * 15)
    rounds, strategies = 150, ("lea", "static")
    states, loads, feas = throughput.rollout(
        JaxDraws(_key(3)[None]), LP, *p, rounds, strategies, device=CPU)
    jlp = JLoadParams(15, 99, 10, 3)
    jstates, jloads, _ = jtp.rollout(_key(3), jlp, *map(jnp.asarray, p), rounds,
                                     strategies=strategies)
    masks = coded_ops.chunk_on_time(states, loads, 10.0, 3.0, deadline, 10)
    jmasks = jco.chunk_on_time(jstates, jloads, 10.0, 3.0, deadline, 10)
    assert masks.shape == (2, rounds, 150) and masks.dtype == torch.bool
    np.testing.assert_array_equal(masks.numpy(), np.asarray(jmasks))
    success = throughput.score_rollout(states, loads, feas, LP, 10.0, 3.0, deadline)
    from_masks = (masks.sum(dim=-1) >= LP.kstar) & feas
    np.testing.assert_array_equal(from_masks.T.numpy(), success.numpy())


# ---------------------------------------------------------------------------
# carrying the JAX package's encoded data across; the ported example
# ---------------------------------------------------------------------------

def test_convert_coded_dataset_carries_both_paths():
    spec_args = (4, 3, 3, 2)
    jspec = jlag.CodeSpec(*spec_args)
    rng, x, y, w = _float_data(lagrange.CodeSpec(*spec_args))
    jfloat = jco.encode_dataset(jspec, jnp.asarray(x), jnp.asarray(y))
    host = type("Host", (), {"spec": jfloat.spec, "x_tilde": np.asarray(jfloat.x_tilde),
                             "y_tilde": np.asarray(jfloat.y_tilde)})
    got = convert.coded_dataset(host, device=CPU)
    assert isinstance(got, coded_ops.CodedDataset)
    assert got.spec == lagrange.CodeSpec(*spec_args)
    np.testing.assert_array_equal(got.x_tilde.numpy(), host.x_tilde)
    assert isinstance(convert.to_torch(host, device=CPU), coded_ops.CodedDataset)

    xi = rng.integers(0, P, size=(3, 5, 7))
    yi = rng.integers(0, P, size=(3, 5))
    wi = rng.integers(0, P, size=(7,))
    jexact = jco.encode_dataset_modp(jspec, jnp.asarray(xi, jnp.int32), jnp.asarray(yi, jnp.int32))
    host_x = type("Host", (), {"spec": jexact.spec, "x_tilde": np.asarray(jexact.x_tilde),
                               "y_tilde": np.asarray(jexact.y_tilde)})
    exact = convert.coded_dataset(host_x, device=CPU)
    assert isinstance(exact, coded_ops.CodedDatasetModp)
    assert exact.x_tilde.dtype == torch.int32
    on = np.ones(12, bool)
    out, ok = coded_ops.coded_linear_gradient_modp(exact, wi, on)
    jout, _ = jco.coded_linear_gradient_modp(jexact, jnp.asarray(wi, jnp.int32), jnp.asarray(on))
    assert bool(ok)
    np.testing.assert_array_equal(_i64(out), _i64(jout))


def test_ported_example_matches_the_jax_example_flow(monkeypatch, capsys):
    rounds = 40
    monkeypatch.setenv("REPRO_EXAMPLE_ROUNDS", str(rounds))
    jflow = runpy.run_path(str(ROOT / "examples" / "coded_regression.py"))
    capsys.readouterr()
    res = coded_regression.run(device=CPU, rounds=rounds,
                               draws=JaxDraws(_key(0)[None]))
    assert res["throughput"]["lea"] == jflow["tput_lea"]
    assert res["throughput"]["static_equal"] == jflow["tput_static"]
    assert res["exact_checked"] == 6
    assert os.environ["REPRO_EXAMPLE_ROUNDS"] == str(rounds)
