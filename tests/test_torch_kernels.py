"""The Poisson-binomial kernel package of the port against the JAX package,
and the port's routing rules.

On the CPU every tensor takes the plain PyTorch version, which is held to
the JAX package's reference DP, its Pallas kernels run in interpret mode
(static thresholds B2, per-row thresholds B1) and exhaustive enumeration.
The CUDA kernel itself only runs on the card: ``test_torch_cuda.py`` holds
its tests, which skip here.
"""

import ast
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lea as jlea
from repro.kernels.poisson_binomial import (success_tails_pallas,
                                            success_tails_pallas_w)
from repro.kernels.poisson_binomial import success_tails_ref as jax_ref
from repro_torch import convert, resolve_device
from repro_torch.core import lea
from repro_torch.core.lea import LoadParams
from repro_torch.kernels import dispatch
from repro_torch.kernels.poisson_binomial import (launch_counts,
                                                  reset_launch_counts,
                                                  success_tails,
                                                  success_tails_cuda,
                                                  success_tails_cuda_w,
                                                  success_tails_ref)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATOL = 1e-6   # float32 round-off of sums of at most n + 1 pmf terms


def _probs(rng, b, n):
    return np.sort(rng.uniform(0, 1, (b, n)).astype(np.float32), axis=-1)[:, ::-1].copy()


def _random_lp(rng, n) -> LoadParams:
    ell_b = int(rng.integers(1, 4))
    ell_g = ell_b + int(rng.integers(1, 8))
    kstar = int(rng.integers(n * ell_b + 1, n * ell_g + 1))
    return LoadParams(n=n, kstar=kstar, ell_g=ell_g, ell_b=ell_b)


# ---------------------------------------------------------------------------
# plain version against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,b", [(1, 5), (4, 64), (15, 2048), (30, 512)])
def test_ref_matches_jax_ref_rowwise_and_shared(n, b):
    rng = np.random.default_rng(n)
    p = _probs(rng, b, n)
    w = rng.integers(-2, n + 2, size=(b, n)).astype(np.int32)
    for thresholds in (w, w[0]):
        want = np.array(jax_ref(jnp.asarray(p), jnp.asarray(thresholds)))
        got = success_tails_ref(torch.from_numpy(p), torch.from_numpy(thresholds))
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_ref_repeats_xla_arithmetic_to_the_bit_at_paper_widths():
    """The fused step and sequential tail sums reproduce XLA's CPU result."""
    rng = np.random.default_rng(0)
    for n in (15, 30):
        p = _probs(rng, 4000, n)
        w = rng.integers(-2, n + 2, size=(4000, n)).astype(np.int32)
        want = np.array(jax_ref(jnp.asarray(p), jnp.asarray(w)))
        got = success_tails_ref(torch.from_numpy(p), torch.from_numpy(w)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,b", [(3, 7), (15, 300), (24, 33)])
def test_ref_matches_pallas_interpret_static_b2(n, b):
    rng = np.random.default_rng(100 + n)
    lp = _random_lp(rng, n)
    w = tuple(int(v) for v in lea.prefix_thresholds(lp))
    p = _probs(rng, b, n)
    want = np.array(success_tails_pallas(jnp.asarray(p), w, interpret=True))
    got = success_tails_ref(torch.from_numpy(p), torch.tensor(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n,b", [(2, 9), (15, 300), (24, 40)])
def test_ref_matches_pallas_interpret_rowwise_b1(n, b):
    rng = np.random.default_rng(200 + n)
    p = _probs(rng, b, n)
    w = rng.integers(-2, n + 2, size=(b, n)).astype(np.int32)
    want = np.array(success_tails_pallas_w(jnp.asarray(p), jnp.asarray(w),
                                           interpret=True))
    got = success_tails_ref(torch.from_numpy(p), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("n", [1, 5, 10])
def test_ref_matches_bruteforce(n):
    rng = np.random.default_rng(300 + n)
    lp = _random_lp(rng, n)
    p = _probs(rng, 3, n)
    got = success_tails_ref(torch.from_numpy(p), torch.tensor(lea.prefix_thresholds(lp)))
    for row in range(3):
        for i in range(1, n + 1):
            want = lea.success_prob_bruteforce(p[row], lp, i)
            assert abs(float(got[row, i - 1]) - want) <= 1e-5


# ---------------------------------------------------------------------------
# thresholds: exact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_prefix_thresholds_match_jax_exactly(seed):
    rng = np.random.default_rng(seed)
    for n in (1, 3, 15, 40):
        lp = _random_lp(rng, n)
        jlp = jlea.LoadParams(lp.n, lp.kstar, lp.ell_g, lp.ell_b)
        np.testing.assert_array_equal(lea.prefix_thresholds(lp),
                                      jlea.prefix_thresholds(jlp))
    b, n = 64, 20
    ks = rng.integers(-30, 200, b).astype(np.int32)
    eg = rng.integers(1, 12, b).astype(np.int32)
    eb = rng.integers(0, 5, b).astype(np.int32)
    nv = rng.integers(0, n + 1, b).astype(np.int32)
    want = np.array(jlea.prefix_thresholds_traced(*map(jnp.asarray, (ks, eg, eb, nv)), n))
    got = lea.prefix_thresholds_traced(*map(torch.from_numpy, (ks, eg, eb, nv)), n)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# allocation: exact except counted near-ties
# ---------------------------------------------------------------------------

def _near_tie_rows(probs_sorted_tails: np.ndarray) -> np.ndarray:
    """Rows whose two best prefix probabilities lie within 1e-6."""
    top2 = np.sort(probs_sorted_tails, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= 1e-6


@pytest.mark.parametrize("inputs", ["random", "ties"])
def test_allocate_matches_jax_with_near_ties_counted(inputs):
    rng = np.random.default_rng(5)
    n, b = 15, 4000
    jlp = jlea.LoadParams(15, 99, 10, 3)
    if inputs == "ties":   # LEA's round-0 0.5s and quantised count estimates
        p = rng.choice(np.float32([0.5, 1 / 3, 2 / 3, 0.25, 0.75]), (b, n))
    else:
        p = rng.uniform(0, 1, (b, n)).astype(np.float32)
    jloads, jistar = map(np.array, jlea.allocate(jnp.asarray(p), jlp))
    loads, istar = lea.allocate(torch.from_numpy(p), convert.load_params(jlp))
    flips = np.flatnonzero((istar.numpy() != jistar)
                           | (loads.numpy() != jloads).any(-1))
    tails = np.array(jlea.success_prob_all_prefixes(
        jnp.sort(jnp.asarray(p), axis=-1)[:, ::-1], jlp))
    assert _near_tie_rows(tails)[flips].all()      # a flip is only a near-tie
    assert flips.size == 0, f"{flips.size} near-tie allocation flips"


@pytest.mark.parametrize("inputs", ["random", "ties"])
def test_allocate_masked_matches_jax_with_near_ties_counted(inputs):
    rng = np.random.default_rng(6)
    b, n = 3000, 20
    if inputs == "ties":
        p = rng.choice(np.float32([0.5, 0.25, 0.75]), (b, n))
    else:
        p = rng.uniform(0, 1, (b, n)).astype(np.float32)
    n_valid = rng.integers(0, n + 1, b)
    jpool = jlea.PoolLoad(
        kstar=jnp.asarray(rng.integers(1, 120, b), jnp.int32),
        ell_g=jnp.asarray(rng.integers(4, 10, b), jnp.int32),
        ell_b=jnp.asarray(rng.integers(1, 4, b), jnp.int32),
        mask=jnp.asarray(np.arange(n)[None] < n_valid[:, None]),
    )
    jloads, jistar, jfeas = map(np.array, jlea.allocate_masked(jnp.asarray(p), jpool))
    loads, istar, feas = lea.allocate_masked(torch.from_numpy(p),
                                             convert.pool_load(jpool, device="cpu"))
    np.testing.assert_array_equal(feas.numpy(), jfeas)
    flips = np.flatnonzero((istar.numpy() != jistar)
                           | (loads.numpy() != jloads).any(-1))
    assert flips.size == 0, f"{flips.size} near-tie allocation flips"


def test_full_width_masked_allocation_equals_static():
    rng = np.random.default_rng(7)
    p = torch.from_numpy(rng.uniform(0, 1, (500, 15)).astype(np.float32))
    lp = LoadParams(15, 99, 10, 3)
    loads_s, istar_s = lea.allocate(p, lp)
    loads_m, istar_m, feas = lea.allocate_masked(p, lea.pool_load(lp, device="cpu"))
    assert torch.equal(loads_s, loads_m) and torch.equal(istar_s, istar_m)
    assert bool(feas.all())


# ---------------------------------------------------------------------------
# routing: CPU tensors -> plain version; nothing falls back on CUDA
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_launching():
    reset_launch_counts()
    rng = np.random.default_rng(8)
    p = torch.from_numpy(_probs(rng, 50, 15))
    w = torch.from_numpy(rng.integers(-2, 17, (50, 15)).astype(np.int32))
    assert dispatch.route(p) == dispatch.PLAIN
    assert torch.equal(success_tails(p, w), success_tails_ref(p, w))
    assert torch.equal(success_tails(p, tuple(w[0].tolist())),
                       success_tails_ref(p, w[0]))
    assert launch_counts() == {"success_tails_cuda": 0, "success_tails_cuda_w": 0}


def test_cuda_entry_points_refuse_cpu_tensors():
    p = torch.rand(4, 15)
    with pytest.raises(ValueError, match="CUDA kernel"):
        success_tails_cuda(p, (1,) * 15)
    with pytest.raises(ValueError, match="CUDA kernel"):
        success_tails_cuda_w(p, torch.ones(4, 15, dtype=torch.int32))


def test_default_device_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device resolves")
    from repro_torch import sweeps
    from repro_torch.core import throughput

    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        throughput.compare(0, LoadParams(15, 99, 10, 3), [0.8] * 15,
                           [0.7] * 15, 10.0, 3.0, 1.0, 10)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweeps.run("fig3", rounds=10)


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_and_chip_smoke_import_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    offenders = [
        (str(f.relative_to(ROOT)), mod)
        for f in files for mod in _imported_modules(f)
        if mod.split(".")[0] in ("jax", "jaxlib", "repro")
    ]
    assert not offenders, offenders
