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
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lea as jlea
from repro.kernels.poisson_binomial import (success_tails_pallas,
                                            success_tails_pallas_w)
from repro.kernels.poisson_binomial import success_tails_ref as jax_ref
from repro.kernels.poisson_binomial.ops import success_tails as jax_success_tails
from repro_torch import convert, resolve_device
from repro_torch.core import lea
from repro_torch.core.lea import LoadParams
from repro_torch.kernels import dispatch
from repro_torch.kernels.poisson_binomial import (launch_counts,
                                                  reset_launch_counts,
                                                  success_tails,
                                                  success_tails_cuda,
                                                  success_tails_cuda_w,
                                                  success_tails_ref,
                                                  threshold_geometry)
from repro_torch.kernels.poisson_binomial.kernel import MAX_LEAD

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
# thresholds read as they lie: the kernel's view of a broadcast tensor
# ---------------------------------------------------------------------------

def _view_values(base, offset, geometry, block):
    """The thresholds the CUDA kernel reads for every row, by its own index
    arithmetic (pb_tails_regs: a block's distinct rows b // rep loaded once,
    each at sum ((b // div) % size) * stride), from the 1-D ``base`` the view
    lies in at ``offset``."""
    rows, n = geometry.rows, geometry.n
    b = np.arange(rows, dtype=np.int64)
    row0 = b // block * block
    u0 = row0 // geometry.rep
    last = np.minimum(row0 + block, rows) - 1
    assert (last // geometry.rep - u0 + 1 <= block).all()   # slots fit the block
    u = u0 + (b // geometry.rep - u0)                          # the thread's slot
    off = np.zeros(rows, dtype=np.int64)
    for div, size, stride in geometry.axes:
        off += (u * geometry.rep // div) % size * stride
    idx = offset + off[:, None] + np.arange(n) * geometry.last_stride
    return base.numpy()[idx]


# (probs shape, w shape, w strides or None for contiguous, rep, axes)
GEOMETRY_CASES = {
    "engine (1, B, 1, n) over (S, B, m, n)": ((2, 7, 50, 15), (1, 7, 1, 15), None, 50,
                                              ((50, 7, 15),)),
    "static tuple": ((40, 15), (15,), None, 40, ()),
    "static over a batch": ((3, 4, 5, 9), (9,), None, 60, ()),
    "full per-row thresholds": ((300, 15), (300, 15), None, 1, ((1, 300, 15),)),
    "leading-axis broadcast": ((3, 300, 15), (300, 15), None, 1, ((1, 300, 15),)),
    "transposed per-row view": ((6, 4, 9), (6, 4, 9), (9, 54, 1), 1, ((4, 6, 9), (1, 4, 54))),
    "one threshold a row": ((8, 5, 6), (8, 1, 1), (1, 1, 1), 5, ((5, 8, 1),)),
}


@pytest.mark.parametrize("case", list(GEOMETRY_CASES))
def test_threshold_geometry_reads_each_layout_as_it_lies(case):
    probs_shape, w_shape, w_strides, rep, axes = GEOMETRY_CASES[case]
    rng = np.random.default_rng(len(case))
    base = torch.from_numpy(rng.integers(-2, 20, 8000).astype(np.int32))
    if w_strides is None:
        w = base[3:3 + int(np.prod(w_shape))].view(w_shape)
    else:
        w = base.as_strided(w_shape, w_strides, 3)
    g = threshold_geometry(probs_shape, tuple(w.shape), w.stride())
    assert (g.rows, g.n, g.rep, g.axes) == (int(np.prod(probs_shape[:-1])),
                                            probs_shape[-1], rep, axes)
    want = torch.broadcast_to(w, probs_shape).reshape(-1, probs_shape[-1]).numpy()
    for block in (128, 64, 7):      # the kernel's blocks, and a ragged one
        np.testing.assert_array_equal(_view_values(base, 3, g, block), want)


@pytest.mark.parametrize("probs_shape,w_shape,w_strides,match", [
    ((3, 4, 15), (2, 4, 15), (60, 15, 1), "do not broadcast"),
    ((4, 15), (2, 4, 15), (60, 15, 1), "do not broadcast"),
    ((4, 15), (4, 14), (14, 1), "do not broadcast"),
    # five strided leading axes that no two of which merge
    ((2, 2, 2, 2, 2, 2, 2, 2, 2, 3), (2, 1, 2, 1, 2, 1, 2, 1, 2, 3),
     (48, 0, 24, 0, 12, 0, 6, 0, 3, 1), f"at most {MAX_LEAD}"),
])
def test_threshold_geometry_refuses_what_the_kernel_cannot_take(probs_shape, w_shape,
                                                                w_strides, match):
    with pytest.raises(ValueError, match=match):
        threshold_geometry(probs_shape, w_shape, w_strides)


@pytest.mark.parametrize("n", [15, 6])
def test_success_tails_on_a_broadcast_view_matches_copy_and_pallas(n):
    rng = np.random.default_rng(400 + n)
    s, b, m = 2, 3, 40
    p = _probs(rng, s * b * m, n).reshape(s, b, m, n)
    w = rng.integers(-2, n + 2, size=(1, b, 1, n)).astype(np.int32)
    got = success_tails(torch.from_numpy(p), torch.from_numpy(w))
    copy = success_tails(torch.from_numpy(p), torch.from_numpy(np.broadcast_to(w, p.shape).copy()))
    assert torch.equal(got, copy)
    want = np.array(jax_success_tails(jnp.asarray(p), jnp.asarray(w), impl="pallas",
                                      interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


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
    lea.allocate_masked(p, lea.pool_load(LoadParams(15, 99, 10, 3), device="cpu"))
    assert launch_counts() == {"success_tails_cuda": 0, "success_tails_cuda_w": 0,
                               "allocate_masked_cuda": 0}


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


# ---------------------------------------------------------------------------
# build: one nvcc per source, started together (a stand-in nvcc here)
# ---------------------------------------------------------------------------

def _fake_nvcc(tmp_path: pathlib.Path) -> pathlib.Path:
    fake = tmp_path / "nvcc"
    fake.write_text(
        f"#!{sys.executable}\n"
        "import pathlib, sys, time\n"
        "args = sys.argv[1:]\n"
        "name = pathlib.Path(args[-1]).stem\n"
        f"log = pathlib.Path({str(tmp_path / 'calls')!r})\n"
        "with log.open('a') as f: f.write('start ' + name + '\\n')\n"
        "time.sleep(0.3)\n"
        "with log.open('a') as f: f.write('end ' + name + '\\n')\n"
        f"fail = pathlib.Path({str(tmp_path / 'fail')!r})\n"
        "if fail.exists() and fail.read_text() == name:\n"
        "    print('error: ' + name); sys.exit(1)\n"
        "pathlib.Path(args[args.index('-o') + 1]).write_bytes(b'lib')\n"
        "print('ptxas info    : Used 10 registers')\n"
    )
    fake.chmod(0o755)
    return fake


def test_build_all_starts_one_nvcc_per_source_together(tmp_path, monkeypatch):
    from repro_torch.kernels import build

    fake = _fake_nvcc(tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "_BUILDS", {})
    names = ["gf_matmul", "lagrange_encode", "coded_gradient"]
    results = build.build_all(names)
    calls = (tmp_path / "calls").read_text().split()[::2]
    assert calls[:3] == ["start"] * 3          # all three ran before any ended
    assert [r.name for r in results] == names
    for r in results:
        assert r.path == build.library_path(r.name) and r.path.exists()
        assert "registers" in r.log and r.seconds > 0
    # built once: a second call reuses them, a new process finds them on disk
    assert build.build_all(names) == results
    monkeypatch.setattr(build, "_BUILDS", {})
    assert [r.seconds for r in build.build_all(names)] == [0.0] * 3
    assert len((tmp_path / "calls").read_text().split()) == 12


def test_build_all_raises_on_a_failed_build_and_leaves_no_temporaries(tmp_path,
                                                                      monkeypatch):
    from repro_torch.kernels import build

    fake = _fake_nvcc(tmp_path)
    (tmp_path / "fail").write_text("lagrange_encode")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "lib")
    monkeypatch.setattr(build, "find_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "_BUILDS", {})
    with pytest.raises(RuntimeError, match="lagrange_encode.cu:\nerror: lagrange_encode"):
        build.build_all(["gf_matmul", "lagrange_encode", "coded_gradient"])
    left = {p.name for p in (tmp_path / "lib").iterdir()}
    assert left <= {build.library_path(n).name for n in ("gf_matmul", "coded_gradient")}
    assert "lagrange_encode" not in build._BUILDS


def test_build_without_nvcc_raises(monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "_BUILDS", {})
    monkeypatch.setattr(build, "BUILD_DIR", pathlib.Path("/nonexistent-build-dir"))
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setattr(build.os.path, "exists", lambda _: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build("gf_matmul")
