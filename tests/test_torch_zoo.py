"""The MoE, hybrid and xLSTM families of the port against the JAX package,
on the CPU.

Each family's SMOKE config (float32): olmoe (8 experts top-2, qk-norm,
MHA), mixtral (4 experts top-2, GQA 4 over 2, window 32), zamba2 (4 Mamba2
layers, the shared block every 2) and, with a tail group, zamba2 at 5
layers, and xLSTM (mLSTM, sLSTM, mLSTM).  The JAX ``init_params(PRNGKey(0))``
tree is carried over by ``convert.model_params``; JAX runs ``flash`` in
interpret mode.  Tolerances:

  * prefill logits and every cache tensor for ``ref`` / ``blockwise`` /
    ``flash``, four cached decode steps, the layers: rtol and atol 1e-5;
  * ``train_loss``, its gradients and one ``make_train_step`` step: as
    ``tests/test_torch_train.py`` states them (rtol 1e-5 with an absolute
    floor of 1e-6 x the largest magnitude compared; the parameters after
    the step within the first-order effect of that gradient error on
    AdamW's first update);
  * the bf16 xLSTM prefill: within 2^-8 (L + 1) max|logit| of the float32
    one, in both packages (:func:`bf16_bound`; ``chip_smoke.py`` phase 17
    holds the card to the same rule).

MoE routing depends on the call's length (capacity ceil(S k cf / E)), so a
prefill may drop routes a decode step never drops: the port's decode equals
its own prefill only where neither dropped one, and that test runs at
``capacity_factor = E / k`` (capacity S: no route can be dropped).
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import restore as jax_restore
from repro.configs import base as jbase
from repro.models import api as japi
from repro.models import layers as JL
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import checkpoint, convert
from repro_torch.configs import base as tbase
from repro_torch.models import api, encdec, hybrid, layers, lm, xlstm
from repro_torch.optim import cosine_warmup

TOL = 1e-5
IMPLS = ("ref", "blockwise", "flash")
ZOO = ("olmoe_1b_7b", "mixtral_8x22b", "zamba2_7b", "xlstm_125m")
# (name, arch, overrides): the SMOKE configs, and zamba2 with a tail group
CASES = {"olmoe": ("olmoe_1b_7b", {}), "mixtral": ("mixtral_8x22b", {}),
         "zamba2": ("zamba2_7b", {}), "zamba2_tail": ("zamba2_7b", dict(n_layers=5)),
         "xlstm": ("xlstm_125m", {})}
B, S, MAX_LEN = 2, 12, 16


def flat(tree, prefix=""):
    """Leaves of a nested dict / tuple by dotted name (numpy arrays)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), t) for i, t in enumerate(tree))
    else:
        leaf = tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
        return {prefix: leaf}
    out = {}
    for key, sub in items:
        out.update(flat(sub, f"{prefix}.{key}" if prefix else str(key)))
    return out


def close(got, want, rtol=1e-5, floor=1e-6):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(float(np.abs(want).max()), 1e-30))


def bf16_bound(ref_logits: np.ndarray, cfg) -> float:
    """The stated bound on a bf16 evaluation's logits against float32:
    2^-8 (the bf16 unit roundoff) a rounding of the residual stream per
    block and one for the head, added in the worst case, times the largest
    logit."""
    return 2.0 ** -8 * (cfg.n_layers + 1) * float(np.abs(ref_logits).max())


def tokens_for(cfg, seed=5, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# fixtures: one JAX model and its port per case
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=list(CASES))
def case(request):
    return request.param


@functools.cache
def jax_model(case: str):
    """(JAX config, port config, JAX ``init_params(PRNGKey(0))``) of a case."""
    arch, over = CASES[case]
    jcfg = jbase.get_smoke_config(arch, **over)
    init = jax.jit(japi.get_model(jcfg).init_params, static_argnums=1)
    return jcfg, tbase.get_smoke_config(arch, **over), init(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def jcfg(case):
    return jax_model(case)[0]


@pytest.fixture(scope="module")
def cfg(case):
    return jax_model(case)[1]


@pytest.fixture(scope="module")
def jparams(case):
    return jax_model(case)[2]


@pytest.fixture(scope="module")
def params(jparams, cfg):
    return convert.model_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


@pytest.fixture(scope="module")
def tokens(cfg):
    return tokens_for(cfg)


@pytest.fixture(scope="module")
def jax_prefills(jcfg, jparams, tokens):
    out = {}
    for impl in IMPLS:
        if jcfg.family == "ssm" and out:       # xLSTM runs no attention
            out[impl] = out["ref"]
            continue
        step = jax.jit(japi.make_prefill_step(jcfg, max_len=MAX_LEN, attn_impl=impl))
        logits, cache = step(jparams, {"tokens": jnp.asarray(tokens)})
        out[impl] = (np.asarray(logits), cache)
    return out


# ---------------------------------------------------------------------------
# configs and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ZOO)
def test_configs_are_the_jax_package_numbers(name):
    mine = importlib.import_module(f"repro_torch.configs.{name}")
    theirs = importlib.import_module(f"repro.configs.{name}")
    for which in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(mine, which)) == dataclasses.asdict(getattr(theirs, which))
    assert name in tbase.list_configs()
    assert tbase.get_config(name).n_params() == jbase.get_config(name).n_params()
    assert tbase.get_config(theirs.CONFIG.name, attn_impl="flash").attn_impl == "flash"


def test_dispatch_and_attention_calls():
    """``get_model`` takes JAX's order, every config of the registry
    included (whisper to ``encdec``, phi-3-vision to ``lm``);
    ``attention_calls`` is B6's launches a flash prefill."""
    want = {"olmoe_1b_7b": (lm, 16), "mixtral_8x22b": (lm, 56), "zamba2_7b": (hybrid, 14),
            "xlstm_125m": (xlstm, 0), "qwen3_0_6b": (lm, 28),
            "whisper_tiny": (encdec, 12), "phi_3_vision_4_2b": (lm, 32)}
    for name, (mod, calls) in want.items():
        full = tbase.get_config(name)
        assert api.get_model(full).prefill is mod.prefill
        assert api.attention_calls(full) == calls
    assert hybrid.n_attn_apps(tbase.get_smoke_config("zamba2_7b", n_layers=5)) == 3
    for name in ("whisper_tiny", "phi_3_vision_4_2b"):
        theirs = tbase.ArchConfig(**dataclasses.asdict(jbase.get_config(name)))
        assert theirs == tbase.get_config(name)
        assert api.get_model(theirs).init_params is want[name][0].init_params


def test_init_params_has_the_jax_tree(jparams, cfg):
    mine = api.get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = {name: (a.shape, a.dtype) for name, a in flat(jax.tree.map(np.asarray, jparams)).items()}
    got = {name: (tuple(t.shape), t.dtype) for name, t in mine.tensors().items()}
    assert set(got) == set(want)
    for name, (shape, dtype) in want.items():
        assert got[name][0] == shape, name
        assert str(got[name][1]).split(".")[-1] == str(dtype), name
    assert abs(float(mine["embed"].std()) - 0.02) < 2e-3
    if cfg.family == "hybrid":
        assert abs(float(mine.mamba["conv_w"].std()) - 0.2) < 0.02
        assert bool((mine.mamba["d_skip"] == 1).all()) and not mine.mamba["a_log"].any()
    with pytest.raises(ValueError, match="do not match"):
        bad = jax.tree.map(np.asarray, jparams)
        bad["embed"] = bad["embed"][:-1]
        convert.model_params(bad, cfg, device="cpu")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_jax(impl, cfg, params, tokens, jax_prefills):
    want_logits, want_cache = jax_prefills[impl]
    want_cache = flat(jax.tree.map(np.asarray, want_cache))
    logits, cache = api.make_prefill_step(cfg, max_len=MAX_LEN, attn_impl=impl)(
        params, {"tokens": torch.from_numpy(tokens)})
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=TOL, atol=TOL)
    got = flat(cache)
    assert set(got) == set(want_cache)
    for name, a in want_cache.items():
        assert got[name].shape == a.shape, name
        np.testing.assert_allclose(got[name], a, rtol=TOL, atol=TOL, err_msg=name)
    assert int(cache["pos"]) == S


def test_decode_steps_match_jax(jcfg, cfg, jparams, params, tokens, jax_prefills):
    j_logits, j_cache = jax_prefills["flash"]
    logits, cache = api.make_prefill_step(cfg, max_len=MAX_LEN, attn_impl="flash")(
        params, {"tokens": torch.from_numpy(tokens)})
    jserve, serve = jax.jit(japi.make_serve_step(jcfg)), api.make_serve_step(cfg)
    for _ in range(4):
        nxt = np.argmax(j_logits, -1).astype(np.int32)
        assert np.array_equal(nxt, logits.argmax(-1).numpy())
        j_logits, j_cache = jserve(jparams, j_cache, {"next_token": jnp.asarray(nxt)})
        logits, cache = serve(params, cache, {"next_token": torch.from_numpy(nxt)})
        j_logits = np.asarray(j_logits)
        np.testing.assert_allclose(logits.numpy(), j_logits, rtol=TOL, atol=TOL)
    want, got = flat(jax.tree.map(np.asarray, j_cache)), flat(cache)
    assert set(got) == set(want)
    for name, a in want.items():
        np.testing.assert_allclose(got[name], a, rtol=TOL, atol=TOL, err_msg=name)
    assert int(cache["pos"]) == S + 4


def test_decode_matches_prefill_logits(cfg, tokens):
    """Teacher forcing in the port: decoding token t on a cache of tokens
    [0, t) gives the prefill logits at position t.  MoE at capacity S (cf =
    E / k), where no prefill drops a route."""
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    params = api.get_model(cfg).init_params(torch.Generator().manual_seed(3), cfg, device="cpu")
    cfg = dataclasses.replace(cfg, attn_impl="flash")
    prefill, serve = api.make_prefill_step(cfg, max_len=S + 2), api.make_serve_step(cfg)
    full, _ = prefill(params, {"tokens": torch.from_numpy(tokens)})
    _, cache = prefill(params, {"tokens": torch.from_numpy(tokens[:, :S - 1])})
    step, cache = serve(params, cache, {"next_token": torch.from_numpy(tokens[:, S - 1])})
    torch.testing.assert_close(step, full, rtol=TOL, atol=TOL)


def test_mixtral_prefill_past_its_window_matches_jax():
    """48 tokens past mixtral SMOKE's 32-token window (at 12 it never
    masks): flash and ref, logits and KV cache."""
    jcfg, cfg, jparams = jax_model("mixtral")
    params = convert.model_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    toks = tokens_for(cfg, seed=8, s=48)
    for impl in ("flash", "ref"):
        want, jcache = jax.jit(japi.make_prefill_step(jcfg, attn_impl=impl))(
            jparams, {"tokens": jnp.asarray(toks)})
        got, cache = api.make_prefill_step(cfg, attn_impl=impl)(
            params, {"tokens": torch.from_numpy(toks)})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(cache["v"].numpy(), np.asarray(jcache["v"]), rtol=TOL,
                                   atol=TOL)
    unwindowed, _ = api.make_prefill_step(dataclasses.replace(cfg, window=None))(
        params, {"tokens": torch.from_numpy(toks)})
    assert float((unwindowed - got).abs().max()) > 1e-4      # the window masks


def test_xlstm_bf16_prefill_meets_the_stated_bound():
    """The bf16 prefill against a float32 evaluation of the same (bf16)
    weights, in both packages, within :func:`bf16_bound` (the rule
    ``chip_smoke.py`` holds the card's xlstm-125m to)."""
    jcfg, cfg = (m.get_smoke_config("xlstm_125m", dtype="bfloat16") for m in (jbase, tbase))
    jcfg32, cfg32 = (dataclasses.replace(c, dtype="float32") for c in (jcfg, cfg))
    jp16 = japi.get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)
    jp32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp16)
    toks = {"tokens": tokens_for(cfg, s=32)}
    run_jax = lambda c, p: np.asarray(jax.jit(japi.make_prefill_step(c))(
        p, {"tokens": jnp.asarray(toks["tokens"])})[0])
    run_port = lambda c, p: api.make_prefill_step(c)(
        convert.model_params(jax.tree.map(np.asarray, p), c, device="cpu"),
        {"tokens": torch.from_numpy(toks["tokens"])})[0].numpy()
    want = run_jax(jcfg32, jp32)
    np.testing.assert_allclose(run_port(cfg32, jp32), want, rtol=TOL, atol=TOL)
    bound = bf16_bound(want, cfg)
    err_jax = float(np.abs(run_jax(jcfg, jp16) - want).max())
    err_port = float(np.abs(run_port(cfg, jp16) - want).max())
    assert 0 < err_jax <= bound and 0 < err_port <= bound, (err_jax, err_port, bound)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

FAMILIES = ("olmoe", "mixtral", "zamba2", "xlstm")


@pytest.mark.parametrize("which", FAMILIES)
def test_train_loss_and_gradients_match_jax(which):
    jcfg, cfg, jparams = jax_model(which)
    toks = tokens_for(cfg, seed=3, b=4, s=16)
    loss_fn = lambda p, b: japi.get_model(jcfg).train_loss(p, b, jcfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        jparams, {"tokens": jnp.asarray(toks)})
    params = convert.model_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu").trainable()
    loss, grads = api.loss_and_grads(params, {"tokens": torch.from_numpy(toks)}, cfg)
    close(loss, want_loss)
    want = flat(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == want[name].shape
        close(g, want[name])


@pytest.mark.parametrize("which", ["olmoe", "zamba2", "xlstm"])
def test_one_train_step_matches_jax(which):
    """One ``make_train_step`` step of the SMOKE config (one microbatch; the
    accumulation modes are the dense family's, ``tests/test_torch_train.py``)
    from the same state and batch, with that file's tolerances."""
    jcfg, cfg, jparams = jax_model(which)
    jstate = jax_adamw_init(jparams)
    toks = tokens_for(cfg, seed=3, b=4, s=16)
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=10)
    jnew, jm = jax.jit(japi.make_train_step(jcfg, **kw))(jstate, {"tokens": jnp.asarray(toks)})
    state = convert.train_state(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    new, metrics = api.make_train_step(cfg, **kw)(state, {"tokens": torch.from_numpy(toks)})
    close(metrics["loss"], jm["loss"])
    close(metrics["grad_norm"], jm["grad_norm"])
    for mine, theirs in ((new.m, jnew.m), (new.v, jnew.v)):
        want = flat(jax.tree.map(np.asarray, theirs))
        assert set(mine) == set(want)
        for name, t in mine.items():
            close(t, want[name])
    lr, eps = float(cosine_warmup(1, peak_lr=1e-2, warmup=2, total=10)), 1e-8
    scale = min(1.0, 1.0 / float(jm["grad_norm"]))         # the step's clipping
    want_p = flat(jax.tree.map(np.asarray, jnew.params))
    want_m = flat(jax.tree.map(np.asarray, jnew.m))
    for name, t in new.params.tensors().items():
        g = np.abs(want_m[name] / 0.1)                       # m = (1 - b1) g at step 1
        dg = 1e-5 * g + 1e-6 * g.max()                       # the gradients' tolerance
        bound = 1e-5 * np.abs(want_p[name]) + np.minimum(
            2 * lr, lr * eps * dg / (g + eps) ** 2) + 1e-7 * scale
        diff = np.abs(t.detach().numpy() - want_p[name])
        assert (diff <= bound).all(), (name, float((diff - bound).max()))


@pytest.mark.parametrize("which", ["olmoe", "zamba2", "xlstm"])
def test_checkpoints_carry_the_new_trees_across(which, tmp_path):
    """A state written by ``repro``'s CheckpointManager restores into the
    port tensor for tensor (xLSTM's tuple of blocks under JAX's ``[i]``
    keys, in JAX's order), and a port checkpoint restores into ``repro``."""
    jcfg, cfg, jparams = jax_model(which)
    jstate = jax_adamw_init(jparams)._replace(step=jnp.asarray(5, jnp.int32))
    mgr = JaxCheckpointManager(str(tmp_path / "jax"))
    mgr.save_async(5, jstate)
    mgr.wait()
    like = api.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step, got, _ = checkpoint.CheckpointManager(str(tmp_path / "jax")).restore_latest(like)
    want = convert.train_state(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    assert step == 5 and type(got.params) is type(want.params)
    for name, t in want.params.tensors().items():
        assert torch.equal(got.params.tensors()[name].detach(), t.detach()), name
    checkpoint.save(str(tmp_path / "port"), 2, like)
    back, _ = jax_restore(str(tmp_path / "port"), 2, jstate)
    for name, a in flat(jax.tree.map(np.asarray, back.params)).items():
        assert np.array_equal(a, like.params.tensors()[name].detach().numpy()), name


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def olmoe_block(router=None):
    jcfg, cfg, jparams = jax_model("olmoe")
    bp = {k: np.array(v[0]) for k, v in jparams["blocks"].items()}
    if router is not None:
        bp["router"] = router(bp["router"])
    return jcfg, cfg, bp


def tie_pairs(router: np.ndarray) -> np.ndarray:
    """Experts 1 and 3 given the router columns of 0 and 2: their scores tie
    for every token."""
    router = router.copy()
    router[:, 1], router[:, 3] = router[:, 0], router[:, 2]
    return router


@pytest.mark.parametrize("kind", ["no drops", "drops", "tied scores"])
def test_moe_matches_jax(kind):
    jcfg, cfg, bp = olmoe_block(tie_pairs if kind == "tied scores" else None)
    cf = {"no drops": cfg.n_experts / cfg.top_k, "drops": 0.5, "tied scores": 1.25}[kind]
    jcfg, cfg = (dataclasses.replace(c, capacity_factor=cf) for c in (jcfg, cfg))
    x = np.random.default_rng(2).standard_normal((3, 40, cfg.d_model)).astype(np.float32)
    want = JL.moe(jnp.asarray(x), bp, jcfg)
    tp = {k: torch.from_numpy(v) for k, v in bp.items()}
    got = layers.moe(torch.from_numpy(x), tp, cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    routes = layers.moe_routes(torch.from_numpy(x), tp, cfg)
    dropped = int((~routes.keep).sum())
    assert (dropped == 0) if kind == "no drops" else (dropped > 0)
    if kind == "tied scores":
        experts = routes.experts.view(3, 40, cfg.top_k)
        # a tied pair split by the top-k boundary goes to its lower index
        split = [(experts == lo).any(-1) ^ (experts == hi).any(-1) for lo, hi in ((0, 1), (2, 3))]
        assert int(split[0].sum() + split[1].sum()) > 0
        assert not bool((experts == 1).any(-1)[split[0]].any())
        assert not bool((experts == 3).any(-1)[split[1]].any())


def zamba2_layer():
    jcfg, cfg, jparams = jax_model("zamba2")
    mp = {k: np.array(v[0]) for k, v in jparams["mamba"].items()}
    rng = np.random.default_rng(4)            # away from init's dt_bias = a_log = 0
    mp["dt_bias"] = (rng.standard_normal(mp["dt_bias"].shape) * 0.5).astype(np.float32)
    mp["a_log"] = (rng.standard_normal(mp["a_log"].shape) * 0.5).astype(np.float32)
    return jcfg, cfg, mp


@pytest.mark.parametrize("s", [256, 200])
def test_mamba2_scan_matches_jax(s):
    """Two chunks of 128 (the state carried between them), and a ragged
    200 that runs as one chunk by JAX's rule: output, final state and the
    raw conv tail."""
    jcfg, cfg, mp = zamba2_layer()
    x = np.random.default_rng(s).standard_normal((2, s, cfg.d_model)).astype(np.float32)
    want_y, want_st = JL.mamba2_scan(jnp.asarray(x), mp, jcfg, return_state=True)
    got_y, got_st = layers.mamba2_scan(torch.from_numpy(x),
                                       {k: torch.from_numpy(v) for k, v in mp.items()}, cfg,
                                       return_state=True)
    for got, want in zip((got_y, *got_st), (want_y, *want_st)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("s", [256, 200])
def test_mlstm_chunked_matches_jax(s):
    """Two chunks of 128, and a ragged 200 as one chunk (``xlstm.mlstm_chunk``),
    from the initial state (stabiliser -inf: no NaN).  q, k and v at 0.3 and
    the gate pre-activations at 1, the scales the model's projections give:
    with unit q and k the quotient q C / max(|q n|, exp(-m)) cancels, and
    float32 summation order alone moves it by more than 1e-5."""
    rng = np.random.default_rng(s)
    q, k, v = ((rng.standard_normal((2, s, 2, 16)) * 0.3).astype(np.float32) for _ in range(3))
    i_pre, f_pre = (rng.standard_normal((2, s, 2)).astype(np.float32) for _ in range(2))
    chunk = xlstm.mlstm_chunk(s)
    assert chunk == {256: 128, 200: 200}[s]
    want_h, want_st = JL.mlstm_chunked(*map(jnp.asarray, (q, k, v, i_pre, f_pre)),
                                       chunk=chunk, return_state=True)
    got_h, got_st = layers.mlstm_chunked(*map(torch.from_numpy, (q, k, v, i_pre, f_pre)),
                                         chunk=chunk, return_state=True)
    assert bool(torch.isfinite(got_h).all())
    for got, want in zip((got_h, *got_st[:2]), (want_h, *want_st[:2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    # the final stabiliser m is a difference of cumulative sums of the S
    # log-forget terms (|log f| ~ 0.7 each): its float32 error is that of the
    # sums, 2^-23 of their magnitude per rounding, whatever the summation order
    log_f = -np.logaddexp(0, -f_pre[:, -chunk:])
    np.testing.assert_allclose(got_st[2].numpy(), np.asarray(want_st[2]), rtol=TOL,
                               atol=2 * 2.0 ** -23 * float(np.abs(log_f).sum(1).max()))


def test_cells_step_from_the_initial_state():
    """``mamba2_decode``, ``mlstm_decode`` (on no path of either package:
    xLSTM decodes through a chunk of 1) and ``slstm_scan`` from the initial
    state: finite (exp(-inf - x) is 0) and equal to JAX's."""
    rng = np.random.default_rng(6)
    jcfg, cfg, mp = zamba2_layer()
    d_in, nh, ds, hd = layers.mamba2_dims(cfg)
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    h0 = np.zeros((2, nh, hd, ds), np.float32)
    conv0 = np.zeros((2, cfg.ssm_conv - 1, d_in + 2 * ds), np.float32)
    want = JL.mamba2_decode(jnp.asarray(x), mp, jcfg, jnp.asarray(h0), jnp.asarray(conv0))
    got = layers.mamba2_decode(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in mp.items()},
                               cfg, torch.from_numpy(h0), torch.from_numpy(conv0))
    q, k, v = (rng.standard_normal((2, 2, 16)).astype(np.float32) for _ in range(3))
    i_pre, f_pre = (rng.standard_normal((2, 2)).astype(np.float32) for _ in range(2))
    cell0 = (np.zeros((2, 2, 16, 16), np.float32), np.zeros((2, 2, 16), np.float32),
             np.full((2, 2), -np.inf, np.float32))
    want_m = JL.mlstm_decode(*map(jnp.asarray, (q, k, v, i_pre, f_pre)),
                             tuple(map(jnp.asarray, cell0)))
    got_m = layers.mlstm_decode(*map(torch.from_numpy, (q, k, v, i_pre, f_pre)),
                                tuple(map(torch.from_numpy, cell0)))
    gates = rng.standard_normal((2, 1, 2, 4, 16)).astype(np.float32)
    r = (rng.standard_normal((2, 4, 16, 16)) * 0.1).astype(np.float32)
    want_s = JL.slstm_scan(jnp.asarray(gates), jnp.asarray(r), return_state=True)
    got_s = layers.slstm_scan(torch.from_numpy(gates), torch.from_numpy(r), return_state=True)
    for got_t, want_t in ((got, want), (got_m, want_m), (got_s, want_s)):
        for g, w in zip(flat(got_t).values(), flat(jax.tree.map(np.asarray, want_t)).values()):
            assert np.isfinite(g).all()
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL)
