"""The LM serving path of the port against the JAX package, on the CPU.

``qwen3_0_6b``'s SMOKE config (float32, 2 layers, GQA 4 over 2 heads,
qk-norm) with the JAX ``init_params(PRNGKey(0))`` tree carried over by
``convert.lm_params``: the layers, the prefill logits and KV cache for each
``attn_impl`` and four cached decode steps must match JAX within float32
round-off (rtol and atol 1e-5, on logits of order 0.5 and on the cache),
and the port's own decode must reproduce its prefill.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import qwen3_0_6b as jqwen
from repro.models import api as japi
from repro.models import layers as JL
from repro_torch import convert
from repro_torch.configs import base as tbase
from repro_torch.configs import qwen3_0_6b as tqwen
from repro_torch.models import api, layers, lm

TOL = 1e-5
IMPLS = ("ref", "blockwise", "flash")
B, S, MAX_LEN = 2, 12, 16


@pytest.fixture(scope="module")
def jcfg():
    return jbase.get_smoke_config("qwen3_0_6b")


@pytest.fixture(scope="module")
def cfg():
    return tbase.get_smoke_config("qwen3_0_6b")


@pytest.fixture(scope="module")
def jparams(jcfg):
    return japi.get_model(jcfg).init_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def params(jparams, cfg):
    return convert.lm_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


@pytest.fixture(scope="module")
def tokens(cfg):
    return np.random.default_rng(5).integers(0, cfg.vocab_size, (B, S))


@pytest.fixture(scope="module")
def jax_prefills(jcfg, jparams, tokens):
    out = {}
    for impl in IMPLS:
        step = japi.make_prefill_step(jcfg, max_len=MAX_LEN, attn_impl=impl)
        logits, cache = step(jparams, {"tokens": jnp.asarray(tokens, jnp.int32)})
        out[impl] = (np.asarray(logits), jax.tree.map(np.asarray, cache))
    return out


def test_configs_are_the_jax_package_numbers():
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(tqwen, name)) == dataclasses.asdict(getattr(jqwen, name))
    assert set(tbase.list_configs()) <= set(jbase.list_configs())
    assert tbase.get_config("qwen3-0.6b", attn_impl="flash").attn_impl == "flash"
    assert tbase.SHAPE_CELLS == {k: tbase.ShapeCell(**dataclasses.asdict(v))
                                 for k, v in jbase.SHAPE_CELLS.items()}
    with pytest.raises(ValueError, match="yi_9b"):
        tbase.get_config("yi_9b")


def test_unported_families_raise(cfg):
    with pytest.raises(NotImplementedError, match="MoE"):
        api.get_model(dataclasses.replace(cfg, n_experts=4, top_k=2))
    with pytest.raises(NotImplementedError, match="hybrid"):
        api.get_model(dataclasses.replace(cfg, family="hybrid"))
    with pytest.raises(NotImplementedError, match="encoder-decoder"):
        api.get_model(dataclasses.replace(cfg, encoder_layers=2))


def test_init_params_has_the_jax_tree(jparams, cfg):
    gen = torch.Generator().manual_seed(0)
    mine = lm.init_params(gen, cfg, device="cpu")
    jtree = jax.tree.map(np.asarray, jparams)
    assert set(mine.blocks) == set(jtree["blocks"])
    for name, a in jtree["blocks"].items():
        assert tuple(mine.blocks[name].shape) == a.shape, name
    for name in ("embed", "ln_f", "lm_head"):
        assert tuple(mine[name].shape) == jtree[name].shape, name
    # the same distributions: N(0, 0.02) for the embedding
    assert abs(float(mine["embed"].std()) - 0.02) < 1e-3
    assert bool((mine.blocks["ln1"] == 1).all())


@pytest.mark.parametrize("part", ["rms_norm", "rope", "mlp"])
def test_layers_match_jax(part, jcfg, cfg, jparams, params):
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    if part == "rms_norm":
        scale = rng.standard_normal(cfg.d_model).astype(np.float32)
        want = JL.rms_norm(jnp.asarray(x), jnp.asarray(scale))
        got = layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale))
    elif part == "rope":
        xh = rng.standard_normal((B, S, cfg.n_heads, cfg.head_dim_)).astype(np.float32)
        pos = np.arange(S) + 1000                 # large angles too
        want = JL.rope(jnp.asarray(xh), jnp.asarray(pos), jcfg.rope_theta)
        got = layers.rope(torch.from_numpy(xh), torch.from_numpy(pos), cfg.rope_theta)
    else:
        jp = jax.tree.map(lambda a: a[0], jparams["blocks"])
        want = JL.mlp(jnp.asarray(x), jp, jcfg)
        got = layers.mlp(torch.from_numpy(x), params.layer(0), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("impl", IMPLS)
def test_prefill_matches_jax(impl, cfg, params, tokens, jax_prefills):
    want_logits, want_cache = jax_prefills[impl]
    step = api.make_prefill_step(cfg, max_len=MAX_LEN, attn_impl=impl)
    logits, cache = step(params, {"tokens": torch.from_numpy(tokens)})
    assert logits.dtype == torch.float32 and logits.shape == (B, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), want_logits, rtol=TOL, atol=TOL)
    for name in ("k", "v"):
        assert tuple(cache[name].shape) == want_cache[name].shape
        np.testing.assert_allclose(cache[name].numpy(), want_cache[name], rtol=TOL, atol=TOL)
    assert int(cache["pos"]) == int(want_cache["pos"]) == S


def test_decode_steps_match_jax(jcfg, cfg, jparams, params, tokens, jax_prefills):
    j_logits, j_cache = jax_prefills["flash"]
    j_cache = jax.tree.map(jnp.asarray, j_cache)
    logits, cache = api.make_prefill_step(cfg, max_len=MAX_LEN, attn_impl="flash")(
        params, {"tokens": torch.from_numpy(tokens)})
    jserve, serve = japi.make_serve_step(jcfg), api.make_serve_step(cfg)
    for _ in range(4):
        nxt = np.argmax(j_logits, -1)
        assert np.array_equal(nxt, logits.argmax(-1).numpy())
        j_logits, j_cache = jserve(jparams, j_cache, {"next_token": jnp.asarray(nxt, jnp.int32)})
        logits, cache = serve(params, cache, {"next_token": torch.from_numpy(nxt)})
        j_logits = np.asarray(j_logits)
        np.testing.assert_allclose(logits.numpy(), j_logits, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(cache["v"].numpy(), np.asarray(j_cache["v"]), rtol=TOL, atol=TOL)
    assert int(cache["pos"]) == int(j_cache["pos"]) == S + 4


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_decode_matches_prefill_logits(impl, cfg, params, tokens):
    """Teacher forcing: decoding token t on a cache of tokens [0, t) gives the
    prefill logits at position t (the pattern of the JAX smoke test)."""
    cfg = dataclasses.replace(cfg, attn_impl=impl)
    prefill, serve = api.make_prefill_step(cfg, max_len=S + 4), api.make_serve_step(cfg)
    full, _ = prefill(params, {"tokens": torch.from_numpy(tokens)})
    _, cache = prefill(params, {"tokens": torch.from_numpy(tokens[:, :S - 1])})
    step, cache = serve(params, cache, {"next_token": torch.from_numpy(tokens[:, S - 1])})
    torch.testing.assert_close(step, full, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("max_len,attn_impl,ran", [
    (8191, None, "flash"), (8192, None, "blockwise"), (8192, "flash", "flash")])
def test_long_prefill_defaults_to_blockwise(max_len, attn_impl, ran, cfg, params, tokens,
                                            monkeypatch):
    """JAX's rule: max_len >= 8192 with no attn_impl given runs blockwise,
    whatever the config says."""
    calls = {"flash": 0, "blockwise": 0}
    for name, attr in (("flash", "flash_attention"), ("blockwise", "_blockwise_attention")):
        real = getattr(layers, attr)
        monkeypatch.setattr(layers, attr, lambda *a, _n=name, _f=real, **k:
                            calls.__setitem__(_n, calls[_n] + 1) or _f(*a, **k))
    flash_cfg = dataclasses.replace(cfg, attn_impl="flash")
    logits, cache = api.make_prefill_step(flash_cfg, max_len=max_len, attn_impl=attn_impl)(
        params, {"tokens": torch.from_numpy(tokens)})
    assert calls[ran] == cfg.n_layers and sum(calls.values()) == cfg.n_layers
    assert cache["k"].shape[3] == max_len
    short, _ = api.make_prefill_step(flash_cfg, max_len=MAX_LEN)(
        params, {"tokens": torch.from_numpy(tokens)})
    torch.testing.assert_close(logits, short, rtol=TOL, atol=TOL)


def test_make_batch_draws_tokens_in_the_vocabulary(cfg):
    gen = torch.Generator().manual_seed(1)
    batch = api.make_batch(cfg, tbase.ShapeCell("c", 8, 3, "prefill"), gen, device="cpu")
    assert batch["tokens"].shape == (3, 8)
    assert 0 <= int(batch["tokens"].min()) and int(batch["tokens"].max()) < cfg.vocab_size
    step = api.make_batch(cfg, tbase.ShapeCell("d", 8, 3, "decode"), gen, device="cpu")
    assert step["next_token"].shape == (3,)


def test_bf16_prefill_tracks_jax(jcfg, cfg, jparams, tokens, jax_prefills):
    """The bf16 storage path (f32 accumulation wherever JAX asks for it).
    Port and JAX round intermediate activations to bf16 at different places;
    each is a bf16 evaluation of the same float32 function, so the two may
    differ by up to twice JAX's own bf16-vs-float32 error."""
    jcfg16 = dataclasses.replace(jcfg, dtype="bfloat16")
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", attn_impl="flash")
    jp16 = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jparams)
    want, _ = japi.make_prefill_step(jcfg16, max_len=MAX_LEN, attn_impl="flash")(
        jp16, {"tokens": jnp.asarray(tokens, jnp.int32)})
    p16 = convert.lm_params(jax.tree.map(np.asarray, jp16), cfg16, device="cpu")
    assert p16["embed"].dtype == torch.bfloat16
    got, cache = api.make_prefill_step(cfg16, max_len=MAX_LEN)(
        p16, {"tokens": torch.from_numpy(tokens)})
    assert got.dtype == torch.float32 and cache["k"].dtype == torch.bfloat16
    want = np.asarray(want)
    err16 = float(np.abs(want - jax_prefills["flash"][0]).max())
    assert 0 < err16 < 1e-2
    assert float(np.abs(got.numpy() - want).max()) <= 2 * err16


@pytest.mark.parametrize("before", [True, False])
def test_step_functions_sum_bf16_split_k_in_float32_and_restore_the_flag(cfg, monkeypatch,
                                                                         before):
    """Each call of a step function turns cuBLAS's bf16 split-K sums off, as
    JAX's ``preferred_element_type`` asks, and gives the caller's value back,
    also when the step raises."""
    flags = torch.backends.cuda.matmul
    seen = []

    def spy(*args, **kwargs):
        seen.append(flags.allow_bf16_reduced_precision_reduction)
        if len(seen) == 3:
            raise RuntimeError("the step fails")
        return "logits", "cache"

    monkeypatch.setattr(lm, "prefill", spy)
    monkeypatch.setattr(lm, "decode_step", spy)
    saved = flags.allow_bf16_reduced_precision_reduction
    try:
        flags.allow_bf16_reduced_precision_reduction = before
        prefill, serve = api.make_prefill_step(cfg, max_len=MAX_LEN), api.make_serve_step(cfg)
        assert prefill(None, {}) == ("logits", "cache")
        assert flags.allow_bf16_reduced_precision_reduction is before
        assert serve(None, None, {}) == ("logits", "cache")
        assert flags.allow_bf16_reduced_precision_reduction is before
        with pytest.raises(RuntimeError, match="the step fails"):
            prefill(None, {})
        assert flags.allow_bf16_reduced_precision_reduction is before
        assert seen == [False, False, False]
    finally:
        flags.allow_bf16_reduced_precision_reduction = saved
