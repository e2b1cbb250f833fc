"""The encoder-decoder (whisper) and vision-stub (phi-3-vision) families of
the port against the JAX package, on the CPU.

Each family's SMOKE config (float32; whisper: 2 encoder and 2 decoder
layers over 16 frames, GELU; phi-3-vision: 2 layers, 8 patches prepended
to the text), with the JAX ``init_params(PRNGKey(0))`` tree carried over by
``convert.model_params`` and frames, patches and tokens made by a seeded
numpy generator.  JAX runs ``flash`` in interpret mode.  Tolerances:

  * ``encode``, the prefill logits and every cache tensor (``k``, ``v``,
    ``ck``, ``cv``), three cached decode steps, the attention layers alone:
    rtol and atol 1e-5 (float32 sums in other orders, values of order 1);
  * ``train_loss`` within rtol 1e-5 and its gradients within rtol 1e-4,
    each with an absolute floor of 1e-6 x the largest magnitude compared
    (``tests/test_torch_train.py``'s rule for sums that cancel);
  * ``input_specs``, the data pipeline's extra streams and the checkpoint
    round trips: exact.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.checkpoint import restore as jax_restore
from repro.configs import base as jbase
from repro.data import DataPipeline as JaxPipeline
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models import layers as JL
from repro.optim import adamw_init as jax_adamw_init
from repro_torch import checkpoint, convert
from repro_torch.configs import base as tbase
from repro_torch.data import DataPipeline
from repro_torch.models import api, encdec, layers, lm

TOL = 1e-5
FAMILIES = {"whisper": "whisper_tiny", "phi3v": "phi_3_vision_4_2b"}
B, S, STEPS = 2, 12, 3


def flat(tree, prefix=""):
    """Leaves of a nested dict by dotted name (numpy arrays)."""
    if isinstance(tree, dict):
        out = {}
        for key, sub in tree.items():
            out.update(flat(sub, f"{prefix}.{key}" if prefix else str(key)))
        return out
    leaf = tree.detach().float().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return {prefix: leaf}


def close(got, want, rtol=TOL, floor=1e-6):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(float(np.abs(want).max()), 1e-30))


@functools.cache
def jax_model(fam: str, **over):
    """(JAX config, port config, JAX ``init_params(PRNGKey(0))``)."""
    jcfg = jbase.get_smoke_config(FAMILIES[fam], **over)
    init = jax.jit(japi.get_model(jcfg).init_params, static_argnums=1)
    return jcfg, tbase.get_smoke_config(FAMILIES[fam], **over), init(jax.random.PRNGKey(0), jcfg)


@functools.cache
def port_params(fam: str):
    jcfg, cfg, jparams = jax_model(fam)
    return convert.model_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu")


@functools.cache
def inputs(fam: str, seed: int = 5, b: int = B, s: int = S) -> dict[str, np.ndarray]:
    """Tokens (b, s) and the family's frames or patches (b, T, d), numpy."""
    cfg = jax_model(fam)[1]
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    extra = "frames" if cfg.is_encdec else "patches"
    out[extra] = rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def as_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def as_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def max_len(cfg) -> int:
    """Cache slots: the prompt, the decode steps and, for the vision stub,
    the patches."""
    return S + 4 + (0 if cfg.is_encdec else cfg.frontend_tokens)


@functools.cache
def jax_prefill(fam: str, impl: str):
    jcfg, _, jparams = jax_model(fam)
    step = jax.jit(japi.make_prefill_step(jcfg, max_len=max_len(jcfg), attn_impl=impl))
    logits, cache = step(jparams, as_jax(inputs(fam)))
    return logits, cache


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", list(FAMILIES))
def test_init_params_has_the_jax_tree(fam):
    """The port's own ``init_params`` makes JAX's names, shapes and dtypes,
    from JAX's distributions: the encoder's output projections scaled by
    0.02 / sqrt(2 ``n_layers``), not by its own depth (shown at 3 encoder
    layers over 2 decoder layers), the cross blocks at 0.02."""
    over = {"encoder_layers": 3} if fam == "whisper" else {}
    jcfg, cfg, jparams = jax_model(fam, **over)
    mine = api.get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    want = {n: (a.shape, str(a.dtype)) for n, a in flat(jax.tree.map(np.asarray, jparams)).items()}
    got = {n: (tuple(t.shape), str(t.dtype).split(".")[-1]) for n, t in mine.tensors().items()}
    assert got == want
    t = mine.tensors()
    std = lambda name: float(t[name].std())
    if fam == "whisper":
        assert abs(std("enc_blocks.wo") / (0.02 / np.sqrt(2 * cfg.n_layers)) - 1) < 0.05
        assert abs(std("cross_blocks.wo") / 0.02 - 1) < 0.05
        assert abs(std("lm_head") / 0.02 - 1) < 0.05
    else:
        assert abs(std("patch_proj") / 0.02 - 1) < 0.05
    assert abs(std("embed") / 0.02 - 1) < 0.05


def test_decoder_lm_from_tensors_with_patch_proj():
    """``DecoderLM`` carries ``patch_proj`` through ``tensors`` /
    ``from_tensors``, and a text-only config has none."""
    params = port_params("phi3v")
    named = params.tensors()
    assert tuple(named["patch_proj"].shape) == (64, 64)
    back = lm.DecoderLM.from_tensors(named)
    assert set(back.tensors()) == set(named)
    assert all(torch.equal(back.tensors()[n], t) for n, t in named.items())
    text = tbase.get_smoke_config("qwen3_0_6b")
    plain = lm.init_params(torch.Generator().manual_seed(0), text, device="cpu")
    assert plain.patch_proj is None and "patch_proj" not in plain.tensors()


# ---------------------------------------------------------------------------
# attention layers alone
# ---------------------------------------------------------------------------

def attention_weights(cfg, seed=7):
    rng = np.random.default_rng(seed)
    d, hd = cfg.d_model, cfg.head_dim_
    shapes = {"wq": (d, cfg.n_heads * hd), "wk": (d, cfg.n_kv_heads * hd),
              "wv": (d, cfg.n_kv_heads * hd), "wo": (cfg.n_heads * hd, d)}
    return {n: (0.2 * rng.standard_normal(s)).astype(np.float32) for n, s in shapes.items()}


@pytest.mark.parametrize("impl", ["ref", "blockwise", "flash"])
@pytest.mark.parametrize("mode", ["bidirectional", "cross"])
def test_attention_train_noncausal_and_cross_at_a_ragged_length(mode, impl):
    """``attention_train(causal=False)`` (rotary, no mask) over 37 positions,
    and ``kv_x=`` (no rotary on either side, no mask) from 12 queries over
    37 keys, against JAX."""
    jcfg = dataclasses.replace(jax_model("whisper")[0], attn_impl=impl)
    cfg = dataclasses.replace(jax_model("whisper")[1], attn_impl=impl)
    rng = np.random.default_rng(3)
    w = attention_weights(cfg)
    sk, sq = 37, 37 if mode == "bidirectional" else 12
    x = rng.standard_normal((B, sq, cfg.d_model)).astype(np.float32)
    kv = rng.standard_normal((B, sk, cfg.d_model)).astype(np.float32)
    kw = dict(causal=False) if mode == "bidirectional" else {}
    want = JL.attention_train(jnp.asarray(x), {n: jnp.asarray(a) for n, a in w.items()}, jcfg,
                              positions=jnp.arange(sq),
                              kv_x=None if mode == "bidirectional" else jnp.asarray(kv), **kw)
    got = layers.attention_train(torch.from_numpy(x),
                                 {n: torch.from_numpy(a) for n, a in w.items()},
                                 cfg, positions=torch.arange(sq),
                                 kv_x=None if mode == "bidirectional" else torch.from_numpy(kv),
                                 **kw)
    close(got, want)


@pytest.mark.parametrize("valid", [16, 11])
def test_attention_decode_cross_matches_jax(valid):
    """``attention_decode(cross=True)``: one query over a read-only cache, no
    rotary, keys at or past ``pos`` masked; the cache comes back unchanged."""
    jcfg, cfg, _ = jax_model("whisper")
    rng = np.random.default_rng(4)
    w = attention_weights(cfg, seed=9)
    t = cfg.frontend_tokens
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    ck, cv = (rng.standard_normal((B, cfg.n_kv_heads, t, cfg.head_dim_)).astype(np.float32)
              for _ in range(2))
    want, _, _ = JL.attention_decode(jnp.asarray(x), {n: jnp.asarray(a) for n, a in w.items()},
                                     jcfg, jnp.asarray(ck), jnp.asarray(cv),
                                     jnp.asarray(valid, jnp.int32), cross=True)
    tck, tcv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got, k_out, v_out = layers.attention_decode(
        torch.from_numpy(x), {n: torch.from_numpy(a) for n, a in w.items()}, cfg, tck, tcv,
        torch.tensor(valid, dtype=torch.int32), cross=True)
    close(got, want)
    assert np.array_equal(k_out.numpy(), ck) and np.array_equal(v_out.numpy(), cv)


# ---------------------------------------------------------------------------
# the encoder, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_encode_matches_jax(impl):
    jcfg, cfg, jparams = jax_model("whisper")
    jcfg, cfg = (dataclasses.replace(c, attn_impl=impl) for c in (jcfg, cfg))
    frames, params = inputs("whisper")["frames"], port_params("whisper")
    want = jax.jit(jencdec.encode, static_argnums=2)(jparams, jnp.asarray(frames), jcfg)
    with torch.inference_mode():
        got = encdec.encode(params, torch.from_numpy(frames), cfg)
    assert tuple(got.shape) == (B, cfg.frontend_tokens, cfg.d_model)
    close(got, want)


@pytest.mark.parametrize("impl", ["ref", "blockwise", "flash"])
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_prefill_logits_and_caches_match_jax(fam, impl):
    """Logits and every cache tensor: whisper's self ``k`` / ``v`` padded to
    ``max_len`` and its raw cross projections ``ck`` / ``cv``; phi-3-v's
    ``k`` / ``v`` over patches and text, ``pos`` counting both."""
    _, cfg, _ = jax_model(fam)
    want_logits, want_cache = jax_prefill(fam, impl)
    step = api.make_prefill_step(cfg, max_len=max_len(cfg), attn_impl=impl)
    logits, cache = step(port_params(fam), as_torch(inputs(fam)))
    close(logits, want_logits)
    want = jax.tree.map(np.asarray, want_cache)
    assert set(cache) == set(want) == ({"k", "v", "ck", "cv", "pos"} if cfg.is_encdec
                                       else {"k", "v", "pos"})
    for name, t in cache.items():
        assert tuple(t.shape) == want[name].shape, name
        close(t, want[name])
    prefix = 0 if cfg.is_encdec else cfg.frontend_tokens
    assert int(cache["pos"]) == S + prefix


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_decode_steps_match_jax(fam):
    """Three cached decode steps from the ``ref`` prefill, fed JAX's greedy
    tokens: logits and the self caches after each; whisper's cross cache is
    never written."""
    jcfg, cfg, jparams = jax_model(fam)
    jlogits, jcache = jax_prefill(fam, "ref")
    _, cache = api.make_prefill_step(cfg, max_len=max_len(cfg), attn_impl="ref")(
        port_params(fam), as_torch(inputs(fam)))
    ck = None if "ck" not in cache else cache["ck"].clone()
    jserve, serve = jax.jit(japi.make_serve_step(jcfg)), api.make_serve_step(cfg)
    for _ in range(STEPS):
        tok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        jlogits, jcache = jserve(jparams, jcache, {"next_token": tok})
        logits, cache = serve(port_params(fam), cache,
                              {"next_token": torch.from_numpy(np.array(tok))})
        close(logits, jlogits)
        for name in ("k", "v"):
            close(cache[name], np.asarray(jcache[name]))
        assert int(cache["pos"]) == int(jcache["pos"])
    if ck is not None:
        assert torch.equal(cache["ck"], ck)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_decode_matches_a_fresh_prefill(fam):
    """The port's decode step t equals a prefill over the prompt and the
    t + 1 tokens fed, with the same frames or patches: decode continues at
    ``pos`` past the patches."""
    _, cfg, _ = jax_model(fam)
    params, batch = port_params(fam), as_torch(inputs(fam))
    logits, cache = api.make_prefill_step(cfg, max_len=max_len(cfg))(params, batch)
    serve, fed = api.make_serve_step(cfg), []
    for _ in range(2):
        fed.append(logits.argmax(-1).to(torch.int32))
        logits, cache = serve(params, cache, {"next_token": fed[-1]})
    longer = dict(batch, tokens=torch.cat([batch["tokens"], torch.stack(fed, 1)], 1))
    fresh, _ = api.make_prefill_step(cfg)(params, longer)
    torch.testing.assert_close(logits, fresh, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fam", list(FAMILIES))
def test_train_loss_and_gradients_match_jax(fam):
    """Whisper's decoder loss given the frames, phi-3-v's loss over the text
    positions only; every gradient, ``patch_proj``'s and the encoder's
    included."""
    jcfg, cfg, jparams = jax_model(fam)
    batch = inputs(fam, seed=3, b=4, s=16)
    loss_fn = lambda p, b: japi.get_model(jcfg).train_loss(p, b, jcfg)
    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(jparams, as_jax(batch))
    params = convert.model_params(jax.tree.map(np.asarray, jparams), cfg, device="cpu").trainable()
    loss, grads = api.loss_and_grads(params, as_torch(batch), cfg)
    close(loss, want_loss)
    want = flat(jax.tree.map(np.asarray, want_grads))
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert tuple(g.shape) == want[name].shape, name
        close(g, want[name], rtol=1e-4)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_train_step_and_remat(fam):
    """One ``make_train_step`` step (``ref``; the flash config raises, B6 has
    no backward) moves the parameters and gives a finite loss near
    ln(vocab); with ``remat`` on, the loss and gradients are bit-equal to
    remat off."""
    _, cfg, _ = jax_model(fam)
    batch = as_torch(inputs(fam, seed=3, b=4, s=16))
    with pytest.raises(RuntimeError, match="no backward"):
        api.make_train_step(dataclasses.replace(cfg, attn_impl="flash"))
    state = api.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = state.params["embed"].detach().clone()
    state, metrics = api.make_train_step(cfg)(state, batch)
    assert abs(float(metrics["loss"]) - np.log(cfg.vocab_size)) < 1.0
    assert not torch.equal(state.params["embed"].detach(), before)
    params = port_params(fam)
    off = api.loss_and_grads(type(params).from_tensors(params.tensors()).trainable(), batch, cfg)
    remat = dataclasses.replace(cfg, remat=True)
    on = api.loss_and_grads(type(params).from_tensors(params.tensors()).trainable(), batch, remat)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(on[1][n], g) for n, g in off[1].items())


# ---------------------------------------------------------------------------
# inputs: specs, batches, the data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cell", list(tbase.SHAPE_CELLS))
@pytest.mark.parametrize("name", tbase.list_configs())
def test_input_specs_match_jax(name, cell):
    """The same keys, shapes and dtypes as JAX's ``ShapeDtypeStruct``
    stand-ins, as meta-device tensors."""
    want = japi.input_specs(jbase.get_config(name), jbase.SHAPE_CELLS[cell])
    got = api.input_specs(tbase.get_config(name), tbase.SHAPE_CELLS[cell])
    assert list(got) == list(want)
    for key, sd in want.items():
        assert tuple(got[key].shape) == sd.shape and got[key].device.type == "meta"
        assert str(got[key].dtype).split(".")[-1] == str(sd.dtype)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_make_batch_draws_from_the_specs(fam):
    cfg = jax_model(fam)[1]
    cell = tbase.ShapeCell("c", 24, 3, "prefill")
    batch = api.make_batch(cfg, cell, torch.Generator().manual_seed(1), device="cpu")
    specs = api.input_specs(cfg, cell)
    assert list(batch) == list(specs)
    for key, sd in specs.items():
        assert batch[key].shape == sd.shape and batch[key].dtype == sd.dtype
    toks = batch["tokens"]
    assert 0 <= int(toks.min()) and int(toks.max()) < cfg.vocab_size
    extra = batch["frames" if cfg.is_encdec else "patches"]
    assert abs(float(extra.std()) - 1) < 0.1 and abs(float(extra.mean())) < 0.1
    again = api.make_batch(cfg, cell, torch.Generator().manual_seed(1), device="cpu")
    assert all(torch.equal(again[k], t) for k, t in batch.items())


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_data_pipeline_extra_specs_are_the_jax_bits(fam):
    """In one process (Python's string hash is the same for both) the extra
    stream equals JAX's bit for bit, on each host; a restored cursor replays
    it."""
    jcfg, cfg = jax_model(fam)[:2]
    cell = tbase.ShapeCell("c", 24, 8, "train")
    extra = "frames" if cfg.is_encdec else "patches"
    jspecs = {extra: japi.input_specs(jcfg, jbase.ShapeCell(**dataclasses.asdict(cell)))[extra]}
    specs = {extra: api.input_specs(cfg, cell)[extra]}
    for host in range(2):
        mine = DataPipeline(512, 8, 16, seed=4, host_id=host, host_count=2, extra_specs=specs)
        theirs = JaxPipeline(512, 8, 16, seed=4, host_id=host, host_count=2,
                             extra_specs=jspecs)
        first = []
        for _ in range(2):
            a, b = mine.next(), theirs.next()
            assert set(a) == set(b) == {"tokens", extra}
            assert a[extra].dtype == np.float32
            assert a[extra].shape == (4, cfg.frontend_tokens, cfg.d_model)
            assert all(np.array_equal(a[k], b[k]) for k in a)
            first.append(a)
        mine.restore({"step": 1, "seed": 4})
        again = mine.next()
        assert all(np.array_equal(again[k], first[1][k]) for k in again)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_checkpoints_carry_the_new_trees_across(fam, tmp_path):
    """A state written by ``repro``'s CheckpointManager restores into the
    port tensor for tensor (the enc-dec tree, ``patch_proj``), and a port
    checkpoint restores into ``repro``, under JAX's leaf names."""
    _, cfg, jparams = jax_model(fam)
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
    mine = like.params.tensors()
    theirs = flat(jax.tree.map(np.asarray, back.params))
    assert set(theirs) == set(mine)
    for name, a in theirs.items():
        assert np.array_equal(a, mine[name].detach().numpy()), name
