"""The training path of the port against the JAX package, on the CPU.

The dense SMOKE configs (float32, 2 layers) with the JAX
``init_state(PRNGKey(0))`` carried over by ``convert.train_state``, token
batches from a seeded numpy generator.  Tolerances:

  * the loss, its gradients and one ``make_train_step`` step (m, v,
    grad_norm) within rtol 1e-5, with an absolute floor of 1e-6 x the
    largest magnitude of the quantity compared: the two packages add the same
    float32 products in other orders, so an element that is a cancelling
    sum is off by round-off of its terms, not of itself;
  * the parameters after that step within rtol 1e-5 plus the first-order
    effect of that gradient error on AdamW's first update,
    lr * eps * dg / (|g| + eps)^2 (at step 1 the update is
    lr * g / (|g| + eps), steep where |g| is near eps);
  * ``cosine_warmup`` and ``adamw_update`` within rtol 1e-6 (the same
    float32 operations, elementwise; ``adamw_update`` with a floor of 1e-7 x
    the largest magnitude, for parameters that ``p - lr * delta`` cancels);
  * the data pipeline, the checkpoint round trips and remat on vs off: bit
    for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JaxCheckpointManager
from repro.configs import base as jbase
from repro.data import DataPipeline as JaxPipeline
from repro.models import api as japi
from repro.models import lm as jlm
from repro.optim import adamw_update as jax_adamw_update
from repro.optim import cosine_warmup as jax_cosine_warmup
from repro.runtime import compression as jcomp
from repro_torch import checkpoint, convert
from repro_torch.configs import base as tbase
from repro_torch.data import DataPipeline, PipelineState
from repro_torch.examples import train_lm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.launch import train as train_mod
from repro_torch.models import api, lm
from repro_torch.optim import adamw_init, adamw_update, cosine_warmup
from repro_torch.runtime import compression

ARCHS = ("qwen3_0_6b", "llama3_2_3b", "yi_9b", "nemotron_4_340b")
B, S = 4, 16


def close(got, want, rtol=1e-5, floor=1e-6):
    want = np.asarray(want, dtype=np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=floor * max(float(np.abs(want).max()), 1e-30))


def tokens_for(cfg, seed=3, b=B, s=S):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def jax_state(jcfg):
    return japi.init_state(jcfg, jax.random.PRNGKey(0))


def to_np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_named(tree) -> dict[str, np.ndarray]:
    """A JAX params / moments tree by the port's dotted names."""
    out = {f"blocks.{k}": np.asarray(v) for k, v in tree["blocks"].items()}
    out.update({k: np.asarray(v) for k, v in tree.items() if k != "blocks"})
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_gradients_match_jax(arch):
    jcfg, cfg = jbase.get_smoke_config(arch), tbase.get_smoke_config(arch)
    jstate = jax_state(jcfg)
    tokens = tokens_for(cfg)
    want_loss, want_grads = jax.value_and_grad(jlm.train_loss)(
        jstate.params, {"tokens": jnp.asarray(tokens)}, jcfg)
    state = convert.train_state(to_np(jstate), cfg, device="cpu")
    loss, grads = api.loss_and_grads(state.params, {"tokens": torch.from_numpy(tokens)}, cfg)
    close(loss, want_loss)
    want = jax_named(want_grads)
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and tuple(g.shape) == want[name].shape
        close(g, want[name])


@pytest.mark.parametrize("accum_mode", ["grads", "loss_scan"])
@pytest.mark.parametrize("arch", ["qwen3_0_6b", "nemotron_4_340b"])
def test_one_train_step_matches_jax(arch, accum_mode):
    """One ``make_train_step`` step at ``microbatch=2`` in each accumulation
    mode, from the same state and batch."""
    over = dict(microbatch=2, accum_mode=accum_mode)
    jcfg = jbase.get_smoke_config(arch, **over)
    cfg = tbase.get_smoke_config(arch, **over)
    jstate = jax_state(jcfg)
    tokens = tokens_for(cfg)
    kw = dict(peak_lr=1e-2, warmup=2, total_steps=10)
    jnew, jm = jax.jit(japi.make_train_step(jcfg, **kw))(jstate, {"tokens": jnp.asarray(tokens)})
    state = convert.train_state(to_np(jstate), cfg, device="cpu")
    new, metrics = api.make_train_step(cfg, **kw)(state, {"tokens": torch.from_numpy(tokens)})
    close(metrics["loss"], jm["loss"])
    close(metrics["grad_norm"], jm["grad_norm"])
    assert int(new.step) == int(jnew.step) == 1
    for mine, theirs in ((new.m, jnew.m), (new.v, jnew.v)):
        want = jax_named(theirs)
        assert set(mine) == set(want)
        for name, t in mine.items():
            close(t, want[name])
    lr, eps = float(cosine_warmup(1, peak_lr=1e-2, warmup=2, total=10)), 1e-8
    scale = min(1.0, 1.0 / float(jm["grad_norm"]))         # the step's clipping
    want_p, want_m = jax_named(jnew.params), jax_named(jnew.m)
    for name, t in new.params.tensors().items():
        g = np.abs(want_m[name] / 0.1)                       # m = (1 - b1) g at step 1
        dg = 1e-5 * g + 1e-6 * g.max()                       # the gradients' tolerance
        bound = 1e-5 * np.abs(want_p[name]) + np.minimum(
            2 * lr, lr * eps * dg / (g + eps) ** 2) + 1e-7 * scale
        diff = np.abs(t.detach().numpy() - want_p[name])
        assert (diff <= bound).all(), (name, float((diff - bound).max()))


def test_grad_transform_runs_before_adamw():
    cfg = tbase.get_smoke_config("qwen3_0_6b")
    seen = {}

    def zero(grads):
        seen.update(grads)
        return {name: torch.zeros_like(g) for name, g in grads.items()}

    state = api.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    before = {name: t.detach().clone() for name, t in state.params.tensors().items()}
    new, metrics = api.make_train_step(cfg, grad_transform=zero)(
        state, {"tokens": torch.from_numpy(tokens_for(cfg))})
    assert set(seen) == set(before) and float(metrics["grad_norm"]) == 0.0
    # zero gradients: only the weight decay moves the parameters
    lr = float(cosine_warmup(1, peak_lr=3e-4, warmup=100, total=10_000))
    for name, t in new.params.tensors().items():
        torch.testing.assert_close(t.detach(), before[name] * (1 - lr * 0.1), rtol=1e-6, atol=0)


@pytest.mark.parametrize("step", [0, 1, 4, 5, 6, 50, 99, 100, 101, 5000, 10_000, 20_000])
def test_cosine_warmup_matches_jax(step):
    kw = dict(peak_lr=3e-4, warmup=100, total=10_000)
    want = np.asarray(jax_cosine_warmup(jnp.asarray(step), **kw))
    for s in (step, torch.tensor(step), torch.tensor(step, dtype=torch.int32)):
        got = cosine_warmup(s, **kw)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("clip", [1.0, None, 1e3])
@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_matches_jax(clip, state_dtype):
    """One update at step 3 from random moments (JAX's float32 arithmetic;
    bf16 moments as nemotron stores them)."""
    cfg = tbase.get_smoke_config("llama3_2_3b", opt_state_dtype=state_dtype)
    jcfg = jbase.get_smoke_config("llama3_2_3b", opt_state_dtype=state_dtype)
    rng = np.random.default_rng(7)
    jstate = jax_state(jcfg)
    noise = lambda a, scale: jnp.asarray(rng.standard_normal(a.shape) * scale).astype(a.dtype)
    jstate = jstate._replace(m=jax.tree.map(lambda a: noise(a, 1e-2), jstate.m),
                             v=jax.tree.map(lambda a: jnp.abs(noise(a, 1e-3)), jstate.v),
                             step=jnp.asarray(3, jnp.int32))
    jgrads = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
                          jstate.params)
    jnew, jm = jax_adamw_update(jstate, jgrads, 1e-3, clip_norm=clip)
    state = convert.train_state(to_np(jstate), cfg, device="cpu")
    assert state.m["embed"].dtype == getattr(torch, state_dtype)
    grads = {name: torch.tensor(a) for name, a in jax_named(jgrads).items()}
    new, metrics = adamw_update(state, grads, 1e-3, clip_norm=clip)
    np.testing.assert_allclose(metrics["grad_norm"].numpy(), np.asarray(jm["grad_norm"]), rtol=1e-6)
    assert int(new.step) == 4
    for mine, theirs in ((new.params.tensors(), jnew.params), (new.m, jnew.m), (new.v, jnew.v)):
        want = jax_named(theirs)
        for name, t in mine.items():
            close(t, want[name].astype(np.float32), rtol=1e-6, floor=1e-7)


@pytest.mark.parametrize("seed", [0, 11])
def test_data_pipeline_batches_are_the_jax_bits(seed):
    for host in range(2):
        mine = DataPipeline(512, 8, 24, seed=seed, host_id=host, host_count=2)
        theirs = JaxPipeline(512, 8, 24, seed=seed, host_id=host, host_count=2)
        for _ in range(3):
            a, b = mine.next(), theirs.next()
            assert a["tokens"].dtype == np.int32 and a["tokens"].shape == (4, 24)
            assert np.array_equal(a["tokens"], b["tokens"])
        assert mine.state.to_dict() == theirs.state.to_dict() == {"step": 3, "seed": seed}


def test_data_pipeline_cursor_restores_and_refuses_extra_specs():
    """The cursor restores; formerly ``extra_specs`` raised, now the
    pipeline takes them (any ``.shape``: a meta tensor or a numpy array)
    and a restored cursor replays the extra stream too."""
    patches = torch.empty((4, 3, 5), device="meta")
    pipe = DataPipeline(100, 4, 8, seed=2, extra_specs={"patches": patches})
    first = [pipe.next() for _ in range(3)]
    assert first[0]["patches"].shape == (4, 3, 5) and first[0]["patches"].dtype == np.float32
    pipe.restore({"step": 1, "seed": 2})
    again = pipe.next()
    assert all(np.array_equal(again[k], first[1][k]) for k in ("tokens", "patches"))
    pipe.restore(PipelineState(step=2, seed=2))
    assert np.array_equal(pipe.next()["tokens"], first[2]["tokens"])
    with pytest.raises(ValueError, match="hosts"):
        DataPipeline(100, 5, 8, host_count=2)
    plain = DataPipeline(100, 4, 8, seed=2, extra_specs={"frames": np.zeros((9, 3, 5))})
    assert np.array_equal(plain.next()["tokens"], first[0]["tokens"])


@pytest.mark.parametrize("kind", ["int8", "topk", "none"])
def test_compression_matches_jax_with_error_feedback(kind):
    """Three steps of ``apply``: the decompressed gradients and the residual
    state equal JAX's within float32 round-off of the largest entry."""
    rng = np.random.default_rng(5)
    shapes = {"a": (33, 17), "blocks.w": (2, 40), "c": (5,)}
    j_init, j_apply = jcomp.make_compressor(kind, k_frac=0.1)
    init, apply = compression.make_compressor(kind, k_frac=0.1)
    jstate = state = None
    for _ in range(3):
        g = {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
        jg = {n: jnp.asarray(a) for n, a in g.items()}
        tg = {n: torch.from_numpy(a) for n, a in g.items()}
        jstate = j_init(jg) if jstate is None else jstate
        state = init(tg) if state is None else state
        jout, jstate = j_apply(jg, jstate)
        out, state = apply(tg, state)
        for n in shapes:
            np.testing.assert_allclose(out[n].numpy(), np.asarray(jout[n]), rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(state[n].numpy(), np.asarray(jstate[n]),
                                       rtol=1e-6, atol=1e-7)
    for n_elems in (1, 1000):
        assert compression.compressed_bytes(kind, n_elems, k_frac=0.1) == \
            jcomp.compressed_bytes(kind, n_elems, k_frac=0.1)


def _bf16_cfgs(arch="nemotron_4_340b"):
    over = dict(dtype="bfloat16", opt_state_dtype="bfloat16")
    return jbase.get_smoke_config(arch, **over), tbase.get_smoke_config(arch, **over)


@pytest.mark.parametrize("arch", ["qwen3_0_6b", "nemotron_4_340b"])
def test_a_jax_checkpoint_restores_into_the_port(arch, tmp_path):
    """``repro``'s CheckpointManager writes a bf16 TrainState (bf16 stored as
    uint16 views); the port restores it tensor for tensor, meta included."""
    jcfg, cfg = _bf16_cfgs(arch)
    jstate = jax_state(jcfg)
    rng = np.random.default_rng(1)
    jstate = jstate._replace(m=jax.tree.map(
        lambda a: jnp.asarray(rng.standard_normal(a.shape)).astype(a.dtype), jstate.m),
        step=jnp.asarray(7, jnp.int32))
    mgr = JaxCheckpointManager(str(tmp_path))
    mgr.save_async(7, jstate, extra_meta={"pipeline": {"step": 7, "seed": 0}})
    mgr.wait()
    like = api.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    step, got, meta = checkpoint.CheckpointManager(str(tmp_path)).restore_latest(like)
    assert step == 7 and meta["pipeline"] == {"step": 7, "seed": 0}
    assert int(got.step) == 7 and got.step.dtype == torch.int32
    assert all(t.requires_grad for t in got.params.tensors().values())
    want = convert.train_state(to_np(jstate), cfg, device="cpu")
    for mine, theirs in ((got.params.tensors(), want.params.tensors()), (got.m, want.m),
                         (got.v, want.v)):
        assert set(mine) == set(theirs)
        for name, t in mine.items():
            assert t.dtype == torch.bfloat16 and torch.equal(t.detach(), theirs[name].detach())


def test_a_port_checkpoint_restores_into_jax(tmp_path):
    jcfg, cfg = _bf16_cfgs("llama3_2_3b")
    state = api.init_state(cfg, torch.Generator().manual_seed(4), device="cpu")
    checkpoint.save(str(tmp_path), 3, state, extra_meta={"lea": {"rounds": 3}})
    like = jax_state(jcfg)
    from repro.checkpoint import restore as jax_restore
    got, meta = jax_restore(str(tmp_path), 3, like)
    assert meta["lea"] == {"rounds": 3}
    for name, a in jax_named(got.params).items():
        want = state.params.tensors()[name].detach().float().numpy()
        assert np.array_equal(a.astype(np.float32), want), name


def test_checkpoint_manager_keeps_three_and_refuses_another_structure(tmp_path):
    cfg = tbase.get_smoke_config("yi_9b")
    state = api.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    mgr = checkpoint.CheckpointManager(str(tmp_path), keep=3)
    for step in (2, 4, 6, 8):
        mgr.save_async(step, state)
        # the caller's in-place update after save_async must not reach the file
        state.m["embed"].add_(1.0)
    mgr.wait()
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_4", "step_6", "step_8"]
    assert checkpoint.latest_step(str(tmp_path)) == 8
    (tmp_path / "step_9.tmp").mkdir()           # a crash mid-write is ignored
    assert checkpoint.latest_step(str(tmp_path)) == 8
    got, _ = checkpoint.restore(str(tmp_path), 8, state)
    assert torch.equal(got.m["embed"], state.m["embed"] - 1.0)
    other = api.init_state(dataclasses.replace(cfg, tie_embeddings=True),
                           torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(tmp_path), 8, other)
    assert checkpoint.latest_step(str(tmp_path / "missing")) is None


@pytest.mark.parametrize("scan_groups", [1, 2])
def test_remat_is_bit_equal_to_no_remat(scan_groups):
    """Remat (per block, and per group of blocks as JAX groups them) changes
    memory, not values: one train step bit for bit."""
    base = tbase.get_smoke_config("qwen3_0_6b", n_layers=4, scan_groups=scan_groups,
                                  microbatch=2)
    tokens = torch.from_numpy(tokens_for(base))
    out = {}
    for remat in (False, True):
        cfg = dataclasses.replace(base, remat=remat)
        state = api.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
        loss, grads = api.loss_and_grads(state.params, {"tokens": tokens}, cfg)
        new, metrics = api.make_train_step(cfg)(state, {"tokens": tokens})
        out[remat] = (loss, grads, new.params.tensors(), metrics["grad_norm"])
    (l0, g0, p0, n0), (l1, g1, p1, n1) = out[False], out[True]
    assert torch.equal(l0, l1) and torch.equal(n0, n1)
    for name in g0:
        assert torch.equal(g0[name], g1[name]), name
        assert torch.equal(p0[name], p1[name]), name


def test_flash_attention_refuses_autograd_on_the_cpu_route():
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    k = v = torch.randn(1, 1, 8, 16)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q.detach(), k.requires_grad_(), v)
    with torch.no_grad():                      # forward only: runs
        assert flash_attention(q, k, v).shape == q.shape


def test_training_a_flash_config_raises():
    cfg = tbase.get_smoke_config("qwen3_0_6b", attn_impl="flash")
    with pytest.raises(RuntimeError, match="no backward"):
        api.make_train_step(cfg)
    params = api.init_state(cfg, torch.Generator().manual_seed(0), device="cpu").params
    with pytest.raises(RuntimeError, match="no backward"):
        lm.train_loss(params, {"tokens": torch.from_numpy(tokens_for(cfg))}, cfg)
    # serving the same trainable parameters still takes the flash route
    logits, _ = api.make_prefill_step(cfg)(params, {"tokens": torch.from_numpy(tokens_for(cfg))})
    assert torch.isfinite(logits).all()


def test_init_state_is_trainable_with_zero_moments():
    cfg = tbase.get_smoke_config("nemotron_4_340b", opt_state_dtype="bfloat16")
    state = api.init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(t.requires_grad for t in state.params.tensors().values())
    assert set(state.m) == set(state.params.tensors())
    assert all(t.dtype == torch.bfloat16 and not t.any() for t in state.m.values())
    assert state.step.dtype == torch.int32 and int(state.step) == 0
    # the serving entry points keep frozen parameters
    fresh = api.get_model(cfg).init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    assert not any(t.requires_grad for t in fresh.parameters())
    assert adamw_init(fresh).m.keys() == state.m.keys()


def _train(*args):
    return train_mod.main(["--device", "cpu", "--smoke", "--batch", "8", "--seq", "16",
                           *args])


def test_trainer_loss_falls_over_20_steps():
    out = _train("--steps", "20", "--lr", "3e-3")
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == out["steps_done"] == 20
    assert losses[-1] < losses[0] and all(np.isfinite(losses))
    assert set(out) == {"history", "steps_done", "wall_s"}


def test_trainer_with_coded_dp_reports_timely_throughput(tmp_path):
    out = _train("--steps", "8", "--lr", "3e-3", "--coded-dp", "--ckpt-dir", str(tmp_path),
                 "--ckpt-every", "4", "--compress", "int8")
    losses = [h["loss"] for h in out["history"] if "loss" in h]
    assert losses and all(np.isfinite(losses))
    assert 0.0 < out["timely_throughput"] <= 1.0
    meta = checkpoint.restore(str(tmp_path), 8, api.init_state(
        tbase.get_smoke_config("qwen3_0_6b"), torch.Generator(), device="cpu"))[1]
    assert meta["pipeline"]["step"] == 8 and meta["lea"]["rounds"] == 8


def test_trainer_resumed_run_equals_the_uninterrupted_run_bit_for_bit(tmp_path):
    """6 steps in one go, and 6 steps interrupted after the checkpoint at 3
    (the later checkpoint removed) and resumed: the same losses after step
    3 and the same final state, bit for bit."""
    whole, cut = tmp_path / "whole", tmp_path / "cut"
    full = _train("--steps", "6", "--ckpt-dir", str(whole), "--ckpt-every", "3")
    _train("--steps", "6", "--ckpt-dir", str(cut), "--ckpt-every", "3")
    for p in (cut / "step_6").iterdir():
        p.unlink()
    (cut / "step_6").rmdir()
    resumed = _train("--steps", "6", "--ckpt-dir", str(cut), "--ckpt-every", "3")
    assert [h["step"] for h in resumed["history"]] == [3, 4, 5]
    assert resumed["history"] == full["history"][3:]
    with np.load(whole / "step_6" / "arrays.npz") as a, np.load(cut / "step_6" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for name in a.files:
            assert np.array_equal(a[name], b[name]), name


def test_train_lm_example_runs_on_the_cpu():
    out = train_lm.run("cpu", steps=12)
    assert out["losses"][-1] < out["losses"][0]
