"""The port's multi-card slice against the JAX package, on the CPU.

The sharding rules (``_param_spec``, ``param_shardings``,
``batch_shardings``, ``cache_shardings``) are pure functions of a mesh's
shape: for every config's SMOKE tree and full-width abstract tree they must
give JAX's ``PartitionSpec`` leaf for leaf on a (2, 4) and a (2, 16, 16)
mesh, and the DTensor placements that spec names.

The sharded paths run in ONE gloo group of four CPU processes (this file as
a script, ``--worker``), spawned once for the module; each check is its own
test below.  The parent computes the JAX references in this process and
hands them over as numpy arrays; the workers never import ``jax``:

  * the qwen3 SMOKE train step on a (2 data x 2 model) mesh against the
    port's single-rank step and ``repro``'s (loss and gradient norm at
    1e-5, the updated parameters at the JAX test's rtol 2e-2 / atol 2e-3);
  * ``moe_impl="ep"`` over (1 x 4) against the dense ``moe`` and
    ``repro.models.layers.moe`` (the JAX test's config) at 1e-5;
  * yi's ``_sharded_lse_decode`` over (1 x 4): prefill and 4 decode steps
    against the local decode and ``repro``'s at 1e-5;
  * the prefill on both ``attention_train`` branches (SMOKE ``n_heads=4``:
    query sequence over tp; ``n_heads=16``: heads) for ``ref`` and
    ``flash``, logits, cache and 4 decode steps against one rank at 1e-5
    (the single-rank path is held to ``repro`` in ``test_torch_lm.py``);
  * olmoe's prefill and decode with ``moe_impl="ep"`` against one rank;
  * ``pipeline_forward`` over 4 stages against ``reference_forward`` and
    ``repro``'s (the JAX test's shapes) at 1e-5;
  * a state saved from (2 x 2) restored onto (1 x 4) with
    ``restore(shardings=)`` and ``reshard_state``: bit-equal.

Plus the dry-run CLI on ``whisper_tiny x decode_32k``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import traceback

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "..", "src")
RANKS = 4
TOL = 1e-5
SEQ, BATCH, MAX_LEN, STEPS = 12, 2, 16, 4


# ---------------------------------------------------------------------------
# the worker: one rank of the gloo group (no jax here)
# ---------------------------------------------------------------------------

def _nested(flat: dict) -> dict:
    tree: dict = {}
    for name, a in flat.items():
        *heads, leaf = name.split(".")
        node = tree
        for h in heads:
            node = node.setdefault(h, {})
        node[leaf] = a
    return tree


def _leaves(tree, prefix: str = ""):
    """(dotted path, leaf) of a cache's nested tuples, in order."""
    if isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from _leaves(t, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def _worker(rank: int, coord: str, inp: str, out: str) -> None:
    import torch

    from repro_torch import convert
    from repro_torch.checkpoint import restore, save
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import api, layers, sharding
    from repro_torch.models import xlstm as xlstm_model
    from repro_torch.models.sharding import full, use_mesh
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.elastic import reshard_state
    from repro_torch.runtime.pipeline_parallel import pipeline_forward, reference_forward

    torch.manual_seed(0)
    torch.set_num_threads(1)
    lmesh.init_distributed(coordinator=coord, num_processes=RANKS, process_id=rank)
    data = dict(np.load(inp))
    res, errors = {}, {}
    mesh22 = lmesh.make_host_mesh((2, 2), ("data", "model"), device="cpu")
    mesh14 = lmesh.make_host_mesh((1, 4), ("data", "model"), device="cpu")
    pod4 = lmesh.make_host_mesh((4,), ("pod",), device="cpu")

    calls = {}

    def counted(name):
        fn = getattr(layers, name)

        def run(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kwargs)

        setattr(layers, name, run)

    for name in ("_sharded_lse_decode", "_moe_ep", "_attention_sharded", "mlstm_sharded",
                 "slstm_sharded"):
        counted(name)
    local_heads = []                    # the heads of each local mlstm_chunked call
    plain_mlstm = layers.mlstm_chunked

    def mlstm_chunked(q, *args, **kwargs):
        local_heads.append(q.shape[2])
        return plain_mlstm(q, *args, **kwargs)

    layers.mlstm_chunked = mlstm_chunked

    def params_of(prefix, cfg):
        flat = {k[len(prefix):]: v for k, v in data.items() if k.startswith(prefix)}
        return convert.model_params(_nested(flat), cfg, device="cpu")

    def check(name, fn):
        try:
            fn()
        except Exception:
            errors[name] = traceback.format_exc()[-3000:]

    def train(tag="train", **over):
        cfg = get_smoke_config("qwen3_0_6b", **over)
        tokens = torch.from_numpy(data["train.tokens"])
        step = api.make_train_step(cfg, peak_lr=1e-3, warmup=1)
        state = adamw_init(params_of("train.p.", cfg).trainable())
        one, m1 = step(state, {"tokens": tokens})
        res[f"{tag}.single_loss"] = np.float32(m1["loss"])
        res[f"{tag}.single_gnorm"] = np.float32(m1["grad_norm"])
        state = adamw_init(params_of("train.p.", cfg).trainable())
        sh = api.state_shardings(cfg, mesh22, state)
        state_d = api.distribute_tree(state, sh)
        bsh = api.batch_shardings(cfg, mesh22, {"tokens": tokens})
        batch_d = api.distribute_tree({"tokens": tokens}, bsh)
        step_d = api.make_train_step(cfg, peak_lr=1e-3, warmup=1, grad_shardings=sh.params)
        with use_mesh(mesh22):
            new, metrics = step_d(state_d, batch_d)
        res[f"{tag}.loss"] = np.float32(full(metrics["loss"]).item())
        res[f"{tag}.gnorm"] = np.float32(full(metrics["grad_norm"]).item())
        for n, t in new.params.tensors().items():
            if tuple(t.placements) != sh.params[n].placements:
                raise AssertionError(f"{n}: placements {t.placements} != {sh.params[n]}")
            res[f"{tag}.new.{n}"] = full(t).detach().numpy()
            res[f"{tag}.single.{n}"] = one.params.tensors()[n].detach().numpy()

    def moe_ep():
        from repro_torch.configs.base import ArchConfig

        cfg = ArchConfig(name="t", family="moe", n_layers=1, d_model=32, n_heads=2,
                         n_kv_heads=2, head_dim=16, d_ff=16, vocab_size=128, n_experts=8,
                         top_k=2, capacity_factor=100.0, dtype="float32", remat=False)
        p = {k: torch.from_numpy(data[f"moe.{k}"]) for k in ("router", "w_gate", "w_up", "w_down")}
        x = torch.from_numpy(data["moe.x"])
        res["moe.dense"] = layers.moe(x, p, cfg).numpy()
        before = calls.get("_moe_ep", 0)
        with use_mesh(mesh14):
            res["moe.ep"] = layers.moe(x, p, dataclasses.replace(cfg, moe_impl="ep")).numpy()
        # drops: a capacity that overflows, held to the dense route the same way
        small = dataclasses.replace(cfg, capacity_factor=0.5)
        res["moe.dense_drop"] = layers.moe(x, p, small).numpy()
        with use_mesh(mesh14):
            res["moe.ep_drop"] = layers.moe(
                x, p, dataclasses.replace(small, moe_impl="ep")).numpy()
        res["moe.calls"] = np.int64(calls.get("_moe_ep", 0) - before)

    def serve(key, cfg, prefix, mesh, impl):
        """Prefill + STEPS decode steps, unsharded and over ``mesh``."""
        tokens = torch.from_numpy(data["serve.tokens"])
        nxt = torch.from_numpy(data["serve.next"])
        params = params_of(prefix, cfg)
        before = dict(calls)
        prefill = api.make_prefill_step(cfg, max_len=MAX_LEN, attn_impl=impl)
        dec = api.make_serve_step(cfg)
        for tag, m in (("one", None), ("mesh", mesh)):
            p = params if m is None else api.distribute_tree(
                params, api.param_shardings(cfg, m, params))
            with use_mesh(m):
                logits, cache = prefill(p, {"tokens": tokens})
                res[f"{key}.{tag}.prefill"] = full(logits).numpy().copy()
                res[f"{key}.{tag}.k"] = full(cache["k"]).numpy().copy()
                res[f"{key}.{tag}.v"] = full(cache["v"]).numpy().copy()
                if m is not None and not sharding.is_dtensor(cache["k"]):
                    raise AssertionError("the sharded prefill's cache is not sharded")
                outs = []
                for i in range(STEPS):
                    lg, cache = dec(p, cache, {"next_token": nxt[:, i]})
                    outs.append(full(lg).numpy())
                res[f"{key}.{tag}.decode"] = np.stack(outs)
                res[f"{key}.{tag}.kd"] = full(cache["k"]).numpy()
        for name in calls:
            res[f"{key}.calls.{name}"] = np.int64(calls[name] - before.get(name, 0))

    def xlstm(key, mesh):
        """The xlstm SMOKE prefill + STEPS decode steps, unsharded and over
        ``mesh``; every state leaf, and the carried cells' placements held
        to the cache rule."""
        cfg = get_smoke_config("xlstm_125m")
        tokens = torch.from_numpy(data["serve.tokens"])
        nxt = torch.from_numpy(data["serve.next"])
        params = params_of("xlstm.p.", cfg)
        before = dict(calls)
        prefill = api.make_prefill_step(cfg, max_len=MAX_LEN)
        dec = api.make_serve_step(cfg)
        for tag, m in (("one", None), ("mesh", mesh)):
            p = params if m is None else api.distribute_tree(
                params, api.param_shardings(cfg, m, params))
            del local_heads[:]
            with use_mesh(m):
                logits, cache = prefill(p, {"tokens": tokens})
                res[f"{key}.{tag}.prefill"] = full(logits).numpy().copy()
                for name, t in _leaves(cache["blocks"]):
                    res[f"{key}.{tag}.state.{name}"] = full(t).numpy().copy()
                if m is not None:
                    rule = dict(_leaves(api.cache_shardings(cfg, m, cache)["blocks"]))
                    kinds = xlstm_model.block_types(cfg)
                    for name, t in _leaves(cache["blocks"]):
                        block, part = name.split(".")[:2]
                        if kinds[int(block)] == "mlstm" and part == "1":   # the conv window
                            continue
                        if tuple(t.placements) != rule[name].placements:
                            raise AssertionError(f"{name}: placements {t.placements} "
                                                 f"!= {rule[name].placements}")
                    res[f"{key}.local_heads"] = np.int64(max(local_heads))
                outs = []
                for i in range(STEPS):
                    lg, cache = dec(p, cache, {"next_token": nxt[:, i]})
                    outs.append(full(lg).numpy())
                res[f"{key}.{tag}.decode"] = np.stack(outs)
        for name in calls:
            res[f"{key}.calls.{name}"] = np.int64(calls[name] - before.get(name, 0))

    def pp():
        w, b, x = (torch.from_numpy(data[f"pp.{k}"]) for k in ("w", "b", "x"))
        fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
        res["pp.got"] = pipeline_forward(fn, {"w": w, "b": b}, x, pod4, axis="pod").numpy()
        res["pp.ref"] = reference_forward(fn, {"w": w, "b": b}, x).numpy()

    def reshard():
        cfg = get_smoke_config("qwen3_0_6b")
        state = adamw_init(params_of("train.p.", cfg).trainable())
        g = torch.Generator().manual_seed(3)
        for t in list(state.m.values()) + list(state.v.values()):
            t.copy_(torch.rand(t.shape, generator=g))
        state8 = api.distribute_tree(state, api.state_shardings(cfg, mesh22, state))
        d = data["ckpt_dir"].item() if data["ckpt_dir"].shape == () else str(data["ckpt_dir"])
        save(d, 3, state8)
        sh4 = api.state_shardings(cfg, mesh14, state)
        restored, _ = restore(d, 3, state, shardings=sh4)
        moved = reshard_state(state8, sh4)
        flat = lambda s: {**{f"p.{n}": t for n, t in s.params.tensors().items()},
                          **{f"m.{n}": t for n, t in s.m.items()},
                          **{f"v.{n}": t for n, t in s.v.items()}}
        want = flat(state)
        for tag, tree in (("restore", restored), ("reshard", moved)):
            for n, t in flat(tree).items():
                if tuple(t.placements) != sh4.params[n[2:]].placements or t.device_mesh != mesh14:
                    raise AssertionError(f"{tag} {n}: placements {t.placements}")
                if not torch.equal(full(t).detach(), want[n].detach()):
                    raise AssertionError(f"{tag} {n}: values differ")
        res["reshard.leaves"] = np.int64(len(want))

    qwen = get_smoke_config("qwen3_0_6b")
    check("train", train)
    check("train_mb2", lambda: train("train_mb2", microbatch=2))    # each rank's rows split
    check("train_mb4", lambda: train("train_mb4", microbatch=4))    # rows gathered first
    check("moe", moe_ep)
    yi = get_smoke_config("yi_9b", decode_attn="sharded_lse")   # yi-9b's own setting
    check("decode", lambda: serve("yi", yi, "yi.p.", mesh14, "ref"))
    for impl in ("ref", "flash"):
        check(f"seq_{impl}", lambda impl=impl: serve(f"seq_{impl}", qwen, "train.p.", mesh14, impl))
        check(f"heads_{impl}", lambda impl=impl: serve(
            f"heads_{impl}", dataclasses.replace(qwen, n_heads=16), "h16.p.", mesh14, impl))
    check("olmoe", lambda: serve("olmoe", dataclasses.replace(
        get_smoke_config("olmoe_1b_7b"), moe_impl="ep"), "olmoe.p.", mesh14, "ref"))
    check("xlstm_heads", lambda: xlstm("xlstm_heads", mesh22))       # 2 heads over tp 2
    check("xlstm_gathered", lambda: xlstm("xlstm_gathered", mesh14))  # 2 heads, tp 4
    check("pp", pp)
    check("reshard", reshard)
    if rank == 0:
        np.savez(out, **res)
        with open(out + ".errors.json", "w") as f:
            json.dump(errors, f)
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.path.insert(0, SRC)
        _worker(int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5])
        sys.exit(0)


# ---------------------------------------------------------------------------
# the parent: JAX references, the group, the checks
# ---------------------------------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.models import api as japi  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.runtime import pipeline_parallel as jpp  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.models import api, sharding  # noqa: E402

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def _flat_np(tree, prefix: str) -> dict:
    return {prefix + k: np.asarray(v) for k, v in convert._named(
        jax.tree.map(np.asarray, tree)).items()}


def _jax_serve(jcfg, jparams, tokens, nxt):
    logits, cache = japi.make_prefill_step(jcfg, max_len=MAX_LEN)(jparams, {"tokens": tokens})
    serve = jax.jit(japi.make_serve_step(jcfg))
    outs = []
    for i in range(STEPS):
        lg, cache = serve(jparams, cache, {"next_token": nxt[:, i]})
        outs.append(np.asarray(lg))
    return np.asarray(logits), np.stack(outs)


def _inputs(tmp) -> tuple[dict, dict]:
    """The workers' inputs as numpy arrays (JAX's seeded initialisations),
    and what the JAX references are computed from."""
    data, ref = {}, {}
    # the qwen3 SMOKE train step (tests/distributed/_sharded_train.py)
    jcfg = jbase.get_smoke_config("qwen3_0_6b")
    cell = jbase.ShapeCell("t", seq_len=32, global_batch=4, kind="train")
    key = jax.random.PRNGKey(0)
    ref["train"] = (jcfg, japi.init_state(jcfg, key), japi.make_batch(jcfg, cell, key))
    data.update(_flat_np(ref["train"][1].params, "train.p."))
    data["train.tokens"] = np.asarray(ref["train"][2]["tokens"])
    # expert parallelism (tests/distributed/_moe_ep.py)
    mcfg = jbase.ArchConfig(
        name="t", family="moe", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=16, vocab_size=128, n_experts=8, top_k=2,
        capacity_factor=100.0, dtype="float32", remat=False)
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    p = {"router": jax.random.normal(ks[0], (32, 8)) * 0.5,
         "w_gate": jax.random.normal(ks[1], (8, 32, 16)) * 0.2,
         "w_up": jax.random.normal(ks[2], (8, 32, 16)) * 0.2,
         "w_down": jax.random.normal(ks[3], (8, 16, 32)) * 0.2}
    x = jax.random.normal(ks[4], (2, 6, 32))
    ref["moe"] = (mcfg, p, x)
    data.update({f"moe.{k}": np.asarray(v) for k, v in p.items()})
    data["moe.x"] = np.asarray(x)
    # serving: yi (sharded_lse), qwen3 at 16 heads, olmoe
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 512, (BATCH, SEQ), dtype=np.int32)
    nxt = rng.integers(0, 512, (BATCH, STEPS), dtype=np.int32)
    data["serve.tokens"], data["serve.next"] = tokens, nxt
    for tag, name, over in (("yi", "yi_9b", {}), ("h16", "qwen3_0_6b", {"n_heads": 16}),
                            ("olmoe", "olmoe_1b_7b", {}), ("xlstm", "xlstm_125m", {})):
        c = jbase.get_smoke_config(name, **over)
        jp = japi.get_model(c).init_params(jax.random.PRNGKey(0), c)
        data.update(_flat_np(jp, f"{tag}.p."))
        if tag in ("yi", "xlstm"):   # JAX's serving: what the sharded path must equal
            ref[tag] = (c, jp, tokens, nxt)
    # the pipeline (tests/distributed/_pp_forward.py)
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    pw = jax.random.normal(ks[0], (4, 16, 16)) * 0.3
    pb = jax.random.normal(ks[1], (4, 16)) * 0.1
    px = jax.random.normal(ks[2], (6, 3, 16))
    ref["pp"] = ({"w": pw, "b": pb}, px)
    data.update({"pp.w": np.asarray(pw), "pp.b": np.asarray(pb), "pp.x": np.asarray(px)})
    data["ckpt_dir"] = np.asarray(str(tmp / "ckpt"))
    return data, ref


def _jax_references(ref) -> dict:
    want = {}
    jcfg, state, batch = ref["train"]
    new, metrics = jax.jit(japi.make_train_step(jcfg, peak_lr=1e-3, warmup=1))(state, batch)
    want["train.loss"] = float(metrics["loss"])
    want["train.new"] = _flat_np(new.params, "")
    mcfg, p, x = ref["moe"]
    want["moe"] = np.asarray(JL.moe(x, p, mcfg))
    c, jp, tokens, nxt = ref["yi"]
    want["yi.serve"] = _jax_serve(c, jp, jnp.asarray(tokens), jnp.asarray(nxt))
    c, jp, tokens, nxt = ref["xlstm"]
    want["xlstm.serve"] = _jax_serve(c, jp, jnp.asarray(tokens), jnp.asarray(nxt))
    _, cache = japi.make_prefill_step(c, max_len=MAX_LEN)(jp, {"tokens": jnp.asarray(tokens)})
    want["xlstm.state"] = {n: np.asarray(t) for n, t in _leaves(cache["blocks"])}
    params, px = ref["pp"]
    want["pp"] = np.asarray(jpp.reference_forward(
        lambda q, h: jnp.tanh(h @ q["w"] + q["b"]), params, px))
    return want


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """The workers' results, their errors by check, and the JAX references
    (computed while the workers run)."""
    tmp = tmp_path_factory.mktemp("sharding")
    data, ref = _inputs(tmp)
    inp, out = str(tmp / "in.npz"), str(tmp / "out.npz")
    np.savez(inp, **data)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        coord = f"localhost:{sock.getsockname()[1]}"
    env = dict(os.environ, PYTHONPATH=SRC)
    procs = [subprocess.Popen([sys.executable, __file__, "--worker", str(r), coord, inp, out],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(RANKS)]
    logs = []
    try:
        want = _jax_references(ref)
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    with open(out + ".errors.json") as f:
        errors = json.load(f)
    return dict(np.load(out)), errors, want


def _ok(group, name):
    res, errors, want = group
    assert name not in errors, errors[name]
    return res, want


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_train_step_2x2_matches_single_rank_and_jax(group):
    res, want = _ok(group, "train")
    assert abs(res["train.loss"] - res["train.single_loss"]) <= TOL
    assert abs(res["train.loss"] - res["train.single_loss"]) <= TOL
    assert abs(res["train.loss"] - want["train.loss"]) <= TOL
    _close(res["train.gnorm"], res["train.single_gnorm"])
    # AdamW divides by sqrt(v): a gradient near 0 moves its parameter by up
    # to lr whatever its rounding, hence the JAX test's own bounds here
    for name, ref in want["train.new"].items():
        got = res[f"train.new.{name}"]
        np.testing.assert_allclose(got, res[f"train.single.{name}"], rtol=2e-2, atol=2e-3)
        np.testing.assert_allclose(got, ref, rtol=2e-2, atol=2e-3)


@pytest.mark.parametrize("mb", [2, 4])
def test_microbatched_train_step_2x2_matches_single_rank(group, mb):
    """``microbatch=2``: each rank splits its own two rows (other groupings
    than the single rank's, the same mean loss and summed gradients);
    ``microbatch=4``: a rank's two rows do not split 4 ways, so the rows
    are gathered and every rank runs the plain split."""
    tag = f"train_mb{mb}"
    res, _ = _ok(group, tag)
    assert abs(res[f"{tag}.loss"] - res[f"{tag}.single_loss"]) <= TOL
    _close(res[f"{tag}.gnorm"], res[f"{tag}.single_gnorm"])
    for name in [k[len(f"{tag}.new."):] for k in res if k.startswith(f"{tag}.new.")]:
        np.testing.assert_allclose(res[f"{tag}.new.{name}"],
                                   res[f"{tag}.single.{name}"], rtol=2e-2, atol=2e-3)


def test_moe_ep_matches_dense_and_jax(group):
    res, want = _ok(group, "moe")
    _close(res["moe.ep"], res["moe.dense"])
    _close(res["moe.ep"], want["moe"])
    _close(res["moe.ep_drop"], res["moe.dense_drop"])
    assert int(res["moe.calls"]) == 2
    assert not np.allclose(res["moe.dense_drop"], res["moe.dense"])   # routes were dropped


@pytest.mark.parametrize("key,check", [("yi", "decode"), ("olmoe", "olmoe")])
def test_sharded_decode_matches_local_and_jax(group, key, check):
    res, want = _ok(group, check)
    path = {"yi": "_sharded_lse_decode", "olmoe": "_moe_ep"}[key]
    # every layer of every decode step (olmoe: and of the prefill) took it
    assert int(res[f"{key}.calls.{path}"]) == 2 * (STEPS + (key == "olmoe"))
    for part in ("prefill", "k", "v", "decode", "kd"):
        _close(res[f"{key}.mesh.{part}"], res[f"{key}.one.{part}"])
    if key == "yi":
        jprefill, jdecode = want["yi.serve"]
        _close(res["yi.mesh.prefill"], jprefill)
        _close(res["yi.mesh.decode"], jdecode)


@pytest.mark.parametrize("branch", ["seq", "heads"])
@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_prefill_branches_match_one_rank(group, branch, impl):
    key = f"{branch}_{impl}"
    res, want = _ok(group, key)
    assert int(res[f"{key}.calls._attention_sharded"]) == 2     # each layer's prefill
    for part in ("prefill", "k", "v", "decode", "kd"):
        _close(res[f"{key}.mesh.{part}"], res[f"{key}.one.{part}"])


@pytest.mark.parametrize("branch,heads", [("heads", 1), ("gathered", 2)])
def test_xlstm_prefill_branches_match_one_rank_and_jax(group, branch, heads):
    """xlstm's SMOKE prefill (2 heads) and 4 decode steps with the mLSTM and
    sLSTM on local tensors: heads split over tp = 2, or gathered on tp = 4
    (every rank runs both heads); the carried states leave in the cache
    rule's placements (checked by the worker)."""
    key = f"xlstm_{branch}"
    res, want = _ok(group, key)
    # two mLSTM blocks and one sLSTM block, each prefill and decode step
    assert int(res[f"{key}.calls.mlstm_sharded"]) == 2 * (1 + STEPS)
    assert int(res[f"{key}.calls.slstm_sharded"]) == 1 + STEPS
    assert int(res[f"{key}.local_heads"]) == heads
    jprefill, jdecode = want["xlstm.serve"]
    for part, ref in (("prefill", jprefill), ("decode", jdecode)):
        _close(res[f"{key}.mesh.{part}"], res[f"{key}.one.{part}"])
        _close(res[f"{key}.mesh.{part}"], ref)
    for name, ref in want["xlstm.state"].items():
        _close(res[f"{key}.mesh.state.{name}"], res[f"{key}.one.state.{name}"])
        _close(res[f"{key}.mesh.state.{name}"], ref)


def test_pipeline_forward_matches_reference_and_jax(group):
    res, want = _ok(group, "pp")
    _close(res["pp.got"], res["pp.ref"])
    _close(res["pp.got"], want["pp"])


def test_checkpoint_restores_onto_another_mesh_bit_equal(group):
    res, _ = _ok(group, "reshard")
    assert int(res["reshard.leaves"]) > 0


# ---------------------------------------------------------------------------
# the sharding rules: pure functions of the mesh's shape
# ---------------------------------------------------------------------------

class _Spec:
    """A JAX sharding reduced to its spec (not a tuple: a tree leaf)."""

    def __init__(self, spec):
        self.spec = tuple(spec)


class _JaxMeshShape:
    """What the JAX rules read of a mesh: ``axis_names`` and ``shape``."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


def _jax_rules(monkeypatch):
    """JAX's rules with ``NamedSharding`` recording the spec alone (no
    devices: a (2, 16, 16) mesh needs 512)."""
    from repro.models import api as mod

    monkeypatch.setattr(mod, "NamedSharding", lambda mesh, spec: _Spec(spec))
    return mod


def _port_specs(tree) -> dict:
    return {k: v.spec for k, v in tree.items()}


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", jbase.list_configs())
@pytest.mark.parametrize("size", ["smoke", "full"])
def test_param_and_state_rules_match_jax(monkeypatch, arch, mesh_name, size):
    shape, axes = MESHES[mesh_name]
    jmod = _jax_rules(monkeypatch)
    jmesh = _JaxMeshShape(shape, axes)
    mesh = sharding.MeshShape(shape, axes)
    get_j = jbase.get_smoke_config if size == "smoke" else jbase.get_config
    get_t = tbase.get_smoke_config if size == "smoke" else tbase.get_config
    jcfg, cfg = get_j(arch), get_t(arch)
    jtree = japi.abstract_params(jcfg)
    want = {k: v.spec for k, v in convert._named(
        jmod.param_shardings(jcfg, jmesh, jtree)).items()}
    got = _port_specs(api.param_shardings(cfg, mesh, api.abstract_params(cfg)))
    assert got == want
    for name, spec in got.items():
        pl = sharding.placements(mesh, spec)
        for i, ax in enumerate(axes):
            dims = [d for d, e in enumerate(spec) if ax in ((e,) if isinstance(e, str) else e or ())]
            assert pl[i] == (torch.distributed.tensor.Shard(dims[0]) if dims
                             else torch.distributed.tensor.Replicate()), (name, spec, pl)
    ep = dataclasses.replace(cfg, moe_impl="ep")
    jep = dataclasses.replace(jcfg, moe_impl="ep")
    assert _port_specs(api.param_shardings(ep, mesh, api.abstract_params(cfg))) == {
        k: v.spec for k, v in convert._named(
            jmod.param_shardings(jep, jmesh, jtree)).items()}
    st = api.state_shardings(cfg, mesh, api.abstract_state(cfg))
    assert _port_specs(st.m) == got and _port_specs(st.v) == got and st.step.spec == ()


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", jbase.list_configs())
def test_batch_and_cache_rules_match_jax(monkeypatch, arch, mesh_name):
    shape, axes = MESHES[mesh_name]
    jmod = _jax_rules(monkeypatch)
    jmesh = _JaxMeshShape(shape, axes)
    mesh = sharding.MeshShape(shape, axes)
    for size, get_j, get_t in (("smoke", jbase.get_smoke_config, tbase.get_smoke_config),
                               ("full", jbase.get_config, tbase.get_config)):
        jcfg, cfg = get_j(arch), get_t(arch)
        for cell_name, jcell in jbase.SHAPE_CELLS.items():
            cell = tbase.SHAPE_CELLS[cell_name]
            if size == "smoke":
                jcell = dataclasses.replace(jcell, seq_len=64, global_batch=32)
                cell = dataclasses.replace(cell, seq_len=64, global_batch=32)
            want = {k: v.spec for k, v in jmod.batch_shardings(
                jcfg, jmesh, japi.input_specs(jcfg, jcell)).items()}
            got = _port_specs(api.batch_shardings(cfg, mesh, api.input_specs(cfg, cell)))
            assert got == want, (size, cell_name)
            if cell.kind != "decode":
                continue
            jc = japi.abstract_cache(jcfg, jcell.global_batch, jcell.seq_len)
            want = {k: v.spec for k, v in convert._named(
                jmod.cache_shardings(jcfg, jmesh, jc)).items()}
            tc = api.abstract_cache(cfg, cell.global_batch, cell.seq_len)
            got = {k: v.spec for k, v in convert._named(
                api.cache_shardings(cfg, mesh, tc)).items()}
            assert got == want, (size, cell_name)


def test_shard_is_a_no_op_without_a_mesh():
    x = torch.arange(6.0).reshape(2, 3)
    assert sharding.shard(x, "dp", "tp") is x
    assert sharding.active_mesh() is None
    with pytest.raises(RuntimeError, match="active mesh"):
        from repro_torch.models import layers

        cfg = tbase.get_smoke_config("yi_9b")
        layers._sharded_lse_decode(None, None, None, None, None, None, cfg)


def test_host_mesh_needs_enough_ranks():
    from repro_torch.launch import mesh

    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        mesh.make_host_mesh((2, 2), ("data", "model"), device="cpu")


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

def test_dryrun_cli_single_cell(tmp_path):
    env = dict(os.environ, PYTHONPATH=SRC)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "whisper_tiny",
         "--shape", "decode_32k", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "all cells ok" in proc.stdout
    rec = json.loads((tmp_path / "whisper_tiny__decode_32k__pod.json").read_text())
    assert {"arch", "cell", "mesh", "devices", "lower_s", "compile_s", "memory", "cost",
            "collectives", "roofline", "overrides"} <= set(rec)
    assert rec["mesh"] == "16x16" and rec["devices"] == 256
    assert {"argument_bytes", "output_bytes", "temp_bytes", "alias_bytes",
            "per_device_total"} <= set(rec["memory"])
    assert {"per_device_flops", "per_device_bytes", "per_device_collective_bytes",
            "compute_s", "memory_s", "collective_s", "dominant", "model_flops_global",
            "useful_flops_ratio", "bound_s"} <= set(rec["roofline"])
    assert rec["cost"]["flops"] > 0 and rec["memory"]["per_device_total"] > 0
