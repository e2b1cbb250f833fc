"""Public model API of the port: family dispatch and the ``make_*_step``
functions (``repro/models/api.py``).

  * :func:`get_model`         — family -> (init_params, train_loss, prefill,
                                decode_step, init_cache): ``encdec``,
                                ``hybrid``, ``xlstm`` and ``lm`` (dense, MoE
                                and the vision stub);
  * :func:`attention_calls`   — full-sequence attention calls a prefill
                                makes (B6's launches under ``flash``);
  * :func:`make_train_step`   — loss + grad + microbatch accumulation +
                                AdamW; :func:`init_state` its state;
  * :func:`make_prefill_step` / :func:`make_serve_step` — serving;
  * :func:`input_specs`       — the inputs of a cell as meta-device tensors
                                (shapes and dtypes, no storage);
  * :func:`make_batch`        — a random batch of those inputs from a
                                ``torch.Generator``;
  * :func:`abstract_params` / :func:`abstract_state` /
    :func:`abstract_cache`      — the same trees on the ``meta`` device;
  * :func:`param_shardings` / :func:`state_shardings` /
    :func:`batch_shardings` / :func:`cache_shardings` — JAX's sharding
                                rules, copied as they are: a tree of
                                :class:`~repro_torch.models.sharding.NamedSharding`
                                per tree of tensors (a parameter tree gives a
                                dict under its dotted names).

Every step function runs under :func:`float32_split_k_sums`.  Under
:func:`~repro_torch.models.sharding.use_mesh` with DTensor parameters,
state and batch (:func:`~repro_torch.models.sharding.distribute`), the
same step functions run sharded.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeCell
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import NO_BACKWARD
from repro_torch.optim import TrainState, adamw_init, adamw_update, cosine_warmup
from repro_torch.runtime.fault_tolerance import split_batch

from . import encdec, hybrid, lm, xlstm
from .sharding import NamedSharding, distribute, is_dtensor, resolve, use_mesh


class Model(NamedTuple):
    init_params: Callable
    train_loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _family(cfg: ArchConfig):
    """The model module, in JAX's order: encoder-decoder, hybrid, xLSTM
    (``ssm`` with ``d_ff == 0``), else the decoder LM (which holds the
    vision stub)."""
    if cfg.is_encdec:
        return encdec
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "ssm" and cfg.d_ff == 0:
        return xlstm
    return lm


def get_model(cfg: ArchConfig) -> Model:
    """The family's (init_params, train_loss, prefill, decode_step,
    init_cache)."""
    mod = _family(cfg)
    return Model(mod.init_params, mod.train_loss, mod.prefill, mod.decode_step,
                 mod.init_cache)


def attention_calls(cfg: ArchConfig) -> int:
    """Full-sequence attention calls one prefill makes, so B6's launches
    under ``attn_impl="flash"``: one a layer for the decoder LM (the vision
    stub included), one an application of the shared block for the hybrid
    (``hybrid.n_attn_apps``), none for xLSTM, and for the encoder-decoder
    one an encoder layer and two a decoder layer (self and cross)."""
    mod = _family(cfg)
    if mod is encdec:
        return cfg.encoder_layers + 2 * cfg.n_layers
    if mod is hybrid:
        return hybrid.n_attn_apps(cfg)
    return 0 if mod is xlstm else cfg.n_layers


def input_specs(cfg: ArchConfig, cell: ShapeCell) -> dict[str, torch.Tensor]:
    """A cell's inputs as meta-device tensors: JAX's ``ShapeDtypeStruct``
    stand-ins, the same shapes and dtypes, no storage.  A train or
    prefill cell gives ``tokens`` (B, S) int32; the vision stub's ``seq_len``
    counts its patches, so its ``tokens`` are (B, S - P) and ``patches``
    (B, P, d); the audio stub adds ``frames`` (B, T, d); both in
    ``cfg.dtype``.  A decode cell gives ``next_token`` (B,) int32."""
    b, s = cell.global_batch, cell.seq_len
    spec = lambda shape, dtype: torch.empty(shape, dtype=dtype, device="meta")
    i32, f = torch.int32, getattr(torch, cfg.dtype)
    if cell.kind not in ("train", "prefill"):
        return {"next_token": spec((b,), i32)}
    front = (b, cfg.frontend_tokens, cfg.d_model)
    if cfg.frontend == "vision_stub":
        return {"tokens": spec((b, s - cfg.frontend_tokens), i32), "patches": spec(front, f)}
    if cfg.frontend == "audio_stub":
        return {"tokens": spec((b, s), i32), "frames": spec(front, f)}
    return {"tokens": spec((b, s), i32)}


def make_batch(cfg: ArchConfig, cell: ShapeCell, generator: torch.Generator,
               device=None) -> dict[str, torch.Tensor]:
    """A random batch of :func:`input_specs`' inputs, drawn in their order
    from ``generator`` (which lives on ``device``): integers in [0,
    ``vocab_size``), float inputs standard normal in float32 cast to their
    dtype."""
    dev = resolve_device(device)
    out = {}
    for name, sd in input_specs(cfg, cell).items():
        if sd.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab_size, sd.shape, generator=generator,
                                      dtype=torch.int32, device=dev)
        else:
            out[name] = torch.randn(sd.shape, generator=generator, dtype=torch.float32,
                                    device=dev).to(sd.dtype)
    return out


@contextlib.contextmanager
def float32_split_k_sums():
    """bf16 GEMMs add their split-K partials in float32 inside the block.

    PyTorch lets cuBLAS add them in bf16 by default
    (``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``);
    the JAX package asks for float32 (``preferred_element_type``).  The flag
    is process-wide, so the caller's value is put back on the way out.
    """
    flags = torch.backends.cuda.matmul
    before = flags.allow_bf16_reduced_precision_reduction
    flags.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        flags.allow_bf16_reduced_precision_reduction = before


def loss_and_grads(params, batch, cfg: ArchConfig) -> tuple[torch.Tensor, dict]:
    """``train_loss`` and its gradients by parameter name (``params.tensors()``
    names; each in its parameter's dtype, as ``jax.value_and_grad`` gives)."""
    tensors = params.tensors()
    loss = get_model(cfg).train_loss(params, batch, cfg)
    grads = torch.autograd.grad(loss, list(tensors.values()))
    return loss.detach(), dict(zip(tensors, grads))


def make_train_step(cfg: ArchConfig, *, peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10_000, grad_transform: Callable | None = None,
                    grad_shardings: dict | None = None):
    """(TrainState, batch) -> (TrainState, {"loss", "grad_norm"}) with
    microbatch gradient accumulation (``cfg.microbatch``).

    ``accum_mode="grads"`` adds each microbatch's gradients in
    ``grad_accum_dtype``, then divides by the count and casts to float32;
    ``"loss_scan"`` takes one gradient of the mean microbatch loss, each
    microbatch's forward checkpointed.  ``grad_transform(grads) -> grads``
    (gradient compression, coded-DP decode) runs before AdamW.  The state's
    tensors are updated in place.  A config with ``attn_impl="flash"``
    raises here: B6 has no backward pass.

    ``grad_shardings`` (``state_shardings(...).params``: a
    :class:`~repro_torch.models.sharding.NamedSharding` per parameter
    name) redistributes each microbatch's gradients, and the accumulator,
    to the parameters' own layout, as JAX pins them.  DTensor gradients
    come out of autograd in whatever placements the backward produced
    (often partial sums); without ``grad_shardings`` AdamW redistributes
    them as its arithmetic needs.
    """
    if cfg.attn_impl == "flash":
        raise RuntimeError(NO_BACKWARD)
    model = get_model(cfg)
    mb = max(1, cfg.microbatch)

    def _split(batch):
        return _microbatches(batch, mb)

    def _pin(grads):
        if grad_shardings is None:
            return grads
        return {name: _redistribute(g, grad_shardings[name]) for name, g in grads.items()}

    def train_step(state: TrainState, batch):
        with float32_split_k_sums():
            if mb == 1:
                loss, grads = loss_and_grads(state.params, batch, cfg)
                grads = _pin(grads)
            elif cfg.accum_mode == "loss_scan":
                tensors = state.params.tensors()
                micro = lambda sub: model.train_loss(state.params, sub, cfg)
                total = None
                for sub in _split(batch):
                    part = checkpoint(micro, sub, use_reentrant=False)
                    total = part if total is None else total + part
                total = total / mb
                grads = dict(zip(tensors, torch.autograd.grad(total, list(tensors.values()))))
                grads = _pin(grads)
                loss = total.detach()
            else:
                acc_dt = getattr(torch, cfg.grad_accum_dtype)
                loss, grads = None, None
                for sub in _split(batch):
                    loss_i, g_i = loss_and_grads(state.params, sub, cfg)
                    g_i = _pin({name: g.to(acc_dt) for name, g in g_i.items()})
                    if grads is None:
                        loss, grads = loss_i, g_i
                    else:
                        loss = loss + loss_i
                        grads = {name: grads[name] + g_i[name] for name in grads}
                loss = loss / mb
                grads = {name: (g / mb).to(torch.float32) for name, g in grads.items()}
            if grad_transform is not None:
                grads = grad_transform(grads)
            lr = cosine_warmup(state.step + 1, peak_lr=peak_lr, warmup=warmup,
                               total=total_steps)
            new_state, om = adamw_update(state, grads, lr)
        return new_state, {"loss": loss, **om}

    return train_step


def _microbatches(batch: dict, k: int) -> list[dict]:
    """``split_batch`` for plain tensors.  A batch of DTensors is split
    rank by rank: microbatch j is each rank's j-th slice of its own rows
    (the rows stay where they are; the microbatches group other examples
    than the plain split's, and their mean loss and summed gradients are
    the same sums).  When a rank's rows do not split ``k`` ways the rows
    are gathered first and every rank runs every microbatch whole, the
    plain split's."""
    tensors = list(batch.values())
    if not tensors or not is_dtensor(tensors[0]):
        return split_batch(batch, k)
    from torch.distributed.tensor import DTensor, Replicate

    from .sharding import redistribute

    if any(x.to_local().shape[0] % k for x in tensors):
        batch = {name: redistribute(x, x.device_mesh, [Replicate()] * x.device_mesh.ndim)
                 for name, x in batch.items()}
    out = [{} for _ in range(k)]
    for name, x in batch.items():
        loc = x.to_local()
        loc = loc.reshape((k, loc.shape[0] // k) + tuple(loc.shape[1:]))
        for j in range(k):
            out[j][name] = DTensor.from_local(loc[j], x.device_mesh, x.placements,
                                              run_check=False)
    return out


def init_state(cfg: ArchConfig, generator: torch.Generator, device=None) -> TrainState:
    """Trainable random parameters (``init_params`` on ``device``, where
    ``generator`` lives) and zero moments in ``cfg.opt_state_dtype``."""
    params = get_model(cfg).init_params(generator, cfg, device=device).trainable()
    return adamw_init(params, getattr(torch, cfg.opt_state_dtype))


def abstract_params(cfg: ArchConfig):
    """``init_params`` on the ``meta`` device: shapes and dtypes, no storage
    (the dry run's stand-ins, as JAX's ``eval_shape``)."""
    return get_model(cfg).init_params(None, cfg, device="meta")


def abstract_state(cfg: ArchConfig) -> TrainState:
    """:func:`init_state` on the ``meta`` device."""
    return adamw_init(abstract_params(cfg).trainable(), getattr(torch, cfg.opt_state_dtype))


def abstract_cache(cfg: ArchConfig, batch: int, max_len: int):
    """``init_cache`` on the ``meta`` device."""
    return get_model(cfg).init_cache(cfg, batch, max_len, device="meta")


# ---------------------------------------------------------------------------
# sharding rules (JAX's, as they are)
# ---------------------------------------------------------------------------

_IN_NAMES = {"wq", "wk", "wv", "w_up", "w_gate", "in_proj", "w_if", "w_gates",
             "w1", "embed_in", "patch_proj"}
_OUT_NAMES = {"wo", "w_down", "out_proj", "w_o", "w2"}


def _axis_size(mesh, logical: str) -> int:
    from .sharding import axis_size

    return axis_size(mesh, logical)


def _param_spec(path: tuple[str, ...], shape: tuple[int, ...], tp: int, fsdp: int,
                ep_mode: bool = False) -> tuple:
    name = path[-1]
    nd = len(shape)

    def ok(dim, size):
        return size > 1 and shape[dim] % size == 0

    if (ep_mode and nd == 4 and name in ("w_gate", "w_up", "w_down")
            and ok(1, tp)):
        # expert parallelism: each tp shard owns E/tp experts outright
        return (None, "tp", None, None)

    if name == "embed":                       # (V, d): vocab over tp, d over fsdp
        return ("tp" if ok(0, tp) else None, "fsdp" if ok(1, fsdp) else None)
    if name == "lm_head":                     # (d, V)
        return ("fsdp" if ok(0, fsdp) else None, "tp" if ok(1, tp) else None)
    if name == "router":                      # (L, d, E)
        return (None, "fsdp" if ok(1, fsdp) else None, None)
    if name in ("conv_w", "conv_b"):          # depthwise conv: shard channels
        ch = nd - 1
        spec = [None] * nd
        if ok(ch, tp):
            spec[ch] = "tp"
        return tuple(spec)
    if name in _IN_NAMES or name in _OUT_NAMES:
        # trailing two dims are (in, out); leading dims (layer stack / experts)
        # stay unsharded.
        spec: list = [None] * nd
        d_in, d_out = nd - 2, nd - 1
        if name in _IN_NAMES:
            if ok(d_in, fsdp):
                spec[d_in] = "fsdp"
            if ok(d_out, tp):
                spec[d_out] = "tp"
        else:
            if ok(d_in, tp):
                spec[d_in] = "tp"
            if ok(d_out, fsdp):
                spec[d_out] = "fsdp"
        return tuple(spec)
    # norms, biases, gates, small vectors: replicate
    return ()


def _tensors_of(tree) -> dict[str, torch.Tensor]:
    return tree.tensors() if hasattr(tree, "tensors") else tree


def param_shardings(cfg: ArchConfig, mesh, params_tree) -> dict[str, NamedSharding]:
    """A :class:`NamedSharding` per parameter, under the dotted names of
    ``params_tree.tensors()`` (or of a dict of tensors under those names:
    optimizer moments, gradients).  ``mesh`` is a ``DeviceMesh`` or a
    :class:`~repro_torch.models.sharding.MeshShape`."""
    tp = _axis_size(mesh, "tp")
    fsdp = _axis_size(mesh, "fsdp")
    ep_mode = (cfg.n_experts > 0 and getattr(cfg, "moe_impl", "dense") == "ep"
               and tp > 1 and cfg.n_experts % tp == 0)
    out = {}
    with use_mesh(mesh):
        for name, leaf in _tensors_of(params_tree).items():
            spec = _param_spec(tuple(name.split(".")), tuple(leaf.shape), tp, fsdp, ep_mode)
            out[name] = NamedSharding(mesh, resolve(spec))
    return out


def state_shardings(cfg: ArchConfig, mesh, state: TrainState) -> TrainState:
    ps = param_shardings(cfg, mesh, state.params)
    return TrainState(
        params=ps,
        m=param_shardings(cfg, mesh, state.m),
        v=param_shardings(cfg, mesh, state.v),
        step=NamedSharding(mesh, ()),
    )


def batch_shardings(cfg: ArchConfig, mesh, specs: dict) -> dict:
    dp = _axis_size(mesh, "dp")

    def assign(leaf):
        b = leaf.shape[0]
        lead = "dp" if (dp > 1 and b % dp == 0) else None
        with use_mesh(mesh):
            return NamedSharding(mesh, resolve((lead,) + (None,) * (len(leaf.shape) - 1)))

    return {name: assign(leaf) for name, leaf in specs.items()}


def _map_with_path(fn, tree, path: tuple[str, ...] = ()):
    """``tree_map_with_path`` over dicts, tuples and lists of tensors; a
    tuple position's key is its index as a string, as JAX's ``str(idx)``."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)


def cache_shardings(cfg: ArchConfig, mesh, cache_tree) -> Any:
    """KV caches: batch over dp, sequence over tp (+dp when batch can't shard).

    SSM/conv/xlstm states: batch over dp; largest model dim over tp when
    divisible.  Exact layouts per DESIGN.md §5.
    """
    dp = _axis_size(mesh, "dp")
    tp = _axis_size(mesh, "tp")

    def assign(keys, leaf):
        name = keys[0] if keys else ""
        shape = tuple(leaf.shape)
        with use_mesh(mesh):
            if name == "pos" or not shape:
                return NamedSharding(mesh, ())
            if name in ("k", "v", "ck", "cv"):
                # (L|napps, B, Hkv, S, Dh)
                b, s_dim = shape[1], shape[3]
                batch_ok = dp > 1 and b % dp == 0
                if not batch_ok and dp > 1 and s_dim % (dp * tp) == 0:
                    seq_spec = ("dp", "tp")
                elif tp > 1 and s_dim % tp == 0:
                    seq_spec = "tp"
                else:
                    seq_spec = None
                return NamedSharding(
                    mesh, resolve((None, "dp" if batch_ok else None, None, seq_spec, None)))
            if name == "ssm":                  # (L, B, nh, hd, ds)
                b, nh = shape[1], shape[2]
                return NamedSharding(mesh, resolve((
                    None, "dp" if dp > 1 and b % dp == 0 else None,
                    "tp" if tp > 1 and nh % tp == 0 else None, None, None)))
            if name == "conv":                 # (L, B, K-1, C)
                b, ch = shape[1], shape[3]
                return NamedSharding(mesh, resolve((
                    None, "dp" if dp > 1 and b % dp == 0 else None, None,
                    "tp" if tp > 1 and ch % tp == 0 else None)))
            # xlstm block states: (B, ...) — batch over dp, biggest tail dim over tp
            spec: list = [None] * len(shape)
            if dp > 1 and shape[0] % dp == 0:
                spec[0] = "dp"
            if len(shape) > 1:
                tail = max(range(1, len(shape)), key=lambda i: (shape[i], -i))
                if tp > 1 and shape[tail] % tp == 0:
                    spec[tail] = "tp"
            return NamedSharding(mesh, resolve(tuple(spec)))

    return _map_with_path(assign, cache_tree)


def distribute_tree(tree, shardings, *, device=None):
    """Every tensor of ``tree`` placed on its sharding
    (:func:`~repro_torch.models.sharding.distribute`): a parameter module
    (its ``tensors()`` names; a trainable module stays trainable), a
    ``TrainState``, or dicts / tuples of tensors.  ``device`` defaults to
    each tensor's own."""
    if isinstance(tree, torch.Tensor):
        return distribute(tree, shardings, device=device)
    if isinstance(tree, TrainState):
        return TrainState(*(distribute_tree(getattr(tree, f), getattr(shardings, f),
                                            device=device) for f in TrainState._fields))
    if hasattr(tree, "tensors"):
        named = tree.tensors()
        out = type(tree).from_tensors({n: distribute(t.detach(), shardings[n], device=device)
                                       for n, t in named.items()})
        return out.trainable() if any(t.requires_grad for t in named.values()) else out
    if isinstance(tree, dict):
        return {k: distribute_tree(v, shardings[k], device=device) for k, v in tree.items()}
    return type(tree)(distribute_tree(v, s, device=device) for v, s in zip(tree, shardings))


def _redistribute(g: torch.Tensor, sh: NamedSharding) -> torch.Tensor:
    if not is_dtensor(g):
        return g
    if tuple(g.placements) == sh.placements:
        return g
    return g.redistribute(sh.mesh, sh.placements)


def make_prefill_step(cfg: ArchConfig, *, max_len: int | None = None,
                      attn_impl: str | None = None):
    """(params, batch) -> (last-position logits, cache).

    As in JAX, a prefill with ``max_len >= 8192`` and no ``attn_impl``
    given runs ``blockwise`` whatever ``cfg.attn_impl`` says; a long flash
    prefill must pass ``attn_impl="flash"``.
    """
    if attn_impl is None and max_len is not None and max_len >= 8192:
        attn_impl = "blockwise"
    if attn_impl is not None:
        cfg = dataclasses.replace(cfg, attn_impl=attn_impl)
    model = get_model(cfg)

    def prefill_step(params, batch):
        with float32_split_k_sums():
            return model.prefill(params, batch, cfg, max_len=max_len)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """(params, cache, batch) -> (logits, cache); the cache is updated in
    place."""
    model = get_model(cfg)

    def serve_step(params, cache, batch):
        with float32_split_k_sums():
            return model.decode_step(params, batch, cache, cfg)

    return serve_step


__all__ = ["Model", "abstract_cache", "abstract_params", "abstract_state", "attention_calls",
           "batch_shardings", "cache_shardings", "distribute_tree", "float32_split_k_sums",
           "get_model", "init_state", "input_specs", "loss_and_grads", "make_batch",
           "make_prefill_step", "make_serve_step", "make_train_step", "param_shardings",
           "state_shardings"]
