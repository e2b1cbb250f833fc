"""Config system of the port: the JAX package's ``ArchConfig`` /
``ShapeCell`` dataclasses and the assigned shape cells, copied field for
field so a config carries across by name, and a registry of the ten
architectures the JAX package lists.

``paper_lea`` (the paper's own workloads, ``SIM`` / ``EC2``) lives beside
these modules and is not an ``ArchConfig``; :func:`list_configs` lists the
language-model architectures.  Asking for one the port does not hold raises
an error that names it.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Any


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    """One architecture.  Field semantics follow the assignment table."""

    name: str
    family: str                 # dense | vlm | audio | hybrid | moe | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int

    # attention
    head_dim: int = 0           # 0 -> d_model // n_heads
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int | None = None   # sliding-window attention (tokens)

    # mlp
    mlp_type: str = "swiglu"    # swiglu | squared_relu | gelu

    # moe
    n_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25

    # ssm / hybrid (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    attn_every: int = 0         # zamba2: shared attn block every N mamba blocks

    # xlstm
    slstm_at: tuple[int, ...] = ()

    # enc-dec / multimodal
    encoder_layers: int = 0
    frontend: str | None = None   # audio_stub | vision_stub
    frontend_tokens: int = 0      # whisper: 1500 frames; phi3v: 576 patches

    # numerics / training
    dtype: str = "bfloat16"
    opt_state_dtype: str = "float32"
    remat: bool = True
    tie_embeddings: bool = False
    vocab_pad_to: int = 128

    # distribution hints
    microbatch: int = 1           # grad-accumulation steps in train_step
    scan_groups: int = 1          # two-level remat scan: groups x (L/groups)
    accum_mode: str = "grads"     # grads (explicit f32 accumulator) | loss_scan
                                  # (single grad over scanned loss; bf16 grads,
                                  #  one deferred reduce — §Perf)
    act_seq_shard: bool = False   # Megatron-SP: activations sharded over seq on
                                  # the tp axis between blocks -> TP reductions
                                  # become reduce-scatter + all-gather (§Perf)
    bf16_reduce: bool = False     # row-parallel projection outputs in bf16 ->
                                  # TP partial-sum + grad reduces in bf16 (§Perf)
    remat_policy: str = "full"    # full | save_rowparallel (save post-all-reduce
                                  # activations so backward never replays TP
                                  # collectives — §Perf A5)
    grad_accum_dtype: str = "float32"   # bfloat16 halves accumulator buffers
                                        # and grad-reduce bytes (§Perf A7)
    attn_impl: str = "ref"        # ref (dense) | blockwise | flash (CUDA kernel B6)
    moe_impl: str = "dense"       # dense (sort-free per-example) | ep (all_to_all)
    decode_attn: str = "auto"     # auto | sharded_lse | local

    source: str = ""              # provenance note [source; verified-tier]

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return (self.vocab_size + m - 1) // m * m

    @property
    def is_encdec(self) -> bool:
        return self.encoder_layers > 0

    def n_params(self) -> int:
        """Analytic parameter count (excludes tiny norm vectors ~O(L*d))."""
        d, f, v, hd = self.d_model, self.d_ff, self.padded_vocab, self.head_dim_
        L = self.n_layers
        attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.family == "ssm" and not self.slstm_at and self.ssm_state:
            pass
        if self.mlp_type == "swiglu":
            mlp = 3 * d * f
        else:
            mlp = 2 * d * f
        if self.n_experts:
            mlp = self.n_experts * mlp + d * self.n_experts
        if self.family == "ssm" and self.d_ff == 0:
            # xlstm: blocks own their projections; rough count
            d_in = 2 * d
            mlp = 0
            attn = 2 * d * d_in + d_in * d + 4 * d_in * hd  # proj + gates
        per_layer = attn + mlp
        if self.family == "hybrid":
            d_in = self.ssm_expand * d
            mamba = d * (2 * d_in + 2 * self.ssm_state + d_in // self.ssm_head_dim) + d_in * d
            per_layer = mamba
            shared_attn = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
            shared_mlp = 3 * d * f if self.mlp_type == "swiglu" else 2 * d * f
            return L * per_layer + shared_attn + shared_mlp + 2 * v * d
        total = L * per_layer + 2 * v * d
        if self.encoder_layers:
            enc = self.encoder_layers * (attn + mlp)
            cross = L * (d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d)
            total += enc + cross
        return total

    def active_params(self) -> int:
        """Active (per-token) params — differs from n_params() only for MoE."""
        if not self.n_experts:
            return self.n_params()
        d, f = self.d_model, self.d_ff
        mlp_one = 3 * d * f if self.mlp_type == "swiglu" else 2 * d * f
        full = self.n_params()
        return full - self.n_layers * (self.n_experts - self.top_k) * mlp_one


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """One assigned (input-shape) cell for the LM family."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPE_CELLS: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524_288, 1, "decode"),
}

# The architectures, in the JAX package's order: dense, the vision stub,
# encoder-decoder, hybrid, MoE and xLSTM.
_ARCHS = ("qwen3_0_6b", "nemotron_4_340b", "yi_9b", "llama3_2_3b", "phi_3_vision_4_2b",
          "whisper_tiny", "zamba2_7b", "mixtral_8x22b", "olmoe_1b_7b", "xlstm_125m")


def list_configs() -> tuple[str, ...]:
    return _ARCHS


def _module(name: str):
    mod_name = name.replace("-", "_").replace(".", "_")
    if mod_name not in _ARCHS:
        raise ValueError(
            f"the port has no config {name!r}; it holds {', '.join(_ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get_config(name: str, **overrides: Any) -> ArchConfig:
    """Load ``repro_torch.configs.<name>.CONFIG`` (accepts dashes)."""
    cfg: ArchConfig = _module(name).CONFIG
    return dataclasses.replace(cfg, **overrides) if overrides else cfg


def get_smoke_config(name: str, **overrides: Any) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg: ArchConfig = _module(name).SMOKE
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
