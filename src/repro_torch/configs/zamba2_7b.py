"""zamba2-7b [hybrid] — Mamba2 backbone + one weight-shared attention block.
[arXiv:2411.15242; unverified]

The same numbers as the JAX package's config, for parity: 81 Mamba2 layers
(state 64, heads of 64, conv 4) and a shared attention + MLP block (32 heads
of 112) applied before every 6 of them, 13 full groups and a tail group of 3
layers: 14 applications, 14 KV-cache slots (``models.hybrid.n_attn_apps``).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14_336,
    vocab_size=32_000,
    mlp_type="swiglu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    attn_every=6,
    microbatch=8,
    source="[arXiv:2411.15242; unverified]",
)

SMOKE = ArchConfig(
    name="zamba2-smoke",
    family="hybrid",
    n_layers=4,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp_type="swiglu",
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_conv=4,
    attn_every=2,
    dtype="float32",
    remat=False,
)
