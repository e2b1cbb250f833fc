"""qwen3-0.6b [dense] — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]

The same numbers as the JAX package's config, for parity (its ``source``
names Qwen3-8B and it leaves ``tie_embeddings`` False, where the public
Qwen3-0.6B ties them).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    qk_norm=True,
    mlp_type="swiglu",
    rope_theta=1_000_000.0,
    microbatch=4,
    scan_groups=7,
    source="[hf:Qwen/Qwen3-8B; hf]",
)

SMOKE = ArchConfig(
    name="qwen3-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    qk_norm=True,
    mlp_type="swiglu",
    dtype="float32",
    remat=False,
)
