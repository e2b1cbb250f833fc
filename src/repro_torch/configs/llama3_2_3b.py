"""llama3.2-3b [dense] — small llama3.  [hf:meta-llama/Llama-3.2-1B; unverified]

The same numbers as the JAX package's config, for parity.

24 heads do not divide the 16-way model axis, so attention activations shard
over the query-sequence axis instead (context parallel) — DESIGN §5.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama3.2-3b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128_256,
    mlp_type="swiglu",
    rope_theta=500_000.0,
    microbatch=8,
    scan_groups=7,
    source="[hf:meta-llama/Llama-3.2-1B; unverified]",
)

SMOKE = ArchConfig(
    name="llama3.2-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=256,
    vocab_size=512,
    mlp_type="swiglu",
    dtype="float32",
    remat=False,
)
