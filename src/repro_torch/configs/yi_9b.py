"""yi-9b [dense] — llama-arch GQA.  [arXiv:2403.04652; hf]

The same numbers as the JAX package's config, for parity.  ``decode_attn``
names the sharded decode, which needs a mesh: on one card the port decodes
locally, as JAX does with no mesh active (``models.layers.attention_decode``).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b",
    family="dense",
    n_layers=48,
    d_model=4096,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=11_008,
    vocab_size=64_000,
    mlp_type="swiglu",
    rope_theta=5_000_000.0,
    microbatch=8,
    scan_groups=8,
    decode_attn="sharded_lse",   # §Perf C1/C2: flash-decoding over seq shards
    source="[arXiv:2403.04652; hf]",
)

SMOKE = ArchConfig(
    name="yi-smoke",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=176,
    vocab_size=512,
    mlp_type="swiglu",
    dtype="float32",
    remat=False,
)
