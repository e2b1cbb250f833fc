"""nemotron-4-340b [dense] — GQA, squared-ReLU MLP.  [arXiv:2402.16819; unverified]

The same numbers as the JAX package's config, for parity.  The whole model
(341 B parameters) does not fit one card; it is served there at full width
with fewer layers (``get_config("nemotron_4_340b", n_layers=2)``).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab_size=256_000,
    mlp_type="squared_relu",
    microbatch=16,
    scan_groups=12,
    opt_state_dtype="bfloat16",   # fits 256 x 16 GB (DESIGN §5)
    grad_accum_dtype="bfloat16",  # §Perf A7b
    source="[arXiv:2402.16819; unverified]",
)

SMOKE = ArchConfig(
    name="nemotron-smoke",
    family="dense",
    n_layers=2,
    d_model=96,
    n_heads=6,
    n_kv_heads=2,
    head_dim=16,
    d_ff=384,
    vocab_size=512,
    mlp_type="squared_relu",
    dtype="float32",
    remat=False,
)
