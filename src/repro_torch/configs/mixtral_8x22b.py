"""mixtral-8x22b [moe] — 8 experts top-2, GQA 48 over 8, sliding-window
attention (4096 tokens).  [arXiv:2401.04088; hf]

The same numbers as the JAX package's config, for parity.  The whole model
(140.6 B parameters) does not fit one card; it is served there at full width
with fewer layers (``get_config("mixtral_8x22b", n_layers=2)``).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16_384,
    vocab_size=32_768,
    mlp_type="swiglu",
    n_experts=8,
    top_k=2,
    window=4096,
    microbatch=16,
    scan_groups=8,
    opt_state_dtype="bfloat16",
    grad_accum_dtype="bfloat16",
    remat_policy="save_rowparallel",
    source="[arXiv:2401.04088; hf]",
)

SMOKE = ArchConfig(
    name="mixtral-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=96,
    vocab_size=512,
    mlp_type="swiglu",
    n_experts=4,
    top_k=2,
    window=32,
    dtype="float32",
    remat=False,
)
