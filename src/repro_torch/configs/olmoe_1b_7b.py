"""olmoe-1b-7b [moe] — 64 experts top-8, qk-norm, MHA.  [arXiv:2409.02060; hf]

The same numbers as the JAX package's config, for parity.  Its
``moe_impl="ep"`` (expert parallelism over a mesh) takes the dense per-example
route here, as JAX does with no active mesh (``models.layers.moe``).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50_304,
    mlp_type="swiglu",
    qk_norm=True,
    n_experts=64,
    top_k=8,
    microbatch=8,
    scan_groups=4,
    moe_impl="ep",
    source="[arXiv:2409.02060; hf]",
)

SMOKE = ArchConfig(
    name="olmoe-smoke",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=64,
    vocab_size=512,
    mlp_type="swiglu",
    qk_norm=True,
    n_experts=8,
    top_k=2,
    dtype="float32",
    remat=False,
)
