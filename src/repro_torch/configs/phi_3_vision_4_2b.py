"""phi-3-vision-4.2b [vlm] — phi3-mini backbone, CLIP frontend stubbed.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

The same numbers as the JAX package's config, for parity: 32 decoder layers
(32 heads of 96, SwiGLU of 8192) that read 576 precomputed patch embeddings
(``models.api.input_specs``' ``patches``, random in every run here),
projected by ``patch_proj`` and prepended to the text tokens
(``models.lm._embed_sequence``).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    head_dim=96,
    d_ff=8192,
    vocab_size=32_064,
    mlp_type="swiglu",
    frontend="vision_stub",
    frontend_tokens=576,
    microbatch=8,
    scan_groups=8,
    source="[hf:microsoft/Phi-3-vision-128k-instruct; hf]",
)

SMOKE = ArchConfig(
    name="phi3v-smoke",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp_type="swiglu",
    frontend="vision_stub",
    frontend_tokens=8,
    dtype="float32",
    remat=False,
)
