"""whisper-tiny [audio] — encoder-decoder, conv frontend stubbed.
[arXiv:2212.04356; unverified]

The same numbers as the JAX package's config, for parity: 4 encoder and 4
decoder layers (6 heads of 64, GELU MLP of 1536) over 1500 precomputed frame
embeddings (``models.api.input_specs``' ``frames``: the post-conv
mel-spectrogram stream, random in every run here).  RoPE stands in for
whisper's learned / sinusoidal positions, as in the JAX package.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,
    encoder_layers=4,
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    mlp_type="gelu",
    frontend="audio_stub",
    frontend_tokens=1500,
    microbatch=8,
    source="[arXiv:2212.04356; unverified]",
)

SMOKE = ArchConfig(
    name="whisper-smoke",
    family="audio",
    n_layers=2,
    encoder_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=128,
    vocab_size=512,
    mlp_type="gelu",
    frontend="audio_stub",
    frontend_tokens=16,
    dtype="float32",
    remat=False,
)
