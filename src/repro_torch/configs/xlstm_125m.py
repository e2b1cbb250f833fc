"""xlstm-125m [ssm] — mLSTM blocks with sLSTM blocks at 3 and 9 (``d_ff=0``:
the blocks own their projections).  [arXiv:2405.04517; unverified]

The same numbers as the JAX package's config, for parity.  No module reads
``head_dim``: the mLSTM head is ``2 d_model / n_heads`` = 384 and the sLSTM
head ``d_model / n_heads`` = 192, and the model runs no attention.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    slstm_at=(3, 9),
    microbatch=4,
    source="[arXiv:2405.04517; unverified]",
)

SMOKE = ArchConfig(
    name="xlstm-smoke",
    family="ssm",
    n_layers=3,
    d_model=64,
    n_heads=2,
    n_kv_heads=2,
    head_dim=32,
    d_ff=0,
    vocab_size=512,
    slstm_at=(1,),
    dtype="float32",
    remat=False,
)
