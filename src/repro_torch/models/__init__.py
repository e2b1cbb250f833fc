"""The LM zoo of the port: the decoder-only families (dense and MoE
``lm``, the Mamba2 + shared-attention ``hybrid``, ``xlstm``), their serving
path (prefill and cached decode) and training step on the shared layer
library, with flash attention (B6) as the CUDA kernel of the serving path."""

from .api import (Model, attention_calls, get_model, init_state, make_batch,  # noqa: F401
                  make_prefill_step, make_serve_step, make_train_step)
