"""The LM zoo of the port: the decoder-only families (dense, MoE and the
vision stub in ``lm``, the Mamba2 + shared-attention ``hybrid``, ``xlstm``)
and the encoder-decoder ``encdec``, their serving path (prefill and cached
decode) and training step on the shared layer library, with flash attention
(B6) as the CUDA kernel of the serving path."""

from .api import (Model, attention_calls, get_model, init_state, input_specs,  # noqa: F401
                  make_batch, make_prefill_step, make_serve_step, make_train_step)
