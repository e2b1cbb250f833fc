"""The LM zoo of the port: the dense decoder LM's serving path (prefill and
cached decode) and its training step on the shared layer library, with flash
attention (B6) as the CUDA kernel of the serving path."""

from .api import (Model, get_model, init_state, make_batch, make_prefill_step,  # noqa: F401
                  make_serve_step, make_train_step)
