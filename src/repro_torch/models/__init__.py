"""The LM zoo of the port: the dense decoder LM's serving path (prefill and
cached decode) on the shared layer library, with flash attention (B6) as
the CUDA kernel."""

from .api import Model, get_model, make_batch, make_prefill_step, make_serve_step  # noqa: F401
