"""repro_torch — the PyTorch / CUDA port of the LEA timely-throughput system.

The same subpackages and module names as the JAX package ``repro`` so a
reader finds each counterpart: ``core`` (Markov workers, the EA allocator,
the batched throughput engine), ``policies`` (estimator replays, regret),
``kernels`` (the Poisson-binomial prefix-tail DP: a hand-written CUDA kernel
for Hopper beside its plain PyTorch version) and ``sweeps`` (scenario
registry, executor, results).

Conventions:

  * every public entry point takes ``device=None``, which means ``"cuda"``;
    with no GPU present it raises — pass ``device="cpu"`` explicitly to run
    on the CPU (the tests do);
  * randomness comes from an explicit :class:`repro_torch.random.Draws`
    (default: :class:`~repro_torch.random.TorchDraws` on a
    ``torch.Generator``), never from a global RNG;
  * a CUDA tensor always reaches the CUDA kernel (or the call raises); only
    CPU tensors take the plain PyTorch version.
"""

from .device import resolve_device  # noqa: F401
