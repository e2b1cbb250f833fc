"""Hand-written Hopper kernels of the port, each beside its plain version.

  * ``poisson_binomial`` — batched EA-allocator prefix-tail DP (B, n)->(B, n),
    CUDA C++ in ``csrc/poisson_binomial.cu``.

``build`` compiles ``csrc/*.cu`` with nvcc at first use; ``dispatch`` is the
route rule (CUDA tensor -> kernel, CPU tensor -> plain version).
"""
