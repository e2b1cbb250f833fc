"""Hand-written Hopper kernels of the port, each beside its plain version.

  * ``poisson_binomial`` — batched EA-allocator prefix-tail DP (B, n)->(B, n),
    CUDA C++ in ``csrc/poisson_binomial.cu``;
  * ``gf`` — exact GF(2^31 - 1) matmul (and its batched form), CUDA C++ in
    ``csrc/gf_matmul.cu``; plain version: the 8-bit-limb fp32 GEMM route;
  * ``lagrange_encode`` — the Lagrange encode GEMM, ``csrc/lagrange_encode.cu``;
  * ``coded_gradient`` — the fused worker gradient X~^T (X~ W - Y),
    ``csrc/coded_gradient.cu``.

``build`` compiles ``csrc/*.cu`` with nvcc at first use (``build_all``: one
nvcc per source, in parallel); ``dispatch`` is the route rule (CUDA tensor ->
kernel, CPU tensor -> plain version).
"""
