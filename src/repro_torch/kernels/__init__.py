"""Hand-written Hopper kernels of the port, each beside its plain version.

  * ``poisson_binomial`` — batched EA-allocator prefix-tail DP (B, n)->(B, n),
    CUDA C++ in ``csrc/poisson_binomial.cu``;
  * ``gf`` — exact GF(2^31 - 1) matmul (and its batched form), CUDA C++ in
    ``csrc/gf_matmul.cu``; plain version: the 8-bit-limb fp32 GEMM route;
  * ``lagrange_encode`` — the Lagrange encode GEMM, ``csrc/lagrange_encode.cu``;
  * ``coded_gradient`` — the fused worker gradient X~^T (X~ W - Y),
    ``csrc/coded_gradient.cu``;
  * ``flash_attention`` — causal / sliding-window GQA attention (forward),
    ``csrc/flash_attention.cu``; plain versions ``flash_attention_ref`` (what
    the kernel computes) and ``attention_ref`` (the JAX package's oracle);
  * ``static_resample`` — one try of the static strategies' rejection
    resampler over the unfinished rounds of a block,
    ``csrc/static_resample.cu`` (no TPU kernel: the JAX package's engine
    resamples with whole-batch passes);
  * ``packet_counts`` — both decode modes' per-packet counts of the fault
    engine in one pass, ``csrc/packet_counts.cu`` (no TPU kernel: the JAX
    package composes the masks and their sum in XLA).

``build`` compiles ``csrc/*.cu`` with nvcc at first use (``build_all``: one
nvcc per source, in parallel); ``dispatch`` is the route rule (CUDA tensor ->
kernel, CPU tensor -> plain version).
"""
