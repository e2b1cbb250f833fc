"""The paper's own workloads (Sec. 6), copied from the JAX package."""
