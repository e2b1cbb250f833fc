"""The paper's OWN workloads (Sec. 6) as configs for benchmarks/examples."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LEASimConfig:
    """Sec. 6.1 numerical analysis: n=15 t2.micro-like workers, K*=99."""

    n: int = 15
    r: int = 10
    k: int = 50
    deg_f: int = 2
    mu_g: float = 10.0
    mu_b: float = 3.0
    deadline: float = 1.0
    rounds: int = 20_000
    # the 4 scenarios: (p_gg, p_bb)
    scenarios: tuple[tuple[float, float], ...] = (
        (0.8, 0.8), (0.8, 0.7), (0.8, 0.533), (0.9, 0.6)
    )


@dataclasses.dataclass(frozen=True)
class LEAEC2Config:
    """Sec. 6.2 EC2 experiments: linear f(X)=X^T B, K*=50, 6 scenarios."""

    n: int = 15
    r: int = 10
    deg_f: int = 1
    mu_g: float = 10.0
    mu_b: float = 1.0          # credit-exhausted t2.micro: ~10x slower (Fig. 1)
    rounds: int = 2_000
    # (rows of X_j, k, lambda, deadline)
    scenarios: tuple[tuple[int, int, float, float], ...] = (
        (25, 120, 10.0, 2.5),
        (25, 120, 30.0, 2.5),
        (30, 100, 10.0, 3.0),
        (30, 100, 30.0, 3.0),
        (60, 50, 10.0, 6.0),
        (60, 50, 30.0, 6.0),
    )
    cols: int = 3000


SIM = LEASimConfig()
EC2 = LEAEC2Config()
