"""Lagrange Coded Computing parameters (Sec. 3.1): the recovery threshold K*.

Only :class:`CodeSpec` lives here for now — the encode/decode paths and the
exact GF(2^31 - 1) arithmetic of the JAX package's ``core/lagrange.py`` are
ported with the coded-computing kernels.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """Static description of one coded-computing instance."""

    n: int        # number of workers
    r: int        # encoded chunks stored per worker
    k: int        # number of data chunks
    deg_f: int    # total degree of the polynomial f evaluated each round

    @property
    def nr(self) -> int:
        return self.n * self.r

    @property
    def mode(self) -> str:
        return "lagrange" if self.nr >= self.k * self.deg_f - 1 else "repetition"

    @property
    def recovery_threshold(self) -> int:
        """K*, eq. (15)/(16) of the paper."""
        if self.mode == "lagrange":
            return (self.k - 1) * self.deg_f + 1
        return self.nr - self.nr // self.k + 1

    def chunk_owner(self, v: int) -> int:
        """Worker that stores encoded chunk v (worker i holds [i*r, (i+1)*r))."""
        return v // self.r

    def worker_chunks(self, i: int) -> range:
        return range(i * self.r, (i + 1) * self.r)


def recovery_threshold(n: int, r: int, k: int, deg_f: int) -> int:
    return CodeSpec(n, r, k, deg_f).recovery_threshold
