"""The benchmark's own random inputs: uniforms keyed by position.

Every uniform the program consumes comes from :class:`KeyedDraws`, which
answers the program's ``Draws`` and ``FaultDraws`` calls.  Each call draws
one whole tensor from a ``torch.Generator`` seeded anew with a key made
from (run seed, job, call kind, call arguments), so the same call always
yields the same tensor on the same device.  The reference regenerates the
draws of the rows it checks by making the same call again after the
window; it needs no copy of anything the program made, and nothing is
recorded while the window runs.
"""

from __future__ import annotations

import hashlib

import torch


def key(*parts) -> int:
    """A 63-bit generator seed from any tuple of ints and strings."""
    digest = hashlib.blake2b(repr(parts).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & (2**63 - 1)


class KeyedDraws:
    """Position-keyed float32 uniforms for one job of one run."""

    def __init__(self, seed: int, job: int, device):
        self.seed, self.job = int(seed), int(job)
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)

    def _uniform(self, shape, *where) -> torch.Tensor:
        self._gen.manual_seed(key(self.seed, self.job, *where))
        return torch.rand(tuple(shape), generator=self._gen, device=self.device,
                          dtype=torch.float32)

    def initial(self, rows, n):
        return self._uniform((rows, n), "initial", rows, n)

    def steps(self, rows, rounds, n):
        return self._uniform((rows, max(rounds - 1, 0), n), "steps", rows, rounds, n)

    def static(self, rows, rounds, start, stop, n, try_index):
        return self._uniform((rows, stop - start, n), "static", rows, rounds, start,
                             stop, n, try_index)

    def single(self, rows, rounds, start, stop, n):
        return self._uniform((rows, stop - start, n), "single", rows, rounds, start,
                             stop, n)

    def fault(self, rows, position, part, shape):
        return self._uniform((rows,) + tuple(shape), "fault", rows, position, part,
                             *shape)
