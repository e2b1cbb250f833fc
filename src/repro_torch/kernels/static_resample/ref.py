"""Plain PyTorch version of the static resampler's try.

The oracle of the CUDA kernel in ``kernel.py`` and the route every CPU
tensor takes: the engine's per-try passes as they were, over the whole
block.  Before each try every strategy's unfinished rounds are found from
its masked loads (``redo``); the try draws every element of the block and
keeps the new loads of the ``redo`` rounds only; the loads are masked and
the ``feasible`` flags formed at the end.

K*, ell_g and ell_b are anything that broadcasts over (B, m) and (B, m, n)
(Python ints, or (B, 1) and (B, 1, 1) tensors); ``mask`` is (B, n) or
``None``.
"""

from __future__ import annotations

import torch


class StaticResampleRef:
    """One block of ``m`` rounds of the resampler in plain PyTorch."""

    def __init__(self, pis, m: int, kstar, ell_g, ell_b, mask=None):
        b, n = pis[0].shape
        self.pis, self.kstar, self.ell_g, self.ell_b, self.mask = pis, kstar, ell_g, ell_b, mask
        self.loads = [torch.zeros((b, m, n), dtype=torch.int32, device=pis[0].device)
                      for _ in pis]
        self.redo = None

    def _masked(self, loads):
        mask = self.mask
        return loads if mask is None else torch.where(mask[:, None, :], loads, 0)

    def unfinished(self) -> int:
        """The unfinished (strategy, round) pairs: the one host read a try."""
        self.redo = [self._masked(x).sum(dim=-1) < self.kstar for x in self.loads]
        return int(torch.stack([r.sum() for r in self.redo]).sum())

    def redraw(self, u: torch.Tensor) -> None:
        """One try: every unfinished pair redrawn from ``u`` (B, m, n)."""
        for j, pi in enumerate(self.pis):
            new = torch.where(u < pi[:, None, :], self.ell_g, self.ell_b).to(torch.int32)
            self.loads[j] = torch.where(self.redo[j][..., None], new, self.loads[j])

    def result(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """``[(loads (B, m, n) int32, feasible (B, m) bool)]`` a strategy."""
        out = []
        for x in self.loads:
            x = self._masked(x)
            out.append((x, x.sum(dim=-1) >= self.kstar))
        return out


__all__ = ["StaticResampleRef"]
