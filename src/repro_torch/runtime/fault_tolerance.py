"""LEA-driven coded data parallelism + fault tolerance.

The paper's scheduling layer embedded in a trainer:

  * the global batch is split into ``k`` microbatch shards, repetition-coded
    (the paper's ``nr < k deg f - 1`` branch — valid for arbitrary, i.e.
    non-polynomial, gradient functions) across ``n`` worker groups, each
    storing ``r`` shard-copies (copy ``v`` holds shard ``v mod k``);
  * per round, the EA algorithm allocates ``ell_g``/``ell_b`` shard
    evaluations per worker from the estimated Markov state — exactly
    Sec. 3.2, with K* = nr - floor(nr/k) + 1; the plan is one
    :func:`repro_torch.core.lea.allocate` call on a (1, n) row, so on the
    card each attempt launches the static-threshold Poisson-binomial kernel;
  * a round SUCCEEDS iff every shard has an on-time copy (repetition-branch
    coverage); the master averages one copy of each shard into the step
    gradient;
  * permanently-dead workers shrink the pool; when ``n_live * r < k`` decode
    becomes infeasible and the caller restarts from a checkpoint.

Graceful degradation
--------------------
Each shard-copy's result streams out as ``packets`` packet blocks scored by
the partial-work-conserving rule of
:func:`repro_torch.faults.packets.packet_on_time` under an optional fault
channel (:mod:`repro_torch.faults.channels`), and shard coverage is per
PACKET: shard j's packet q is covered iff ANY stored copy of j delivered
packet q.

A round that misses coverage is RETRIED up to ``max_retries`` times with
exponential backoff (each retry first lets the worker chains advance
``backoff_base * 2^(attempt-1)`` extra Markov steps, then re-plans loads
from the updated estimator).  Coverage accumulates across attempts.  Every
round ends in exactly ONE of four dispositions, counted in ``outcomes``
(the counts always sum to ``rounds``):

  ``on_time``  — full coverage on the first attempt;
  ``late``     — full coverage after >= 1 retry;
  ``partial``  — still short after retries, but every shard's first ``p1``
                 packet indices are covered and ``allow_partial`` is set:
                 the round is served degraded (hierarchical layer-1);
  ``dropped``  — none of the above; the round returns ``None``.

Randomness: the executor takes one draws source (an int seeds a
:class:`~repro_torch.random.TorchDraws`) for its initial worker states
(``initial(1, n)``), every Markov step (``steps(1, 2, n)``) and, with a
channel, every attempt's fault uniforms (``fault(1, position, part, ...)``).
Worker speeds follow the paper's two-state model, simulated here; on a real
cluster the observation hook is per-host wall-clock completion times.
Gradients and batches are flat dicts of tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core import lea
from repro_torch.core.lagrange import CodeSpec
from repro_torch.core.markov import initial_states, step_states
from repro_torch.device import resolve_device
from repro_torch.faults.channels import apply_channel, base_trace
from repro_torch.faults.packets import packet_on_time
from repro_torch.random import FaultDraws, as_draws, require

from .elastic import remap_estimator

OUTCOMES = ("on_time", "late", "partial", "dropped")


def _plan_round(est: lea.EstimatorState, live: torch.Tensor, lp: lea.LoadParams):
    """Phase (1): predicted p_good (dead workers forced bad) -> one (1, n)
    allocate -> dead workers get zero load.  Returns ``(loads, i_star)``."""
    p_good = torch.where(est.seen_prev, lea.predicted_good_prob(est),
                         torch.full((lp.n,), 0.5, device=live.device))
    p_good = torch.where(live, p_good, 0.0)
    loads, i_star = lea.allocate(p_good[None], lp)
    return torch.where(live, loads[0], 0), i_star[0]


@dataclasses.dataclass(frozen=True)
class CodedDPConfig:
    n_workers: int = 8
    r: int = 4                 # shard-copies stored per worker group
    k: int = 16                # microbatch shards per round
    deadline: float = 1.0
    mu_g: float = 10.0         # shard evaluations / second, good state
    mu_b: float = 3.0
    p_gg: float = 0.8          # simulation-only: true (unknown) dynamics
    p_bb: float = 0.7
    # --- graceful degradation (repro_torch.faults) ---
    packets: int = 1           # packet blocks per shard-copy result
    max_retries: int = 0       # extra attempts for an uncovered round
    backoff_base: int = 1      # Markov steps waited before retry 1 (then x2)
    allow_partial: bool = False  # serve layer-1-covered rounds degraded
    p1: int = 1                # layer-1 packet-prefix length (see faults.packets)

    @property
    def spec(self) -> CodeSpec:
        # deg_f = "infinity" for non-polynomial f -> repetition branch
        return CodeSpec(self.n_workers, self.r, self.k, deg_f=10**9)

    @property
    def load_params(self) -> lea.LoadParams:
        return lea.LoadParams(
            n=self.n_workers,
            kstar=self.spec.recovery_threshold,
            ell_g=int(min(self.mu_g * self.deadline, self.r)),
            ell_b=int(self.mu_b * self.deadline),
        )


class CodedDataParallelExecutor:
    """Runs LEA-coded gradient rounds on top of a grad_fn.

    ``grad_fn(params, shard_batch) -> grads``; the executor owns shard
    assignment, per-round allocation, completion simulation/observation,
    estimator updates, shard-copy decoding, retry/degrade dispositioning
    and elastic pool resizes.  ``channel`` is an optional tuple of fault
    injectors applied to every attempt's completion times and packet
    deliveries; ``draws`` is an int seed or a draws source (module
    docstring).
    """

    def __init__(self, cfg: CodedDPConfig, grad_fn: Callable, *, draws=0,
                 channel: Sequence = (), device=None):
        self.cfg = cfg
        self.grad_fn = grad_fn
        self.channel = tuple(channel)
        self.device = resolve_device(device)
        self.draws = as_draws(draws, self.device)
        if self.channel:
            require(self.draws, FaultDraws)
        self.est = lea.init_estimator(cfg.n_workers, device=self.device)
        self._true_states = self._fresh_states(cfg.n_workers)
        self.live = np.ones(cfg.n_workers, bool)
        self.rounds = 0
        self.successes = 0
        self.outcomes = {name: 0 for name in OUTCOMES}

    def _chain(self, n: int) -> tuple[torch.Tensor, torch.Tensor]:
        full = lambda v: torch.full((1, n), v, dtype=torch.float32, device=self.device)
        return full(self.cfg.p_gg), full(self.cfg.p_bb)

    def _fresh_states(self, n: int) -> torch.Tensor:
        """(n,) stationary states from one ``initial(1, n)`` draw."""
        u = self.draws.initial(1, n).to(self.device)
        return initial_states(u, *self._chain(n))[0]

    # -- estimator state round-trips through checkpoints --------------------
    def state_dict(self) -> dict:
        return {
            "counts": self.est.counts.cpu().numpy().tolist(),
            "prev_state": self.est.prev_state.cpu().numpy().tolist(),
            "seen_prev": bool(self.est.seen_prev),
            "live": self.live.tolist(),
            "rounds": self.rounds,
            "successes": self.successes,
            "outcomes": dict(self.outcomes),
        }

    def load_state_dict(self, d: dict) -> None:
        self.est = lea.EstimatorState(
            counts=torch.as_tensor(d["counts"], dtype=torch.float32, device=self.device),
            prev_state=torch.as_tensor(d["prev_state"], dtype=torch.int32,
                                       device=self.device),
            seen_prev=torch.as_tensor(d["seen_prev"], device=self.device),
        )
        self.live = np.asarray(d["live"], bool)
        self.rounds = int(d["rounds"])
        self.successes = int(d["successes"])
        self.outcomes = {
            name: int(d.get("outcomes", {}).get(name, 0)) for name in OUTCOMES
        }

    def mark_dead(self, worker: int) -> None:
        """Permanent host failure.  Infeasibility triggers restart upstream."""
        self.live[worker] = False

    @property
    def decode_feasible(self) -> bool:
        return int(self.live.sum()) * self.cfg.r >= self.cfg.k

    def resize(self, new_n: int, survivors: list[int] | None = None) -> None:
        """Elastic pool resize: carry estimator history across grow/shrink.

        ``survivors`` maps old worker indices onto the first slots of the
        new pool (default: the identity prefix); newcomers start live with
        the pooled estimator prior (:func:`remap_estimator`) and a fresh
        stationary state draw.
        """
        old_n = self.cfg.n_workers
        if survivors is None:
            survivors = list(range(min(old_n, new_n)))
        self.est = remap_estimator(self.est, old_n, new_n, survivors)
        self.cfg = dataclasses.replace(self.cfg, n_workers=new_n)
        states = self._fresh_states(new_n).cpu().numpy().copy()
        live = np.ones(new_n, bool)
        old_states = self._true_states.cpu().numpy()
        for i, s in enumerate(survivors[:new_n]):
            states[i] = old_states[s]
            live[i] = self.live[s]
        self._true_states = torch.as_tensor(states, device=self.device)
        self.live = live

    def _advance_network(self, steps: int = 1) -> None:
        n = self.cfg.n_workers
        p_gg, p_bb = self._chain(n)
        for _ in range(steps):
            u = self.draws.steps(1, 2, n).to(self.device)[:, 0]       # (1, n)
            self._true_states = step_states(u, self._true_states[None], p_gg, p_bb)[0]

    def _attempt(self) -> tuple[np.ndarray, np.ndarray, dict]:
        """One delivery attempt: plan, simulate completion, observe.

        Returns ``(packet mask (n*r, packets), loads, attempt info)``.
        """
        cfg = self.cfg
        live = torch.as_tensor(self.live, device=self.device)
        loads_dev, _ = _plan_round(self.est, live, cfg.load_params)
        states_dev = self._true_states

        trace = base_trace(1, 1, cfg.n_workers, cfg.r, cfg.packets, cfg.deadline,
                           device=self.device)
        if self.channel:
            trace = apply_channel(self.draws, self.channel, trace)
        mask = packet_on_time(
            states_dev[None, None], loads_dev[None, None], cfg.mu_g, cfg.mu_b,
            cfg.deadline, cfg.r, cfg.packets, trace=trace, conserve=True,
        )[0, 0].cpu().numpy()                                       # (n*r, packets)
        mask &= np.repeat(self.live, cfg.r)[:, None]

        # (4) estimator update — completion times reveal the round's states
        self.est = lea.update_estimator(self.est, states_dev)

        loads = loads_dev.cpu().numpy().copy()
        states = states_dev.cpu().numpy()
        speeds = np.where(states == 1, cfg.mu_g, cfg.mu_b)
        on_time_workers = int(
            (((loads / np.maximum(speeds, 1e-9)) <= cfg.deadline + 1e-9)
             & self.live).sum()
        )
        info = {"on_time_workers": on_time_workers, "loads": loads.tolist()}
        return mask, loads, info

    def _coverage(self, mask: np.ndarray) -> np.ndarray:
        """(n*r, packets) arrivals -> (k, packets) shard-packet coverage:
        shard j's packet q is covered iff ANY stored copy v (v mod k == j)
        delivered packet q."""
        cfg = self.cfg
        covered = np.zeros((cfg.k, cfg.packets), bool)
        for j in range(cfg.k):
            covered[j] = mask[j::cfg.k].any(axis=0)
        return covered

    def round(self, params, batch) -> tuple[dict | None, dict]:
        """One LEA round (with bounded retry + degrade — module docstring).

        Returns ``(gradient | None, info)``; ``info["outcome"]`` is one of
        ``OUTCOMES`` and the running ``outcomes`` counts always sum to
        ``rounds``.
        """
        cfg = self.cfg
        lp = cfg.load_params
        self.rounds += 1

        covered = np.zeros((cfg.k, cfg.packets), bool)
        attempts = 0
        first_info: dict = {}
        arrived_copies = 0
        for attempt in range(cfg.max_retries + 1):
            # attempt 0 advances one round; retries wait out an exponentially
            # growing backoff of extra Markov steps before redelivering
            steps = 1 if attempt == 0 else cfg.backoff_base * (2 ** (attempt - 1))
            self._advance_network(steps)
            mask, loads, info = self._attempt()
            if attempt == 0:
                first_info = info
            attempts = attempt + 1
            arrived_copies = int(mask.all(axis=-1).sum())
            covered |= self._coverage(mask)
            if covered.all():
                break

        full = bool(covered.all())
        layer1 = bool(covered[:, : cfg.p1].all())
        if full:
            outcome = "on_time" if attempts == 1 else "late"
        elif cfg.allow_partial and layer1:
            outcome = "partial"
        else:
            outcome = "dropped"
        self.outcomes[outcome] += 1

        info = {
            "success": full and attempts == 1,
            "outcome": outcome,
            "attempts": attempts,
            "on_time_workers": first_info.get("on_time_workers", 0),
            "arrived_copies": arrived_copies,
            "covered_packets": int(covered.sum()),
            "kstar": lp.kstar,
            "loads": first_info.get("loads", []),
        }
        if outcome == "dropped":
            return None, info
        if full:
            self.successes += 1

        # master decodes: one on-time copy of each shard, average grads.
        # Degraded (partial) rounds serve the layer-1 prefix of every shard;
        # the gradient estimate still averages over all k shards, flagged
        # by the outcome.
        shards = split_batch(batch, cfg.k)
        grads = None
        for j in range(cfg.k):
            g = self.grad_fn(params, shards[j])          # computed by copy owner
            grads = g if grads is None else {name: grads[name] + g[name] for name in grads}
        return {name: v / cfg.k for name, v in grads.items()}, info

    @property
    def timely_throughput(self) -> float:
        return self.successes / max(self.rounds, 1)


def split_batch(batch: dict, k: int) -> list[dict]:
    """A dict of (b, ...) tensors -> k dicts of (b/k, ...) shards."""
    def split(x):
        b = x.shape[0]
        if b % k:
            raise ValueError(f"batch of {b} rows does not split into {k} shards")
        return x.reshape((k, b // k) + tuple(x.shape[1:]))

    stacked = {name: split(x) for name, x in batch.items()}
    return [{name: x[j] for name, x in stacked.items()} for j in range(k)]


__all__ = ["OUTCOMES", "CodedDPConfig", "CodedDataParallelExecutor", "split_batch"]
