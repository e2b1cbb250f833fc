"""Monte-Carlo sweeps of a registered scenario family through
``sweeps.run_group``: one sweep a job, back to back.

Set-up expands the family, checks it against the configuration file,
groups it with ``seeds`` rows a scenario and picks the program's own
``round_chunk`` for the group; one sweep warms every shape.  Job ``j``
draws from ``KeyedDraws(seed, j)``.  Each job keeps the host successes of
``checked_rows_per_chain`` rows a chain, drawn from (seed, j); after the
window the reference recomputes those rows of ``checked_jobs`` jobs (the
first and others drawn from the seed) and the check reads the share of
per-round, per-strategy successes on which the two differ.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.draws import KeyedDraws, key
from portbench.reference import engine as ref


def check_scenarios(scenarios, cfg: dict) -> None:
    """Raise unless the program's scenarios are the configuration's."""
    chains = [tuple(c) for c in cfg["chains"]]
    for sc in scenarios:
        lp = sc.lp
        got = dict(n=lp.n, kstar=lp.kstar, ell_g=lp.ell_g, ell_b=lp.ell_b,
                   mu_g=sc.mu_g, mu_b=sc.mu_b, deadline=sc.deadline)
        want = {k: cfg[k] for k in got}
        if got != want or len(set(sc.p_gg)) != 1 or len(set(sc.p_bb)) != 1:
            raise ValueError(f"scenario {sc.name} is not {cfg['name']}: {got} vs {want}")
        if (sc.p_gg[0], sc.p_bb[0]) not in chains:
            raise ValueError(f"scenario {sc.name}'s chain is not among {chains}")


def sample(seed: int, job: int, tag: str, pool, count: int) -> np.ndarray:
    """``count`` sorted distinct picks from ``pool``, drawn from (seed, job)."""
    rng = np.random.default_rng(key(seed, job, tag))
    return np.sort(rng.choice(np.asarray(pool), size=min(count, len(pool)), replace=False))


def checked_jobs(seed: int, done: int, count: int) -> list[int]:
    """Job 0 and ``count - 1`` more drawn from the seed among ``done`` jobs."""
    if done <= 1 or count <= 1:
        return list(range(min(done, 1)))
    return [0] + sample(seed, -1, "jobs", range(1, done), count - 1).tolist()


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.kept: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    # -- the program ---------------------------------------------------
    def setup(self) -> None:
        from repro_torch import sweeps
        from repro_torch.sweeps import executor

        scenarios = sweeps.expand(self.traffic["family"], **self.traffic.get("family_params", {}))
        check_scenarios(scenarios, self.cfg)
        self.group, = sweeps.build_groups(scenarios, seeds=self.traffic["seeds"])
        self.chunk = executor.suggest_round_chunk(self.group)
        self.rows, self.rounds = self.group.batch.rows, self.group.rounds
        self.n = self.group.n_max
        self.strategies = self.group.strategies
        self.chain_of_row = np.repeat(np.arange(len(scenarios)), self.traffic["seeds"])
        self.p_gg = np.array([sc.p_gg[0] for sc in scenarios], np.float32)[self.chain_of_row]
        self.p_bb = np.array([sc.p_bb[0] for sc in scenarios], np.float32)[self.chain_of_row]
        self._sweep(-1)

    def _sweep(self, job: int) -> np.ndarray:
        from repro_torch.sweeps import run_group

        return run_group(self.group, round_chunk=self.chunk,
                         draws=KeyedDraws(self.seed, job, self.device), device=self.device)

    def checked_rows(self, job: int) -> np.ndarray:
        per = self.traffic["checked_rows_per_chain"]
        return np.concatenate([sample(self.seed, job, f"rows{c}",
                                      np.flatnonzero(self.chain_of_row == c), per)
                               for c in range(self.chain_of_row.max() + 1)])

    def job(self, j: int) -> int:
        succ = self._sweep(j)
        rows = self.checked_rows(j)
        self.kept[j] = (rows, succ[rows].copy())
        return self.rows * self.rounds

    def finish(self) -> None:
        pass

    def release(self) -> None:
        del self.group

    # -- the numbers ---------------------------------------------------
    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"row_rounds_per_s": units / window_s}

    def work(self) -> dict:
        """B1's least bytes and operations a sweep: one DP row a round, a
        row and an allocator strategy, on the configuration's thresholds."""
        from portbench.work import b1

        alloc = [s for s in self.strategies if s not in ("static", "static_equal",
                                                          "static_single")]
        w = ref.thresholds(self.n, self.cfg["kstar"], self.cfg["ell_g"], self.cfg["ell_b"])
        blocks = len(self.blocks())
        moved, ops = b1.launch_work(len(alloc) * self.rows * self.rounds, self.n, w,
                                    self.rows * blocks)
        return {"b1": (moved, ops)}

    # -- the reference -------------------------------------------------
    def blocks(self) -> list[tuple[int, int]]:
        chunk = self.chunk or self.rounds
        return [(a, min(a + chunk, self.rounds)) for a in range(0, self.rounds, chunk)]

    def reference(self, job: int, rows: np.ndarray, rd=ref.float32) -> np.ndarray:
        """(R, M, S) successes of ``rows`` of job ``job``, worked out again."""
        draws = KeyedDraws(self.seed, job, self.device)
        b, m, n = self.rows, self.rounds, self.n
        idx = torch.as_tensor(rows, device=self.device)

        def draws_for(kind, *a):
            if kind == "initial":
                u = draws.initial(b, n)
            elif kind == "steps":
                u = draws.steps(b, m, n)
            else:
                start, stop, t = a
                u = draws.static(b, m, start, stop, n, t)
            return u[idx].cpu().numpy()

        cfg = self.cfg
        states, loads, feas = ref.rollout(
            draws_for, len(rows), m, n, np.repeat(self.p_gg[rows, None], n, 1),
            np.repeat(self.p_bb[rows, None], n, 1), self.strategies,
            cfg["kstar"], cfg["ell_g"], cfg["ell_b"], self.blocks(), rd)
        got = ref.received(states[None], loads, cfg["mu_g"], cfg["mu_b"], cfg["deadline"], rd)
        return ((got >= cfg["kstar"]) & feas).transpose(1, 2, 0)

    def check(self, done: int, control: bool = False) -> tuple[list, int]:
        return compare_kept(self, done, control, "success_mismatch_share")


def compare_kept(driver, done: int, control: bool, name: str) -> tuple[list, int]:
    """``([(name, share)], failed)``: the share of the kept answers of the
    checked jobs on which the program (``control``: the reference in
    bfloat16) and the reference differ, and the checked jobs with any."""
    wrong = total = failed = 0
    for j in checked_jobs(driver.seed, done, driver.traffic["checked_jobs"]):
        rows, got = driver.kept[j]
        want = driver.reference(j, rows)
        if control:
            got = driver.reference(j, rows, ref.bfloat16)
        diff = int(np.count_nonzero(got != want))
        wrong, total, failed = wrong + diff, total + want.size, failed + (diff > 0)
    return [(name, wrong / max(total, 1))], failed
