"""Fault-scored sweeps through ``faults.sweep_faults``: one sweep of a
registered fault family's grid a job, back to back.

Set-up expands the family, checks it against the configuration file and
builds the call's arguments: each cell's row repeated ``seeds`` times, the
channel ``preempt`` + ``packet_bernoulli`` with each row's (p_preempt,
p_drop), the packet geometry from the family's meta.  Job ``j`` draws
from ``KeyedDraws(seed, j)`` and ends when the checked rows' outcomes are
on the host.  After the window the reference recomputes
``checked_rows_per_cell`` rows a cell of ``checked_jobs`` jobs, all three
decode modes, and the check reads the share of outcomes that differ.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.draws import KeyedDraws
from portbench.drivers.sweep import check_scenarios, compare_kept, sample
from portbench.reference import engine as ref
from portbench.reference import faults as ref_faults


class Driver:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        self.cfg, self.traffic, self.seed = cfg, traffic, int(seed)
        self.device = torch.device(device)
        self.kept: dict[int, tuple[np.ndarray, np.ndarray]] = {}

    def setup(self) -> None:
        from repro_torch import faults, sweeps
        from repro_torch.core.lea import PoolLoad

        scenarios = sweeps.expand(self.traffic["family"], **self.traffic.get("family_params", {}))
        check_scenarios(scenarios, self.cfg)
        seeds, dev = self.traffic["seeds"], self.device
        meta = [dict(sc.meta) for sc in scenarios]
        self.cell_of_row = np.repeat(np.arange(len(scenarios)), seeds)
        col = lambda v: np.asarray(v, np.float32)[self.cell_of_row]
        self.p_preempt = col([m["p_preempt"] for m in meta])
        self.p_drop = col([m["p_drop"] for m in meta])
        self.p_gg = col([sc.p_gg[0] for sc in scenarios])
        self.p_bb = col([sc.p_bb[0] for sc in scenarios])
        geo = {k: meta[0][k] for k in ("r", "packets", "p1", "k1star")}
        if any({k: m[k] for k in geo} != geo for m in meta) or geo["r"] != self.cfg["r"]:
            raise ValueError("the grid's cells must share the configuration's packet geometry")
        self.geo, sc = geo, scenarios[0]
        self.rows, self.rounds, self.n = len(self.cell_of_row), sc.rounds, sc.lp.n
        self.strategies = tuple(self.traffic["strategies"])
        lp = sc.lp
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=dev)
        f32 = lambda v: torch.as_tensor(v, device=dev)
        pool = PoolLoad(kstar=i32(lp.kstar), ell_g=i32(lp.ell_g), ell_b=i32(lp.ell_b),
                        mask=torch.ones(lp.n, dtype=torch.bool, device=dev))
        channel = faults.make_channel([("preempt", {"p_preempt": f32(self.p_preempt)}),
                                       ("packet_bernoulli", {"p_drop": f32(self.p_drop)})])
        full = lambda p: f32(np.repeat(p[:, None], self.n, 1))
        self.args = (pool, full(self.p_gg), full(self.p_bb), sc.mu_g, sc.mu_b, sc.deadline,
                     channel, geo["k1star"])
        self.kwargs = dict(rounds=self.rounds, strategies=self.strategies, r=geo["r"],
                           packets=geo["packets"], p1=geo["p1"], device=dev)
        self._sweep(-1, np.arange(1))

    def _sweep(self, job: int, rows: np.ndarray) -> np.ndarray:
        """(3, R, M, S) host outcomes of ``rows`` (full_aon, full_conserve,
        partial)."""
        from repro_torch import faults

        out = faults.sweep_faults(KeyedDraws(self.seed, job, self.device), *self.args,
                                  **self.kwargs)
        idx = torch.as_tensor(rows, device=self.device)
        return torch.stack([x[idx] for x in out]).cpu().numpy()

    def checked_rows(self, job: int) -> np.ndarray:
        per = self.traffic["checked_rows_per_cell"]
        return np.concatenate([sample(self.seed, job, f"rows{c}",
                                      np.flatnonzero(self.cell_of_row == c), per)
                               for c in range(self.cell_of_row.max() + 1)])

    def job(self, j: int) -> int:
        rows = self.checked_rows(j)
        self.kept[j] = (rows, self._sweep(j, rows))
        return self.rows * self.rounds

    def finish(self) -> None:
        pass

    def release(self) -> None:
        del self.args

    def end_to_end(self, units: int, window_s: float) -> dict:
        return {"row_rounds_per_s": units / window_s}

    def work(self) -> dict:
        """B1's least bytes and operations a sweep: the whole grid's
        allocator rows in one launch."""
        from portbench.work import b1

        alloc = [s for s in self.strategies if not s.startswith("static")]
        w = ref.thresholds(self.n, self.cfg["kstar"], self.cfg["ell_g"], self.cfg["ell_b"])
        return {"b1": b1.launch_work(len(alloc) * self.rows * self.rounds, self.n, w,
                                     self.rows)}

    def reference(self, job: int, rows: np.ndarray, rd=ref.float32) -> np.ndarray:
        """(3, R, M, S) outcomes of ``rows`` of job ``job``, worked out again."""
        draws = KeyedDraws(self.seed, job, self.device)
        b, m, n, cfg, geo = self.rows, self.rounds, self.n, self.cfg, self.geo
        idx = torch.as_tensor(rows, device=self.device)
        pick = lambda u: u[idx].cpu().numpy()

        def draws_for(kind, *a):
            if kind == "initial":
                return pick(draws.initial(b, n))
            if kind == "steps":
                return pick(draws.steps(b, m, n))
            start, stop, t = a
            return pick(draws.static(b, m, start, stop, n, t))

        full = lambda p: np.repeat(p[rows, None], n, 1)
        states, loads, feas = ref.rollout(
            draws_for, len(rows), m, n, full(self.p_gg), full(self.p_bb), self.strategies,
            cfg["kstar"], cfg["ell_g"], cfg["ell_b"], [(0, m)], rd)
        t_cut = ref_faults.cutoffs(pick(draws.fault(b, 0, "hit", (m, n))),
                                   pick(draws.fault(b, 0, "frac", (m, n))),
                                   self.p_preempt[rows], cfg["deadline"], rd)
        keep = ref_faults.delivered(
            pick(draws.fault(b, 1, "drop", (m, n, geo["r"], geo["packets"]))),
            self.p_drop[rows], rd)
        out = ref_faults.outcomes(states, loads, feas, t_cut, keep, cfg["mu_g"], cfg["mu_b"],
                                  cfg["deadline"], geo["r"], geo["packets"], cfg["kstar"],
                                  geo["k1star"], geo["p1"], rd)
        return np.stack(out).transpose(0, 2, 3, 1)

    def check(self, done: int, control: bool = False) -> tuple[list, int]:
        return compare_kept(self, done, control, "outcome_mismatch_share")
