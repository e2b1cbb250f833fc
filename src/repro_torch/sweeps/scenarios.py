"""Built-in scenario families: the paper's grids + beyond-paper sweeps.

Paper replications:

  * ``fig3``           — Sec. 6.1 numerical grid (4 chains, K*=99)
  * ``fig4``           — Sec. 6.2 EC2 replay (6 scenarios, K* in {120,100,50})
  * ``kstar_table``    — the recovery-threshold worked examples (not simulated)

Beyond-paper families (the scenario diversity the ROADMAP asks for; the
straggler-slack and elastic-pool grids follow the regimes studied by *Slack
Squeeze Coded Computing* (arXiv:1904.07098) and *Hierarchical Coded Elastic
Computing* (arXiv:2206.09399)):

  * ``deadline_sweep``  — deadline d grid; loads ell(d) move with d, so K*
                          feasibility and LEA's edge shift along the grid
                          (per-row ell -> the whole grid is ONE engine call)
  * ``bursty_chains``   — fixed stationary availability, swept mixing
                          eigenvalue lam = p_gg + p_bb - 1 (iid -> long bursts)
  * ``hetero_kstar``    — data-size grid k -> heterogeneous K* (per-row K* ->
                          the whole grid is ONE engine call, the
                          shape-polymorphic engine's showcase)
  * ``elastic_pool``    — worker-pool ramp n (elastic scale-up/down at fixed
                          work), preempted-pool regimes; pools mask-padded
                          to the widest ramp point, again ONE engine call
  * ``straggler_slack`` — speed-ratio x deadline grid: how much straggler
                          slack LEA can squeeze vs static
  * ``packet_erasure``  — preemption x packet-loss grid on the Fig. 3 pool,
                          its channel and packet geometry in ``meta``
                          (scored by :mod:`repro_torch.faults`)

Non-stationary families (the ``repro_torch.policies`` proving grounds — chains
whose parameters move, where windowed/discounted estimators beat vanilla
LEA's all-history counts; cf. the changing-worker regimes of Slack Squeeze
Coded Computing):

  * ``drifting_chains`` — per-worker availability drifts sinusoidally with
                          phase offsets, so the identity of the reliable
                          workers rotates continuously
  * ``regime_switch``   — abrupt regime changes every ``dwell`` rounds: a
                          rotating third of the pool degrades (preemption /
                          credit-exhaustion waves)
  * ``computed_drift``  — SMOOTH per-round drift through the dense
                          (rounds, n) ``dense_schedule`` spec (no step-block
                          quantisation; the second materialisation path)
"""

from __future__ import annotations

import math

from repro_torch.configs.paper_lea import EC2, SIM
from repro_torch.core import markov
from repro_torch.core.lagrange import CodeSpec
from repro_torch.core.lea import LoadParams

from .registry import Scenario, as_dense_schedule, register

# default strategy tuple for the non-stationary families: vanilla LEA vs its
# adaptive variants, the static floor and the genie ceiling (regret columns)
POLICY_STRATEGIES = ("lea", "lea_window64", "lea_discount97", "static", "oracle")


def _const(n: int, v: float) -> tuple[float, ...]:
    return (float(v),) * n


def _chain_rows(pis, lam: float) -> tuple[tuple[float, ...], tuple[float, ...]]:
    """Per-worker (p_gg, p_bb) rows with stationary dists ``pis`` and shared
    mixing eigenvalue ``lam`` (the bursty_chains parametrization)."""
    p_gg = tuple(float(pi + (1.0 - pi) * lam) for pi in pis)
    p_bb = tuple(float((1.0 - pi) + pi * lam) for pi in pis)
    return p_gg, p_bb


def _sim_lp(k: int = SIM.k, deg_f: int = SIM.deg_f) -> LoadParams:
    """The paper Sec. 6.1 LoadParams: K* from ``CodeSpec(n, r, k, deg_f)``,
    two-level loads from the mu * d budget — shared by every family that
    runs on the SIM worker pool."""
    spec = CodeSpec(SIM.n, SIM.r, k, deg_f)
    return LoadParams(
        n=SIM.n, kstar=spec.recovery_threshold,
        ell_g=int(min(SIM.mu_g * SIM.deadline, SIM.r)),
        ell_b=int(SIM.mu_b * SIM.deadline),
    )


# ---------------------------------------------------------------------------
# paper replications
# ---------------------------------------------------------------------------

@register("fig3")
def fig3(rounds: int | None = None) -> tuple[Scenario, ...]:
    """Paper Fig. 3: 4 Markov chains, n=15, K*=99, LEA vs static vs oracle."""
    lp = _sim_lp()
    rounds = rounds or SIM.rounds
    return tuple(
        Scenario(
            name=f"fig3_scenario{i}", family="fig3", lp=lp,
            p_gg=_const(SIM.n, p_gg), p_bb=_const(SIM.n, p_bb),
            mu_g=SIM.mu_g, mu_b=SIM.mu_b, deadline=SIM.deadline, rounds=rounds,
            strategies=("lea", "static", "oracle"), baseline="static",
            seed=i, meta=(("scenario", i),),
        )
        for i, (p_gg, p_bb) in enumerate(SIM.scenarios, 1)
    )


# credit-based chain estimated from Fig. 1-style traces (see fig4_ec2.py)
FIG4_P_GG, FIG4_P_BB = 0.85, 0.6


@register("fig4")
def fig4(rounds: int = 400) -> tuple[Scenario, ...]:
    """Paper Fig. 4 EC2 replay: 6 scenarios, heterogeneous K* in {120,100,50}
    (one engine call — K* is a per-row batch quantity).

    The arrival gap is folded into the chain via the exact t-step transition
    probabilities (``markov.t_step_transitions``) so one engine round is one
    request; speeds are normalized so a good worker clears its full store
    within the deadline and a bad one r/10 of it.
    """
    scenarios = []
    for i, (xrows, k, lam, d) in enumerate(EC2.scenarios, 1):
        spec = CodeSpec(EC2.n, EC2.r, k, EC2.deg_f)
        ell_g = EC2.r
        ell_b = max(1, EC2.r // 10)
        lp = LoadParams(n=EC2.n, kstar=spec.recovery_threshold,
                        ell_g=ell_g, ell_b=ell_b)
        gap = max(1, int(round((30.0 + lam) / (10 * d))))
        p_gg_t, p_bb_t = markov.t_step_transitions(FIG4_P_GG, FIG4_P_BB, gap)
        scenarios.append(Scenario(
            name=f"fig4_scenario{i}", family="fig4", lp=lp,
            p_gg=_const(EC2.n, float(p_gg_t)), p_bb=_const(EC2.n, float(p_bb_t)),
            mu_g=float(ell_g), mu_b=float(ell_b), deadline=1.0, rounds=rounds,
            strategies=("lea", "static_single"), baseline="static_single",
            seed=i,
            meta=(("rows", xrows), ("k", k), ("lam", lam), ("d", d),
                  ("gap", gap)),
        ))
    return tuple(scenarios)


@register("kstar_table")
def kstar_table(rounds: int = 0) -> tuple[Scenario, ...]:
    """Recovery-threshold worked examples (eqs. 15/16) — catalogue by default.

    With the default ``rounds=0`` these scenarios are never simulated; the
    table benchmark reads the expected K* / coding mode off ``meta`` and
    checks ``CodeSpec`` (``sweeps.run`` raises its catalogue-only error).
    Passing ``rounds > 0`` makes the family genuinely expandable into
    simulatable scenarios — each worked example runs on a placeholder
    fifty-fifty chain, useful for smoke-testing the K* grid end to end.
    """
    cases = [
        # (n, r, k, deg_f, expected K*, expected mode, where in the paper);
        # K* and mode are the PAPER's values, hard-coded — never re-derived
        # from CodeSpec here, so the table benchmark is a real check
        (15, 10, 50, 2, 99, "lagrange", "Sec6.1 sim"),
        (15, 10, 50, 1, 50, "lagrange", "Sec6.2 EC2 k=50"),
        (15, 10, 100, 1, 100, "lagrange", "Sec6.2 EC2 k=100"),
        (15, 10, 120, 1, 120, "lagrange", "Sec6.2 EC2 k=120"),
        (3, 2, 2, 2, 3, "lagrange", "Sec3.1 example 1"),
        (3, 2, 4, 2, 6, "repetition", "Sec3.1 example 2 (repetition)"),
    ]
    scenarios = []
    for n, r, k, deg, want, want_mode, where in cases:
        spec = CodeSpec(n, r, k, deg)
        lp = LoadParams(n=n, kstar=spec.recovery_threshold, ell_g=2, ell_b=1)
        scenarios.append(Scenario(
            name=f"kstar_{where.replace(' ', '_')}", family="kstar_table",
            lp=lp, p_gg=_const(n, 0.5), p_bb=_const(n, 0.5),
            mu_g=2.0, mu_b=1.0, deadline=1.0, rounds=rounds,
            strategies=("lea",), baseline="lea",
            meta=(("n", n), ("r", r), ("k", k), ("deg_f", deg),
                  ("expect_kstar", want), ("mode", want_mode), ("where", where)),
        ))
    return tuple(scenarios)


# ---------------------------------------------------------------------------
# beyond-paper families
# ---------------------------------------------------------------------------

@register("deadline_sweep")
def deadline_sweep(
    deadlines: tuple[float, ...] = (0.5, 0.7, 1.0, 1.5, 2.0),
    p_gg: float = 0.8,
    p_bb: float = 0.7,
    rounds: int = 2_000,
) -> tuple[Scenario, ...]:
    """Deadline grid on the Fig. 3 chain: loads ell(d) shift with d, so each
    deadline is its own LoadParams group (K* feasibility changes)."""
    spec = CodeSpec(SIM.n, SIM.r, SIM.k, SIM.deg_f)
    scenarios = []
    for d in deadlines:
        ell_g = int(min(SIM.mu_g * d, SIM.r))
        ell_b = max(1, int(SIM.mu_b * d))
        if ell_g <= ell_b:  # deadline too tight for a two-level allocation
            continue
        lp = LoadParams(n=SIM.n, kstar=spec.recovery_threshold,
                        ell_g=ell_g, ell_b=ell_b)
        scenarios.append(Scenario(
            name=f"deadline_d{d:g}", family="deadline_sweep", lp=lp,
            p_gg=_const(SIM.n, p_gg), p_bb=_const(SIM.n, p_bb),
            mu_g=SIM.mu_g, mu_b=SIM.mu_b, deadline=float(d), rounds=rounds,
            meta=(("deadline", d),),
        ))
    return tuple(scenarios)


@register("bursty_chains")
def bursty_chains(
    lams: tuple[float, ...] = (0.0, 0.3, 0.6, 0.8, 0.95),
    pi_g: float = 0.6,
    rounds: int = 2_000,
) -> tuple[Scenario, ...]:
    """Correlation sweep at fixed availability: pi_g held constant while the
    chain's mixing eigenvalue lam = p_gg + p_bb - 1 ramps from iid (lam=0) to
    long bursts (lam -> 1) — the regime where LEA's one-step prediction gains
    the most over the stationary static draw."""
    lp = _sim_lp()
    scenarios = []
    for lam in lams:
        # _chain_rows keeps the stationary distribution at pi_g for every
        # lam in [0, 1) while the mixing eigenvalue ramps.
        p_gg, p_bb = _chain_rows((pi_g,) * SIM.n, lam)
        scenarios.append(Scenario(
            name=f"bursty_lam{lam:g}", family="bursty_chains", lp=lp,
            p_gg=p_gg, p_bb=p_bb,
            mu_g=SIM.mu_g, mu_b=SIM.mu_b, deadline=SIM.deadline, rounds=rounds,
            meta=(("lam", lam), ("pi_g", pi_g)),
        ))
    return tuple(scenarios)


@register("hetero_kstar")
def hetero_kstar(
    ks: tuple[int, ...] = (50, 80, 100, 120),
    deg_f: int = 1,
    lams: tuple[float, ...] = (0.2, 0.6),
    pi_g: float = 0.6,
    rounds: int = 2_000,
) -> tuple[Scenario, ...]:
    """Data-size grid k -> heterogeneous K*: a (k x burstiness) product grid.
    K* is a per-row batch quantity, so the whole grid is ONE engine
    call regardless of how many K*s it spans."""
    scenarios = []
    for k in ks:
        lp = _sim_lp(k=k, deg_f=deg_f)
        for lam in lams:
            p_gg, p_bb = _chain_rows((pi_g,) * SIM.n, lam)
            scenarios.append(Scenario(
                name=f"kstar{lp.kstar}_lam{lam:g}",
                family="hetero_kstar", lp=lp,
                p_gg=p_gg, p_bb=p_bb,
                mu_g=SIM.mu_g, mu_b=SIM.mu_b, deadline=SIM.deadline,
                rounds=rounds,
                meta=(("k", k), ("kstar", lp.kstar), ("lam", lam)),
            ))
    return tuple(scenarios)


@register("elastic_pool")
def elastic_pool(
    ns: tuple[int, ...] = (10, 15, 20, 30),
    k: int = 50,
    deg_f: int = 2,
    p_gg: float = 0.8,
    p_bb: float = 0.7,
    rounds: int = 2_000,
) -> tuple[Scenario, ...]:
    """Elastic worker-pool ramp: the pool grows/shrinks at fixed work (k, r),
    as when preemptible machines join and leave (cf. Hierarchical Coded
    Elastic Computing, arXiv:2206.09399).  The ramp is mask-padded to its
    widest point and fused into ONE engine call; K* stays put while the
    allocator's headroom n*ell_g - K* ramps."""
    scenarios = []
    for n in ns:
        spec = CodeSpec(n, SIM.r, k, deg_f)
        ell_g = int(min(SIM.mu_g * SIM.deadline, SIM.r))
        ell_b = int(SIM.mu_b * SIM.deadline)
        if n * ell_g < spec.recovery_threshold:
            continue   # pool too small to ever meet K* by the deadline
        lp = LoadParams(n=n, kstar=spec.recovery_threshold,
                        ell_g=ell_g, ell_b=ell_b)
        scenarios.append(Scenario(
            name=f"elastic_n{n}", family="elastic_pool", lp=lp,
            p_gg=_const(n, p_gg), p_bb=_const(n, p_bb),
            mu_g=SIM.mu_g, mu_b=SIM.mu_b, deadline=SIM.deadline, rounds=rounds,
            meta=(("n", n), ("kstar", spec.recovery_threshold)),
        ))
    return tuple(scenarios)


# ---------------------------------------------------------------------------
# non-stationary families (repro_torch.policies proving grounds)
# ---------------------------------------------------------------------------

@register("drifting_chains")
def drifting_chains(
    periods: tuple[int, ...] = (400, 1000),
    rounds: int = 2_000,
    step: int = 50,
    lam: float = 0.5,
    base_pi: float = 0.55,
    amp: float = 0.35,
    strategies: tuple[str, ...] = POLICY_STRATEGIES,
    baseline: str = "lea",
) -> tuple[Scenario, ...]:
    """Sinusoidal availability drift with per-worker phase offsets.

    Worker i's stationary availability follows
    ``pi_i(t) = base_pi + amp * sin(2*pi*(t/period + i/n))`` (piecewise-
    constant in blocks of ``step`` rounds; mixing eigenvalue ``lam`` fixed),
    so WHICH workers are reliable rotates continuously — vanilla LEA's
    all-history counts converge to every worker's time-average and stop
    ranking, while windowed/discounted estimators track the current phase.
    One scenario per drift period."""
    n = SIM.n
    lp = _sim_lp()
    scenarios = []
    for period in periods:
        schedule = []
        for start in range(0, rounds, step):
            t_mid = start + step / 2.0
            pis = [
                min(max(base_pi + amp * math.sin(
                    2.0 * math.pi * (t_mid / period + i / n)), 0.02), 0.98)
                for i in range(n)
            ]
            p_gg, p_bb = _chain_rows(pis, lam)
            schedule.append((start, p_gg, p_bb))
        scenarios.append(Scenario(
            name=f"drift_T{period}", family="drifting_chains", lp=lp,
            p_gg=schedule[0][1], p_bb=schedule[0][2],
            mu_g=SIM.mu_g, mu_b=SIM.mu_b, deadline=SIM.deadline,
            rounds=rounds, strategies=tuple(strategies), baseline=baseline,
            schedule=tuple(schedule),
            meta=(("period", period), ("step", step), ("lam", lam),
                  ("base_pi", base_pi), ("amp", amp)),
        ))
    return tuple(scenarios)


@register("regime_switch")
def regime_switch(
    dwells: tuple[int, ...] = (250, 500),
    rounds: int = 2_000,
    lam: float = 0.5,
    pi_good: float = 0.9,
    pi_degraded: float = 0.1,
    n_rotate: int = 3,
    strategies: tuple[str, ...] = POLICY_STRATEGIES,
    baseline: str = "lea",
) -> tuple[Scenario, ...]:
    """Abrupt degradation waves: every ``dwell`` rounds a different third of
    the pool degrades (preemption / credit-exhaustion, cf. the Fig. 1 EC2
    traces), rotating through ``n_rotate`` worker groups.

    Long-run, every worker is degraded 1/n_rotate of the time, so vanilla
    LEA's cumulative counts blur the groups together; a windowed/discounted
    estimator re-identifies the currently-degraded group within its memory
    length after each switch.  One scenario per dwell time."""
    n = SIM.n
    lp = _sim_lp()
    scenarios = []
    for dwell in dwells:
        schedule = []
        for regime, start in enumerate(range(0, rounds, dwell)):
            degraded = {i for i in range(n) if i % n_rotate == regime % n_rotate}
            pis = [pi_degraded if i in degraded else pi_good for i in range(n)]
            p_gg, p_bb = _chain_rows(pis, lam)
            schedule.append((start, p_gg, p_bb))
        scenarios.append(Scenario(
            name=f"regime_dwell{dwell}", family="regime_switch", lp=lp,
            p_gg=schedule[0][1], p_bb=schedule[0][2],
            mu_g=SIM.mu_g, mu_b=SIM.mu_b, deadline=SIM.deadline,
            rounds=rounds, strategies=tuple(strategies), baseline=baseline,
            schedule=tuple(schedule),
            meta=(("dwell", dwell), ("lam", lam), ("pi_good", pi_good),
                  ("pi_degraded", pi_degraded), ("n_rotate", n_rotate)),
        ))
    return tuple(scenarios)


@register("computed_drift")
def computed_drift(
    periods: tuple[int, ...] = (400, 1000),
    rounds: int = 2_000,
    lam: float = 0.5,
    base_pi: float = 0.55,
    amp: float = 0.35,
    strategies: tuple[str, ...] = POLICY_STRATEGIES,
    baseline: str = "lea",
) -> tuple[Scenario, ...]:
    """Smooth per-round drift via a precomputed dense (rounds, n) chain spec.

    The ``dense_schedule`` showcase: the same rotating sinusoidal
    availability as ``drifting_chains`` but computed at EVERY round (no
    ``step``-block quantisation) — ``pi_i(t) = base_pi + amp *
    sin(2*pi*(t/period + i/n))`` materialised directly as (rounds, n)
    arrays through :func:`repro_torch.sweeps.registry.as_dense_schedule`.  One
    scenario per drift period; windowed/discounted LEA variants track the
    continuously-moving regime that vanilla LEA's all-history counts blur.
    """
    n = SIM.n
    lp = _sim_lp()
    scenarios = []
    for period in periods:
        t = [tm + 0.5 for tm in range(rounds)]      # mid-round sample points
        p_gg = []
        p_bb = []
        for tm in t:
            pis = [
                min(max(base_pi + amp * math.sin(
                    2.0 * math.pi * (tm / period + i / n)), 0.02), 0.98)
                for i in range(n)
            ]
            g, b = _chain_rows(pis, lam)
            p_gg.append(g)
            p_bb.append(b)
        dense = as_dense_schedule(p_gg, p_bb)
        scenarios.append(Scenario(
            name=f"cdrift_T{period}", family="computed_drift", lp=lp,
            p_gg=dense[0][0], p_bb=dense[1][0],
            mu_g=SIM.mu_g, mu_b=SIM.mu_b, deadline=SIM.deadline,
            rounds=rounds, strategies=tuple(strategies), baseline=baseline,
            dense_schedule=dense,
            meta=(("period", period), ("lam", lam),
                  ("base_pi", base_pi), ("amp", amp)),
        ))
    return tuple(scenarios)


@register("packet_erasure")
def packet_erasure(
    p_preempts: tuple[float, ...] = (0.0, 0.2, 0.4),
    p_drops: tuple[float, ...] = (0.0, 0.05, 0.15),
    packets: int = 4,
    p1: int = 1,
    k1: int = 25,
    rounds: int = 2_000,
) -> tuple[Scenario, ...]:
    """Fault grid for the ``repro.faults`` runtime: preemption x packet loss.

    A (p_preempt x p_drop) product grid on the Fig. 3 worker pool; each
    cell's fault channel — a ``preempt`` ramp composed with iid
    ``packet_bernoulli`` erasure — and its packet geometry ride in ``meta``
    (the registry stays fault-agnostic).  A caller turns the meta columns
    into per-row channel parameters and scores every cell's rounds under
    three decode modes (all-or-nothing / partial-work conserving /
    hierarchical layer-1, threshold ``K1 = (k1-1) deg_f + 1``) on the same
    trajectories and the same fault realisations, in ONE pass of
    :func:`repro_torch.faults.engine.sweep_faults`.
    """
    lp = _sim_lp()
    k1star = CodeSpec(SIM.n, SIM.r, k1, SIM.deg_f).recovery_threshold
    scenarios = []
    for p_pre in p_preempts:
        for p_drop in p_drops:
            scenarios.append(Scenario(
                name=f"erasure_pre{p_pre:g}_drop{p_drop:g}",
                family="packet_erasure", lp=lp,
                p_gg=_const(SIM.n, 0.8), p_bb=_const(SIM.n, 0.7),
                mu_g=SIM.mu_g, mu_b=SIM.mu_b, deadline=SIM.deadline,
                rounds=rounds,
                meta=(("p_preempt", p_pre), ("p_drop", p_drop),
                      ("packets", packets), ("p1", p1), ("k1", k1),
                      ("k1star", k1star), ("r", SIM.r)),
            ))
    return tuple(scenarios)


@register("straggler_slack")
def straggler_slack(
    speed_ratios: tuple[float, ...] = (2.0, 3.3, 5.0, 10.0),
    deadlines: tuple[float, ...] = (1.0, 1.5),
    rounds: int = 2_000,
) -> tuple[Scenario, ...]:
    """Straggler-slack grid: how slow is a bad worker (mu_g / mu_b) x how much
    deadline slack exists — the adaptive-straggler regime of Slack Squeeze
    Coded Computing (arXiv:1904.07098).  Each cell reshapes (ell_g, ell_b),
    (ell is per-row, so the whole grid is still one engine call)."""
    spec = CodeSpec(SIM.n, SIM.r, SIM.k, SIM.deg_f)
    scenarios = []
    for ratio in speed_ratios:
        mu_b = SIM.mu_g / ratio
        for d in deadlines:
            ell_g = int(min(SIM.mu_g * d, SIM.r))
            ell_b = max(1, int(mu_b * d))
            if ell_g <= ell_b:
                continue
            lp = LoadParams(n=SIM.n, kstar=spec.recovery_threshold,
                            ell_g=ell_g, ell_b=ell_b)
            scenarios.append(Scenario(
                name=f"slack_r{ratio:g}_d{d:g}", family="straggler_slack",
                lp=lp, p_gg=_const(SIM.n, 0.8), p_bb=_const(SIM.n, 0.7),
                mu_g=SIM.mu_g, mu_b=float(mu_b), deadline=float(d),
                rounds=rounds,
                meta=(("speed_ratio", ratio), ("deadline", d)),
            ))
    return tuple(scenarios)
