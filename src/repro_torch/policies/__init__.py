"""repro_torch.policies — pluggable scheduling policies with regret accounting.

  * :mod:`~repro_torch.policies.api`        — the :class:`Policy` protocol;
  * :mod:`~repro_torch.policies.estimators` — built-ins: paper LEA,
    sliding-window and discounted-count LEA, optimistic UCB, the genie;
  * :mod:`~repro_torch.policies.registry`   — ``@policies.register``,
    dynamic ``lea_window<W>`` / ``lea_discount<D>`` spellings (memoised);
  * :mod:`~repro_torch.policies.regret`     — per-round / cumulative
    timely-throughput regret vs the oracle.
"""

from .api import Policy, PolicyContext
from .estimators import discounted_lea, lea_p_good, oracle_p_good, windowed_lea
from .registry import (catalogue, describe, is_registered, names, register,
                       register_policy, resolve)
from .regret import (cumulative_regret, final_regret, per_round_regret,
                     regret_curve_summary)

__all__ = [
    "Policy", "PolicyContext", "catalogue", "cumulative_regret", "describe",
    "discounted_lea", "final_regret", "is_registered", "lea_p_good", "names",
    "oracle_p_good", "per_round_regret", "register", "register_policy",
    "regret_curve_summary", "resolve", "windowed_lea",
]
