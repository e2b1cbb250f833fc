"""Core library: LEA scheduling on two-state Markov workers (the paper's
Sec. 2-4), and the batched timely-throughput engine."""

from .lagrange import CodeSpec, recovery_threshold  # noqa: F401
from .lea import (  # noqa: F401
    EstimatorState,
    LoadParams,
    PoolLoad,
    allocate,
    allocate_masked,
    estimated_transitions,
    init_estimator,
    pool_load,
    predicted_good_prob,
    prefix_thresholds,
    prefix_thresholds_traced,
    round_success,
    success_prob_all_prefixes,
    update_estimator,
)
from .markov import (  # noqa: F401
    initial_states,
    sample_trajectory,
    speeds_from_states,
    stationary_good_prob,
    step_states,
    t_step_transitions,
)
from .throughput import (  # noqa: F401
    STATIC_STRATEGIES,
    allocator_strategies,
    compare,
    simulate,
    simulate_strategies,
    simulate_strategies_pool,
    strategy_known,
    sweep,
    sweep_pool,
    timely_throughput,
)
