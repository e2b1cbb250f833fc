"""repro_torch.sweeps — grouped, chunked, registry-driven Monte-Carlo sweeps.

  * :mod:`~repro_torch.sweeps.registry`  — named scenario families -> flat
    :class:`ScenarioBatch` tensors, grouped by signature;
  * :mod:`~repro_torch.sweeps.scenarios` — the paper's Fig. 3 / Fig. 4 grids
    plus deadline, bursty-chain, heterogeneous-K*, elastic-pool,
    straggler-slack and non-stationary families;
  * :mod:`~repro_torch.sweeps.executor`  — one batched engine call per group;
  * :mod:`~repro_torch.sweeps.results`   — throughputs, ratios, CIs, regret,
    provenance-stamped manifests.

The one-liner::

    from repro_torch import sweeps

    for r in sweeps.run("fig3", seeds=64):       # on the GPU
        print(r.name, r.throughput, f"{r.baseline_ratio:.2f}x")
"""

from repro_torch.obs.telemetry import TelemetryFrame

from .executor import (compile_cache_size, run, run_group, run_groups,
                       suggest_round_chunk)
from .registry import (Scenario, ScenarioBatch, SweepGroup, as_dense_schedule,
                       build_groups, catalogue, describe, expand, family_names,
                       register)
from .results import (ScenarioResult, manifest, summarize, summarize_group,
                      write_manifest)

__all__ = [
    "Scenario", "ScenarioBatch", "ScenarioResult", "SweepGroup", "TelemetryFrame",
    "as_dense_schedule", "build_groups", "catalogue", "compile_cache_size",
    "describe", "expand", "family_names", "manifest", "register", "run",
    "run_group", "run_groups", "suggest_round_chunk", "summarize",
    "summarize_group", "write_manifest",
]
