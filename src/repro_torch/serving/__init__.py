"""repro_torch.serving — streaming coded serving over the batched engine.

The paper maximizes timely throughput for a SINGLE job on a fixed grid of
rounds; this package turns that offline engine into an online service
simulator: a continuous arrival process of requests — each with its own
recovery threshold, loads and deadline — competes for one worker pool
(cf. *Stream Distributed Coded Computing*, arXiv 2103.01921, and the
load-adaptive redundancy of *Slack Squeeze Coded Computing*, arXiv
1904.07098):

  * :mod:`~repro_torch.serving.arrivals`  — registered arrival processes
    (Poisson, shift-exponential — the paper Sec. 6.2 model, MMPP bursts,
    constant) sampled as batched count streams on the device from the
    arrival variates of a :class:`~repro_torch.random.ArrivalDraws`;
  * :mod:`~repro_torch.serving.queue`     — a fixed-capacity mask-padded
    :class:`RequestQueue` with EDF/FIFO ordering and slot recycling as
    tensor updates;
  * :mod:`~repro_torch.serving.admission` — predicted-feasibility and
    capacity-reservation admission gates (both tensors in the request
    spec, so admit-all and controlled runs share one code path);
  * :mod:`~repro_torch.serving.engine`    — the serving loop over rounds
    on the device: multi-job EDF water-filling allocation
    (:func:`repro_torch.core.lea.allocate_queue`), engine-rule scoring,
    optional time-axis fault channels, and full per-request accounting
    (:class:`ServingOutcomes` + sojourn streams for latency percentiles).

``telemetry=`` (:class:`ServingTelemetry`) and ``tap=`` streams come from
:mod:`repro_torch.obs`.  ``arrival_key`` has no counterpart, as the port
draws through sources, not keys (the arrival stream's tag is
:data:`repro_torch.random.ARRIVAL_TAG`).
"""

from repro_torch.obs.telemetry import ServingTelemetry

from .admission import admission_budget, admission_room, minimal_demand, predicted_success
from .arrivals import make_process, process_names, register_process, sample_arrivals
from .engine import (EVENT_EXPIRED, EVENT_LATE, EVENT_NONE, EVENT_ON_TIME,
                     ServingOutcomes, serving_compile_cache_size, simulate_serving,
                     sweep_serving)
from .queue import (ADMIT_ALL_CAP, RequestQueue, RequestSpec, admit, edf_order,
                    empty_queue, release)

__all__ = [
    "ADMIT_ALL_CAP", "EVENT_EXPIRED", "EVENT_LATE", "EVENT_NONE",
    "EVENT_ON_TIME", "RequestQueue", "RequestSpec", "ServingOutcomes", "ServingTelemetry",
    "admission_budget", "admission_room", "admit", "edf_order", "empty_queue",
    "make_process", "minimal_demand", "predicted_success", "process_names",
    "register_process", "release", "sample_arrivals", "serving_compile_cache_size",
    "simulate_serving", "sweep_serving",
]
