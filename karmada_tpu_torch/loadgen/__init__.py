"""Sustained-traffic serve harness (the load generator subsystem).

Counterpart of the JAX package's ``loadgen/``.  This package drives the serve plane with open-loop
synthetic traffic and closes the loop with the scheduler's admission /
batch-formation machinery (scheduler/queue.py, scheduler/service.py):

  arrival.py    deterministic-seed arrival processes (steady Poisson,
                diurnal sine, failover-storm burst) via thinning
  scenarios.py  the scenario catalog: arrival shape + cluster-event
                schedule + queue/admission tuning per named scenario
  driver.py     LoadDriver: injects bindings and cluster events into a
                running plane through the same store/worker paths real
                traffic uses; compressed virtual-clock mode for tier-1
                and bench soaks, real-time mode for `serve --loadgen`
  report.py     SOAK payload: p50/p95/p99 schedule latency and queue
                dwell from flight-recorder cycle spans, admission/shed
                accounting, starvation age, per-stage utilization

Exposure: `python -m karmada_tpu_torch.cli loadgen` lists the catalog
and rehearses a scenario (the SOAK payload), and `serve --loadgen
SCENARIO` drives a live plane in realtime.
"""

from karmada_tpu_torch.loadgen.driver import (  # noqa: F401 — public surface
    LoadDriver,
    RealClock,
    ServeSlice,
    ServiceModel,
    VirtualClock,
    load_state,
    warm_device_path,
)
from karmada_tpu_torch.loadgen.scenarios import SCENARIOS, get_scenario  # noqa: F401
