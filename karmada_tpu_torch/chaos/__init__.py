"""Chaos plane: deterministic fault injection + post-soak safety audit
(counterpart of the JAX package's ``chaos/``).

Public surface:

  armed() / fire(site, **ctx) / raise_if(site, **ctx)
      the seam API (one list read when disarmed — guard call sites with
      ``if chaos.armed():``)
  configure(spec, seed) / disarm() / active()
      process-wide arming (`serve --chaos SPEC`, `Scheduler(chaos=)`,
      loadgen scenario fault events)
  parse_spec(spec) / SITES / SITE_*
      the fault grammar and the injection-site catalog
  state_payload()
      the chaos state payload (/debug/chaos, utils/httpserve)
  capture_baseline() / audit_soak(driver, baseline)
      the conservation/accountability/recovery auditor (chaos/audit.py)

The site catalog and the spec grammar are in chaos/plane.py, the
invariants the auditor proves in chaos/audit.py.
"""

from karmada_tpu_torch.chaos.audit import (  # noqa: F401 — public surface
    audit_soak,
    capture_baseline,
)
from karmada_tpu_torch.chaos.plane import (  # noqa: F401 — public surface
    SITE_DEVICE_CYCLE,
    SITE_DEVICE_D2H,
    SITE_DEVICE_DISPATCH,
    SITE_ESTIMATOR_RPC,
    SITE_LEASE_HEARTBEAT,
    SITE_REBALANCE_PLAN,
    SITE_RESIDENT_MIRROR,
    SITE_STORE_WATCH,
    SITE_WORKER_RECONCILE,
    SITES,
    ChaosFault,
    ChaosPlane,
    Fault,
    active,
    armed,
    configure,
    disarm,
    fire,
    parse_spec,
    raise_if,
    state_payload,
)
