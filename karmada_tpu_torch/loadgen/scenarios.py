"""The loadgen scenario catalog (the JAX package's, copied whole).

A Scenario is a complete sustained-traffic experiment: an arrival shape
(as a multiple of the plane's measured solve capacity, so the same
scenario is meaningful on a laptop's serial backend and a TPU pod), a
cluster-event schedule (kills / revivals / capacity flaps at fractions
of the scenario duration), and the queue tuning it runs under
(batch_window, batch-formation deadline, admission bound).

Sizes are expressed relative to capacity rather than absolute seconds:

  * load_factor       mean arrival rate = load_factor x capacity, where
                      capacity = 1 / per_binding_s of the service model
                      (measured by bench --soak, fixed in tier-1 tests);
  * deadline_cycles   batch deadline = that many full-batch service
                      times (model.cost(batch_window));
  * admission_batches admission bound = that many batch_windows.

The compressed catalog entries are a few hundred bindings (tier-1
budget); *-heavy variants are the same shapes scaled up, marked slow.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, Tuple

from karmada_tpu_torch.loadgen import arrival


@dataclass(frozen=True)
class ClusterEventSpec:
    """One scheduled fleet event.  kinds:
    kill        delete `count` clusters and evict their placements (the
                failover storm: every affected binding reschedules)
    revive      recreate the most recently killed `count` clusters
    flap_down   scale `count` clusters' allocatable by `scale` (< 1)
    flap_up     restore flapped clusters to full capacity
    chaos       arm `spec` (the JAX package's chaos fault grammar) on the
                process-wide chaos plane — fault windows open here
    chaos_clear clear the chaos site named in `spec` (empty = all) —
                fault windows close here
    whatif      fire one facade capacity query (facade/)
                against the live plane: `spec` names the query
                (placement | cluster-loss | headroom, default
                placement), `count` carries the replica count; answers
                accumulate on the driver's whatif_results and MUST
                leave live placements bit-identical
    """

    at_frac: float  # fraction of the scenario duration
    kind: str       # kill|revive|flap_down|flap_up|chaos|chaos_clear|whatif
    count: int = 1
    scale: float = 0.5
    spec: str = ""  # chaos fault spec / site / whatif query name


@dataclass(frozen=True)
class Scenario:
    name: str
    description: str
    n_bindings: int
    load_factor: float                  # mean arrival rate, x capacity
    shape: str = "steady"               # steady | diurnal | burst
    diurnal_amplitude: float = 0.0      # fraction of base rate
    diurnal_periods: float = 1.0        # sine periods over the duration
    burst_factor: float = 0.0           # burst-window rate, x capacity
    burst_start_frac: float = 0.0
    burst_end_frac: float = 0.0
    n_clusters: int = 6
    priority_high_frac: float = 0.1     # fraction injected at priority 10
    batch_window: int = 64
    deadline_cycles: float = 2.0        # batch deadline, full-batch costs
    admission_batches: float = 4.0      # admission bound, batch_windows
    events: Tuple[ClusterEventSpec, ...] = field(default_factory=tuple)
    slow: bool = False                  # heavy variant (excluded tier-1)
    # workload shape: "duplicated" places every binding on all feasible
    # clusters; "divided" (Divided + Aggregated) packs binding_replicas
    # into the fewest most-available clusters — the shape rebalance
    # drains act on (a duplicated re-solve would go right back)
    binding_style: str = "duplicated"
    binding_replicas: int = 1
    # policy-path mode (ROADMAP item 2 leftover): inject workloads as
    # Deployment templates matched by ONE PropagationPolicy, so the soak
    # exercises the detector/policy fan-out (template -> policy match ->
    # binding render) instead of creating ResourceBindings directly
    policy_path: bool = False
    # rebalance plane: cycle interval in full-batch service times
    # (model.cost(batch_window)); 0 leaves the plane disarmed
    rebalance_interval_cycles: float = 0.0
    # shortlist tier (ops/shortlist): top-k candidate lanes per binding
    # for the hierarchical two-tier solve; 0 keeps every chunk dense.
    # Device-backend slices only (the host backends never build
    # SolverBatches); the slice arms it with min_cells=0 so compressed
    # scales exercise the exact production tier-selection path
    shortlist_k: int = 0
    # group-affine fleet: clusters carry a region in `n_regions` groups
    # and each binding's placement targets ONE group — the million-user
    # shape (per-tenant affinity) whose eligible sets fit k
    n_regions: int = 0

    @property
    def chaotic(self) -> bool:
        """True when the schedule contains chaos fault events — the
        driver arms the chaos plane and the safety auditor runs."""
        return any(e.kind in ("chaos", "chaos_clear") for e in self.events)

    # -- derived quantities (given the service model's capacity) ------------
    def mean_rate(self, capacity_rate: float) -> float:
        """Expected arrivals/second over the whole run."""
        base = self.load_factor * capacity_rate
        if self.shape == "burst" and self.burst_factor > 0:
            wfrac = max(0.0, self.burst_end_frac - self.burst_start_frac)
            return (base * (1.0 - wfrac)
                    + self.burst_factor * capacity_rate * wfrac)
        return base  # the sine averages out over whole periods

    def duration_s(self, capacity_rate: float) -> float:
        """Virtual duration such that ~n_bindings arrive in expectation."""
        return self.n_bindings / max(self.mean_rate(capacity_rate), 1e-9)

    def rate_fn(self, capacity_rate: float, t0: float,
                duration: float) -> Tuple[arrival.RateFn, float]:
        """(rate function over absolute time, dominating max rate)."""
        base = self.load_factor * capacity_rate
        if self.shape == "diurnal":
            period = duration / max(self.diurnal_periods, 1e-9)
            fn = arrival.diurnal_rate(base, self.diurnal_amplitude,
                                      period, t0=t0)
            return fn, base * (1.0 + abs(self.diurnal_amplitude))
        if self.shape == "burst" and self.burst_factor > 0:
            burst = self.burst_factor * capacity_rate
            fn = arrival.burst_rate(base, burst,
                                    t0 + self.burst_start_frac * duration,
                                    t0 + self.burst_end_frac * duration)
            return fn, max(base, burst)
        return arrival.constant_rate(base), base

    def deadline_s(self, model) -> float:
        return self.deadline_cycles * model.cost(self.batch_window)

    def rebalance_interval_s(self, model) -> float:
        """Rebalance cycle interval on the virtual clock (0 = disarmed)."""
        return self.rebalance_interval_cycles * model.cost(self.batch_window)

    def admission_limit(self) -> int:
        return max(self.batch_window,
                   int(math.ceil(self.admission_batches * self.batch_window)))


def _churn_events(flaps: int, count: int = 1,
                  scale: float = 0.4) -> Tuple[ClusterEventSpec, ...]:
    """Alternating capacity flaps spread across the run: down at odd
    slots, restored at the following even slot."""
    out = []
    for i in range(flaps):
        frac = (i + 1) / (flaps + 1)
        kind = "flap_down" if i % 2 == 0 else "flap_up"
        out.append(ClusterEventSpec(at_frac=frac, kind=kind, count=count,
                                    scale=scale))
    return tuple(out)


SCENARIOS: Dict[str, Scenario] = {s.name: s for s in (
    # no-overload steady state: the SLO reference point — sheds nothing,
    # p99 dwell under the deadline (asserted by the soak tests and the
    # bench acceptance run).  deadline_cycles 6 keeps the deadline well
    # above the ~2-cycle batch fill time at this load: cuts are full
    # batches except genuine stragglers, and a deadline-cut batch's
    # oldest dwell IS the deadline by construction, so the SLO only
    # holds when such cuts are rare — i.e. the deadline needs headroom.
    Scenario(
        name="steady",
        description="steady Poisson at 0.5x solve capacity, quiet fleet",
        n_bindings=320, load_factor=0.5, deadline_cycles=6.0,
    ),
    # diurnal sine: peaks briefly above capacity (1.08x), troughs near
    # idle — exercises deadline-triggered trickle batching at the trough
    # and queue growth + catch-up at the peak
    Scenario(
        name="diurnal",
        description="diurnal sine, mean 0.6x capacity, peak 1.08x",
        n_bindings=360, load_factor=0.6, deadline_cycles=6.0,
        shape="diurnal", diurnal_amplitude=0.8, diurnal_periods=1.0,
    ),
    # failover storm: a third in, arrivals burst to 2x capacity while two
    # clusters die (their placements evict and reschedule); the admission
    # gate must shed the excess and keep depth bounded.  The tight
    # deadline (0.5 cycles) makes the pre-storm phase trickle-batch so
    # plenty of placements exist to evict when the kill lands, and the
    # small admission bound (2 batch_windows) forces real shedding.
    Scenario(
        name="storm",
        description="failover storm: 2x-capacity arrival burst + 2 "
                    "cluster kills, revived later",
        n_bindings=600, load_factor=0.5,
        deadline_cycles=0.5, admission_batches=2.0,
        shape="burst", burst_factor=2.0,
        burst_start_frac=0.4, burst_end_frac=0.65,
        events=(
            ClusterEventSpec(at_frac=0.4, kind="kill", count=2),
            ClusterEventSpec(at_frac=0.8, kind="revive", count=2),
        ),
    ),
    # cluster churn: capacity flaps every ~14% of the run — every flap is
    # a Cluster event, i.e. a full unschedulable-requeue + store rescan,
    # the most expensive control-plane reaction per event
    Scenario(
        name="churn",
        description="capacity flaps on a rotating cluster under 0.6x "
                    "steady load",
        n_bindings=360, load_factor=0.6, deadline_cycles=6.0,
        events=_churn_events(flaps=6, count=1, scale=0.4),
    ),
    # the compressed chaos soak (the chaos plane's acceptance shape):
    # storm-grade arrivals + a cluster kill/revive, an estimator outage window
    # (the circuit must open, then half-open-recover after the clear), one
    # mid-cycle device fault of each flavor (a hang that degrades the backend
    # — which must re-arm — and a dispatch raise that the cycle containment
    # re-queues), and one resident-mirror corruption (the forced parity audit
    # must rebuild bit-exact).  Event order matters: the hang lands while the
    # estimator outage is still open (failures overlap), and the corruption
    # waits until the backend has had its recovery cooldown.  Run it with
    # ServeSlice(backend="device", resident=True, device_cycle_timeout_s=...,
    # device_recover_cycles=..) — bench.py --chaos and tests/test_chaos.py
    # both do.
    Scenario(
        name="chaos",
        description="failure storm: 1.5x burst + kill/revive + estimator "
                    "outage + device hang/raise + resident corruption",
        n_bindings=420, load_factor=0.5,
        deadline_cycles=1.0, admission_batches=3.0,
        shape="burst", burst_factor=1.5,
        burst_start_frac=0.3, burst_end_frac=0.55,
        events=(
            ClusterEventSpec(at_frac=0.2, kind="chaos",
                             spec="estimator.rpc:error"),
            ClusterEventSpec(at_frac=0.3, kind="kill", count=1),
            ClusterEventSpec(at_frac=0.35, kind="chaos",
                             spec="device.cycle:hang:3#1"),
            ClusterEventSpec(at_frac=0.5, kind="chaos_clear",
                             spec="estimator.rpc"),
            ClusterEventSpec(at_frac=0.6, kind="revive", count=1),
            ClusterEventSpec(at_frac=0.75, kind="chaos",
                             spec="resident.mirror:corrupt#1"),
            ClusterEventSpec(at_frac=0.85, kind="chaos",
                             spec="device.dispatch:raise#1"),
        ),
    ),
    # what-if isolation proof: steady traffic with facade capacity
    # queries fired mid-soak (one of each kind, twice over).  Every
    # query runs a DETACHED solve on a copy-on-write fork of live
    # state, so the acceptance check is brutal and simple: the final
    # placement map must be bit-identical to a control run with the
    # whatif events stripped (tests/test_facade.py proves it).
    Scenario(
        name="whatif",
        description="steady 0.5x load with facade what-if capacity "
                    "queries riding the soak; placements must not move",
        n_bindings=320, load_factor=0.5, deadline_cycles=6.0,
        binding_style="divided", binding_replicas=2,
        events=(
            ClusterEventSpec(at_frac=0.3, kind="whatif", count=50,
                             spec="placement"),
            ClusterEventSpec(at_frac=0.4, kind="whatif", count=8,
                             spec="headroom"),
            ClusterEventSpec(at_frac=0.5, kind="whatif", count=16,
                             spec="cluster-loss"),
            ClusterEventSpec(at_frac=0.7, kind="whatif", count=200,
                             spec="placement"),
            ClusterEventSpec(at_frac=0.8, kind="whatif", count=4,
                             spec="headroom"),
        ),
    ),
    # hotspot (the rebalance plane's acceptance shape): 4 of 6 clusters
    # start capacity-crushed, so the Divided+Aggregated workload packs
    # onto the 2 "hot" survivors (skewed arrivals).  Then capacity
    # churn: the cold 4 restore AND the hot 2 flap down — placements
    # that were fine are now overcommitted, the exact situation the
    # scheduler never revisits and the rebalance plane exists for.  The
    # plane must drain the hot clusters to within the overcommit
    # threshold (paced by the shared eviction budget), re-place victims
    # through the normal queue with origin=rebalance, and converge with
    # zero conservation violations.  Workloads flow through the
    # detector/policy path (one PropagationPolicy matches every injected
    # Deployment), and one chaos rebalance.plan:skip fault proves the
    # seam + auditor accountability.
    Scenario(
        name="hotspot",
        description="skewed arrivals pack 2 hot clusters, capacity churn "
                    "overcommits them; rebalance drains + re-places",
        n_bindings=160, load_factor=0.5, deadline_cycles=2.0,
        n_clusters=6,
        binding_style="divided", binding_replicas=3,
        policy_path=True,
        rebalance_interval_cycles=2.0,
        events=(
            ClusterEventSpec(at_frac=0.0, kind="flap_down", count=4,
                             scale=0.05),
            ClusterEventSpec(at_frac=0.55, kind="flap_up", count=4),
            ClusterEventSpec(at_frac=0.6, kind="flap_down", count=2,
                             scale=0.1),
            ClusterEventSpec(at_frac=0.75, kind="chaos",
                             spec="rebalance.plan:skip#1"),
        ),
    ),
    # million-binding shape at compressed scale: a group-affine fleet
    # (each binding's affinity targets one region, so eligible sets fit
    # the shortlist k) under the hierarchical two-tier solve — the
    # production tier-selection path end-to-end on the virtual clock.
    # Device-backend slices only (bench --megafleet and the shortlist
    # soak test drive it with backend="device").
    Scenario(
        name="megafleet",
        description="group-affine fleet under the two-tier shortlist "
                    "solve: per-region affinity bindings, steady Poisson",
        n_bindings=320, load_factor=0.5, deadline_cycles=6.0,
        n_clusters=48, n_regions=8, shortlist_k=8,
        binding_style="divided", binding_replicas=3,
        batch_window=64,
    ),
    Scenario(
        name="megafleet-heavy",
        description="group-affine two-tier solve at production-shaped "
                    "counts",
        n_bindings=20000, load_factor=0.6, deadline_cycles=4.0,
        n_clusters=512, n_regions=32, shortlist_k=32,
        binding_style="divided", binding_replicas=5,
        batch_window=512,
        slow=True,
    ),
    # heavy variants: same shapes, production-shaped counts; marked slow
    # (bench --soak and the opt-in slow tests run them)
    Scenario(
        name="storm-heavy",
        description="failover storm at 5000 bindings",
        n_bindings=5000, load_factor=0.5,
        deadline_cycles=0.5, admission_batches=2.0,
        shape="burst", burst_factor=2.0,
        burst_start_frac=0.4, burst_end_frac=0.65,
        n_clusters=16, batch_window=256,
        events=(
            ClusterEventSpec(at_frac=0.4, kind="kill", count=4),
            ClusterEventSpec(at_frac=0.8, kind="revive", count=4),
        ),
        slow=True,
    ),
    Scenario(
        name="diurnal-heavy",
        description="diurnal sine at 5000 bindings, two periods",
        n_bindings=5000, load_factor=0.6, deadline_cycles=6.0,
        shape="diurnal", diurnal_amplitude=0.8, diurnal_periods=2.0,
        n_clusters=16, batch_window=256,
        slow=True,
    ),
)}


def get_scenario(name: str) -> Scenario:
    try:
        return SCENARIOS[name]
    except KeyError:
        raise ValueError(
            f"unknown scenario {name!r}; available: "
            f"{', '.join(sorted(SCENARIOS))}") from None
