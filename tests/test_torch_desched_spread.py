"""A region spread left short by the descheduler, on both packages.

chip_smoke's phase 15c left one region-spread binding short of its
replicas in every run (`ns-45/app-237`: 50 replicas, 45 placed): replicas
re-placed after a squeeze filled a member it used, 5 of its own went
pending there, the descheduler shrank them, and the spread had no room
elsewhere.  This builds that shape at a CPU size on both packages'
ControlPlanes and holds the end states (every object of the plane and of
its members) equal, so the question "is this a placement the JAX package
would keep?" has its answer: it is.

The shape:
- `ns-45/app`: 50 replicas, Divided by available replicas, a region
  spread of exactly 3 groups over m0 (r0), m1 (r1), m2 (r2), which it
  fills but for 1, 4 and 1 pods.
- 64 movers (`default/mover-NN`, 4 replicas each, affinity m1 and one of
  8 home members), placed on their homes while m1 is full.
- m1 then shows 8 free pods and the homes are squeezed to 4 pods: the
  descheduler shrinks 56 movers (7 a home, the shared budget's window),
  and the one cycle that re-places them -- 64 rows, 8 waves of 8 --
  puts a wave of 8 movers (32 replicas) on m1 at once: each row of a
  wave sees the same free pods.  The member admits workloads in name
  order, so the movers (namespace `default`) take m1 and 24 of the
  spread's replicas go pending; the descheduler shrinks them and the
  spread, needing 3 regions, finds 2 free pods: it ends 26 of 50,
  Unschedulable -- on the JAX package's device backend and on the
  port's.
- On the serial backend (each row against the snapshot alone) both
  packages end with the spread whole: the same answer again.
"""

import pytest

import torch_loop as TL
from torch_fixtures import collect_jax_planes  # noqa: F401 — autouse
from torch_loop import deterministic_uids  # noqa: F401 — autouse

HOMES = [f"h{i}" for i in range(8)]


def policy(M, ns, name, target, clusters, spread=False):
    return M.PropagationPolicy(
        metadata=M.ObjectMeta(name=name, namespace=ns),
        spec=M.PropagationSpec(
            resource_selectors=[M.ResourceSelector(
                api_version="apps/v1", kind="Deployment", name=target)],
            placement=M.Placement(
                cluster_affinity=M.ClusterAffinity(
                    cluster_names=list(clusters)),
                spread_constraints=([M.SpreadConstraint(
                    spread_by_field="region", min_groups=3, max_groups=3)]
                    if spread else []),
                replica_scheduling=M.ReplicaSchedulingStrategy(
                    replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                    replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
                    weight_preference=M.ClusterPreferences(
                        dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS)))))


def deployment(ns, name, replicas):
    return {"apiVersion": "apps/v1", "kind": "Deployment",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"replicas": replicas, "template": {"spec": {
                "containers": [{"name": "c", "image": "c:1"}]}}}}


def placements(cp):
    return {f"{rb.namespace}/{rb.name}": (
        sorted((t.name, t.replicas) for t in rb.spec.clusters),
        [(c.status, c.reason) for c in rb.status.conditions
         if c.type == "Scheduled"])
        for rb in cp.store.list("ResourceBinding")}


def squeeze_spread(M, backend, log):
    """The shape of the module docstring on `backend` (the JAX package's
    own device backend on its CPU; the port's with device="cpu")."""
    clock = TL.Clock()
    if M is TL.MJ:
        cp = M.ControlPlane(backend=backend, clock=clock,
                            enable_descheduler=True,
                            controllers=TL.JAX_CONTROLLERS)
    else:
        cp = M.ControlPlane(backend=backend, clock=clock,
                            enable_descheduler=True,
                            device="cpu" if backend == "device" else None)
    for name, region, pods in (("m0", "r0", 12), ("m1", "r1", 33),
                               ("m2", "r2", 11)):
        cp.add_member(name, cpu_milli=64_000, pods=pods, region=region)
    for h in HOMES:
        cp.add_member(h, cpu_milli=64_000, pods=40, region="r-home")
    cp.tick()
    cp.apply_policy(policy(M, "ns-45", "pp-app", "app", ["m0", "m1", "m2"],
                           spread=True))
    cp.apply(deployment("ns-45", "app", 50))
    cp.tick()
    log.append(placements(cp))
    cp.member("m1").pods_allocatable = 29  # full: the movers go home
    cp.tick()
    for i in range(64):
        cp.apply_policy(policy(M, "default", f"pp-mover-{i:02d}",
                               f"mover-{i:02d}", ["m1", HOMES[i % 8]]))
        cp.apply(deployment("default", f"mover-{i:02d}", 4))
    cp.tick()
    log.append(placements(cp))
    cp.member("m1").pods_allocatable = 37
    for h in HOMES:
        cp.member(h).pods_allocatable = 4
    for _ in range(6):
        clock.advance(30)
        cp.tick()
        log.append(placements(cp))
    return cp


@pytest.mark.parametrize("backend", ["device", "serial"])
def test_squeezed_region_spread_end_state_equal(backend):
    (cj, cp), (lj, lp) = TL.run_both(squeeze_spread, backend)
    assert lp == lj
    app, cond = lp[-1]["ns-45/app-deployment"]
    assert lp[0]["ns-45/app-deployment"][0] == [("m0", 11), ("m1", 29),
                                                ("m2", 10)]
    if backend == "device":
        # the shape of phase 15c: short, Unschedulable, the filled member
        # holding what the movers left it
        assert app == [("m0", 11), ("m1", 5), ("m2", 10)]
        assert cond == [("False", "Unschedulable")]
        movers_on_m1 = sum(
            r for key, (targets, _c) in lp[-1].items()
            if key.startswith("default/") for m, r in targets if m == "m1")
        assert movers_on_m1 == 32
    else:
        assert sum(r for _m, r in app) == 50
        assert cond == [("True", "BindingScheduled")]
    assert cp.descheduler.shrinks > 0
