"""Helpers of the loop parity suites (tests/test_torch_failover.py,
tests/test_torch_api.py): the two packages' planes side by side, their
normalized snapshots, and uids from a counter on both sides."""

import dataclasses
import importlib
import itertools

import pytest

import torch_scenarios as S

#: fields cleared by name wherever they appear: identity, store times,
#: and the times the JAX package reads from the wall clock whatever a
#: plane's clock is (its collector's lease renewals, the scheduler's
#: last-scheduled stamp, the rebalancer's trigger and finish)
CLEARED = frozenset({
    "uid", "resource_version", "resourceVersion", "creation_timestamp",
    "creationTimestamp", "deletion_timestamp", "last_transition_time",
    "last_scheduled_time", "renew_time", "reschedule_triggered_at",
    "finish_time",
})


def pkg(name):
    M = S.models_of(name)
    for mod in ("models.config", "models.extras", "models.autoscaling",
                "models.certs", "models.codec", "models.conversion"):
        M.__dict__.update({k: v for k, v in vars(
            importlib.import_module(f"{name}.{mod}")).items()
            if not k.startswith("_")})
    M.name = name
    M.config = importlib.import_module(f"{name}.models.config")
    M.ControlPlane = importlib.import_module(f"{name}.e2e").ControlPlane
    M.AdmissionDenied = importlib.import_module(
        f"{name}.webhook.admission").AdmissionDenied
    for mod in ("binding", "cluster", "failover", "lease", "certificates",
                "extras", "detector"):
        setattr(M, mod, importlib.import_module(f"{name}.controllers.{mod}"))
    M.builtin = importlib.import_module(f"{name}.webhook.builtin")
    M.ObjectStore = importlib.import_module(f"{name}.store.store").ObjectStore
    M.worker = importlib.import_module(f"{name}.store.worker")
    M.Runtime = M.worker.Runtime
    M.GATES = importlib.import_module(f"{name}.utils.features").GATES
    M.Unstructured = importlib.import_module(
        f"{name}.models.unstructured").Unstructured
    return M


MJ = pkg("karmada_tpu")
MP = pkg("karmada_tpu_torch")
JAX_CONTROLLERS = ",".join(sorted(MP.worker.PORTED_CONTROLLERS))


@pytest.fixture(autouse=True)
def deterministic_uids(monkeypatch):
    """Both stores hand out uids from one sequence each, in creation
    order: a template's uid breaks ties in the scheduler, so random uids
    would make the two planes' placements differ by chance."""
    for name in ("karmada_tpu", "karmada_tpu_torch"):
        seq = itertools.count(1)
        monkeypatch.setattr(importlib.import_module(f"{name}.store.store"),
                            "new_uid", lambda seq=seq: f"uid-{next(seq):06d}")


class Clock:
    """A plane's clock that only the scenario moves."""

    def __init__(self, t: float = 1000.0) -> None:
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def plane(M, backend, clock=None, **kw):
    """The JAX ControlPlane on exactly the ported controllers ("device"
    runs its serial backend), or the port's (device="cpu" for
    "device")."""
    if clock is not None:
        kw["clock"] = clock
    if M is MJ:
        kw.setdefault("controllers", JAX_CONTROLLERS)
        return M.ControlPlane(
            backend="serial" if backend == "device" else backend, **kw)
    return M.ControlPlane(backend=backend,
                          device="cpu" if backend == "device" else None,
                          **kw)


def norm(v, cleared=CLEARED):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {"@": type(v).__name__,
                **{f.name: (None if f.name in cleared
                            else norm(getattr(v, f.name), cleared))
                   for f in dataclasses.fields(v)}}
    if isinstance(v, dict):
        return {k: (None if k in cleared else norm(x, cleared))
                for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(x, cleared) for x in v]
    return v


def snapshot(target, cleared=CLEARED) -> dict:
    """Every object of a plane's store (or of a bare ObjectStore) and of
    its members, normalized."""
    store = getattr(target, "store", target)
    out = {(o.KIND, o.metadata.namespace, o.metadata.name): norm(o, cleared)
           for o in store.items()}
    for name, member in getattr(target, "members", {}).items():
        for o in member.store.items():
            out[("member", name, o.KIND, o.metadata.namespace,
                 o.metadata.name)] = norm(o, cleared)
    return out


def assert_same(a: dict, b: dict) -> None:
    if a == b:
        return
    only = sorted(set(a) ^ set(b), key=repr)
    diff = sorted((k for k in set(a) & set(b) if a[k] != b[k]), key=repr)
    raise AssertionError(f"snapshots differ: only on one side {only[:6]}, "
                         f"differing {diff[:6]}; first: "
                         f"{a.get(diff[0]) if diff else None!r} vs "
                         f"{b.get(diff[0]) if diff else None!r}")


def port_clean(cp) -> None:
    """No contained fault on the port's plane."""
    assert cp.scheduler.faults() == {}
    assert not any(cp.runtime.reconcile_errors().values()), \
        cp.runtime.reconcile_errors()
    assert cp.eviction_queue.failures == 0


def run_both(scenario, backend, cleared=CLEARED):
    """The scenario on both packages: equal logs, equal snapshots, and no
    contained fault on the port's side.  Returns the planes and logs."""
    logs = ([], [])
    cps = [scenario(M, backend, log) for M, log in zip((MJ, MP), logs)]
    assert logs[0] == logs[1]
    assert_same(snapshot(cps[0], cleared), snapshot(cps[1], cleared))
    if hasattr(cps[1], "scheduler"):
        port_clean(cps[1])
        if backend == "device":
            assert cps[1].scheduler.device.type == "cpu"
            assert {c["backend"] for c in cps[1].scheduler.cycle_log} \
                <= {"device"}
    return cps, logs
