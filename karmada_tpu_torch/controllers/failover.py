"""Failure detection and elastic recovery: the reference's failover loop.

Counterpart of the JAX package's ``controllers/failover.py`` (SURVEY.md
section 3.5):
* ClusterTaintController -- pkg/controllers/cluster/cluster_controller.go:156
  taintClusterByCondition: Ready=False adds the not-ready NoExecute taint;
  recovery removes it (grace periods collapsed to immediate for the
  deterministic runtime).
* NoExecuteTaintManager -- pkg/controllers/cluster/taint_manager.go:101:
  bindings targeting a NoExecute-tainted cluster are evicted once the
  matching toleration's tolerationSeconds expire (untolerated taints evict
  immediately; a taint cleared before the deadline cancels the pending
  eviction).  With an eviction queue attached (controllers/cluster.py
  RateLimitedEvictionQueue), due evictions go through `evict_one` behind
  the queue's pacing.
* GracefulEvictionController -- pkg/controllers/gracefuleviction/
  evictiontask.go:38-116: an eviction task drains only once the binding's
  *other* clusters report healthy replacement (or the grace period lapses);
  SuppressDeletion pins the task for manual intervention.
* ApplicationFailoverController -- pkg/controllers/applicationfailover/
  rb_application_failover_controller.go:61: workloads unhealthy past
  spec.failover.tolerationSeconds are evicted and rescheduled; with the
  StatefulFailoverInjection gate (utils/features.GATES) the evicted
  cluster's collected status rides the task as preserved labels.

Eviction itself mirrors binding_types.go GracefulEvict: the cluster leaves
.spec.clusters and a GracefulEvictionTask is appended, so the scheduler
re-places the lost replicas while the stale Work survives until the task
drains (the binding controller keeps evicting clusters' Works alive).

The lifecycle ledger (obs/events.py) gets the JAX controllers' events:
taint added / removed, eviction pending, workload evicted, eviction task
drained and eviction deferred (the last through the controller's
`recorder`, when it has one).  The taint manager also counts its
evictions (`NoExecuteTaintManager.evicted`), and application failover
its deferred ones (`ApplicationFailoverController.deferred`: an eviction
held back because its state-preservation payload cannot be built yet,
also printed to stderr once per binding and cluster).  The reads that
only look take the stored objects without copying (ObjectStore.visit /
peek), and the taint manager finds a tainted cluster's bindings in an
index of the stored bindings by target, built in store order on the
first reconcile after a binding write (the JAX manager lists every
binding for every tainted cluster).
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional

from karmada_tpu_torch.models.cluster import (
    COND_CLUSTER_READY,
    Cluster,
    EFFECT_NO_EXECUTE,
    Taint,
)
from karmada_tpu_torch.models.meta import is_condition_true
from karmada_tpu_torch.models.work import GracefulEvictionTask, ResourceBinding
from karmada_tpu_torch.store.store import Event, NotFoundError, ObjectStore
from karmada_tpu_torch.store.worker import AsyncWorker, Runtime
from karmada_tpu_torch.utils import events as ev

TAINT_NOT_READY = "cluster.karmada.io/not-ready"
DEFAULT_GRACE_PERIOD_S = 600
DEFAULT_TOLERATION_S = 300

PURGE_IMMEDIATELY = "Immediately"
PURGE_GRACIOUSLY = "Graciously"
PURGE_NEVER = "Never"


def parse_json_path(status, path: str) -> str:
    """Evaluate a k8s-jsonpath-style expression against a collected status
    dict (helper/failover.go:47-62 parseJSONValue with AllowMissingKeys
    false).  Supports the subset state-preservation rules use in practice:
    `{.a.b[0].c}` / `.a.b` / `a.b` — dotted fields with integer indexing.
    Raises KeyError/IndexError on a missing segment."""
    expr = path.strip()
    if expr.startswith("{") and expr.endswith("}"):
        expr = expr[1:-1].strip()
    expr = expr.lstrip(".")
    cur = status
    if expr:
        for part in expr.split("."):
            fieldname, _, idxpart = part.partition("[")
            indices = ([s.rstrip("]") for s in idxpart.split("[")]
                       if idxpart else [])
            if fieldname:
                if not isinstance(cur, dict) or fieldname not in cur:
                    raise KeyError(
                        f"jsonpath {path!r}: missing field {fieldname!r}")
                cur = cur[fieldname]
            for idx in indices:
                if not isinstance(cur, (list, tuple)):
                    raise KeyError(f"jsonpath {path!r}: {fieldname!r} "
                                   "is not an array")
                i = int(idx)
                if i < 0 or i >= len(cur):
                    # k8s jsonpath rejects negative indices; silently
                    # resolving them would build payloads the reference
                    # never would
                    raise KeyError(f"jsonpath {path!r}: index {i} out of "
                                   f"range")
                cur = cur[i]
    if isinstance(cur, bool):
        return "true" if cur else "false"
    if isinstance(cur, str):
        return cur
    if isinstance(cur, (int, float)):
        return str(cur)
    import json

    return json.dumps(cur, sort_keys=True)


def build_preserved_label_state(rules, status) -> Dict[str, str]:
    """helper/failover.go:30-45 BuildPreservedLabelState: every rule must
    resolve (a missing path aborts the whole build)."""
    out: Dict[str, str] = {}
    for rule in rules:
        out[rule.alias_label_name] = parse_json_path(status, rule.json_path)
    return out


def evict_cluster(
    rb: ResourceBinding,
    cluster: str,
    reason: str,
    producer: str,
    grace_period_seconds: Optional[int] = None,
    suppress_deletion: Optional[bool] = None,
    now: Optional[float] = None,
    purge_mode: str = "",
    preserved_label_state: Optional[Dict[str, str]] = None,
    clusters_before_failover: Optional[list] = None,
) -> bool:
    """binding_types.go GracefulEvict semantics; returns True if changed."""
    target = next((t for t in rb.spec.clusters if t.name == cluster), None)
    if target is None:
        return False
    rb.spec.clusters = [t for t in rb.spec.clusters if t.name != cluster]
    if any(t.from_cluster == cluster for t in rb.spec.graceful_eviction_tasks):
        return True
    rb.spec.graceful_eviction_tasks.append(GracefulEvictionTask(
        from_cluster=cluster,
        replicas=target.replicas,
        reason=reason,
        producer=producer,
        grace_period_seconds=grace_period_seconds,
        suppress_deletion=suppress_deletion,
        creation_timestamp=now if now is not None else time.time(),
        purge_mode=purge_mode,
        preserved_label_state=dict(preserved_label_state or {}),
        clusters_before_failover=list(clusters_before_failover or []),
    ))
    return True


class ClusterTaintController:
    """Ready=False <-> not-ready NoExecute taint."""

    def __init__(self, store: ObjectStore, runtime: Runtime, clock=None) -> None:
        self.store = store
        self.clock = clock if clock is not None else time.time
        self.worker = runtime.register(AsyncWorker("cluster-taint", self._reconcile))
        store.bus.subscribe(self._on_event, kind=Cluster.KIND)

    def _on_event(self, event: Event) -> None:
        self.worker.enqueue(event.obj.name)

    def _reconcile(self, name) -> None:
        cluster = self.store.peek(Cluster.KIND, "", name)
        if cluster is None:
            return
        ready = is_condition_true(cluster.status.conditions, COND_CLUSTER_READY)
        has = any(t.key == TAINT_NOT_READY for t in cluster.spec.taints)
        if ready and has:
            def rm(c: Cluster) -> None:
                c.spec.taints = [t for t in c.spec.taints if t.key != TAINT_NOT_READY]
            self.store.mutate(Cluster.KIND, "", name, rm)
            ev.emit(ev.ObjectRef(kind=Cluster.KIND, name=name),
                    ev.TYPE_NORMAL, ev.REASON_UNTAINT_CLUSTER_SUCCEED,
                    "cluster recovered Ready: not-ready NoExecute taint "
                    "removed", origin="cluster-taint")
        elif not ready and not has:
            def add(c: Cluster) -> None:
                c.spec.taints.append(Taint(
                    key=TAINT_NOT_READY, effect=EFFECT_NO_EXECUTE,
                    time_added=self.clock(),
                ))
            self.store.mutate(Cluster.KIND, "", name, add)
            ev.emit(ev.ObjectRef(kind=Cluster.KIND, name=name),
                    ev.TYPE_WARNING, ev.REASON_TAINT_CLUSTER_SUCCEED,
                    "cluster Ready=False: not-ready NoExecute taint added",
                    origin="cluster-taint")


class NoExecuteTaintManager:
    """Evict bindings from NoExecute-tainted clusters (taint_manager.go:101),
    honoring tolerationSeconds: a tolerated taint delays the eviction until
    the toleration expires, and a taint removed before that deadline
    cancels it (the reference's needEviction/tolerationTime semantics —
    a brief flap never evicts a workload with the defaulted 300s
    not-ready toleration).

    With an eviction_queue attached, due evictions flow through the
    rate-limited queue (cluster/eviction_worker.go) instead of executing
    inline — a mass cluster failure then drains gradually."""

    def __init__(self, store: ObjectStore, runtime: Runtime,
                 eviction_queue=None, clock=None) -> None:
        self.store = store
        self.eviction_queue = eviction_queue
        self.clock = clock if clock is not None else time.time
        # (ns, name, cluster) -> deadline: tolerated taints awaiting expiry;
        # touched by the worker AND the periodic flush (separate threads in
        # serve mode), so every access holds the lock
        self._pending: Dict[tuple, float] = {}
        self._pending_lock = threading.Lock()
        #: evictions made (a binding leaving a tainted cluster)
        self.evicted = 0
        # cluster -> the stored bindings targeting it, in store order;
        # built on the first reconcile after any binding write, so a run of
        # taint events (a region failing) scans the bindings once.  A
        # binding write bumps the generation; a build is kept only if no
        # write came while it ran (serve mode writes on other threads)
        self._targets = None
        self._targets_gen = 0
        self._targets_lock = threading.Lock()
        self.worker = runtime.register(AsyncWorker("taint-manager", self._reconcile))
        runtime.register_periodic(self._flush_deadlines, name="taint-manager")
        store.bus.subscribe(self._on_event, kind=Cluster.KIND)
        store.bus.subscribe(self._on_binding_event, kind=ResourceBinding.KIND)

    def _on_binding_event(self, event: Event) -> None:
        with self._targets_lock:
            self._targets_gen += 1
            self._targets = None

    def _bindings_on(self, cluster_name: str) -> list:
        with self._targets_lock:
            targets, gen = self._targets, self._targets_gen
        if targets is None:
            targets = {}
            for rb in self.store.visit(ResourceBinding.KIND):
                for t in rb.spec.clusters:
                    on = targets.setdefault(t.name, [])
                    if not on or on[-1] is not rb:
                        on.append(rb)
            with self._targets_lock:
                if self._targets_gen == gen:
                    self._targets = targets
        return targets.get(cluster_name, [])

    def _on_event(self, event: Event) -> None:
        taints = [t for t in event.obj.spec.taints if t.effect == EFFECT_NO_EXECUTE]
        had = event.old is not None and any(
            t.effect == EFFECT_NO_EXECUTE for t in event.old.spec.taints)
        # taint cleared is as important as taint added: pending deadlines
        # for the recovered cluster must be CANCELLED, not left to burn
        # rate-limited queue tokens at their stale expiry
        if taints or had:
            self.worker.enqueue(event.obj.name)

    def _eviction_due(self, rb: ResourceBinding, taints, now: float):
        """None = never (all taints tolerated forever); otherwise the
        timestamp at which eviction is due (<= now means due immediately).
        k8s/karmada semantics: due at the MINIMUM expiry across taints,
        where an untolerated taint is due immediately and a matching
        toleration without seconds tolerates that taint forever."""
        placement = rb.spec.placement
        tolerations = placement.cluster_tolerations if placement else []
        due = None
        for taint in taints:
            matching = [t for t in tolerations if t.tolerates(taint)]
            if not matching:
                return now
            secs = [t.toleration_seconds for t in matching]
            if any(s is None for s in secs):
                continue  # tolerated forever
            start = taint.time_added if taint.time_added is not None else now
            d = start + min(secs)
            due = d if due is None else min(due, d)
        return due

    def _cancel_cluster(self, cluster_name: str) -> None:
        with self._pending_lock:
            for key in [k for k in self._pending if k[2] == cluster_name]:
                self._pending.pop(key, None)

    def _reconcile(self, cluster_name) -> None:
        cluster = self.store.peek(Cluster.KIND, "", cluster_name)
        if cluster is None:
            self._cancel_cluster(cluster_name)
            return
        taints = [t for t in cluster.spec.taints if t.effect == EFFECT_NO_EXECUTE]
        if not taints:
            self._cancel_cluster(cluster_name)
            return
        now = self.clock()
        for rb in self._bindings_on(cluster_name):
            due = self._eviction_due(rb, taints, now)
            key = (rb.namespace, rb.name, cluster_name)
            if due is None:
                with self._pending_lock:
                    self._pending.pop(key, None)
            elif due > now:
                # armed, waiting out tolerationSeconds (a taint cleared
                # before expiry cancels it)
                with self._pending_lock:
                    newly = key not in self._pending
                    self._pending[key] = due
                if newly:
                    ev.emit_key((rb.namespace, rb.name), ev.TYPE_WARNING,
                                ev.REASON_EVICTION_PENDING,
                                f"eviction from {cluster_name} pending "
                                "toleration expiry (NoExecute taint "
                                "tolerated for a bounded window)",
                                origin="taint-manager")
            else:
                with self._pending_lock:
                    self._pending.pop(key, None)
                if self.eviction_queue is not None:
                    self.eviction_queue.add(key)
                else:
                    self.evict_one(key)

    def _flush_deadlines(self) -> None:
        """Expired toleration deadlines become evictions; evict_one
        re-verifies, so a taint cleared in the meantime cancels cleanly."""
        now = self.clock()
        with self._pending_lock:
            due_now = [k for k, d in self._pending.items() if d <= now]
            for key in due_now:
                self._pending.pop(key, None)
        for key in due_now:
            if self.eviction_queue is not None:
                self.eviction_queue.add(key)
            else:
                self.evict_one(key)

    def evict_one(self, key) -> None:
        """One paced eviction; re-verifies the decision at processing time
        (the binding or the taints may have changed while queued)."""
        ns, name, cluster_name = key
        cluster = self.store.peek(Cluster.KIND, "", cluster_name)
        if cluster is None:
            return
        taints = [t for t in cluster.spec.taints if t.effect == EFFECT_NO_EXECUTE]
        if not taints:
            return
        rb = self.store.peek(ResourceBinding.KIND, ns, name)
        if rb is None or not any(t.name == cluster_name for t in rb.spec.clusters):
            return
        due = self._eviction_due(rb, taints, self.clock())
        if due is None or due > self.clock():
            return  # toleration re-verified: cancelled or not yet expired

        changed = []

        def do_evict(obj: ResourceBinding) -> None:
            changed.clear()  # mutate may retry the closure
            if evict_cluster(
                obj, cluster_name,
                reason="TaintUntolerated", producer="taint-manager",
                now=self.clock(),
            ):
                changed.append(True)

        try:
            self.store.mutate(ResourceBinding.KIND, ns, name, do_evict)
        except NotFoundError:
            return
        if changed:
            self.evicted += 1
            ev.emit_key((ns, name), ev.TYPE_WARNING,
                        ev.REASON_EVICT_WORKLOAD_FROM_CLUSTER,
                        f"gracefully evicted from {cluster_name}: "
                        "untolerated NoExecute taint (toleration expired)",
                        origin="taint-manager")


class GracefulEvictionController:
    """Drain eviction tasks once replacement is healthy or grace expires."""

    def __init__(self, store: ObjectStore, runtime: Runtime,
                 grace_period_s: float = DEFAULT_GRACE_PERIOD_S,
                 clock=None) -> None:
        self.store = store
        self.clock = clock if clock is not None else time.time
        self.grace_period_s = grace_period_s
        self.worker = runtime.register(AsyncWorker("graceful-eviction", self._reconcile))
        store.bus.subscribe(self._on_event, kind=ResourceBinding.KIND)
        runtime.register_periodic(self.resync, name="graceful-eviction")

    def resync(self) -> None:
        for rb in self.store.visit(ResourceBinding.KIND):
            if rb.spec.graceful_eviction_tasks:
                self.worker.enqueue((rb.namespace, rb.name))

    def _on_event(self, event: Event) -> None:
        if event.obj.spec.graceful_eviction_tasks:
            self.worker.enqueue((event.obj.namespace, event.obj.name))

    def _replacement_ready(self, rb: ResourceBinding) -> bool:
        """assessEvictionTasks health gate: every scheduled cluster applied
        and healthy (evictiontask.go:70-96)."""
        if not rb.spec.clusters:
            return False
        by_cluster = {i.cluster_name: i for i in rb.status.aggregated_status}
        for target in rb.spec.clusters:
            item = by_cluster.get(target.name)
            if item is None or not item.applied or item.health != "Healthy":
                return False
        return True

    def _reconcile(self, key) -> None:
        ns, name = key
        rb = self.store.try_get(ResourceBinding.KIND, ns, name)
        if rb is None or not rb.spec.graceful_eviction_tasks:
            return
        now = self.clock()
        ready = self._replacement_ready(rb)
        keep = []
        for task in rb.spec.graceful_eviction_tasks:
            if task.suppress_deletion:
                keep.append(task)
                continue
            grace = (
                task.grace_period_seconds
                if task.grace_period_seconds is not None
                else self.grace_period_s
            )
            expired = now - task.creation_timestamp >= grace
            if ready or expired:
                continue  # drop the task; binding controller prunes the Work
            keep.append(task)
        if len(keep) != len(rb.spec.graceful_eviction_tasks):
            drained = {t.from_cluster for t in rb.spec.graceful_eviction_tasks} - {
                t.from_cluster for t in keep
            }

            def update(obj: ResourceBinding) -> None:
                obj.spec.graceful_eviction_tasks = [
                    t for t in obj.spec.graceful_eviction_tasks
                    if t.from_cluster not in drained
                ]
            self.store.mutate(ResourceBinding.KIND, ns, name, update)
            why = ("replacement healthy on every scheduled cluster"
                   if ready else "grace period expired")
            for cluster in sorted(drained):
                ev.emit_key((ns, name), ev.TYPE_NORMAL,
                            ev.REASON_EVICTION_TASK_DRAINED,
                            f"eviction task for {cluster} drained ({why})",
                            origin="graceful-eviction")


class ApplicationFailoverController:
    """Unhealthy-too-long workloads get evicted and rescheduled.

    Periodic-only (the reference drives this with time-based requeues,
    rb_application_failover_controller.go:89-160); eviction additionally
    requires the cluster to have been seen unhealthy in a PREVIOUS periodic
    round, so a workload that is merely still starting up (applied but not
    yet ready) never flaps even with tolerationSeconds=0.
    """

    def __init__(self, store: ObjectStore, runtime: Runtime,
                 clock=None, recorder=None) -> None:
        self.store = store
        self.clock = clock if clock is not None else time.time
        self.recorder = recorder
        #: evictions deferred (a retry each round)
        self.deferred = 0
        self._unhealthy_since: Dict[tuple, float] = {}
        self._round = 0
        self._seen_round: Dict[tuple, int] = {}
        self._deferral_logged: set = set()
        runtime.register_periodic(self.run_once, name="application-failover")

    def run_once(self) -> None:
        self._round += 1
        for rb in self.store.visit(ResourceBinding.KIND):
            if rb.spec.failover is not None:
                self._reconcile(rb)

    def _task_state(self, rb: ResourceBinding, cluster: str):
        """StatefulFailoverInjection payload for evicting `cluster`
        (applicationfailover/common.go:139-170 buildTaskOptions): preserved
        labels extracted from the failed cluster's collected status, plus
        the pre-failover cluster set.  Returns (preserved, ok); ok=False
        means the status needed by the rules has not been collected yet —
        the eviction must wait (the reference surfaces an error and
        retries)."""
        from karmada_tpu_torch.utils.features import GATES

        rules = getattr(rb.spec.failover, "state_preservation", None) or []
        if not rules or not GATES.enabled("StatefulFailoverInjection"):
            return {}, True
        item = next((i for i in rb.status.aggregated_status
                     if i.cluster_name == cluster), None)
        if item is None or item.status is None:
            self._defer_event(rb, cluster,
                              "application status not collected yet")
            return {}, False
        try:
            preserved = build_preserved_label_state(rules, item.status)
        except (KeyError, ValueError, IndexError) as e:
            self._defer_event(rb, cluster,
                              f"state preservation rule failed: {e}")
            return {}, False
        return preserved, True

    def _defer_event(self, rb: ResourceBinding, cluster: str,
                     why: str) -> None:
        """A deferred eviction must never be invisible: the reference
        surfaces buildTaskOptions errors on every retry (common.go:147);
        here each deferral is counted and printed to stderr once per
        (binding, cluster)."""
        msg = (f"application failover of cluster {cluster!r} deferred: "
               f"{why}")
        self.deferred += 1
        if self.recorder is not None:
            self.recorder.event(rb, ev.TYPE_WARNING,
                                ev.REASON_EVICTION_DEFERRED, msg,
                                origin="app-failover")
        key = (rb.namespace, rb.name, cluster)
        if key not in self._deferral_logged:
            self._deferral_logged.add(key)
            import sys

            print(f"[app-failover] {rb.namespace}/{rb.name}: {msg}",
                  file=sys.stderr, flush=True)

    def _reconcile(self, rb: ResourceBinding) -> None:
        ns, name = rb.namespace, rb.name
        toleration = getattr(rb.spec.failover, "toleration_seconds",
                             DEFAULT_TOLERATION_S)
        purge = getattr(rb.spec.failover, "purge_mode", PURGE_GRACIOUSLY)
        now = self.clock()
        to_evict = []
        unhealthy_now = set()
        for item in rb.status.aggregated_status:
            k = (ns, name, item.cluster_name)
            if item.health == "Unhealthy":
                unhealthy_now.add(item.cluster_name)
                since = self._unhealthy_since.setdefault(k, now)
                first_round = self._seen_round.setdefault(k, self._round)
                if now - since >= toleration and first_round < self._round:
                    to_evict.append(item.cluster_name)
            else:
                self._unhealthy_since.pop(k, None)
                self._seen_round.pop(k, None)
        # forget stale entries for clusters no longer targeted
        for k in list(self._unhealthy_since):
            if k[:2] == (ns, name) and k[2] not in unhealthy_now:
                self._unhealthy_since.pop(k, None)
                self._seen_round.pop(k, None)
        if not to_evict:
            return

        evicted: list = []

        def update(obj: ResourceBinding) -> None:
            changed = False
            evicted.clear()  # mutate may retry the closure
            # snapshot BEFORE any eviction mutates the list: every task of
            # this pass must record the same pre-failover cluster set, or
            # later tasks omit earlier-evicted clusters and the injection
            # guard lets preserved state land on a pre-failover cluster
            before_fo = [t.name for t in obj.spec.clusters]
            for cluster in to_evict:
                preserved, ok = self._task_state(obj, cluster)
                if not ok:
                    # state-preservation rules configured but the failed
                    # cluster's status is not collected yet: keep the
                    # workload until the payload can be built (common.go:
                    # 147-151 returns an error and retries)
                    continue
                evicted.append(cluster)
                if purge == PURGE_IMMEDIATELY:
                    if preserved:
                        # an Immediately task carries the injection payload
                        # (binding/common.go:171-207 injects ONLY from
                        # Immediately/Directly tasks); the Work itself is
                        # not kept alive for Immediately purges
                        changed = evict_cluster(
                            obj, cluster, reason="ApplicationUnhealthy",
                            producer="app-failover", now=now,
                            purge_mode=PURGE_IMMEDIATELY,
                            preserved_label_state=preserved,
                            clusters_before_failover=before_fo,
                        ) or changed
                    else:
                        before = len(obj.spec.clusters)
                        obj.spec.clusters = [
                            t for t in obj.spec.clusters if t.name != cluster
                        ]
                        changed = changed or len(obj.spec.clusters) != before
                elif purge == PURGE_NEVER:
                    changed = evict_cluster(
                        obj, cluster, reason="ApplicationUnhealthy",
                        producer="app-failover", suppress_deletion=True,
                        now=now, purge_mode=PURGE_NEVER,
                        preserved_label_state=preserved,
                        clusters_before_failover=before_fo,
                    ) or changed
                else:
                    changed = evict_cluster(
                        obj, cluster, reason="ApplicationUnhealthy",
                        producer="app-failover",
                        grace_period_seconds=getattr(
                            rb.spec.failover, "grace_period_seconds", None),
                        now=now, purge_mode=PURGE_GRACIOUSLY,
                        preserved_label_state=preserved,
                        clusters_before_failover=before_fo,
                    ) or changed
            # the spec change alone re-triggers scheduling; steady mode then
            # tops the lost replicas back up without disrupting survivors

        self.store.mutate(ResourceBinding.KIND, ns, name, update)
        for cluster in evicted:
            ev.emit_key((ns, name), ev.TYPE_WARNING,
                        ev.REASON_EVICT_WORKLOAD_FROM_CLUSTER,
                        f"application unhealthy past toleration on "
                        f"{cluster}: evicted (purge={purge})",
                        origin="app-failover")
        # deferred evictions (payload not collectable yet) keep their
        # tracking state so they fire as soon as the status arrives
        for cluster in evicted:
            self._unhealthy_since.pop((ns, name, cluster), None)
            self._seen_round.pop((ns, name, cluster), None)
            # a fresh failover episode on this cluster gets its own
            # deferral notice (and the set stays bounded)
            self._deferral_logged.discard((ns, name, cluster))
