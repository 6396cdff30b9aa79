"""Reconcile worker queues and the controller runtime.

Counterpart of the JAX package's ``store/worker.py``.  Every controller
runs off a de-duplicating work queue (AsyncWorker) in one of two modes:

  * pump mode  -- deterministic: `Runtime.pump()` drains every queue to
    quiescence on the calling thread; `tick()` runs the periodic hooks
    first (the test harness and chip_smoke drive this);
  * serve mode -- threaded: one thread per worker with full-jitter
    exponential backoff when idle, and one for the periodic hooks.

A reconcile that raises is requeued with a retry budget, as the
reference's rate-limited workqueue does.  The raise is contained, so it
is counted: `AsyncWorker.reconcile_errors` per worker,
`Runtime.reconcile_errors()` over all of them and
karmada_worker_reconcile_errors_total (a kernel failure inside a
reconcile shows there, never only as a requeue).  The chaos seam
`worker.reconcile` raises in front of the reconcile, so an injected fault
takes the same path.

With the flight recorder armed (obs.TRACER), every reconcile runs inside
a "reconcile.<worker>" span carrying its key and queue dwell: the root
the scheduler's cycle span and every controller's spans parent into.

`Runtime(controllers=)` is the reference's `--controllers=` list
(controllermanager.go enablement filtering), as in the JAX package: a
disabled controller still constructs (its worker registers but never
pumps, its periodic hooks are dropped).  The names are the JAX package's
GOVERNED_CONTROLLERS; a name whose controller the port has not taken yet
(PORTED_CONTROLLERS lacks it) raises ValueError ("not ported") when it is
asked for by name, and "*" runs what the port has.  A spec rehydrated from
the controller-manager ConfigMap (`Runtime(controllers=, drop_unported=True)`)
may have been written for the JAX package: there such names are dropped
(`Runtime.unported_dropped`) and the rest of the spec holds.
"""

from __future__ import annotations

import contextlib
import random
import threading
import time
import traceback
import zlib
from collections import OrderedDict
from typing import Callable, Dict, Hashable, List, Optional

from karmada_tpu_torch import chaos, obs
from karmada_tpu_torch.utils.metrics import REGISTRY, exponential_buckets

RECONCILE_ERRORS = REGISTRY.counter(
    "karmada_worker_reconcile_errors_total",
    "Reconcile (or periodic-hook) invocations that raised, by worker — "
    "the retry/backoff machinery's input signal",
    ("worker",),
)

WORKER_BACKOFF = REGISTRY.histogram(
    "karmada_worker_backoff_seconds",
    "Idle-poll backoff sleeps taken by serve-mode worker threads "
    "(full-jitter exponential; soaks read this as retry pressure)",
    ("worker",),
    buckets=exponential_buckets(0.001, 2, 12),
)


class AsyncWorker:
    """Dedup-ing work queue: enqueueing an in-queue key is a no-op; a key
    re-enqueued while being processed is processed again afterwards."""

    def __init__(self, name: str,
                 reconcile: Callable[[Hashable], Optional[bool]],
                 max_retries: int = 10) -> None:
        self.name = name
        self.reconcile = reconcile
        self.max_retries = max_retries
        self._queue: "OrderedDict[Hashable, None]" = OrderedDict()
        self._retries: Dict[Hashable, int] = {}
        self._processing: set = set()
        self._dirty: set = set()
        # first-enqueue timestamps for the reconcile span's queue dwell;
        # only filled while tracing is on
        self._enqueued_at: Dict[Hashable, float] = {}
        self._cv = threading.Condition()
        self._stopped = False
        #: reconciles that raised (contained and requeued)
        self.reconcile_errors = 0

    def enqueue(self, key: Hashable) -> None:
        with self._cv:
            if key in self._processing:
                self._dirty.add(key)
                return
            if obs.TRACER.enabled and key not in self._queue:
                self._enqueued_at[key] = time.perf_counter()
            self._queue[key] = None
            self._cv.notify()

    def _pop(self, block: bool):
        """(key, first-enqueue time): the time is None when tracing was
        off at enqueue (or the key was requeued internally)."""
        with self._cv:
            while not self._queue:
                if not block or self._stopped:
                    return None, None
                self._cv.wait(timeout=0.2)
            key, _ = self._queue.popitem(last=False)
            self._processing.add(key)
            return key, self._enqueued_at.pop(key, None)

    def _done(self, key: Hashable, requeue: bool) -> None:
        with self._cv:
            self._processing.discard(key)
            redo = key in self._dirty
            self._dirty.discard(key)
            if requeue:
                retries = self._retries.get(key, 0) + 1
                if retries <= self.max_retries:
                    self._retries[key] = retries
                    self._queue[key] = None
                    return
            # done, or dropped at max retries (workqueue Forget semantics):
            # forget the budget and honor any concurrent enqueue
            self._retries.pop(key, None)
            if redo:
                self._queue[key] = None

    def process_one(self, block: bool = False) -> bool:
        """Run one reconcile; returns False when the queue was empty.  A
        reconcile that raises (or returns False) is requeued with a retry
        budget."""
        key, enq_t = self._pop(block)
        if key is None:
            return False
        requeue = False
        tracer = obs.TRACER
        try:
            if chaos.armed():
                # chaos seam: an injected reconcile fault takes the SAME
                # requeue / backoff path a real controller raise would
                chaos.raise_if(chaos.SITE_WORKER_RECONCILE,
                               worker=self.name, key=key)
            if tracer.enabled:
                span = tracer.start_span(
                    obs.SPAN_RECONCILE_PREFIX + self.name,
                    key=repr(key)[:120])
                if enq_t is not None:
                    span.set_attr(queue_dwell_s=round(
                        time.perf_counter() - enq_t, 6))
                with span:
                    result = self.reconcile(key)
            else:
                result = self.reconcile(key)
            requeue = result is False
        except Exception:  # noqa: BLE001 — controller loops never die
            self.reconcile_errors += 1
            RECONCILE_ERRORS.inc(worker=self.name)
            traceback.print_exc()
            requeue = True
        self._done(key, requeue)
        return True

    def pending(self) -> int:
        with self._cv:
            return len(self._queue) + len(self._processing)

    def stop(self) -> None:
        with self._cv:
            self._stopped = True
            self._cv.notify_all()


# the names --controllers= governs: the controller-manager's controller
# set.  Workers OUTSIDE this set (the scheduler, the operator, the search
# cache, agent CSR approval) are separate binaries in the reference and
# are never subject to the flag.
GOVERNED_CONTROLLERS = frozenset({
    "detector", "deps-distributor", "binding", "execution", "work-status",
    "binding-status", "cluster-status", "cluster-lifecycle", "cluster-lease",
    "taint-manager", "cluster-taint", "taint-policy", "graceful-eviction",
    "application-failover", "remedy", "namespace-sync", "unified-auth",
    "frq", "federatedhpa", "cronfederatedhpa", "hpa-marker",
    "replicas-syncer", "mcs", "mci", "endpointslice-collect",
    "endpointslice-dispatch", "rebalancer", "cert-rotation", "descheduler",
})

#: the governed controllers the port has (e2e.ControlPlane wires each)
PORTED_CONTROLLERS = frozenset({
    "detector", "deps-distributor", "binding", "execution", "work-status",
    "binding-status", "cluster-status", "cluster-lifecycle", "cluster-lease",
    "taint-manager", "cluster-taint", "taint-policy", "graceful-eviction",
    "application-failover", "remedy", "namespace-sync", "frq",
    "rebalancer", "cert-rotation", "descheduler",
})

# internal worker names that ride a governed controller's switch
_CONTROLLER_ALIAS = {"detector-policy": "detector"}


def parse_controllers(spec: str, drop_unported: bool = False) -> tuple:
    """`--controllers=` list semantics (controllermanager.go enablement
    filtering): "*" enables everything not explicitly disabled; "-name"
    disables; without "*", only listed names run.  Unknown names are
    rejected up front (the reference controller-manager refuses to start
    on a typoed controller name), and so is a governed name the port has
    not taken yet, enabled by name -- unless `drop_unported`, which
    drops such names (unported_names) and keeps the star, the enables
    and the disables."""
    names = [s.strip() for s in (spec or "*").split(",") if s.strip()]
    star = "*" in names
    disabled = {n[1:] for n in names if n.startswith("-")}
    enabled = {n for n in names if n != "*" and not n.startswith("-")}
    unknown = (disabled | enabled) - GOVERNED_CONTROLLERS
    if unknown:
        raise ValueError(
            f"unknown controller name(s) {sorted(unknown)}; "
            f"valid names: {sorted(GOVERNED_CONTROLLERS)}"
        )
    missing = enabled - PORTED_CONTROLLERS
    if missing and not drop_unported:
        raise ValueError(
            f"controller(s) {sorted(missing)} not ported; the port runs "
            f"{sorted(PORTED_CONTROLLERS)}")
    return star, enabled - missing, disabled


def unported_names(spec: str) -> frozenset:
    """The governed names `spec` enables that the port has not taken."""
    names = [s.strip() for s in (spec or "*").split(",") if s.strip()]
    return frozenset(n for n in names if n in GOVERNED_CONTROLLERS
                     and n not in PORTED_CONTROLLERS)


class Runtime:
    """Holds every controller's worker; runs them deterministically (pump)
    or in background threads (serve).

    `controllers` filters which reconcile workers and periodic hooks run,
    by name (parse_controllers; `drop_unported` as there, the dropped
    names on `unported_dropped`)."""

    def __init__(self, periodic_interval_s: float = 0.5,
                 controllers: str = "*", drop_unported: bool = False) -> None:
        self.workers: List[AsyncWorker] = []
        self._threads: List[threading.Thread] = []
        self._periodic: List[Callable[[], None]] = []
        self._periodic_interval_s = periodic_interval_s
        self._stop_event = threading.Event()
        #: periodic hooks that raised in serve mode (contained)
        self.periodic_errors = 0
        self._ctrl_star, self._ctrl_on, self._ctrl_off = parse_controllers(
            controllers, drop_unported)
        self.unported_dropped = (unported_names(controllers) if drop_unported
                                 else frozenset())
        self._disabled_workers: set = set()
        self._ungoverned_depth = 0

    def controller_enabled(self, name: Optional[str]) -> bool:
        if self._ungoverned_depth > 0:
            return True  # inside an ungoverned() block (agent machinery)
        name = _CONTROLLER_ALIAS.get(name, name)
        if name is None or name not in GOVERNED_CONTROLLERS:
            return True  # infrastructure (scheduler, CSR approval, ...)
        if name in self._ctrl_off:
            return False
        return self._ctrl_star or name in self._ctrl_on

    @contextlib.contextmanager
    def ungoverned(self):
        """Context manager: registrations inside bypass the --controllers
        filter.  Pull-mode agents reuse the controller CLASSES (and thus
        their worker names) but are the reference's separate agent binary
        with its own flag -- the control plane's list must not kill them."""
        self._ungoverned_depth += 1
        try:
            yield
        finally:
            self._ungoverned_depth -= 1

    def register(self, worker: AsyncWorker) -> AsyncWorker:
        self.workers.append(worker)
        if not self.controller_enabled(worker.name):
            self._disabled_workers.add(worker)
        return worker

    def unregister(self, worker: AsyncWorker) -> None:
        """Tear a worker down (e.g. a pull agent leaving): stopped and
        removed so long-lived planes don't accumulate dead queues."""
        worker.stop()
        try:
            self.workers.remove(worker)
        except ValueError:
            pass
        self._disabled_workers.discard(worker)

    def register_periodic(self, fn: Callable[[], None],
                          name: Optional[str] = None) -> None:
        """A resync-style hook invoked once per tick (pump mode) or per
        periodic interval (serve mode); `name` subjects it to the
        `controllers` enablement filter."""
        if not self.controller_enabled(name):
            return
        self._periodic.append(fn)

    def unregister_periodic(self, fn: Callable[[], None]) -> None:
        try:
            self._periodic.remove(fn)
        except ValueError:
            pass

    def reconcile_errors(self) -> Dict[str, int]:
        """Contained raises by worker name ("periodic" for serve-mode
        hooks)."""
        out: Dict[str, int] = {}
        for w in self.workers:
            out[w.name] = out.get(w.name, 0) + w.reconcile_errors
        out["periodic"] = self.periodic_errors
        return out

    # -- deterministic mode ------------------------------------------------
    def pump(self, max_rounds: int = 200) -> int:
        """Drain all queues until quiescent.  Returns reconciles executed."""
        total = 0
        for _ in range(max_rounds):
            progressed = False
            for w in self.workers:
                if w in self._disabled_workers:
                    continue
                while w.process_one(block=False):
                    progressed = True
                    total += 1
            if not progressed:
                return total
        raise RuntimeError("runtime did not quiesce (reconcile livelock?)")

    def tick(self) -> int:
        """One periodic round followed by a pump."""
        for fn in self._periodic:
            fn()
        return self.pump()

    # -- threaded mode -----------------------------------------------------
    def serve(self) -> None:
        for w in self.workers:
            if w in self._disabled_workers:
                continue
            t = threading.Thread(target=self._run_worker, args=(w,),
                                 daemon=True, name=f"worker-{w.name}")
            t.start()
            self._threads.append(t)
        if self._periodic:
            t = threading.Thread(target=self._run_periodic, daemon=True,
                                 name="periodic")
            t.start()
            self._threads.append(t)

    def _run_periodic(self) -> None:
        while not self._stop_event.wait(self._periodic_interval_s):
            for fn in self._periodic:
                try:
                    fn()
                except Exception:  # noqa: BLE001 — periodic hooks never die
                    self.periodic_errors += 1
                    RECONCILE_ERRORS.inc(worker="periodic")
                    traceback.print_exc()

    def _run_worker(self, w: AsyncWorker) -> None:
        # full-jitter exponential backoff, the stream seeded per worker
        # name so runs replay
        rng = random.Random(zlib.crc32(w.name.encode("utf-8")))
        base, cap = 0.005, 0.5
        attempt = 0
        while not w._stopped:  # noqa: SLF001
            if w.process_one(block=True):
                attempt = 0
            else:
                delay = rng.uniform(0.0, min(cap, base * (2 ** attempt)))
                WORKER_BACKOFF.observe(delay, worker=w.name)
                time.sleep(delay)
                attempt = min(attempt + 1, 10)

    def stop(self) -> None:
        """Stop every worker and the periodic thread, and wait for them."""
        self._stop_event.set()
        for w in self.workers:
            w.stop()
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []
