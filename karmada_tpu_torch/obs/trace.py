"""Span/trace core of the flight recorder (counterpart of the JAX
package's ``obs/trace.py``).

One Trace is the tree of Spans hanging off a single root span — a
scheduler cycle, a controller reconcile, a pipeline run.  Spans
carry monotonic start/end times, free-form attributes, and a parent id;
the tree is finalized and handed to the recorder exactly once, when the
root span ends.  Parentage is propagated through a contextvar so nested
code auto-parents without plumbing span objects through every signature,
and `Tracer.attach` hands a context across an explicit thread boundary
(the scheduler's guarded device-cycle thread, estimator fan-out pools).

Disabled-path contract (the hot loops depend on it): `Tracer.start_span`
returns the ONE process-wide `NOOP_SPAN` instance — no allocation, no
clock read — so call sites may either guard on `tracer.enabled` or just
use the returned span; both are zero-cost when tracing is off.

Degradation-guard interplay: a cycle abandoned mid-pipeline leaves its
stage spans open on the zombie thread.  When the trace root ends (on the
live worker thread), every still-open span is force-closed with
`unfinished=true` and the complete trace — marked `cancelled=true` by
the guard's attribute — is recorded: the evidence the guard used to
discard along with the cycle.  A zombie that unblocks minutes later and
touches its spans again hits a finalized trace and is ignored.
"""

from __future__ import annotations

import contextvars
import itertools
import threading
import time
from typing import Dict, List, Optional

_CURRENT: contextvars.ContextVar = contextvars.ContextVar(
    "karmada_tpu_torch_obs_current_span", default=None)

_next_id = itertools.count(1).__next__  # GIL-atomic


class NoopSpan:
    """The disabled path: one process-wide instance, every operation a
    no-op.  Usable as a context manager and falsy so call sites can write
    `if sp:` around attribute math they'd rather skip entirely."""

    __slots__ = ()
    trace = None

    def set_attr(self, **kw):
        return self

    def end(self, **kw):
        return None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False


NOOP_SPAN = NoopSpan()

# sentinel: "parent from the ambient context" (None means "force a root")
FROM_CONTEXT = object()


class Trace:
    """Accumulator for one root span's tree.  Thread-safe: spans may end
    on any thread; finalization (submission to the recorder) happens
    exactly once, under the trace lock, when the root span ends."""

    __slots__ = ("trace_id", "root_name", "start_unix", "_t0", "_recorder",
                 "_records", "_open", "_lock", "_done")

    def __init__(self, trace_id: str, recorder, t0: float,
                 root_name: str) -> None:
        self.trace_id = trace_id
        self.root_name = root_name
        self.start_unix = time.time()
        self._t0 = t0
        self._recorder = recorder
        self._records: List[dict] = []
        self._open: Dict[int, "Span"] = {}
        self._lock = threading.Lock()
        self._done = False

    def _register(self, span: "Span") -> None:
        with self._lock:
            if not self._done:
                self._open[span.span_id] = span

    def _finish(self, span: "Span", t_end: float, attrs: dict) -> None:
        """Close `span` exactly once.  A double end, or an end arriving
        after the trace finalized (abandoned-cycle zombie), is a no-op."""
        with self._lock:
            if self._done or span.span_id not in self._open:
                return
            del self._open[span.span_id]
            if attrs:
                span.attrs.update(attrs)
            span.t1 = t_end
            self._records.append(span._record(self._t0))
            if span.parent_id is None:
                self._finalize_locked(t_end)

    def _finalize_locked(self, t_end: float) -> None:
        # root ended: force-close every still-open span (a cancelled cycle
        # yields a COMPLETE trace — its dangling stages are the evidence)
        for sp in self._open.values():
            sp.t1 = t_end
            sp.attrs.setdefault("unfinished", True)
            self._records.append(sp._record(self._t0))
        self._open.clear()
        self._done = True
        spans = sorted(self._records, key=lambda r: (r["start_s"],
                                                     r["span_id"]))
        self._recorder.record({
            "trace_id": self.trace_id,
            "root": self.root_name,
            "start_unix": round(self.start_unix, 3),
            "duration_s": round(t_end - self._t0, 9),
            "cancelled": any(r["attrs"].get("cancelled") for r in spans),
            "spans": spans,
        })


class Span:
    __slots__ = ("name", "trace", "span_id", "parent_id", "t0", "t1",
                 "attrs", "_token")

    def __init__(self, name: str, trace: Trace, parent_id: Optional[int],
                 attrs: Optional[dict]) -> None:
        self.name = name
        self.trace = trace
        self.span_id = _next_id()
        self.parent_id = parent_id
        self.t0 = time.perf_counter()
        self.t1: Optional[float] = None
        self.attrs = dict(attrs) if attrs else {}
        self._token = None
        trace._register(self)

    def set_attr(self, **kw):
        self.attrs.update(kw)
        return self

    def end(self, **kw) -> None:
        self.trace._finish(self, time.perf_counter(), kw)

    def _record(self, t0: float) -> dict:
        return {"name": self.name, "span_id": self.span_id,
                "parent_id": self.parent_id,
                "start_s": round(self.t0 - t0, 9),
                "end_s": round(self.t1 - t0, 9),
                "attrs": self.attrs}

    # context-manager use: entering makes the span the ambient parent for
    # nested spans on this thread/task; exiting restores and ends it
    def __enter__(self) -> "Span":
        self._token = _CURRENT.set(self)
        return self

    def __exit__(self, exc_type, exc, tb):
        _CURRENT.reset(self._token)
        self._token = None
        if exc is not None:
            self.attrs.setdefault("error", repr(exc))
        self.end()
        return False


class _Attach:
    """Adopt a span from another thread as this thread's ambient parent
    (without ending it on exit) — the thread-handoff helper."""

    __slots__ = ("_span", "_token")

    def __init__(self, span: Span) -> None:
        self._span = span
        self._token = None

    def __enter__(self) -> Span:
        self._token = _CURRENT.set(self._span)
        return self._span

    def __exit__(self, *exc):
        _CURRENT.reset(self._token)
        return False


class Tracer:
    """The process-wide tracing switch + span factory.  Disabled (the
    default) it returns NOOP_SPAN everywhere; `configure()` arms it with
    a bounded TraceRecorder."""

    def __init__(self) -> None:
        self.recorder = None

    @property
    def enabled(self) -> bool:
        return self.recorder is not None

    def configure(self, capacity: int = 256, slow_keep: int = 8,
                  recorder=None):
        from karmada_tpu_torch.obs.recorder import TraceRecorder

        self.recorder = (recorder if recorder is not None
                         else TraceRecorder(capacity=capacity,
                                            slow_keep=slow_keep))
        return self.recorder

    def disable(self) -> None:
        self.recorder = None

    def current(self) -> Optional[Span]:
        sp = _CURRENT.get()
        return sp if isinstance(sp, Span) else None

    def start_span(self, name: str, parent=FROM_CONTEXT, **attrs):
        """A new span: child of `parent` (default: the ambient context
        span), else the root of a fresh trace.  Returns NOOP_SPAN when
        tracing is disabled — zero allocation on the hot path."""
        rec = self.recorder
        if rec is None:
            return NOOP_SPAN
        if parent is FROM_CONTEXT:
            parent = self.current()
        if isinstance(parent, Span):
            if parent.trace._done:
                # the parent's trace already finalized — this caller is a
                # zombie (e.g. an abandoned device cycle unblocking late);
                # it must NOT start polluting the ring with fresh roots
                return NOOP_SPAN
            return Span(name, parent.trace, parent.span_id, attrs)
        trace = Trace(f"t{_next_id():06x}", rec, time.perf_counter(), name)
        return Span(name, trace, None, attrs)

    # alias emphasizing with-statement use: `with tracer.span("x"): ...`
    span = start_span

    def attach(self, parent):
        """Context manager adopting `parent` (captured on another thread
        via `tracer.current()`) as this thread's ambient span."""
        if not isinstance(parent, Span):
            return NOOP_SPAN
        return _Attach(parent)
