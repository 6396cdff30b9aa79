"""What a compressed soak comparison holds still, in one place: chip_smoke.py
(the card's soaks against their CPU replays) and tests/torch_soak.py (the
port's soaks against the JAX package's) both hold still through it.

Each context manager takes the scheduler/service modules to patch (the
port's, or the port's and the JAX package's) and restores them on exit.

  still_cycle_clock  the modules' `time` reads a perf_counter that stands
                     still.  A Scheduler floors a binding's e2e sample at
                     its cycle's wall seconds (`max(e2e, cycle_elapsed)`),
                     which would tie a compressed soak's latency samples to
                     how busy the host is; with the clock still every
                     cycle's wall reads 0 and the samples are the virtual
                     clock's alone.  The spans, the driver and the virtual
                     clocks keep their own clocks.
  held_cut_timers    the modules' `threading.Timer` never fires.  The
                     deferred-cut timer re-drives the worker when the
                     oldest binding reaches the batch deadline, in real
                     seconds: in a compressed soak whose wall outlasts that
                     delay it adds a no-op cycle (a `reconcile.scheduler`
                     span, a ring sample) at a point set by the host's load,
                     so two runs would differ by it.  LoadDriver's pumps
                     and ticks cut every batch without it.

Imports nothing but the standard library.
"""

import contextlib
import threading
import time


class _StillPerfCounter:
    """The time module with perf_counter standing still."""

    def __getattr__(self, name):
        return getattr(time, name)

    @staticmethod
    def perf_counter() -> float:
        return 0.0


class _HeldTimer:
    """A threading.Timer that never fires."""

    daemon = True

    def __init__(self, *args, **kwargs):
        pass

    def start(self):
        pass

    def cancel(self):
        pass


class _NoTimerThreading:
    """The threading module with Timer held back."""

    Timer = _HeldTimer

    def __getattr__(self, name):
        return getattr(threading, name)


@contextlib.contextmanager
def _replaced(services, attr, value):
    prev = [getattr(m, attr) for m in services]
    for m in services:
        setattr(m, attr, value)
    try:
        yield
    finally:
        for m, v in zip(services, prev):
            setattr(m, attr, v)


def still_cycle_clock(*services):
    """`services`' perf_counter stands still inside the block."""
    return _replaced(services, "time", _StillPerfCounter())


def held_cut_timers(*services):
    """`services`' Schedulers arm no deferred-cut timer inside the
    block."""
    return _replaced(services, "threading", _NoTimerThreading())
