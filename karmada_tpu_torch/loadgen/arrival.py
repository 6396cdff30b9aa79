"""Deterministic-seed arrival processes for the load generator (the
JAX package's ``loadgen/arrival.py``).

Open-loop traffic: arrival times are drawn up front from a seeded RNG,
so a scenario replays bit-identically — the soak tests assert exact
admission accounting, which only holds when the traffic itself is
reproducible.  All processes are expressed as a non-homogeneous Poisson
process over a rate function `rate(t)` (arrivals/second on whatever
clock the driver injects) and realized by Lewis-Shedler thinning: draw
candidate gaps at `max_rate`, keep each candidate with probability
`rate(t) / max_rate`.
"""

from __future__ import annotations

import math
import random
from typing import Callable, List

RateFn = Callable[[float], float]


def constant_rate(rate: float) -> RateFn:
    """Steady traffic: the same expected arrivals/second forever."""
    return lambda t: rate


def diurnal_rate(base: float, amplitude: float, period_s: float,
                 t0: float = 0.0) -> RateFn:
    """Diurnal sine: rate(t) = base * (1 + amplitude * sin(...)), floored
    at 0.  `amplitude` is a fraction of base (0.8 swings between 0.2x
    and 1.8x base); the mean over whole periods stays `base`."""

    def fn(t: float) -> float:
        phase = 2.0 * math.pi * ((t - t0) / period_s)
        return max(0.0, base * (1.0 + amplitude * math.sin(phase)))

    return fn


def burst_rate(base: float, burst: float, t_start: float,
               t_end: float) -> RateFn:
    """Failover-storm shape: steady `base` with a [t_start, t_end)
    window at `burst` (absolute rate, not additive)."""

    def fn(t: float) -> float:
        return burst if t_start <= t < t_end else base

    return fn


def poisson_times(rate_fn: RateFn, max_rate: float, t0: float, t1: float,
                  rng: random.Random) -> List[float]:
    """Arrival times of a non-homogeneous Poisson process on [t0, t1)
    via thinning.  `max_rate` must dominate rate_fn over the interval
    (candidates are drawn at max_rate and kept at rate/max_rate); a
    rate_fn exceeding it silently truncates the process, so callers
    compute max_rate from the same parameters as rate_fn."""
    if max_rate <= 0.0 or t1 <= t0:
        return []
    out: List[float] = []
    t = t0
    while True:
        # exponential gap at the dominating rate
        t += -math.log(1.0 - rng.random()) / max_rate
        if t >= t1:
            return out
        if rng.random() * max_rate < rate_fn(t):
            out.append(t)
