"""Kubernetes-style resource quantities with exact integer milli-unit math.

The reference's capacity arithmetic (pkg/estimator/client/general.go:294-334)
operates on `resource.Quantity`: `Value()` (ceiling to whole units) for most
resources and `MilliValue()` for CPU. To keep the TPU solver bit-compatible
we normalise every quantity to an exact integer count of *milli-units* at
parse time; all downstream tensors are integer typed.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

# Binary suffixes (Ki, Mi, ...) and decimal suffixes (k, M, ...) per the
# Kubernetes resource.Quantity grammar.
_BIN = {"Ki": 2**10, "Mi": 2**20, "Gi": 2**30, "Ti": 2**40, "Pi": 2**50, "Ei": 2**60}
_DEC = {"n": -3, "u": -2, "m": -1, "": 0, "k": 1, "M": 2, "G": 3, "T": 4, "P": 5, "E": 6}

_QTY_RE = re.compile(r"^([+-]?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*([A-Za-z]*)$")


@dataclass(frozen=True, order=True)
class Quantity:
    """An exact resource amount stored as integer milli-units."""

    milli: int

    # -- constructors ------------------------------------------------------
    @staticmethod
    def from_milli(m: int) -> "Quantity":
        return Quantity(int(m))

    @staticmethod
    def from_units(v: int) -> "Quantity":
        return Quantity(int(v) * 1000)

    @staticmethod
    def parse(s: "str | int | float | Quantity") -> "Quantity":
        return parse_quantity(s)

    # -- accessors (match k8s resource.Quantity semantics) -----------------
    def value(self) -> int:
        """Whole units, rounded up (k8s Quantity.Value())."""
        return -((-self.milli) // 1000)

    def milli_value(self) -> int:
        return self.milli

    # -- arithmetic --------------------------------------------------------
    def __add__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.milli + other.milli)

    def __sub__(self, other: "Quantity") -> "Quantity":
        return Quantity(self.milli - other.milli)

    def __neg__(self) -> "Quantity":
        return Quantity(-self.milli)

    def is_zero(self) -> bool:
        return self.milli == 0

    def __str__(self) -> str:
        if self.milli % 1000 == 0:
            return str(self.milli // 1000)
        return f"{self.milli}m"

    def to_json(self) -> str:
        return str(self)


def parse_quantity(s: "str | int | float | Quantity") -> Quantity:
    """Parse a Kubernetes quantity string ("100m", "2Gi", "1.5", 3) exactly."""
    if isinstance(s, Quantity):
        return s
    if isinstance(s, int):
        return Quantity.from_units(s)
    if isinstance(s, float):
        if s != s or s in (float("inf"), float("-inf")):
            raise ValueError(f"invalid quantity: {s!r}")
        # floats only appear from hand-written configs; route via repr for exactness
        s = repr(s)
    m = _QTY_RE.match(s.strip())
    if not m:
        raise ValueError(f"invalid quantity: {s!r}")
    num, suffix = m.group(1), m.group(2)
    # milli-units per unit of suffix, as an exact rational scale_num/scale_den
    if suffix in _BIN:
        scale_num, scale_den = 1000 * _BIN[suffix], 1
    elif suffix in _DEC:
        e = 3 * _DEC[suffix] + 3
        scale_num, scale_den = (10**e, 1) if e >= 0 else (1, 10**-e)
    else:
        raise ValueError(f"invalid quantity suffix: {s!r}")

    if "e" in num.lower():
        mantissa, _, exp = num.lower().partition("e")
        exp_i = int(exp)
    else:
        mantissa, exp_i = num, 0

    neg = mantissa.startswith("-")
    mantissa = mantissa.lstrip("+-")
    if "." in mantissa:
        int_part, frac = mantissa.split(".", 1)
    else:
        int_part, frac = mantissa, ""
    digits = (int_part + frac) or "0"
    # milli = digits * 10^(exp_i - len(frac)) * scale_num / scale_den, exact
    power = exp_i - len(frac)
    n = int(digits) * scale_num
    d = scale_den
    if power >= 0:
        n *= 10**power
    else:
        d *= 10**-power
    if n % d == 0:
        n //= d
    else:
        # inexact at milli granularity: k8s rounds away from zero (up for
        # positive quantities) to the smallest representable unit
        n = -((-n) // d)
    if neg:
        n = -n
    return Quantity(n)


# Canonical resource names (mirror corev1.ResourceName usage in the reference)
RESOURCE_CPU = "cpu"
RESOURCE_MEMORY = "memory"
RESOURCE_PODS = "pods"
RESOURCE_EPHEMERAL_STORAGE = "ephemeral-storage"


def resource_request_value(name: str, q: Quantity) -> int:
    """The integer the division math uses: MilliValue for cpu, Value otherwise.

    Mirrors pkg/estimator/client/general.go:296-325.
    """
    return q.milli_value() if name == RESOURCE_CPU else q.value()
