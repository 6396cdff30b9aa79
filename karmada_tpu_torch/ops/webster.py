"""Webster (Sainte-Laguë) proportional seat allocation — exact golden path.

Port of reference pkg/util/helper/webstermethod.go:112 (AllocateWebsterSeats)
and pkg/util/helper/binding.go:70-183 (Dispenser + UID tiebreaker):

  * one seat at a time to the party with the highest priority
    votes/(2*seats+1);
  * ties: fewer seats wins, then lexicographically smaller (or larger, when
    fnv32a(uid) is odd) name wins;
  * parties only present in the initial assignment keep their seats with
    zero votes.

Priority arithmetic: the Go reference compares float64 quotients
(webstermethod.go:131).  This framework instead defines the priority as the
QUANTIZED INTEGER  (votes << PRIORITY_QBITS) // (2*seats + 1)  — exact,
platform-independent integer math with 2^-28 relative resolution.  The TPU
kernel (ops/solver.py) computes the identical quantity in int64, so serial
and device paths agree bit-for-bit with no float in either.  Behavior
diverges from the Go float64 path only when two priorities collide within
one quantum (then the seats/name tiebreak decides instead of the 53-bit
mantissa) — strictly tighter determinism than the reference's.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

# Quantization of the Webster priority votes/(2*seats+1): both the serial
# heap below and the TPU kernel (ops/solver.webster_divide) compare
# (votes << PRIORITY_QBITS) // (2*seats + 1) as integers.  28 bits keeps
# votes << 28 within int64 for votes < 2^34 (capacity values are clamped to
# MaxInt32 upstream).
PRIORITY_QBITS = 28


def priority_quantized(votes: int, seats: int) -> int:
    """The framework's Webster priority: integer-quantized votes/(2s+1)."""
    return (max(int(votes), 0) << PRIORITY_QBITS) // (2 * int(seats) + 1)


def fnv32a(data: str) -> int:
    """FNV-1a 32-bit (hash/fnv New32a), used for the UID tiebreak direction."""
    h = 0x811C9DC5
    for b in data.encode("utf-8"):
        h ^= b
        h = (h * 0x01000193) & 0xFFFFFFFF
    return h


def tiebreak_descending_by_uid(uid: str) -> bool:
    """binding.go:117-144 — odd fnv32a(uid) flips name order to descending."""
    if not uid:
        return False
    return bool(fnv32a(uid) & 1)


@dataclass
class Party:
    name: str
    votes: int
    seats: int


class _NameKey:
    """Orders names ascending or descending under heapq's min-ordering."""

    __slots__ = ("name", "desc")

    def __init__(self, name: str, desc: bool) -> None:
        self.name = name
        self.desc = desc

    def __lt__(self, other: "_NameKey") -> bool:
        return self.name > other.name if self.desc else self.name < other.name

    def __eq__(self, other: object) -> bool:
        return isinstance(other, _NameKey) and other.name == self.name


def allocate_webster_seats(
    new_seats: int,
    party_votes: Dict[str, int],
    initial_assignments: Optional[Dict[str, int]] = None,
    name_descending: bool = False,
) -> List[Party]:
    """Allocate `new_seats` additional seats; returns parties sorted by name.

    Matches AllocateWebsterSeats (webstermethod.go:112-161) with the
    Dispenser's UID tiebreaker (seats asc, then name asc/desc). The default
    tiebreaker in the reference reduces to name-ascending, so
    `name_descending=False` also covers the nil-tiebreaker case.
    """
    parties: Dict[str, Party] = {}
    for n, s in (initial_assignments or {}).items():
        parties[n] = Party(name=n, votes=0, seats=int(s))
    for n, v in party_votes.items():
        if n in parties:
            parties[n].votes = int(v)
        else:
            parties[n] = Party(name=n, votes=int(v), seats=0)
    if not parties:
        return []

    # heap entries: (-quantized_priority, seats, name_key, name)
    def entry(p: Party):
        prio = priority_quantized(p.votes, p.seats)
        return (-prio, p.seats, _NameKey(p.name, name_descending), p.name)

    heap = [entry(p) for p in parties.values()]
    heapq.heapify(heap)
    for _ in range(int(new_seats)):
        _, _, _, name = heapq.heappop(heap)
        p = parties[name]
        p.seats += 1
        heapq.heappush(heap, entry(p))

    return sorted(parties.values(), key=lambda p: p.name)


def dispense_by_weight(
    num_replicas: int,
    weights: Dict[str, int],
    init: Optional[Dict[str, int]] = None,
    uid: str = "",
) -> Dict[str, int]:
    """Dispenser.AllocateByWeight (binding.go:94-115): returns name→seats
    including initial seats. A zero weight sum leaves the initial result."""
    init = dict(init or {})
    if num_replicas == 0 and init:
        return init
    if sum(weights.values()) == 0:
        return init
    parties = allocate_webster_seats(
        num_replicas, weights, init, tiebreak_descending_by_uid(uid)
    )
    return {p.name: p.seats for p in parties}


def fnv32a_batch_odd(uids):
    """Vectorized tiebreak_descending_by_uid over a batch: bool[n] of
    fnv32a(uid) & 1, with empty uids False (webster.py:52-57 semantics).
    One numpy pass per character column instead of a Python loop per byte."""
    n = len(uids)
    bs = [u.encode("utf-8") for u in uids]
    lens = np.fromiter((len(x) for x in bs), np.int64, n)
    L = int(lens.max()) if n else 0
    if L == 0:
        return np.zeros(n, bool)
    flat = np.frombuffer(b"".join(bs), np.uint8)
    starts = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=starts[1:])
    h = np.full(n, 0x811C9DC5, np.uint64)
    idx0 = starts[:-1]
    for j in range(L):
        valid = lens > j
        c = np.zeros(n, np.uint64)
        c[valid] = flat[idx0[valid] + j]
        hv = (h ^ c) * np.uint64(0x01000193) & np.uint64(0xFFFFFFFF)
        h = np.where(valid, hv, h)
    return ((h & np.uint64(1)).astype(bool)) & (lens > 0)
