#!/usr/bin/env python3
"""What each of the loop's host memos buys on config 5's plane, on one card.

The member model and the collector keep two memos so that a tick over
5,000 members costs little when little moved:

  idle       FakeMemberCluster.tick skipped while the member's state_key
             is that of a tick that wrote nothing
  collected  ClusterStatusController skips a member whose state_key and
             Cluster resourceVersion are those of its last collect

and the NoExecute taint manager keeps a cluster -> bindings index
(`_targets`) rebuilt after any binding write.  Two more memos were tried
and went, and are put back here only to be measured:

  used       FakeMemberCluster.used_milli kept until the member's store
             moves (its revision and size)
  plan       FakeMemberCluster.admission_plan kept until its state_key
             (health aside) moves

This script builds chip_smoke's phase 12b plane on the card (every
member of config 5, 4,096 templates), runs 12b (and, unless
--loop-only, 14b and 14c) as chip_smoke does, and then, on the quiescent
plane, in turns (the plane as it is, each kept memo taken away alone,
each gone memo put back alone; ROUNDS rounds) measures:

  idle     IDLE_TICKS ticks that change nothing (median wall, s)
  sparse   SPARSE_MEMBERS members' pods raised by one (a set of its own
           each time), ticked to quiescence (wall, s, and ticks)

The taint index is timed apart: the bindings on each member of the
region the bindings target most, through the index built once, against
a listing of every binding a cluster (the JAX manager's way).  One JSON
line a measurement; run from the root of a checkout on a machine with a
card and nvcc:

    python3 tools/loop_memos.py [--rounds 2] [--loop-only]

`--members` and `--templates` cut the plane (config 5's first members;
the placements drawn over their names) and `--cpu` runs it with
device="cpu", for a quick check of the script itself.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402
from karmada_tpu_torch.members.member import FakeMemberCluster  # noqa: E402

ROUNDS = 2
IDLE_TICKS = 3
SPARSE_MEMBERS = 100
VARIANTS = ("idle taken away", "collected taken away", "used put back",
            "plan put back")


def memoized(fn, key):
    """`fn` kept on each member until key(member) moves (the gone memo)."""
    def kept(self):
        memo = self.__dict__.setdefault("_measured_memos", {})
        k = key(self)
        hit = memo.get(fn.__name__)
        if hit is None or hit[0] != k:
            hit = (k, fn(self))
            memo[fn.__name__] = hit
        return dict(hit[1])
    return kept


def variant(cp, name: str):
    """(arm, disarm, before_tick) setting the plane up as `name` says."""
    cls = FakeMemberCluster
    saved = {"used": cls.used_milli, "plan": cls.admission_plan}
    if name == "used put back":
        return (lambda: setattr(cls, "used_milli", memoized(
                    saved["used"],
                    lambda m: (m.store.revision, len(m.store)))),
                lambda: setattr(cls, "used_milli", saved["used"]),
                lambda: None)
    if name == "plan put back":
        return (lambda: setattr(cls, "admission_plan", memoized(
                    saved["plan"],
                    lambda m: (lambda k: k[:1] + k[2:])(m.state_key()))),
                lambda: setattr(cls, "admission_plan", saved["plan"]),
                lambda: None)
    if name == "idle taken away":
        members = list(cp.members.values())

        def forget():
            for m in members:
                m.__dict__.pop("_idle", None)
        return (lambda: None, lambda: None, forget)
    if name == "collected taken away":
        return (lambda: None, lambda: None,
                cp.cluster_status._collected.clear)  # noqa: SLF001
    return (lambda: None, lambda: None, lambda: None)


def ticks_to_quiet(cp, before_tick, max_ticks=C.LOOP_TICKS):
    """Tick until a tick changes nothing; returns (walls, quiet)."""
    walls = []
    while len(walls) < max_ticks:
        rev = C.loop_revision(cp)
        before_tick()
        t0 = time.perf_counter()
        cp.tick(rounds=1)
        if cp.scheduler.device.type == "cuda":
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if C.loop_revision(cp) == rev:
            return walls, True
    return walls, False


def measure(cp, name, sparse_set) -> dict:
    arm, disarm, before_tick = variant(cp, name)
    arm()
    try:
        idle = []
        for _ in range(IDLE_TICKS):
            walls, _q = ticks_to_quiet(cp, before_tick, max_ticks=1)
            idle += walls
        for m in sparse_set:
            cp.member(m).pods_allocatable += 1
        walls, quiet = ticks_to_quiet(cp, before_tick)
    finally:
        disarm()
    return {"plane": name or "as it is",
            "idle_tick_s": statistics.median(idle),
            "sparse_s": sum(walls), "sparse_ticks": len(walls),
            "sparse_quiet": quiet}


def taint_index(cp) -> dict:
    """The region whose members the bindings target most, as a region's
    taint events would ask."""
    tm = cp.taint_manager
    region_of = {m: cp.store.peek("Cluster", "", m).spec.region
                 for m in cp.members}
    held = {}
    for rb in cp.store.visit("ResourceBinding"):
        for t in rb.spec.clusters:
            held[region_of[t.name]] = held.get(region_of[t.name], 0) + 1
    region = min(held, key=lambda r: (-held[r], r))
    names = sorted(m for m in cp.members if region_of[m] == region)
    tm._on_binding_event(None)  # noqa: SLF001 — a fresh build, as after a write
    t0 = time.perf_counter()
    kept = sum(len(tm._bindings_on(n)) for n in names)  # noqa: SLF001
    t1 = time.perf_counter()
    listed = 0
    for n in names:
        listed += sum(1 for rb in cp.store.visit("ResourceBinding")
                      if any(t.name == n for t in rb.spec.clusters))
    t2 = time.perf_counter()
    return {"taint_index_region": region, "clusters": len(names),
            "bindings": kept,
            "index_s": t1 - t0, "listing_s": t2 - t1,
            "same": kept == listed}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=ROUNDS)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--members", type=int, default=C.LOOP_MEMBERS)
    ap.add_argument("--templates", type=int, default=C.LOOP_TEMPLATES)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--loop-only", action="store_true",
                    help="measure on 12b's plane, without 14b and 14c")
    args = ap.parse_args()
    if args.cpu:
        dev = torch.device("cpu")
    elif torch.cuda.is_available():
        dev = torch.device("cuda", 0)
        C.phase_device()
        C.phase_build()
    else:
        print("loop_memos: no CUDA device", file=sys.stderr)
        return 2
    C.GC.arm()
    M = C.models()
    rng = random.Random(args.seed)
    fleet = C.build_fleet(M, rng, args.members)
    placements = C.build_placements(M, rng, [c.name for c in fleet])
    items = C.build_bindings(M, rng, 100_000,
                             placements)[:args.templates]
    t0 = time.perf_counter()
    _launches, cp = C.phase_loop(M, fleet, placements, items, dev)
    walls = {"12b": time.perf_counter() - t0}
    if not args.loop_only:
        t1 = time.perf_counter()
        C.phase_member_rebalance(cp, dev, placements, items)
        t2 = time.perf_counter()
        C.phase_outage(cp, dev)
        walls.update({"14b": t2 - t1, "14c": time.perf_counter() - t2})
    out = [{"phase_s": walls}]
    print(json.dumps(out[0]), flush=True)
    _div, pinned = C.divided_load(cp)
    free = [m for m in sorted(cp.members) if m not in pinned]
    size = min(SPARSE_MEMBERS,
               len(free) // (args.rounds * (len(VARIANTS) + 1)))
    sets = iter(free[i:i + size] for i in range(0, len(free), size))
    for r in range(args.rounds):
        for name in (None,) + VARIANTS:
            row = measure(cp, name, next(sets))
            row["round"] = r
            out.append(row)
            print(json.dumps(row), flush=True)
    row = taint_index(cp)
    out.append(row)
    print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "loop_memos.json"),
              "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
