"""Dirty-set incremental solving: the watch-driven steady state.

Counterpart of the JAX package's ``scheduler/incremental.py``.  At 0.1%
churn, 99.9% of a full cycle (re-encode and re-solve every binding)
reproduces last cycle's answer.  This module is the solver-side reconcile
loop:

  1. ops/dirty.dirty_codes classifies every slot-store row clean or dirty
     in one pass (K12: rv churn from the window's deltas and our own
     write-backs, feasibility-flip lanes from the resident plane,
     capacity-sensitive rows, non-device routes).
  2. Dirty rows are grouped by their ORIGINAL chunk, each group one
     single-chunk run_pipeline call through the resident plane's encoder,
     chained through a carried consumed-capacity ledger.
  3. Every other row keeps last cycle's placement.

Sequential equivalence (bit-exact at waves=1 only): the control is
run_pipeline(all items, chunk=K, waves=1, carry=True, carry_state=ledger),
where a row in chunk c prices against the ledger plus the consumption of
chunks < c.  Clean rows reproduce their previous placement and consume
nothing (the solver's stickiness contract), which leans on the write-back
protocol: write_back() runs between cycles, so a row's stored prev
advances to its last result (the write bumps the rv, the row re-solves
once, reproduces, and goes quiet).  Dirty rows grouped by original chunk
solve as one chunk each, seeded with the ledger plus the consumption of
earlier groups.  Consecutive chunk groups coalesce into one dispatch only
when order-free: the incoming group's SENSITIVE rows' placement masks must
be disjoint from the CONSUMER rows' masks grouped so far (and, with the
shortlist armed, the merged mask union stays within 8 * k lanes).

The carried ledger (tensors.CarryState, full cluster vocabulary): every
cycle's rows price against the PRE-cycle ledger; the next ledger is this
one retired on the cycle's capacity-updated lanes (a status write now
embeds the charged consumption) plus the cycle's own consumption; a
structural rebuild resets it and forces a full solve.

The audit (every `audit_every`-th cycle, or forced) runs the full dense
control against the same pre-cycle ledger and compares results row by row
and the ledgers store by store; on any divergence the control's results
and ledger are adopted.

Single-threaded by contract: one cycle loop drives adopt / cycle /
write_back in sequence.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from karmada_tpu_torch.obs import events as ev
from karmada_tpu_torch.obs import incidents as obs_incidents
from karmada_tpu_torch.ops import dirty as dirty_mod
from karmada_tpu_torch.ops import tensors as T
from karmada_tpu_torch.resident.state import RowToken
from karmada_tpu_torch.scheduler import pipeline
from karmada_tpu_torch.utils.locks import OwnerThread
from karmada_tpu_torch.utils.metrics import REGISTRY

INC_CYCLES = REGISTRY.counter(
    "karmada_incremental_cycles_total",
    "Incremental-plane scheduling cycles by mode (incremental: dirty "
    "sub-batches only; full: dense solve forced by adopt/rebuild/"
    "roster-change/audit-mismatch)",
    ("mode",),
)
INC_AUDITS = REGISTRY.counter(
    "karmada_incremental_audits_total",
    "Bit-exact parity audits of the incremental solve against the full "
    "dense control (outcome=ok|mismatch; mismatch also forces adoption "
    "of the control's results and ledger)",
    ("outcome",),
)

#: conservative grade for rows with no slot-store row yet (appended
#: bindings, affinity-failover rows that bypass the cache)
_ALL_BITS = dirty_mod.DIRTY | dirty_mod.SENSITIVE | dirty_mod.CONSUMER


def _norm(res) -> tuple:
    """Order-free comparable form of one scheduling outcome."""
    if isinstance(res, Exception):
        return ("exc", type(res).__name__)
    return tuple(sorted((t.name, int(t.replicas)) for t in res))


def _ledger_equal(a: T.CarryState, b: T.CarryState) -> bool:
    """Store equality treating missing keys as zeros (a group's
    sub-vocabulary may never have priced a resource)."""
    def eq(da, db):
        for k in set(da) | set(db):
            x, y = da.get(k), db.get(k)
            if x is None:
                x = np.zeros_like(y)
            if y is None:
                y = np.zeros_like(x)
            if x.shape != y.shape or not np.array_equal(x, y):
                return False
        return True

    pa, pb = a.pods, b.pods
    if (pa is None) != (pb is None):
        pa = np.zeros(0, np.int64) if pa is None else pa
        pb = np.zeros(pa.shape, np.int64) if pb is None else pb
    return (eq(a.milli, b.milli) and eq(a.sets, b.sets)
            and (pa is None or np.array_equal(pa, pb)))


@dataclass
class CycleReport:
    """One incremental cycle's outcome."""

    mode: str = "incremental"        # or "full"
    reason: str = ""                 # full-solve trigger ("" incremental)
    total: int = 0                   # roster size
    dirty: int = 0                   # rows re-solved this cycle
    chunk_groups: int = 0            # original-chunk groups before coalesce
    groups: List[int] = field(default_factory=list)  # dispatch sizes
    host_rows: int = 0               # rows the device tiers stopped owning
    audited: bool = False
    audit_outcome: Optional[str] = None   # "ok" | "mismatch"
    seconds: float = 0.0
    # host seconds by stage: "plane" (begin_cycle), "dirty" (the dirty
    # pass), "group", "audit" (the dense control), and the solves'
    # pipeline stages summed over their calls ("encode", "shortlist",
    # "dispatch", "wait", "spread", "big", "finalize", "decode")
    stages: Dict[str, float] = field(default_factory=dict)
    # the "dirty" stage's host seconds in its three parts: "roster" (the
    # rv-churn slots and forced rows), "codes" (ops/dirty.dirty_codes)
    # and "map" (slot codes to roster positions, the dirty set)
    dirty_split: Dict[str, float] = field(default_factory=dict)


_PIPELINE_STAGES = ("encode", "shortlist", "dispatch", "wait", "spread",
                    "big", "finalize", "decode")


def _add_stages(rep: CycleReport, res) -> None:
    for k in _PIPELINE_STAGES:
        rep.stages[k] = rep.stages.get(k, 0.0) + getattr(res, f"{k}_s")


class IncrementalSolver:
    """Steady-state scheduling driver over a ResidentState plane, on the
    plane's device.

    adopt() once (full solve: roster, ledger and slot store), then cycle()
    per round with the window's deltas; write_back() patches changed
    placements into the binding objects (rv bump: the next cycle re-solves
    exactly those rows once more, reproduces them, and goes quiet).

    The roster is append-only between full solves: the bindings keep
    their order, new ones appended (force-dirtied).  A shrink or reorder
    falls back to a full solve."""

    def __init__(self, state, estimator, *, chunk: int = 4096,
                 waves: int = 1, audit_every: int = 16,
                 shortlist=None) -> None:
        assert waves == 1, \
            "incremental solving is bit-exact only at waves=1 (a chunk's " \
            "rows must never see same-chunk consumption)"
        self.state = state
        self.estimator = estimator
        self.chunk = int(chunk)
        self.audit_every = max(0, int(audit_every))
        self.shortlist = shortlist
        # with the shortlist armed, merged groups keep their mask union
        # within one narrow sub-vocabulary (8 * k lanes): more sequential
        # groups never break exactness, over-merging disjoint regions
        # widens the union until the shortlist falls back to dense
        self._lane_budget = (8 * shortlist.k) if shortlist else None
        # single-threaded by contract: adopt / cycle / write_back run on
        # the one scheduler worker (utils/locks.OwnerThread: the first
        # caller owns the plane, any other thread raises while armed)
        self._owner = OwnerThread("scheduler.incremental")
        self.ledger: T.CarryState = T.CarryState()
        self.keys: List[str] = []
        self.key_pos: Dict[str, int] = {}
        self.bindings: List = []
        self.results: Dict[int, object] = {}
        # pos -> slot-store slot (-1: no cached row), refreshed for rows
        # that re-encode so the next dirty pass reads live slots
        self._slots: np.ndarray = np.zeros(0, np.int64)
        # keys our own write_back() touched since the last cycle
        self._pending: Set[str] = set()
        # pos -> last normalized outcome write_back applied
        self._applied: Dict[int, tuple] = {}
        # positions whose result changed since the last write_back
        self._since_wb: Set[int] = set()
        # the caller's roster object: the same list at the same length
        # skips the O(n) key rebuild in cycle()
        self._roster_src: Optional[object] = None
        self.cycles = 0
        self._plm_cache: Optional[Tuple[int, np.ndarray]] = None
        self._pid_cache: Optional[Tuple[int, np.ndarray]] = None

    # -- roster ---------------------------------------------------------------
    @staticmethod
    def _token(rb, key: str):
        terms = (rb.spec.placement.cluster_affinities
                 if rb.spec.placement else [])
        # affinity-failover rows encode against synthesized status and
        # bypass the row cache: no stable token
        return None if terms else RowToken(key, rb.metadata.resource_version)

    def _set_roster(self, bindings: Sequence, keys: List[str]) -> List[int]:
        """Adopt the cycle's roster (prefix already checked stable);
        returns the appended positions."""
        n0 = len(self.keys)
        appended = list(range(n0, len(keys)))
        for i in appended:
            self.key_pos[keys[i]] = i
        if appended:
            self._slots = np.concatenate(
                [self._slots, np.full(len(appended), -1, np.int64)])
        self.keys = keys
        self.bindings = list(bindings)
        self._roster_src = bindings
        return appended

    def _rebuild_roster(self, bindings: Sequence, keys: List[str]) -> None:
        self.keys = keys
        self.key_pos = {k: i for i, k in enumerate(keys)}
        self.bindings = list(bindings)
        self._slots = np.full(len(keys), -1, np.int64)
        self.results = {}
        self._applied = {}
        self._since_wb = set()
        self._roster_src = bindings

    def _refresh_slots(self, positions) -> None:
        rows = self.state.rows
        for p in positions:
            row = rows.get(self.keys[p])
            self._slots[p] = row.slot if row is not None else -1

    # -- plane views (cached on the frozen masters' identity) -----------------
    def _plm(self) -> np.ndarray:
        m = self.state.plane.pl_mask
        if self._plm_cache is None or self._plm_cache[0] != id(m):
            self._plm_cache = (id(m), np.asarray(m).astype(bool))
        return self._plm_cache[1]

    def _pid(self) -> np.ndarray:
        a = self.state.plane.placement_id
        if self._pid_cache is None or self._pid_cache[0] != id(a):
            self._pid_cache = (id(a), np.asarray(a))
        return self._pid_cache[1]

    # -- the two solve legs ---------------------------------------------------
    def _run(self, bindings: List, keys: List[str],
             seed: T.CarryState) -> "pipeline.PipelineResult":
        state = self.state
        toks = [self._token(rb, k) for rb, k in zip(bindings, keys)]

        def encode(part, offset, armed):
            return state.encode_cycle(
                part, toks[offset:offset + len(part)], explain=armed)

        return pipeline.run_pipeline(
            [(rb.spec, rb.status) for rb in bindings], state.cindex,
            self.estimator, chunk=self.chunk, waves=1,
            cache=state.enc_cache, carry=True, carry_spread=False,
            encode=encode, keys=keys, shortlist=self.shortlist,
            carry_state=seed, collect_carry=True, device=state.device)

    def _run_all(self, seed: T.CarryState) -> "pipeline.PipelineResult":
        """Full dense control: every roster row, seeded from `seed`."""
        return self._run(self.bindings, self.keys, seed)

    def _solve_group(self, grp: List[int],
                     seed: T.CarryState) -> "pipeline.PipelineResult":
        return self._run([self.bindings[p] for p in grp],
                         [self.keys[p] for p in grp], seed)

    def _full(self, reason: str, rep: CycleReport) -> CycleReport:
        res = self._run_all(self.ledger)
        _add_stages(rep, res)
        self.results = dict(res.results)
        self._since_wb = set(self.results)
        self.ledger = res.carry
        self._refresh_slots(range(len(self.keys)))
        INC_CYCLES.inc(mode="full")
        rep.mode = "full"
        rep.reason = reason
        rep.dirty = len(self.keys)
        rep.host_rows = len(self.keys) - len(self.results)
        return rep

    # -- lifecycle ------------------------------------------------------------
    def adopt(self, clusters: Sequence, bindings: Sequence) -> CycleReport:
        """First cycle: full solve, roster + ledger + slot store built."""
        self._owner.check("adopt()")
        t0 = time.perf_counter()
        self.cycles += 1
        self._rebuild_roster(
            bindings, [f"{rb.namespace}/{rb.name}" for rb in bindings])
        self.state.begin_cycle(clusters, None)
        self.ledger = T.CarryState()
        rep = CycleReport(total=len(self.keys))
        rep.stages["plane"] = time.perf_counter() - t0
        rep = self._full("adopt", rep)
        rep.seconds = time.perf_counter() - t0
        return rep

    def cycle(self, clusters: Sequence, bindings: Sequence,
              deltas=None, force_audit: Optional[bool] = None) -> CycleReport:
        """One watch-driven cycle: advance the plane by `deltas`, re-solve
        the dirty set, audit on cadence.  `bindings` is the full roster
        (append-only against the previous cycle, or a full solve runs)."""
        self._owner.check("cycle()")
        t0 = time.perf_counter()
        self.cycles += 1
        state = self.state
        gen0 = state.generation
        state.begin_cycle(clusters, deltas)
        rep = CycleReport(total=len(bindings))
        t1 = time.perf_counter()
        rep.stages["plane"] = t1 - t0

        n0 = len(self.keys)
        if bindings is self._roster_src and len(bindings) == n0:
            keys = self.keys  # identity fast path: no O(n) key rebuild
        else:
            keys = [f"{rb.namespace}/{rb.name}" for rb in bindings]
        full_reason = None
        if state.generation != gen0 or state.plane is None:
            # structural rebuild: the vocabulary the ledger indexes is gone
            full_reason = "plane-rebuild"
            self.ledger = T.CarryState()
        elif len(keys) < n0 or keys[:n0] != self.keys:
            full_reason = "roster-change"
        if full_reason:
            self._rebuild_roster(bindings, keys)
            self.ledger.retire_lanes(state.last_cap_lanes)
            ev.emit(ev.SCHEDULER_REF, ev.TYPE_NORMAL,
                    ev.REASON_INCREMENTAL_FULL_SOLVE,
                    f"incremental plane forced a full dense solve: "
                    f"{full_reason}", origin="incremental")
            rep = self._full(full_reason, rep)
            self._pending.clear()
            rep.seconds = time.perf_counter() - t0
            self._flight(rep)
            return rep

        appended = self._set_roster(bindings, keys)
        # capacity catch-up: a status write's reported availability now
        # embeds previously charged consumption
        self.ledger.retire_lanes(state.last_cap_lanes)

        # rv churn: the window's deltas plus our own write-backs
        touched = set(self._pending)
        self._pending.clear()
        if deltas is not None:
            touched.update(f"{ns}/{nm}" for ns, nm in deltas.bindings_touched)
        rv_slots: List[int] = []
        forced_pos: List[int] = list(appended)
        for key in touched:
            p = self.key_pos.get(key)
            if p is None:
                continue
            s = int(self._slots[p])
            if s >= 0:
                rv_slots.append(s)
            else:
                forced_pos.append(p)

        # the fused slot mirrors serve the pass when they are in sync
        dr = state.device_rows
        mirrors = (dr.mirrors if dr is not None and dr.mirrors
                   and state._rows_dirty is None  # noqa: SLF001
                   else None)
        t_codes = time.perf_counter()
        codes = dirty_mod.dirty_codes(
            state, np.asarray(rv_slots, np.int64), mirrors=mirrors)
        t_map = time.perf_counter()

        n = len(keys)
        pos_codes = np.zeros(n, np.uint8)
        has_slot = self._slots >= 0
        pos_codes[has_slot] = codes[self._slots[has_slot]]
        pos_codes[~has_slot] = _ALL_BITS  # no cached row: dirty
        if forced_pos:
            pos_codes[forced_pos] = _ALL_BITS
        dirty_pos = np.flatnonzero(pos_codes & dirty_mod.DIRTY)
        rep.dirty = int(dirty_pos.size)
        dirty_mod.COUNTS["rows"] += rep.dirty
        dirty_mod.COUNTS["dirty_fraction"] = rep.dirty / max(n, 1)
        dirty_mod.DIRTY_ROWS.inc(rep.dirty)
        dirty_mod.DIRTY_FRACTION.set(rep.dirty / max(n, 1))
        INC_CYCLES.inc(mode="incremental")
        t2 = time.perf_counter()
        rep.stages["dirty"] = t2 - t1
        rep.dirty_split = {"roster": t_codes - t1, "codes": t_map - t_codes,
                           "map": t2 - t_map}

        groups = self._group(dirty_pos, pos_codes)
        rep.chunk_groups = len(np.unique(dirty_pos // self.chunk))
        rep.groups = [len(g) for g in groups]
        rep.stages["group"] = time.perf_counter() - t2

        pre = self.ledger.copy()  # the audit's seed: the PRE-cycle ledger
        seed = self.ledger
        new_results: Dict[int, object] = {}
        for grp in groups:
            res = self._solve_group(grp, seed)
            _add_stages(rep, res)
            seed = res.carry
            for j, r in res.results.items():
                new_results[grp[j]] = r
        self.ledger = seed
        for p in dirty_pos.tolist():
            if p not in new_results:
                # the row left the device tiers: the caller's serial
                # fallback owns it now
                if self.results.pop(p, None) is not None:
                    rep.host_rows += 1
        self.results.update(new_results)
        self._since_wb.update(new_results)
        self._refresh_slots(dirty_pos.tolist())

        rep.audited = (force_audit if force_audit is not None
                       else (self.audit_every > 0
                             and self.cycles % self.audit_every == 0))
        if rep.audited:
            t3 = time.perf_counter()
            rep.audit_outcome = self._audit(pre)
            rep.stages["audit"] = time.perf_counter() - t3
        rep.seconds = time.perf_counter() - t0
        self._flight(rep)
        return rep

    def _flight(self, rep: CycleReport) -> None:
        """One kind="incremental" flight record per cycle: the dirty-set
        and taint-group stats plus the audit verdict digest the incident
        bundles snapshot.  Disarmed cost is one list read."""
        if not obs_incidents.flight_armed():
            return
        obs_incidents.record(
            "incremental", t=round(time.time(), 6), cycle=self.cycles,
            mode=rep.mode, reason=rep.reason, total=rep.total,
            dirty=rep.dirty, chunk_groups=rep.chunk_groups,
            groups=list(rep.groups), host_rows=rep.host_rows,
            audited=rep.audited, audit_outcome=rep.audit_outcome,
            seconds=round(rep.seconds, 6))

    # -- grouping -------------------------------------------------------------
    def _group(self, dirty_pos: np.ndarray,
               pos_codes: np.ndarray) -> List[List[int]]:
        """Original-chunk groups with the coalescing rule (module
        docstring): merge chunk group g into the running dispatch only when
        g's sensitive rows' placement masks are disjoint from the consumer
        mask union so far, the merged size stays within one chunk, and
        (shortlist armed) the merged mask union within the lane budget."""
        if dirty_pos.size == 0:
            return []
        plm = self._plm()
        pid = self._pid()
        C = plm.shape[1]
        budget = self._lane_budget if self._lane_budget else C

        def mask_union(rows: np.ndarray, bit: int) -> np.ndarray:
            sel = rows[(pos_codes[rows] & bit) != 0]
            if sel.size == 0:
                return np.zeros(C, bool)
            slots = self._slots[sel]
            if np.any(slots < 0):
                return np.ones(C, bool)  # unknown row: taints everything
            return plm[pid[slots]].any(axis=0)

        chunk_ids = dirty_pos // self.chunk
        bounds = np.flatnonzero(np.diff(chunk_ids)) + 1
        groups: List[List[int]] = []
        cur: List[int] = []
        cur_cons = np.zeros(C, bool)
        cur_all = np.zeros(C, bool)
        for g in np.split(dirty_pos, bounds):
            inc_sens = mask_union(g, dirty_mod.SENSITIVE)
            g_all = mask_union(g, dirty_mod.DIRTY)  # every row is DIRTY
            if (cur and len(cur) + len(g) <= self.chunk
                    and not np.any(cur_cons & inc_sens)
                    and int(np.count_nonzero(cur_all | g_all)) <= budget):
                cur.extend(g.tolist())
            else:
                if cur:
                    groups.append(cur)
                cur = g.tolist()
                cur_cons = np.zeros(C, bool)
                cur_all = np.zeros(C, bool)
            cur_cons |= mask_union(g, dirty_mod.CONSUMER)
            cur_all |= g_all
        if cur:
            groups.append(cur)
        return groups

    # -- audit ----------------------------------------------------------------
    def _audit(self, pre: T.CarryState) -> str:
        """Full dense control against the same pre-cycle ledger; adopt its
        results and ledger on any divergence."""
        res = self._run_all(pre)
        bad = [p for p in set(res.results) | set(self.results)
               if (self.results.get(p) is None) != (res.results.get(p) is None)
               or (self.results.get(p) is not None
                   and _norm(self.results[p]) != _norm(res.results[p]))]
        ledger_ok = _ledger_equal(self.ledger, res.carry)
        if not bad and ledger_ok:
            INC_AUDITS.inc(outcome="ok")
            return "ok"
        INC_AUDITS.inc(outcome="mismatch")
        what = (f"{len(bad)} row(s) diverged"
                + ("" if ledger_ok else " and the capacity ledger drifted"))
        names = ", ".join(self.keys[p] for p in sorted(bad)[:5])
        ev.emit(ev.SCHEDULER_REF, ev.TYPE_WARNING,
                ev.REASON_INCREMENTAL_AUDIT_MISMATCH,
                f"incremental solve diverged from the dense control: {what}"
                + (f" ({names})" if names else "")
                + "; adopting the control's results and ledger",
                origin="incremental")
        # incident bundle with the divergence diff (built BEFORE the
        # adoption below rewrites self.results): row-level incremental vs
        # control answers, bounded
        diff = [{"key": self.keys[p],
                 "incremental": (None if self.results.get(p) is None
                                 else _norm(self.results[p])),
                 "control": (None if res.results.get(p) is None
                             else _norm(res.results[p]))}
                for p in sorted(bad)[:10]]
        obs_incidents.trigger(
            obs_incidents.TRIGGER_AUDIT_DIVERGENCE,
            f"incremental audit divergence adopted: {what}",
            refs=[self.keys[p] for p in sorted(bad)[:16]],
            detail={"rows": diff, "n_bad": len(bad),
                    "ledger_ok": ledger_ok, "cycle": self.cycles})
        self.results = dict(res.results)
        self._since_wb = set(self.results)
        self.ledger = res.carry
        self._refresh_slots(range(len(self.keys)))
        return "mismatch"

    # -- write-back -----------------------------------------------------------
    def write_back(self) -> int:
        """Patch changed placements into the roster's binding objects
        (spec.clusters + rv bump), changed-only: a result identical to the
        last applied one writes nothing, which ends the self-churn loop.
        Visits only positions whose result changed since the last
        write_back.  Returns the number of bindings written."""
        self._owner.check("write_back()")
        changed = 0
        for pos in self._since_wb:
            res = self.results.get(pos)
            if res is None:
                continue  # row left the device tiers since
            norm = _norm(res)
            if self._applied.get(pos) == norm:
                continue
            self._applied[pos] = norm
            if isinstance(res, Exception):
                continue  # no placement to record; outcome tracked only
            rb = self.bindings[pos]
            rb.spec.clusters = list(res)
            rb.metadata.resource_version += 1
            self._pending.add(self.keys[pos])
            changed += 1
        self._since_wb.clear()
        return changed
