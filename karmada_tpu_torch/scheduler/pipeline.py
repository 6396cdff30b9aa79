"""Chunked executor of one scheduling cycle: the port's main device path.

Counterpart of the JAX package's ``scheduler/pipeline.run_pipeline`` on
its main route.  Per chunk:

  Encode   (host)    items[lo:hi] -> SolverBatch (ops/tensors.encode_batch)
                     against one cycle-shared EncoderCache
  Dispatch (async)   ops/solver.dispatch_compact launches the chunk's
                     kernels and returns without waiting for the card
  Finalize (host)    wait for the card's queued work, then the chunk's
                     spread sub-solves (ops/spread.solve_spread, one per
                     (axis, tier)) and big-tier sub-solve
                     (ops/solver.solve_big), then read back the main COO
                     (idx/val/status/nnz) and decode it
                     (ops/tensors.decode_compact)

Chunk k's finalize runs after chunk k+1 was encoded and dispatched, so the
host's encode of the next chunk overlaps the card's work on this one.

Carry (`carry=True`): the consumed-capacity accumulators thread chunk to
chunk, so chunk k+1 prices against the snapshot minus everything chunks
<= k consumed.  The chain stays on the card while consecutive chunks share
a resource/class vocabulary (the next dispatch reads the previous one's
live accumulators); lossless vocabulary growth re-keys them on the card
(``_device_remap``, an index_select without a host sync); a lossy change
closes the segment into a host-side, name-keyed CarryState.  With carry
on, each sub-solve also prices against its chunk's carry-in, and its own
consumption is folded back into the chain at the next dispatch boundary
(`extras`: a lazy add on the card when it fits the next chunk's
vocabulary).  That is one chunk late: chunk k's sub-solves run at its
finalize, after chunk k+1 dispatched, so their consumption reaches chunk
k+2's carry-in -- the JAX package's accounting, reproduced as it is.

Every device route runs here (DEVICE_ROUTES); host routes are absent from
the result, for the caller's serial path (scheduler/core.schedule_items).

Resident and incremental cycles: `encode=` replaces the chunk encoder
(the resident plane's gather plus miss re-encode, resident/state.py; its
fused batches carry device binding fields, and every host-side read goes
through the host `route` or tensors.host_rows); `carry_state=` seeds the
carry chain with a ledger carried from earlier runs and `collect_carry=`
returns the run's cumulative consumption (scheduler/incremental.py).

Explain (`explain=DecisionRecorder`): chunks encode the placements' static
fail bits and dispatch the explain variant (K7 after each wave's K2, and
after each spread sub-solve); finalize turns the planes into Decision
records (obs/decisions) and attaches the dominant rejection reason to
every unschedulable result (`exc.reason`).

Cancellation (`cancelled=threading.Event`, the Scheduler's mid-serve
guard, scheduler/service.py): the event is checked between chunks and
before each chunk's sub-solves and decode.  Once it is set the run
launches nothing more and records nothing: no result, no count, no carry
(PipelineResult.cancelled is True and the partial result is the caller's
to discard).

Shortlist (`shortlist=ShortlistConfig`): chunks at or above its cell
threshold run tier 1 (ops/shortlist: K1 + K8 over the chunk's profiles)
and dispatch the solver over the candidate-union sub-vocabulary.  Each
shortlisted chunk has its own lane set, so the carry chain keys its
segments on the lane set too and crosses vocabularies through the keyed
CarryState.  Rows truncated out of a chunk (eligible set beyond k_max,
waves=1 only) are solved per binding at full width in its finalize,
against the full-vocabulary consumption of every chunk before it.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karmada_tpu_torch import obs
from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.obs import decisions as obs_decisions
from karmada_tpu_torch.ops import shortlist as sl
from karmada_tpu_torch.ops import solver, spread, tensors

#: routes whose results the device path owns; every other row falls back
#: to the serial host path
DEVICE_ROUTES = (
    tensors.ROUTE_DEVICE,
    tensors.ROUTE_DEVICE_SPREAD,
    tensors.ROUTE_DEVICE_SPREAD_BIG,
    tensors.ROUTE_DEVICE_BIG,
)


@dataclass
class PipelineResult:
    """Aggregate outcome of one run_pipeline call; times are host-clock
    seconds of each stage, summed over chunks."""

    results: Dict[int, object] = field(default_factory=dict)  # global index
    scheduled: int = 0
    failures: Dict[str, int] = field(default_factory=dict)
    chunks: int = 0
    encode_s: float = 0.0
    dispatch_s: float = 0.0
    # device wait at finalize's start: the stream holds this chunk's main
    # solve and the next chunk's, which any read-back would wait for
    wait_s: float = 0.0
    finalize_s: float = 0.0  # main COO read-back
    decode_s: float = 0.0
    spread_s: float = 0.0    # spread sub-solves (phases A and B, host DFS)
    big_s: float = 0.0       # big-tier and shortlist-residual sub-solves
    shortlist_s: float = 0.0  # tier 1 and the sub-batch build
    explain_s: float = 0.0   # Decision records from the explain planes
    routes: Dict[int, int] = field(default_factory=dict)  # rows per route
    # the run's shortlist counts: chunks shortlisted, dense fallbacks by
    # reason, widen rounds, residual rows, per-chunk union widths and the
    # tier-2 cells solved vs the dense equivalent
    shortlist: Dict[str, object] = field(default_factory=dict)
    # collect_carry: the run's cumulative consumption (seed + every
    # chunk's own), keyed in the full vocabulary
    carry: Optional["tensors.CarryState"] = None
    # the guard's event fired mid-cycle: nothing above was recorded past
    # that point and the result is partial
    cancelled: bool = False


class _CarryChain:
    """Chunk-to-chunk consumed-capacity threading (JAX: _CarryChain).

    Invariant: the latest dispatched handle's used-out equals the
    cumulative consumption of every chunk dispatched so far, rendered in
    the open segment's vocabulary, plus the segment base (everything
    absorbed before the segment opened).  `total` holds closed segments
    keyed by resource name / class key; `extras` holds sub-solve
    consumption pending its fold into the chain."""

    def __init__(self) -> None:
        self.total = tensors.CarryState()
        self.extras = tensors.CarryState()
        # open segment: [sig, batch, base (numpy triple), handle | None]
        self._seg: Optional[list] = None

    @staticmethod
    def _sig(batch) -> tuple:
        # sub_sig joins the signature: two shortlisted sub-vocabulary
        # batches can share every shape while holding different cluster
        # lane sets -- chaining their live accumulators would misalign
        # lanes silently
        return (batch.C, tuple(batch.res_names), tuple(batch.class_keys),
                batch.est_override.shape[0], batch.avail_milli.shape[1],
                batch.sub_sig)

    @staticmethod
    def _subset(from_batch, to_batch) -> bool:
        """True when re-keying from_batch -> to_batch drops nothing (one
        lane set: crossing lane sets goes through the keyed store)."""
        return (from_batch.C == to_batch.C
                and from_batch.sub_sig == to_batch.sub_sig
                and set(from_batch.res_names) <= set(to_batch.res_names)
                and set(from_batch.class_keys) <= set(to_batch.class_keys))

    def _extras_fit(self, batch) -> bool:
        """True when the pending extras render losslessly into batch's
        vocabulary (they can ride the device chain)."""
        return (set(self.extras.milli) <= set(batch.res_names)
                and set(self.extras.sets) <= set(batch.class_keys))

    @staticmethod
    def _device_remap(used, from_batch, to_batch):
        """Re-key live device accumulators into to_batch's vocabulary on
        the card (index_select + where; no host sync).  Caller guarantees
        _subset(from_batch, to_batch)."""
        um, up, us = used
        dev = um.device

        def plan(src_keys, dst_keys, n):
            src = {k: i for i, k in enumerate(src_keys)}
            idx = np.zeros(n, np.int64)
            ok = np.zeros(n, bool)
            for j, k in enumerate(dst_keys):
                if k in src:
                    idx[j], ok[j] = src[k], True
            return (torch.from_numpy(idx).to(dev),
                    torch.from_numpy(ok).to(dev))

        idx_r, ok_r = plan(from_batch.res_names, to_batch.res_names,
                           to_batch.avail_milli.shape[1])
        um2 = torch.where(ok_r[None, :], um.index_select(1, idx_r), 0)
        idx_q, ok_q = plan(from_batch.class_keys, to_batch.class_keys,
                           to_batch.est_override.shape[0])
        us2 = torch.where(ok_q[:, None], us.index_select(0, idx_q), 0)
        return um2, up, us2

    def _close(self) -> None:
        """Fold the open segment's consumption into the keyed store (host
        sync on the segment's last dispatched chunk)."""
        if self._seg is None:
            return
        _sig, batch, base, handle = self._seg
        self._seg = None
        if handle is None:
            return
        used = tuple(u.cpu().numpy() for u in handle.used)
        self.total.absorb(batch, used, base)

    def carry_in(self, batch):
        """The used0 operands for this chunk's dispatch (device tensors on
        the chained path, numpy after a segment close)."""
        sig = self._sig(batch)
        seg = self._seg
        if seg is not None and seg[3] is not None and (
                self.extras.empty() or self._extras_fit(batch)):
            used = None
            if seg[0] == sig:
                used = seg[3].used
            elif self._subset(seg[1], batch):
                used = self._device_remap(seg[3].used,
                                          seg[1], batch)
                base = tensors.remap_used(seg[2], seg[1], batch)
                self._seg = [sig, batch, base, None]
            if used is not None:
                if not self.extras.empty():
                    # pending sub-solve consumption rides the chain from
                    # here (adds on the card, no host sync); it reaches
                    # the keyed store at segment close via used - base
                    extra = self.extras.used0_for(batch)
                    used = tuple(u + torch.from_numpy(e).to(u.device)
                                 for u, e in zip(used, extra))
                    self.extras = tensors.CarryState()
                return used
        # slow path (a lossy vocabulary change): close the segment and
        # retire the pending extras into the keyed store
        self._close()
        if not self.extras.empty():
            self.total.merge(self.extras)
            self.extras = tensors.CarryState()
        base = self.total.used0_for(batch)
        self._seg = [sig, batch, base, None]
        return base

    def dispatched(self, batch, handle) -> None:
        if self._seg is None or self._seg[0] != self._sig(batch):
            raise AssertionError("dispatched() without a carry_in() segment")
        self._seg[3] = handle

    def snapshot(self) -> "tensors.CarryState":
        """The consumption of every chunk dispatched so far as a fresh
        keyed store in the full vocabulary, without closing the open
        segment (host sync on its last dispatched chunk)."""
        out = self.total.copy()
        if not self.extras.empty():
            out.merge(self.extras)
        if self._seg is not None and self._seg[3] is not None:
            _sig, batch, base, handle = self._seg
            out.absorb(batch, tuple(u.cpu().numpy() for u in handle.used),
                       base)
        return out


def _record_decisions(recorder, batch, part, offset, keys, out_local,
                      expl_planes, sp_expl) -> None:
    """One finalized chunk's explain planes as Decision records (JAX:
    pipeline._record_decisions).  Main-route rows decode from the dense
    planes, spread rows from their callback rows, every other device row
    (big tier, group-DFS failures, the shortlist residual) gets an
    outcome-level decision from its result.  The dominant unschedulable
    reason is attached to the result exceptions (`exc.reason`)."""
    names = batch.cluster_index.names
    nc = batch.n_clusters

    def key_of(i: int) -> str:
        if keys is not None:
            return keys[offset + i]
        return obs_decisions.default_key(part[i][0])

    def attach_reason(res, outcome_code) -> None:
        _st, dom = obs_decisions.split_outcome(int(outcome_code))
        if dom is not None and isinstance(res, Exception):
            res.reason = dom

    def planes_row(i, vrow, srow, arow, oc, backend):
        res_i = out_local.get(i)
        attach_reason(res_i, oc)
        pid = int(batch.placement_id[i])
        recorder.record(obs_decisions.decision_from_planes(
            key_of(i), names, vrow, srow, arow, int(oc), res_i,
            backend=backend, static_w_row=batch.pl_static_w[pid, :nc],
            plugin_row=batch.pl_extra_score[pid, :nc]))

    covered = set()
    if expl_planes is not None:
        verdict, score, avail, outcome = expl_planes
        for i in range(len(part)):
            if batch.route[i] != tensors.ROUTE_DEVICE:
                continue
            covered.add(i)
            planes_row(i, verdict[i, :nc], score[i, :nc], avail[i, :nc],
                       outcome[i], "device")
    for b, (vrow, srow, arow, oc) in sp_expl.items():
        covered.add(b)
        planes_row(b, vrow, srow, arow, oc, "device-spread")
    for i, r in out_local.items():
        if i not in covered:
            recorder.record(obs_decisions.decision_from_result(
                key_of(i), r, nc, backend="device-big"))


@dataclass
class _InFlight:
    offset: int
    part: Sequence
    batch: object
    handle: Optional[solver.CompactHandle]
    used0: Optional[tuple]  # the dispatch's carry-in
    # shortlist truncation residual: chunk-local rows solved per binding
    # at full width in finalize, and the full-vocabulary carry snapshot
    # they price against (the chunk's own used0 lives in the sub
    # vocabulary, blind to lanes outside the union)
    residual: List[int] = field(default_factory=list)
    resid_used0: Optional["tensors.CarryState"] = None
    # the chunk's pipeline.chunk span (None when tracing is off)
    span: object = None


def _host(used) -> tuple:
    return tuple(u.cpu().numpy() if torch.is_tensor(u) else np.asarray(u)
                 for u in used)


def run_pipeline(
    items: Sequence[Tuple],
    cindex: "tensors.ClusterIndex",
    estimator,
    *,
    chunk: int,
    waves: int = 8,
    cache: Optional["tensors.EncoderCache"] = None,
    carry: bool = True,
    enable_empty_workload_propagation: bool = False,
    explain: Optional["obs_decisions.DecisionRecorder"] = None,
    keys: Optional[Sequence[str]] = None,
    shortlist: Optional["sl.ShortlistConfig"] = None,
    device=None,
    encode: Optional[Callable[[Sequence, int, bool], object]] = None,
    carry_state: Optional["tensors.CarryState"] = None,
    collect_carry: bool = False,
    carry_spread: bool = True,
    cancelled: Optional[threading.Event] = None,
) -> PipelineResult:
    """Schedule `items` ((spec, status) pairs) chunk by chunk on `device`
    (the card by default).  `results` maps global item index ->
    List[TargetCluster] | Exception for every row on a device route
    (DEVICE_ROUTES; main-route FitErrors carry the per-cluster
    diagnosis); host-routed rows are absent.  With `carry`, the spread and
    big-tier sub-solves price against their chunk's carry-in and feed
    their consumption back (module docstring).

    explain: a DecisionRecorder arming the explain plane; every device
      row gets one Decision (main and spread rows with per-cluster verdict
      tables, the others outcome-level).  None launches nothing for it.
    keys: per-item binding identities ("namespace/name") for the
      decisions; derived from each spec's workload when omitted.
    shortlist: a ShortlistConfig arming the two-tier solve (module
      docstring); None keeps every chunk dense.
    encode: the chunk encoder, `encode(part, offset, explain) ->
      SolverBatch`; the resident plane (resident/state.py) substitutes its
      gather-plus-miss-re-encode here.  The batch must equal a fresh full
      encode (the plane's audit enforces that).  Default:
      tensors.encode_batch against `cindex` / `cache`.
    carry_state: seed the carry chain with consumption from a previous run
      (needs carry=True): the incremental plane's ledger.  The seed object
      is not mutated.
    collect_carry: return the run's cumulative consumption (seed + every
      chunk's own) as PipelineResult.carry (one host sync at the end).
    carry_spread: with carry, the spread and big-tier sub-solves price
      against their chunk's carry-in and feed their consumption back (the
      JAX Scheduler's carry_spread=carry); False prices them against the
      raw snapshot, as the JAX incremental solver runs them.
    cancelled: the mid-serve guard's event (module docstring); once set,
      the run stops launching and records nothing more."""
    device = resolve_device(device)
    res = PipelineResult()
    n = len(items)
    if n == 0:
        return res
    if chunk <= 0:
        raise ValueError("chunk size must be positive")
    cache = cache if cache is not None else tensors.EncoderCache()
    keep_sel = enable_empty_workload_propagation
    chain = _CarryChain() if carry else None
    if carry_state is not None:
        if chain is None:
            raise ValueError("carry_state seeding requires carry=True")
        # merge copies every array on first insert: the caller's seed
        # stays untouched however the chain mutates its store
        chain.total.merge(carry_state)
    armed = explain is not None

    def live() -> bool:
        return cancelled is None or not cancelled.is_set()

    # flight recorder: one pipeline.cycle span (a child of the ambient
    # scheduler.cycle span when the Scheduler drives the run); `traced`
    # is the one guard every per-chunk site checks, so the disabled path
    # makes no span.  Stage spans time what the host sees: the wait span
    # is the host's synchronise, and no span adds one.
    tracer = obs.TRACER
    traced = tracer.enabled
    cyc = (tracer.start_span(obs.SPAN_PIPELINE, items=n, chunk=chunk,
                             waves=waves, carry=carry)
           if traced else None)

    if shortlist is not None:
        res.shortlist = {"chunks": 0, "fallbacks": {}, "widened": 0,
                         "residual_rows": 0, "unions": [],
                         "cells_solve": 0, "cells_dense": 0}

    def finalize(entry: _InFlight) -> None:
        batch, part = entry.batch, entry.part
        ch_span = entry.span

        def stage(name):
            # stage spans parent on the chunk's span, not the ambient
            # context: chunks interleave (k+1 encodes before k finalizes)
            return (tracer.start_span(name, parent=ch_span)
                    if ch_span is not None else None)

        t_start = time.perf_counter()
        w_span = stage(obs.SPAN_WAIT) if entry.handle is not None else None
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_wait = time.perf_counter()
        if w_span is not None:
            w_span.end()
        res.wait_s += t_wait - t_start
        if not live():
            if ch_span is not None:
                ch_span.end(n_ok=0)
            return  # abandoned: nothing it computed may escape
        # spread-route explain rows land here via solve_spread's callback
        sp_expl: Dict[int, tuple] = {}

        def sp_cb(b, vrow, srow, arow, oc):
            sp_expl[b] = (vrow, srow, arow, oc)

        # the sub-solves first: they need no main result
        sub: Dict[int, object] = {}
        groups = tensors.spread_groups(batch, part)
        big_idx = [i for i in range(len(part))
                   if batch.route[i] == tensors.ROUTE_DEVICE_BIG]
        used0 = None
        if carry_spread and chain is not None and (
                entry.used0 is not None) and (groups or big_idx):
            used0 = _host(entry.used0)
        collect = used0 is not None
        sp_span = stage(obs.SPAN_SPREAD) if groups else None
        for (axis, tier), idxs in groups.items():
            ret = spread.solve_spread(
                batch, part, idxs, waves=waves,
                enable_empty_workload_propagation=keep_sel,
                collect_used=collect, used0=used0, axis=axis, tier=tier,
                device=device, explain=armed,
                explain_cb=sp_cb if armed else None)
            out, used = ret if collect else (ret, None)
            if used is not None:
                chain.extras.absorb(batch, used, used0)
            sub.update(out)
        if sp_span is not None:
            sp_span.end(groups=len(groups))
        t_spread = time.perf_counter()
        if big_idx:
            big_span = stage(obs.SPAN_BIG)
            ret = solver.solve_big(
                part, big_idx, cindex, estimator, cache, waves=waves,
                enable_empty_workload_propagation=keep_sel,
                collect_used=collect, used0=used0, from_batch=batch,
                device=device)
            out, big_used = ret if collect else (ret, None)
            if big_used is not None:
                chain.extras.absorb(*big_used)
            sub.update(out)
            if big_span is not None:
                big_span.end(rows=len(big_idx))
        if entry.residual:
            # rows whose eligible set outgrew k_max, at full width against
            # the consumption of every chunk before this one (exact at
            # waves=1: a chunk's rows never see each other there); their
            # results override the sub-solve's invalidated rows below
            collect_r = chain is not None and entry.resid_used0 is not None
            ret = solver.solve_rows(
                part, entry.residual, cindex, estimator, cache,
                route=tensors.ROUTE_DEVICE, waves=waves,
                enable_empty_workload_propagation=keep_sel,
                collect_used=collect_r, used0=entry.resid_used0,
                device=device)
            out, r_used = ret if collect_r else (ret, None)
            if r_used is not None:
                chain.extras.absorb(*r_used)
            sub.update(out)
        t_big = time.perf_counter()
        res.spread_s += t_spread - t_wait
        res.big_s += t_big - t_spread
        if not live():
            if ch_span is not None:
                ch_span.end(n_ok=0)
            return
        local: Dict[int, object] = {}
        expl_planes = None
        if entry.handle is not None:
            d2h_span = stage(obs.SPAN_D2H)
            fin = solver.finalize_compact(entry.handle)
            idx, val, status = fin[:3]
            if armed:
                expl_planes = fin[-1]  # (verdict, score, avail, outcome)
            t_read = time.perf_counter()
            if d2h_span is not None:
                d2h_span.end()
            dec_span = stage(obs.SPAN_DECODE)
            decoded = tensors.decode_compact(
                batch, idx, val, status,
                enable_empty_workload_propagation=keep_sel,
                items=part,
                outcome=expl_planes[3] if expl_planes is not None else None)
            if dec_span is not None:
                dec_span.end()
            res.finalize_s += t_read - t_big
            res.decode_s += time.perf_counter() - t_read
            local = {i: decoded[i] for i in range(len(part))
                     if batch.route[i] == tensors.ROUTE_DEVICE}
        local.update(sub)
        if armed:
            t_ex = time.perf_counter()
            _record_decisions(explain, batch, part, entry.offset, keys,
                              local, expl_planes, sp_expl)
            res.explain_s += time.perf_counter() - t_ex
        res.chunks += 1
        n_ok = 0
        for i, r in local.items():
            res.results[entry.offset + i] = r
            if isinstance(r, Exception):
                k = type(r).__name__
                res.failures[k] = res.failures.get(k, 0) + 1
            else:
                n_ok += 1
        res.scheduled += n_ok
        if ch_span is not None:
            ch_span.end(n_ok=n_ok)

    pending: Optional[_InFlight] = None
    try:
        for lo in range(0, n, chunk):
            if not live():
                break
            part = items[lo:lo + chunk]
            t0 = time.perf_counter()
            ch_span = enc_span = None
            if traced:
                ch_span = tracer.start_span(obs.SPAN_CHUNK, parent=cyc,
                                            index=lo // chunk, offset=lo,
                                            n=len(part))
                enc_span = tracer.start_span(obs.SPAN_ENCODE, parent=ch_span)
            batch = (encode(part, lo, armed) if encode is not None
                     else tensors.encode_batch(part, cindex, estimator,
                                               cache=cache, explain=armed))
            t1 = time.perf_counter()
            for r, k in zip(*np.unique(batch.route[:len(part)],
                                       return_counts=True)):
                res.routes[int(r)] = res.routes.get(int(r), 0) + int(k)
            residual: List[int] = []
            resid_used0 = None
            if shortlist is not None:
                # tier selection: a covered chunk swaps in its
                # sub-vocabulary batch, which the dispatch/decode/carry
                # below run unchanged; a fallback keeps the dense batch.  Truncation only at
                # waves=1 (rows never see each other's consumption there)
                # and without keep_sel (it needs the full selection plane).
                sub_b, info = sl.shrink_chunk(
                    batch, shortlist,
                    allow_truncate=(waves == 1 and not keep_sel),
                    device=device, part=part)
                st = res.shortlist
                if sub_b is not None:
                    batch = sub_b
                    residual = info["residual"]
                    st["chunks"] += 1
                    st["widened"] += info["widened"]
                    st["residual_rows"] += len(residual)
                    st["unions"].append(info["union"])
                    st["cells_solve"] += info["cells_solve"]
                    st["cells_dense"] += info["cells_dense"]
                    if residual and chain is not None:
                        # the full-vocabulary carry-in, taken BEFORE this
                        # chunk's dispatch: the chunks before it, exactly
                        resid_used0 = chain.snapshot()
                else:
                    why = info["fallback"]
                    st["fallbacks"][why] = st["fallbacks"].get(why, 0) + 1
                if ch_span is not None:
                    ch_span.set_attr(shortlist=(
                        f"union={info['union']} k={info['k']}"
                        if sub_b is not None
                        else info.get("fallback", "off")))
            t2 = time.perf_counter()
            if enc_span is not None:
                enc_span.end()
            if not live():
                break
            handle = used0 = None
            # with carry every chunk dispatches so the chain stays contiguous
            # (an all-host batch consumes nothing); without it an all-host
            # chunk skips the card.  The check reads the host `route`, never a
            # fused batch's device b_valid
            if chain is not None or bool(
                    np.any(np.asarray(batch.route) == tensors.ROUTE_DEVICE)):
                d_span = (tracer.start_span(obs.SPAN_DISPATCH, parent=ch_span)
                          if ch_span is not None else None)
                used0 = chain.carry_in(batch) if chain is not None else None
                handle = solver.dispatch_compact(
                    batch, waves=waves, keep_sel=keep_sel,
                    with_used=chain is not None, used0=used0, device=device,
                    explain=armed)
                if d_span is not None:
                    d_span.end()
                if chain is not None:
                    chain.dispatched(batch, handle)
            res.encode_s += t1 - t0
            res.shortlist_s += t2 - t1
            res.dispatch_s += time.perf_counter() - t2
            entry = _InFlight(offset=lo, part=part, batch=batch,
                              handle=handle, used0=used0, residual=residual,
                              resid_used0=resid_used0, span=ch_span)
            if pending is not None:
                finalize(pending)
            pending = entry
        if pending is not None and live():
            finalize(pending)
        if chain is not None and collect_carry and live():
            res.carry = chain.snapshot()
    finally:
        res.cancelled = not live()
        if cyc is not None:
            # nested under a scheduler.cycle trace the root's end
            # force-closes any still-open chunk / stage span; a root
            # pipeline.cycle does the same itself
            cyc.end(cancelled=res.cancelled, chunks=res.chunks,
                    scheduled=res.scheduled)
    return res
