"""ResidentState: solver tensors kept between cycles, advanced by deltas.

Counterpart of the JAX package's ``resident/state.py``.  A cycle without
it rebuilds the whole SolverBatch from Python objects (ops/tensors
encode_batch).  The plane keeps instead:

  * the cluster/placement-side tensors (the arrays ops/solver reads, named
    per ops/tensors.FIELD_DTYPES) as FROZEN copy-on-write numpy masters
    between cycles, advanced by coalesced cluster deltas
    (resident/deltas.py): a capacity flap recomputes one cluster's lanes;
  * their device mirrors, advanced by one fused K10 scatter of the
    churned lanes per sync (ops/resident_update.scatter_fields) and
    primed into the solver's device-transfer cache
    (ops/solver.prime_cluster_slot), so a dispatch uploads none of them;
  * per-binding encoded rows in a slot store keyed by (namespace/name,
    resourceVersion): a cycle re-encodes only churned bindings, through
    the real encode_batch on the miss subset, whose vocabulary (placement,
    class, GVK, resource) is merged into the resident one; with
    `fused=True` the slot store is mirrored on the card too and a chunk's
    rows are gathered there by K11 (ops/resident_gather), so a warm chunk
    uploads only its [B] slot vector.

Any structural change (cluster membership/spec/labels, the plugin
registry, a failed audit) resets the plane; the next encode is one full
encode_batch whose tensors become the new masters.  The audit re-encodes a
cycle from scratch and compares bit for bit (compare_batches); a mismatch
rebuilds the plane and the fresh batch serves the cycle.

No path degrades silently: a failed mirror sync, scatter or gather raises.
The fallbacks taken by design are counted: explain-armed chunks take the
host assemble (gather_fallbacks["explain"]), structural changes rebuild
(rebuilds), an audit mismatch adopts the fresh batch (audit_mismatches).

Driven single-threaded from one cycle loop; stats are plain ints.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from karmada_tpu_torch import chaos as chaos_mod
from karmada_tpu_torch import obs
from karmada_tpu_torch.device import resolve_device
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.models.work import ResourceBindingStatus
from karmada_tpu_torch.ops import resident_gather, resident_update, serial
from karmada_tpu_torch.ops import solver as solver_mod
from karmada_tpu_torch.ops import tensors
from karmada_tpu_torch.resident.deltas import (
    API,
    CAPACITY,
    STRUCTURAL,
    CycleDeltas,
    _RANK,
    classify_change,
)
from karmada_tpu_torch.utils.metrics import REGISTRY

# -- observability ------------------------------------------------------------
RESIDENT_GENERATION = REGISTRY.gauge(
    "karmada_resident_generation",
    "Structural generation of the resident state plane (bumps on every "
    "full rebuild; 0 = no plane adopted yet)",
)
RESIDENT_VOCAB = REGISTRY.gauge(
    "karmada_resident_vocab_size",
    "Entries per resident vocabulary axis",
    ("axis",),
)
RESIDENT_ROWS = REGISTRY.gauge(
    "karmada_resident_rows_cached",
    "Encoded binding rows currently cached in the resident slot store",
)
RESIDENT_LOOKUPS = REGISTRY.counter(
    "karmada_resident_row_lookups_total",
    "Per-binding row-cache lookups by result (hit = gathered from the "
    "resident store, miss = re-encoded via encode_batch)",
    ("result",),
)
RESIDENT_REBUILDS = REGISTRY.counter(
    "karmada_resident_rebuilds_total",
    "Full resident-plane rebuilds (lossless fallback to encode_batch) "
    "by reason",
    ("reason",),
)
RESIDENT_AUDITS = REGISTRY.counter(
    "karmada_resident_audits_total",
    "Resident-vs-full-encode parity audits by outcome (a mismatch "
    "forces a rebuild and the fresh batch serves the cycle)",
    ("outcome",),
)
RESIDENT_DELTAS = REGISTRY.counter(
    "karmada_resident_cluster_deltas_total",
    "Coalesced cluster deltas applied to the resident plane by class",
    ("kind",),
)
RESIDENT_GATHER_FALLBACKS = REGISTRY.counter(
    "karmada_resident_gather_fallbacks_total",
    "Cycles the fused device-gather path fell back to the host assemble "
    "control by reason (explain = explain plane armed for the chunk, "
    "device-rows = slot-store mirror sync failed/degraded)",
    ("reason",),
)

_ROUTE_DEVICE = tensors.ROUTE_DEVICE


@dataclass
class ResidentPlane:
    """The persistent tensor set (numpy masters, frozen between writes).

    Cluster/placement-side fields are the arrays dispatch reads, shared
    verbatim into every cycle's SolverBatch; binding-axis fields are the
    slot store the per-cycle gather reads."""

    # cluster axis
    cluster_valid: np.ndarray
    deleting: np.ndarray
    name_rank: np.ndarray
    pods_allowed: np.ndarray
    has_summary: np.ndarray
    avail_milli: np.ndarray
    has_alloc: np.ndarray
    api_ok: np.ndarray
    # request classes
    req_milli: np.ndarray
    req_is_cpu: np.ndarray
    req_pods: np.ndarray
    est_override: np.ndarray
    # placements
    pl_mask: np.ndarray
    pl_tol_bypass: np.ndarray
    pl_strategy: np.ndarray
    pl_static_w: np.ndarray
    pl_has_cluster_sc: np.ndarray
    pl_sc_min: np.ndarray
    pl_sc_max: np.ndarray
    pl_ignore_avail: np.ndarray
    pl_extra_score: np.ndarray
    region_id: np.ndarray
    pl_has_region_sc: np.ndarray
    pl_region_min: np.ndarray
    pl_region_max: np.ndarray
    # binding-axis slot store (gathered per cycle)
    placement_id: np.ndarray
    gvk_id: np.ndarray
    class_id: np.ndarray
    replicas: np.ndarray
    uid_desc: np.ndarray
    fresh: np.ndarray
    non_workload: np.ndarray
    nw_shortcut: np.ndarray
    route: np.ndarray
    prev_idx: np.ndarray
    prev_val: np.ndarray
    evict_idx: np.ndarray


#: the cluster/placement-side plane fields, in ops/solver._CLUSTER_FIELDS
#: order (the device-slot priming contract)
CLUSTER_SIDE_FIELDS = solver_mod._CLUSTER_FIELDS  # noqa: SLF001
#: the spread-topology fields the dispatch reads off the batch
SHARED_EXTRA_FIELDS = (
    "region_id", "pl_has_region_sc", "pl_region_min", "pl_region_max",
)
BINDING_SLOT_FIELDS = (
    "placement_id", "gvk_id", "class_id", "replicas", "uid_desc",
    "fresh", "non_workload", "nw_shortcut", "route",
)
#: fields whose device mirror advances by a cluster-lane row scatter
#: (leading axis C)
ROW_SCATTER_FIELDS = frozenset({
    "cluster_valid", "deleting", "name_rank", "pods_allowed", "has_summary",
    "avail_milli", "has_alloc",
})
#: fields whose device mirror advances by a column scatter (trailing C)
COL_SCATTER_FIELDS = frozenset({"est_override", "api_ok"})
#: the slot store's device-mirror field set (fused gather path)
DEVICE_SLOT_FIELDS = BINDING_SLOT_FIELDS + (
    "prev_idx", "prev_val", "evict_idx")
assert DEVICE_SLOT_FIELDS == resident_gather.GATHER_FIELDS


class RowToken:
    """Identity + validity of one binding's cached encoded row."""

    __slots__ = ("key", "rv")

    def __init__(self, key: str, rv: int) -> None:
        self.key = key
        self.rv = rv


class _Row:
    __slots__ = ("slot", "rv")

    def __init__(self, slot: int, rv: int) -> None:
        self.slot = slot
        self.rv = rv


def _freeze(arr: np.ndarray) -> np.ndarray:
    if isinstance(arr, np.ndarray) and arr.flags.owndata:
        arr.flags.writeable = False
    return arr


class _Txn:
    """Copy-on-write transaction over the frozen plane masters: first
    access of a field copies it writable; commit() freezes the copies,
    swaps them into the plane, and reports which fields changed."""

    def __init__(self, plane: ResidentPlane) -> None:
        self.plane = plane
        self._w: Dict[str, np.ndarray] = {}

    def get(self, field: str) -> np.ndarray:
        arr = self._w.get(field)
        if arr is None:
            arr = np.array(getattr(self.plane, field))  # writable copy
            self._w[field] = arr
        return arr

    def commit(self) -> List[str]:
        for f, arr in self._w.items():
            setattr(self.plane, f, _freeze(arr))
        return list(self._w)


class _DevicePlane:
    """Device mirrors of the cluster-side masters, advanced by K10 and
    primed into the solver's device-transfer cache."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.mirrors: Dict[str, torch.Tensor] = {}
        self.np_refs: Dict[str, np.ndarray] = {}

    def sync(self, plane: ResidentPlane, dirty: Dict[str, object]) -> bool:
        """Advance the mirrors to the current masters and prime the
        solver's cache.  `dirty` maps field -> lane array for fields whose
        change is a pure lane/column rewrite: those scatter, all in one
        resident_update.scatter_fields call (one staged upload, one K10
        launch); any other identity change re-places the whole field.
        Returns True when primed."""
        items = []
        for f in CLUSTER_SIDE_FIELDS:
            master = getattr(plane, f)
            if self.np_refs.get(f) is master:
                continue
            mirror = self.mirrors.get(f)
            lanes = dirty.get(f)
            if (mirror is not None and lanes is not None
                    and tuple(mirror.shape) == master.shape
                    and f in ROW_SCATTER_FIELDS | COL_SCATTER_FIELDS):
                if f in ROW_SCATTER_FIELDS:
                    items.append((mirror, lanes, master[lanes], "rows"))
                else:
                    items.append((mirror, lanes, master[..., lanes], "cols"))
            else:
                mirror = resident_gather.place_slot(master, self.device)
            self.mirrors[f] = mirror
            self.np_refs[f] = master
        resident_update.scatter_fields(items, self.device)
        return solver_mod.prime_cluster_slot(
            tuple(self.np_refs[f] for f in CLUSTER_SIDE_FIELDS),
            tuple(self.mirrors[f] for f in CLUSTER_SIDE_FIELDS),
            self.device)


class _DeviceRows:
    """Device mirrors of the binding-axis slot store (the fused gather
    path).  The masters stay the host source of truth; the mirrors advance
    by one fused K10 scatter of exactly the churned slots per sync (every
    field's rows staged in one buffer, one upload, one launch), in place,
    and are re-placed whole on geometry changes (slot-capacity growth,
    sparse-width growth, rebuild).  In place is safe on the one stream:
    every gather enqueued before a scatter has run before it, and wrote
    its own output buffers."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.mirrors: Dict[str, torch.Tensor] = {}

    def sync(self, plane: ResidentPlane, dirty) -> None:
        """`dirty` is None (clean), "full" (re-place every field) or an
        int64 array of churned slots (scatter)."""
        full = isinstance(dirty, str) or not self.mirrors
        if not full and dirty is None:
            return
        items = []
        for f in DEVICE_SLOT_FIELDS:
            master = getattr(plane, f)
            mirror = self.mirrors.get(f)
            if (not full and mirror is not None
                    and tuple(mirror.shape) == master.shape):
                items.append((mirror, dirty, master[dirty], "rows"))
            else:
                self.mirrors[f] = resident_gather.place_slot(
                    master, self.device)
        resident_update.scatter_fields(items, self.device)
        if not full:
            resident_gather.COUNTS["row_scatters"] += len(dirty)
            resident_gather.GATHER_SCATTERS.inc(len(dirty))


class AuditMismatch(Exception):
    """Raised internally when the parity audit finds divergence."""

    def __init__(self, fields: List[str]) -> None:
        super().__init__(f"resident-vs-full-encode mismatch: {fields}")
        self.fields = fields


class ResidentState:
    """The resident state plane of one scheduler's device path, on
    `device` (the first CUDA card by default; "cpu" runs the kernels'
    plain versions)."""

    def __init__(self, estimator: Optional[GeneralEstimator] = None,
                 audit_interval: int = 64, fused: bool = False,
                 device=None) -> None:
        self.estimator = estimator or GeneralEstimator()
        self.audit_interval = max(0, int(audit_interval))
        self.device = resolve_device(device)
        self.device_mirrors = _DevicePlane(self.device)
        # fused path: the slot store mirrors on the card and a chunk's rows
        # gather there; the host assemble stays the control (explain-armed
        # chunks and rebuild cycles take it)
        self.fused = bool(fused)
        self.device_rows = _DeviceRows(self.device) if self.fused else None
        # None = mirrors clean, "full" = re-place everything, int64 lanes =
        # scatter exactly these slots
        self._rows_dirty: object = "full"

        self.plane: Optional[ResidentPlane] = None
        self.cindex: Optional[tensors.ClusterIndex] = None
        self.clusters: List = []
        self.cluster_rvs: List[int] = []
        self.names: List[str] = []
        self.nC = 0
        self.C = 0
        # vocabularies (append-only between rebuilds)
        self.res_names: List[str] = []
        self.class_keys: List = []
        self.class_reqs: List = []
        self.placements: List = []
        self.pkeys: Dict[str, int] = {}
        self.gvk_keys: List[Tuple[str, str]] = []
        self.gvks: Dict[Tuple[str, str], int] = {}
        self.region_names: List[str] = []
        self.label_axes: Dict[str, tuple] = {}
        self.plugins_gen: Optional[int] = None
        self.enc_cache = tensors.EncoderCache()
        # binding-row slot store
        self.rows: Dict[str, _Row] = {}
        self._free: List[int] = []
        self._next_slot = 0
        self.Kp = 4
        self.Ke = 4
        # explain plane: per-placement static fail-bit rows (+ assembled)
        self._fail_rows: Dict[int, np.ndarray] = {}
        self._fail_plane: Optional[Tuple[tuple, np.ndarray]] = None
        # device-mirror dirtiness accumulated since the last sync
        self._dirty: Dict[str, object] = {}
        self._device_primed = False
        # lanes whose `deleting` value or api_ok column CHANGED in the last
        # begin_cycle window: the only feasibility inputs a non-structural
        # delta moves (the incremental dirty pass expands them into rows)
        self.last_flip_lanes: np.ndarray = np.zeros(0, np.int64)
        # capacity-updated lanes of the last window: the incremental plane
        # retires its carried-consumption ledger on these
        self.last_cap_lanes: np.ndarray = np.zeros(0, np.int64)

        self.generation = 0
        self.cycles = 0
        self.fused_cycles = 0
        self.host_cycles = 0
        self.gather_fallbacks: Dict[str, int] = {}
        self.hits = 0
        self.misses = 0
        self.rebuilds: Dict[str, int] = {}
        self.audits_ok = 0
        self.audit_mismatches = 0
        self.last_audit: Optional[dict] = None
        self.last_deltas: dict = {}

    # -- lifecycle -----------------------------------------------------------
    def fork_clusters(self) -> List:
        """A deep-copied fork of the plane's member-cluster view for
        hypothetical (what-if) solves: the mirrors on the device are not
        touched (a detached solve encodes its own batch), and the
        host-side Cluster objects are the only tier a caller could
        mutate, so the fork copies exactly those.  Returns [] before the
        first begin_cycle (the caller falls back to a store snapshot)."""
        import copy

        return [copy.deepcopy(c) for c in self.clusters]

    def begin_cycle(self, clusters: Sequence,
                    deltas: Optional[CycleDeltas] = None) -> None:
        """Advance the plane to this cycle's cluster snapshot: apply the
        coalesced deltas, or rebuild on any structural change.  Must run
        before the cycle's encode_cycle calls.  The deltas are a hint: the
        resourceVersion sweep classifies every lane whose rv moved against
        the retained previous snapshot, so the plane lands exactly on this
        snapshot whatever the deltas said."""
        from karmada_tpu_torch.scheduler.plugins import REGISTRY as _PLUGINS

        clusters = list(clusters)
        self.cycles += 1
        self.last_flip_lanes = np.zeros(0, np.int64)
        self.last_cap_lanes = np.zeros(0, np.int64)
        reason = None
        changed: Dict[str, str] = dict(deltas.clusters) if deltas else {}
        if self.plane is None:
            reason = "init"
        elif self.plugins_gen != _PLUGINS.generation:
            reason = "plugin-registry"
        elif deltas is not None and deltas.structural:
            reason = deltas.structural_reason or "cluster-structural"
        elif [c.name for c in clusters] != self.names:
            reason = "membership"
        else:
            for lane, new in enumerate(clusters):
                rv = new.metadata.resource_version
                if rv == self.cluster_rvs[lane]:
                    continue
                cls, why = classify_change(self.clusters[lane], new)
                if cls == STRUCTURAL:
                    reason = why
                    break
                prev = changed.get(new.metadata.name)
                if prev is None or _RANK[cls] > _RANK[prev]:
                    changed[new.metadata.name] = cls
        with obs.TRACER.span(obs.SPAN_RESIDENT_APPLY,
                             clusters=len(clusters),
                             structural=bool(reason),
                             deltas=len(changed)):
            if reason is not None:
                self._reset(clusters, reason)
            else:
                self.clusters = clusters
                self.cluster_rvs = [
                    c.metadata.resource_version for c in clusters]
                # the cycle's miss encodes, audits and big-tier sub-solves
                # read THIS snapshot's objects (capacity lives on them)
                self.cindex = tensors.ClusterIndex.build(clusters)
                # placement-key pins hold the previous cycle's bindings
                self.enc_cache.placement_keys = {}
                if changed:
                    self._apply(CycleDeltas(
                        clusters=changed,
                        binding_events=(deltas.binding_events
                                        if deltas else 0)))
            if deltas is not None:
                for key in deltas.bindings_deleted:
                    self.forget(f"{key[0]}/{key[1]}")
        self.plugins_gen = _PLUGINS.generation

    def _reset(self, clusters: List, reason: str) -> None:
        """Drop to the lossless fallback: the next encode_cycle is one full
        encode_batch whose tensors become the new masters."""
        self.plane = None
        self.cindex = tensors.ClusterIndex.build(clusters)
        self.clusters = clusters
        self.cluster_rvs = [c.metadata.resource_version for c in clusters]
        self.names = [c.name for c in clusters]
        self.nC = len(clusters)
        self.C = tensors._next_pow2(max(self.nC, 1), 8)  # noqa: SLF001
        self.res_names = []
        self.class_keys = []
        self.class_reqs = []
        self.placements = []
        self.pkeys = {}
        self.gvk_keys = []
        self.gvks = {}
        self.region_names = []
        self.label_axes = {}
        self.enc_cache = tensors.EncoderCache()
        self.rows = {}
        self._free = []
        self._next_slot = 0
        self.Kp = 4
        self.Ke = 4
        self._fail_rows = {}
        self._fail_plane = None
        self._dirty = {}
        self._device_primed = False
        # mirrors of the retired generation must not be scatter-based
        self.device_mirrors.np_refs = {}
        if self.device_rows is not None:
            self.device_rows.mirrors = {}
        self._rows_dirty = "full"
        self.generation += 1
        RESIDENT_GENERATION.set(float(self.generation))
        RESIDENT_REBUILDS.inc(reason=reason)
        self.rebuilds[reason] = self.rebuilds.get(reason, 0) + 1

    # -- delta application ---------------------------------------------------
    def _apply(self, deltas: CycleDeltas) -> None:
        cap_lanes: List[int] = []
        api_lanes: List[int] = []
        idx = self.cindex.index
        for name, kind in deltas.clusters.items():
            lane = idx.get(name)
            if lane is None:
                continue  # membership drift; begin_cycle's names check owns it
            RESIDENT_DELTAS.inc(kind=kind)
            if kind == CAPACITY:
                cap_lanes.append(lane)
            elif kind == API:
                # an api change rides on a status write: refresh both
                api_lanes.append(lane)
                cap_lanes.append(lane)
        by_lane = dict(enumerate(self.clusters))
        if cap_lanes:
            self.last_cap_lanes = np.asarray(sorted(set(cap_lanes)),
                                             np.int64)
            self._apply_capacity(sorted(set(cap_lanes)), by_lane)
        if api_lanes:
            self._apply_api(sorted(set(api_lanes)), by_lane)
        self.last_deltas = {"capacity": len(cap_lanes),
                            "api": len(api_lanes),
                            "binding_events": deltas.binding_events}

    def _apply_capacity(self, lanes: List[int],
                        by_lane: Dict[int, object]) -> None:
        """Recompute the churned clusters' capacity lanes: encode_batch's
        arithmetic restricted to `lanes` (the audit holds it bit-exact)."""
        txn = _Txn(self.plane)
        deleting = txn.get("deleting")
        has_summary = txn.get("has_summary")
        pods_allowed = txn.get("pods_allowed")
        avail_milli = txn.get("avail_milli")
        has_alloc = txn.get("has_alloc")
        est_override = txn.get("est_override") if self.class_keys else None
        modeling = self.estimator.enable_resource_modeling
        max_for = self.estimator._max_for_cluster  # noqa: SLF001
        flips: List[int] = []
        for lane in lanes:
            c = by_lane[lane]
            s = c.status.resource_summary
            if bool(deleting[lane]) != bool(c.metadata.deleting):
                # the one feasibility input a status write can move
                flips.append(lane)
            deleting[lane] = c.metadata.deleting
            has_summary[lane] = s is not None
            pods_allowed[lane] = (tensors._allowed_pods(s)  # noqa: SLF001
                                  if s is not None else 0)
            avail_milli[lane, :] = 0
            has_alloc[lane, :] = False
            if s is not None:
                for r, name in enumerate(self.res_names):
                    alloc = s.allocatable.get(name)
                    if alloc is None:
                        continue
                    has_alloc[lane, r] = True
                    m = alloc.milli
                    used = s.allocated.get(name)
                    if used is not None:
                        m -= used.milli
                    ing = s.allocating.get(name)
                    if ing is not None:
                        m -= ing.milli
                    avail_milli[lane, r] = m
            if est_override is not None:
                modeled = (modeling and s is not None
                           and s.allocatable_modelings)
                for q, rr in enumerate(self.class_reqs):
                    if modeled and not isinstance(
                            rr, tensors._SetClass):  # noqa: SLF001
                        est_override[q, lane] = max_for(c, rr)
                    else:
                        est_override[q, lane] = -1
        changed = txn.commit()
        lanes_arr = np.asarray(lanes, np.int64)
        for f in changed:
            self._mark_dirty(f, lanes_arr)
        if flips:
            self.last_flip_lanes = np.union1d(
                self.last_flip_lanes, np.asarray(flips, np.int64))
        self._invalidate_enc_cache()

    def _apply_api(self, lanes: List[int],
                   by_lane: Dict[int, object]) -> None:
        if not self.gvk_keys:
            return
        txn = _Txn(self.plane)
        api_ok = txn.get("api_ok")
        flips: List[int] = []
        for lane in lanes:
            c = by_lane[lane]
            old_col = api_ok[:, lane].copy()
            for g, (api_version, kind) in enumerate(self.gvk_keys):
                api_ok[g, lane] = (
                    c.api_enablement(api_version, kind) == serial.API_ENABLED)
            if not np.array_equal(old_col, api_ok[:, lane]):
                flips.append(lane)  # an api_ok flip is a feasibility flip
        if flips:
            self.last_flip_lanes = np.union1d(
                self.last_flip_lanes, np.asarray(flips, np.int64))
        for f in txn.commit():
            self._mark_dirty(f, np.asarray(lanes, np.int64))
        # gvk rows cached in the encoder are stale for these clusters
        self.enc_cache.gvk_rows = {}
        self._invalidate_enc_cache()

    def _invalidate_enc_cache(self) -> None:
        """Status-derived encoder-cache entries went stale; pods_allowed
        re-points at the (already updated) master."""
        c = self.enc_cache
        c.override_rows = {}
        c.assembled = None
        c.assembled_sig = None
        c.cluster_axis = None
        c.pods_allowed = (self.plane.pods_allowed if self.plane is not None
                          else None)

    def _mark_dirty(self, field: str, lanes: Optional[np.ndarray]) -> None:
        """Accumulate device-mirror dirtiness: lane-scatterable changes
        merge their lane sets; anything else escalates to a re-place."""
        if lanes is None or (field not in ROW_SCATTER_FIELDS
                             and field not in COL_SCATTER_FIELDS):
            self._dirty[field] = None
            return
        prev = self._dirty.get(field, _MISSING)
        if prev is _MISSING:
            self._dirty[field] = lanes
        elif prev is not None:
            self._dirty[field] = np.union1d(prev, lanes)
        self._device_primed = False

    # -- the per-cycle encoder -----------------------------------------------
    def encode_cycle(self, items: Sequence,
                     tokens: Optional[Sequence[Optional[RowToken]]] = None,
                     explain: bool = False,
                     audit: Optional[bool] = None) -> tensors.SolverBatch:
        """Encode one cycle chunk: cached rows gather, churned rows
        re-encode through encode_batch and merge.  The SolverBatch is
        identical to a fresh full encode (the audit's bit-exact contract).
        `audit` forces/suppresses the parity audit (None = cadence)."""
        n = len(items)
        assert self.cindex is not None, "begin_cycle() before encode_cycle()"
        corrupted = False
        if self.plane is not None and chaos_mod.armed():
            # chaos seam (resident.mirror:corrupt): flip one value in a
            # resident master and force THIS cycle's parity audit -- the
            # corrupted batch must be caught by the audit and replaced by
            # the fresh encode before the solve reads it (an auditable
            # rebuild, never a wrong placement)
            f = chaos_mod.fire(chaos_mod.SITE_RESIDENT_MIRROR,
                               generation=self.generation)
            if f is not None and f.mode == "corrupt":
                self._chaos_corrupt()
                corrupted = True
                audit = True
        if self.plane is None:
            # lossless fallback: ONE full encode, adopted as masters
            batch = tensors.encode_batch(items, self.cindex, self.estimator,
                                         cache=self.enc_cache,
                                         explain=explain)
            self._adopt(batch, items, tokens)
            RESIDENT_LOOKUPS.inc(n, result="miss")
            self.misses += n
            self.sync_device()
            return batch

        slots = np.zeros(n, np.int64)
        miss_pos: List[int] = []
        hits = 0
        rows = self.rows
        for i in range(n):
            tok = tokens[i] if tokens is not None else None
            if tok is not None:
                row = rows.get(tok.key)
                if row is not None and row.rv == tok.rv:
                    slots[i] = row.slot
                    hits += 1
                    continue
            miss_pos.append(i)
        with obs.TRACER.span(obs.SPAN_RESIDENT_ENCODE, items=n,
                             hits=hits, misses=len(miss_pos),
                             fused=self.fused):
            if miss_pos:
                mini = tensors.encode_batch(
                    [items[i] for i in miss_pos], self.cindex,
                    self.estimator, cache=self.enc_cache)
                self._merge(mini, miss_pos, tokens, slots)
            batch = None
            if self.fused:
                if explain:
                    # the explain planes decode host-side per row
                    RESIDENT_GATHER_FALLBACKS.inc(reason="explain")
                    self.gather_fallbacks["explain"] = \
                        self.gather_fallbacks.get("explain", 0) + 1
                else:
                    batch = self._assemble_fused(slots, n)
            if batch is None:
                batch = self._assemble(items, slots, n, explain)
                self.host_cycles += 1
            else:
                self.fused_cycles += 1
        RESIDENT_LOOKUPS.inc(hits, result="hit")
        RESIDENT_LOOKUPS.inc(len(miss_pos), result="miss")
        self.hits += hits
        self.misses += len(miss_pos)
        run_audit = (audit if audit is not None
                     else (self.audit_interval > 0
                           and self.cycles % self.audit_interval == 0))
        if run_audit:
            solve_view = batch
            if corrupted:
                # the corruption travels as far as a real one would: the
                # same K10 sync a real update takes carries the flipped
                # lane to the card's mirror, and the audit compares its
                # fresh encode with the cluster side the solve would read
                # there
                self.sync_device()
                solve_view = self.mirror_view(batch)
            fresh = self.audit(items, solve_view, tokens, explain=explain)
            if fresh is not None:
                return fresh
        self.sync_device()
        return batch

    def _chaos_corrupt(self) -> None:
        """Bit-flip one live lane of a cluster-side master (the fault a
        bad copy or a buggy scatter kernel would produce), through the
        same copy-on-write transaction real updates use, and mark the
        mirror dirty so the corruption propagates exactly as far as a real
        one would.  pods_allowed on a valid lane: a value every solve
        reads and the parity audit compares unconditionally."""
        txn = _Txn(self.plane)
        arr = txn.get("pods_allowed")
        lane = max(self.nC - 1, 0) // 2
        arr[lane] += 1
        txn.commit()
        self._mark_dirty("pods_allowed", np.asarray([lane], np.int64))

    def mirror_view(self, batch: tensors.SolverBatch) -> tensors.SolverBatch:
        """`batch` with its cluster-side fields read back from the card's
        mirrors (what a solve of `batch` reads there); fields whose mirror
        does not hold the batch's master stay the batch's own."""
        dev = self.device_mirrors
        swap = {}
        for f in CLUSTER_SIDE_FIELDS:
            mirror = dev.mirrors.get(f)
            if mirror is not None and dev.np_refs.get(f) is getattr(batch, f):
                swap[f] = mirror.cpu().numpy()
        return dataclasses.replace(batch, **swap) if swap else batch

    def forget(self, key: str) -> None:
        """Drop one binding's cached row (binding deleted)."""
        row = self.rows.pop(key, None)
        if row is not None:
            self._free.append(row.slot)
        RESIDENT_ROWS.set(float(len(self.rows)))

    # -- adopt / merge / assemble --------------------------------------------
    def _adopt(self, batch: tensors.SolverBatch, items: Sequence,
               tokens: Optional[Sequence[Optional[RowToken]]]) -> None:
        """Take a full encode's tensors as the new resident masters."""
        n = batch.n_bindings
        self.res_names = list(batch.res_names)
        self.class_keys = list(batch.class_keys)
        self.class_reqs = list(batch.class_reqs or [])
        self.placements = list(batch.placements or [])
        self.pkeys = {tensors._placement_key(p): i  # noqa: SLF001
                      for i, p in enumerate(self.placements)}
        self.gvk_keys = list(batch.gvk_keys or [])
        self.gvks = {g: i for i, g in enumerate(self.gvk_keys)}
        self.region_names = list(batch.region_names or [])
        self.label_axes = dict(batch.label_axes or {})
        self.Kp = batch.prev_idx.shape[1]
        self.Ke = batch.evict_idx.shape[1]
        cap = tensors._next_pow2(max(n, 64), 64)  # noqa: SLF001
        slot = {
            "placement_id": np.zeros(cap, np.int32),
            "gvk_id": np.zeros(cap, np.int32),
            "class_id": np.full(cap, -1, np.int32),
            "replicas": np.zeros(cap, np.int64),
            "uid_desc": np.zeros(cap, bool),
            "fresh": np.zeros(cap, bool),
            "non_workload": np.zeros(cap, bool),
            "nw_shortcut": np.zeros(cap, bool),
            "route": np.zeros(cap, np.int32),
            "prev_idx": np.full((cap, self.Kp), -1, np.int32),
            "prev_val": np.zeros((cap, self.Kp), np.int32),
            "evict_idx": np.full((cap, self.Ke), -1, np.int32),
        }
        for f, arr in slot.items():
            arr[:n] = getattr(batch, f)[:n]
        shared = {f: getattr(batch, f)
                  for f in CLUSTER_SIDE_FIELDS + SHARED_EXTRA_FIELDS}
        self.plane = ResidentPlane(**shared, **slot)
        for f in CLUSTER_SIDE_FIELDS + SHARED_EXTRA_FIELDS:
            _freeze(getattr(self.plane, f))
        self.rows = {}
        self._free = []
        self._next_slot = n
        if tokens is not None:
            for i in range(n):
                tok = tokens[i]
                if tok is not None:
                    self.rows[tok.key] = _Row(i, tok.rv)
            # slots of untokened rows are reusable at once
            self._free.extend(i for i in range(n) if tokens[i] is None)
        else:
            self._free.extend(range(n))
        self._dirty = {}  # fresh masters: full re-place on next sync
        self.device_mirrors.np_refs = {}
        self._rows_dirty = "full"
        self._update_vocab_gauges()

    def _alloc_slots(self, k: int) -> np.ndarray:
        out = np.empty(k, np.int64)
        j = 0
        while j < k and self._free:
            out[j] = self._free.pop()
            j += 1
        if j < k:
            need = self._next_slot + (k - j)
            if need > self.plane.placement_id.shape[0]:
                self._grow_rows(need)
            out[j:] = np.arange(self._next_slot, need)
            self._next_slot = need
        return out

    def _grow_rows(self, need: int) -> None:
        cap = tensors._next_pow2(need, 64)  # noqa: SLF001
        self._rows_dirty = "full"  # slot geometry changes: re-place
        p = self.plane
        for f in DEVICE_SLOT_FIELDS:
            old = getattr(p, f)
            shape = (cap,) + old.shape[1:]
            fill = -1 if f in ("prev_idx", "evict_idx") else 0
            new = np.full(shape, fill, old.dtype)
            new[:old.shape[0]] = old
            setattr(p, f, new)

    def _widen_sparse(self, field: str, width: int) -> None:
        self._rows_dirty = "full"  # sparse width changes: re-place
        p = self.plane
        old = getattr(p, field)
        fill = -1 if field in ("prev_idx", "evict_idx") else 0
        new = np.full((old.shape[0], width), fill, old.dtype)
        new[:, :old.shape[1]] = old
        setattr(p, field, new)

    def _merge(self, mini: tensors.SolverBatch, miss_pos: List[int],
               tokens: Optional[Sequence[Optional[RowToken]]],
               slots: np.ndarray) -> None:
        """Fold a miss-subset encode into the resident state: vocabulary
        entries append (translating new rows/columns out of the mini
        batch), binding rows land in slots with remapped ids."""
        nm = mini.n_bindings
        rmap = np.zeros(max(len(mini.res_names), 1), np.int64)
        for rm, name in enumerate(mini.res_names):
            rmap[rm] = self._res_index(name, mini, rm)
        pmap = np.zeros(max(len(mini.placements or []), 1), np.int32)
        for pm, pl in enumerate(mini.placements or []):
            pmap[pm] = self._placement_index(pl, mini, pm)
        qmap = np.zeros(max(len(mini.class_keys), 1), np.int32)
        for qm, key in enumerate(mini.class_keys):
            qmap[qm] = self._class_index(key, mini, qm, rmap)
        gmap = np.zeros(max(len(mini.gvk_keys or []), 1), np.int32)
        for gm, gk in enumerate(mini.gvk_keys or []):
            gmap[gm] = self._gvk_index(gk, mini, gm)
        for lk, axis in (mini.label_axes or {}).items():
            self.label_axes.setdefault(lk, axis)
        if mini.prev_idx.shape[1] > self.Kp:
            self.Kp = mini.prev_idx.shape[1]
            self._widen_sparse("prev_idx", self.Kp)
            self._widen_sparse("prev_val", self.Kp)
        if mini.evict_idx.shape[1] > self.Ke:
            self.Ke = mini.evict_idx.shape[1]
            self._widen_sparse("evict_idx", self.Ke)
        # reuse the slot of a key whose row went stale; allocate otherwise
        mslots = np.empty(nm, np.int64)
        fresh_needed: List[int] = []
        for j, i in enumerate(miss_pos):
            tok = tokens[i] if tokens is not None else None
            row = self.rows.get(tok.key) if tok is not None else None
            if row is not None:
                mslots[j] = row.slot
                row.rv = tok.rv
            else:
                fresh_needed.append(j)
        if fresh_needed:
            newly = self._alloc_slots(len(fresh_needed))
            for k, j in enumerate(fresh_needed):
                mslots[j] = newly[k]
                tok = tokens[miss_pos[j]] if tokens is not None else None
                if tok is not None:
                    self.rows[tok.key] = _Row(int(newly[k]), tok.rv)
                else:
                    self._free.append(int(newly[k]))
        p = self.plane
        cid = mini.class_id[:nm]
        p.placement_id[mslots] = pmap[mini.placement_id[:nm]]
        p.gvk_id[mslots] = gmap[mini.gvk_id[:nm]]
        p.class_id[mslots] = np.where(
            cid >= 0, qmap[np.maximum(cid, 0)], -1).astype(np.int32)
        for f in ("replicas", "uid_desc", "fresh", "non_workload",
                  "nw_shortcut", "route"):
            getattr(p, f)[mslots] = getattr(mini, f)[:nm]
        kpm = mini.prev_idx.shape[1]
        p.prev_idx[mslots, :] = -1
        p.prev_val[mslots, :] = 0
        p.prev_idx[mslots[:, None], np.arange(kpm)[None, :]] = \
            mini.prev_idx[:nm]
        p.prev_val[mslots[:, None], np.arange(kpm)[None, :]] = \
            mini.prev_val[:nm]
        kem = mini.evict_idx.shape[1]
        p.evict_idx[mslots, :] = -1
        p.evict_idx[mslots[:, None], np.arange(kem)[None, :]] = \
            mini.evict_idx[:nm]
        slots[miss_pos] = mslots
        self._mark_rows_dirty(mslots)
        RESIDENT_ROWS.set(float(len(self.rows)))
        self._update_vocab_gauges()

    def _mark_rows_dirty(self, slots: np.ndarray) -> None:
        """Accumulate slot-store mirror dirtiness: churned slot sets union;
        a pending full re-place absorbs them."""
        if self.device_rows is None or isinstance(self._rows_dirty, str):
            return
        lanes = np.unique(np.asarray(slots, np.int64))
        self._rows_dirty = (lanes if self._rows_dirty is None
                            else np.union1d(self._rows_dirty, lanes))

    def _res_index(self, name: str, mini: tensors.SolverBatch,
                   rm: int) -> int:
        if name in self.res_names:
            return self.res_names.index(name)
        r = len(self.res_names)
        p = self.plane
        R = p.avail_milli.shape[1]
        txn = _Txn(p)
        if r >= R:
            R2 = R * 2
            for f, fill in (("avail_milli", 0), ("has_alloc", False),
                            ("req_milli", 0), ("req_is_cpu", False)):
                old = getattr(p, f)
                new = np.full((old.shape[0], R2) if old.ndim == 2 else (R2,),
                              fill, old.dtype)
                if old.ndim == 2:
                    new[:, :R] = old
                else:
                    new[:R] = old
                txn._w[f] = new  # noqa: SLF001 -- txn adopts the grown copy
        avail = txn.get("avail_milli")
        alloc = txn.get("has_alloc")
        is_cpu = txn.get("req_is_cpu")
        avail[:, r] = mini.avail_milli[:, rm]
        alloc[:, r] = mini.has_alloc[:, rm]
        is_cpu[r] = mini.req_is_cpu[rm]
        for f in txn.commit():
            self._mark_dirty(f, None)
        self.res_names.append(name)
        return r

    def _class_index(self, key, mini: tensors.SolverBatch, qm: int,
                     rmap: np.ndarray) -> int:
        for q, k in enumerate(self.class_keys):
            if k == key:
                return q
        q = len(self.class_keys)
        p = self.plane
        Q = p.req_milli.shape[0]
        txn = _Txn(p)
        if q >= Q:
            Q2 = Q * 2
            for f, fill in (("req_milli", 0), ("req_pods", 1),
                            ("est_override", -1)):
                old = getattr(p, f)
                new = np.full((Q2,) + old.shape[1:], fill, old.dtype)
                new[:Q] = old
                txn._w[f] = new  # noqa: SLF001
        req_milli = txn.get("req_milli")
        req_pods = txn.get("req_pods")
        est_override = txn.get("est_override")
        row = np.zeros(req_milli.shape[1], np.int64)
        nR = len(mini.res_names)
        row[rmap[:nR]] = mini.req_milli[qm, :nR]
        req_milli[q] = row
        req_pods[q] = mini.req_pods[qm]
        est_override[q] = mini.est_override[qm]
        for f in txn.commit():
            self._mark_dirty(f, None)
        self.class_keys.append(key)
        reqs = mini.class_reqs or []
        self.class_reqs.append(reqs[qm] if qm < len(reqs) else None)
        return q

    _PL_FIELDS = ("pl_mask", "pl_tol_bypass", "pl_strategy", "pl_static_w",
                  "pl_has_cluster_sc", "pl_sc_min", "pl_sc_max",
                  "pl_ignore_avail", "pl_extra_score", "pl_has_region_sc",
                  "pl_region_min", "pl_region_max")

    def _placement_index(self, pl, mini: tensors.SolverBatch,
                         pm: int) -> int:
        key = tensors._placement_key(pl)  # noqa: SLF001
        pid = self.pkeys.get(key)
        if pid is not None:
            return pid
        pid = len(self.placements)
        p = self.plane
        P = p.pl_strategy.shape[0]
        txn = _Txn(p)
        if pid >= P:
            for f in self._PL_FIELDS:
                old = getattr(p, f)
                new = np.zeros((P * 2,) + old.shape[1:], old.dtype)
                new[:P] = old
                txn._w[f] = new  # noqa: SLF001
        for f in self._PL_FIELDS:
            txn.get(f)[pid] = getattr(mini, f)[pm]
        for f in txn.commit():
            self._mark_dirty(f, None)
        self.placements.append(pl)
        self.pkeys[key] = pid
        self._fail_plane = None  # the [P, C] explain plane grew
        return pid

    def _gvk_index(self, gk: Tuple[str, str], mini: tensors.SolverBatch,
                   gm: int) -> int:
        g = self.gvks.get(gk)
        if g is not None:
            return g
        g = len(self.gvk_keys)
        p = self.plane
        G = p.api_ok.shape[0]
        txn = _Txn(p)
        if g >= G:
            new = np.zeros((G * 2,) + p.api_ok.shape[1:], p.api_ok.dtype)
            new[:G] = p.api_ok
            txn._w["api_ok"] = new  # noqa: SLF001
        txn.get("api_ok")[g] = mini.api_ok[gm]
        for f in txn.commit():
            self._mark_dirty(f, None)
        self.gvk_keys.append(gk)
        self.gvks[gk] = g
        return g

    def _shared_batch(self, B: int, n: int, rows: tuple, route: np.ndarray,
                      explain: bool, fail_plane) -> tensors.SolverBatch:
        p = self.plane
        shared = {f: getattr(p, f)
                  for f in CLUSTER_SIDE_FIELDS + SHARED_EXTRA_FIELDS}
        batch = tensors._build_solver_batch(  # noqa: SLF001
            shared, B, self.C, n, self.nC, *rows, route, self.cindex,
            list(self.region_names), list(self.res_names),
            list(self.class_keys), dict(self.label_axes), explain,
            fail_plane)
        batch.placements = list(self.placements)
        batch.gvk_keys = list(self.gvk_keys)
        batch.class_reqs = list(self.class_reqs)
        return batch

    def _assemble(self, items: Sequence, slots: np.ndarray, n: int,
                  explain: bool) -> tensors.SolverBatch:
        """The host assemble (the control): numpy rows off the masters."""
        p = self.plane
        B = tensors._next_pow2(max(n, 1), 8)  # noqa: SLF001
        sl = slots[:n]
        out = {}
        for f in resident_gather.OUT_FIELDS[1:]:
            m = getattr(p, f)
            fill = resident_gather._FILL[f]  # noqa: SLF001
            a = np.full((B,) + m.shape[1:], fill, m.dtype)
            a[:n] = m[sl]
            out[f] = a
        route = np.ascontiguousarray(p.route[sl], np.int32)
        b_valid = np.zeros(B, bool)
        b_valid[:n] = route == _ROUTE_DEVICE
        fail_plane = self._ensure_fail_plane() if explain else None
        return self._shared_batch(
            B, n, (b_valid,) + tuple(out[f] for f in
                                     resident_gather.OUT_FIELDS[1:]),
            route, explain, fail_plane)

    def _assemble_fused(self, slots: np.ndarray,
                        n: int) -> tensors.SolverBatch:
        """The fused assemble: binding-axis fields gather from the device
        slot store (K11) and ride into the dispatch as device tensors; the
        only upload is the [B] slot vector.  The host keeps what the host
        path reads: `route` (routing, decode) and non_workload (decode),
        both O(n) gathers off the masters, plus the nnz bound."""
        p = self.plane
        self.device_rows.sync(p, self._rows_dirty)
        self._rows_dirty = None
        sl = slots[:n]
        B = tensors._next_pow2(max(n, 1), 8)  # noqa: SLF001
        slots_b = np.full(B, -1, np.int64)
        slots_b[:n] = sl
        out = resident_gather.dispatch_gather(slots_b,
                                              self.device_rows.mirrors)
        resident_gather.COUNTS["rows"] += n
        resident_gather.GATHER_ROWS.inc(n)
        route = np.ascontiguousarray(p.route[sl], np.int32)
        nw_host = np.ascontiguousarray(p.non_workload[sl])
        # the JAX solver's donation-safety bound (solver._nnz_bound): wide
        # rows (Duplicated / non-workload) count the full cluster axis,
        # the rest their replica target plus the sparse prev width
        validh = route == _ROUTE_DEVICE
        strat = p.pl_strategy[p.placement_id[sl]]
        wide = validh & ((strat == tensors.STRAT_DUPLICATED) | nw_host)
        per_row = np.minimum(p.replicas[sl], self.C) + self.Kp
        bound = (int(np.sum(wide)) * self.C
                 + int(np.sum(per_row[validh & ~wide])))
        batch = self._shared_batch(B, n, out, route, False, None)
        batch.fused = True
        batch.nnz_bound_hint = bound
        batch.non_workload_host = nw_host
        # masters are copy-on-write frozen (slot fields change only at the
        # next encode_cycle's merge), and the shortlist reads this handle
        # at shrink time, right after this encode
        batch.fused_src = {"plane": p, "slots": sl, "slots_b": slots_b,
                           "mirrors": self.device_rows.mirrors}
        return batch

    def _ensure_fail_plane(self) -> np.ndarray:
        """The [P, C] explain fail-bit plane over the resident placement
        vocabulary, cached until placements or the cluster plane change
        structurally."""
        P = self.plane.pl_strategy.shape[0]
        sig = (self.generation, len(self.placements), P)
        if self._fail_plane is not None and self._fail_plane[0] == sig:
            return self._fail_plane[1]
        from karmada_tpu_torch.scheduler.plugins import REGISTRY as _PLUGINS

        plug_filters = _PLUGINS.enabled_filters()
        dummy = ResourceBindingStatus()
        plane = np.zeros((P, self.C), np.int32)
        for pid, pl in enumerate(self.placements):
            fb = self._fail_rows.get(pid)
            if fb is None:
                fb = tensors._fail_row(  # noqa: SLF001
                    pl, self.clusters, self.C, plug_filters, dummy)
                self._fail_rows[pid] = fb
            plane[pid] = fb
        _freeze(plane)
        self._fail_plane = (sig, plane)
        return plane

    # -- audit ---------------------------------------------------------------
    def audit(self, items: Sequence, batch: tensors.SolverBatch,
              tokens: Optional[Sequence[Optional[RowToken]]] = None,
              explain: bool = False) -> Optional[tensors.SolverBatch]:
        """Re-encode `items` from scratch and compare bit for bit with the
        resident batch.  On mismatch: count it, rebuild, and return the
        fresh batch (which the caller serves); on parity None."""
        with obs.TRACER.span(obs.SPAN_RESIDENT_AUDIT, items=len(items)):
            fresh = tensors.encode_batch(items, self.cindex, self.estimator,
                                         explain=explain)
            mismatches = compare_batches(batch, fresh)
        outcome = "mismatch" if mismatches else "ok"
        RESIDENT_AUDITS.inc(outcome=outcome)
        if mismatches:
            self.audit_mismatches += 1
        else:
            self.audits_ok += 1
        self.last_audit = {"cycle": self.cycles, "outcome": outcome,
                           "fields": mismatches[:8]}
        if not mismatches:
            return None
        # incident trigger (obs/incidents): divergence adoption is a
        # forensic moment -- capture the flight ring and the plane's state
        # before the rebuild papers over it
        from karmada_tpu_torch.obs import incidents as obs_incidents

        obs_incidents.trigger(
            obs_incidents.TRIGGER_AUDIT_DIVERGENCE,
            f"resident audit divergence adopted: {len(mismatches)} "
            "diverged field(s); plane rebuilt from scratch",
            detail={"plane": "resident", "fields": mismatches[:8],
                    "cycle": self.cycles, "items": len(items)})
        self._reset(self.clusters, "audit-mismatch")
        self._adopt(fresh, items, tokens)
        self.sync_device()
        return fresh

    # -- device plane --------------------------------------------------------
    def sync_device(self) -> None:
        """Bring the cluster-side device mirrors up to the masters (one
        fused K10 scatter of the churned lanes, or a re-place) and prime
        the solver's transfer cache; nothing to do when in sync.  Each
        encode ends with it, and the incremental dirty pass runs it
        first (ops/dirty.dirty_codes reads the mirrors)."""
        if self.plane is None:
            return
        if self._device_primed and not self._dirty:
            return
        self._device_primed = self.device_mirrors.sync(self.plane,
                                                       self._dirty)
        self._dirty = {}

    # -- introspection -------------------------------------------------------
    def _update_vocab_gauges(self) -> None:
        RESIDENT_VOCAB.set(float(self.nC), axis="clusters")
        RESIDENT_VOCAB.set(float(len(self.placements)), axis="placements")
        RESIDENT_VOCAB.set(float(len(self.class_keys)), axis="classes")
        RESIDENT_VOCAB.set(float(len(self.res_names)), axis="resources")
        RESIDENT_VOCAB.set(float(len(self.gvk_keys)), axis="gvks")
        RESIDENT_ROWS.set(float(len(self.rows)))

    def stats(self) -> dict:
        """Counts of the plane: generation, vocabulary sizes, rows cached,
        hits and misses, rebuilds, audits, the fused path's cycles."""
        total = self.hits + self.misses
        return {
            "enabled": True,
            "device": str(self.device),
            "generation": self.generation,
            "resident": self.plane is not None,
            "cycles": self.cycles,
            "vocab": {
                "clusters": self.nC,
                "placements": len(self.placements),
                "classes": len(self.class_keys),
                "resources": len(self.res_names),
                "gvks": len(self.gvk_keys),
                "cluster_lanes": self.C,
            },
            "rows_cached": len(self.rows),
            "row_hits": self.hits,
            "row_misses": self.misses,
            "hit_rate": round(self.hits / total, 4) if total else None,
            "rebuilds": dict(self.rebuilds),
            "audits": {"ok": self.audits_ok,
                       "mismatch": self.audit_mismatches},
            "last_audit": self.last_audit,
            "last_deltas": self.last_deltas,
            "device_primed": self._device_primed,
            "fused": {
                "armed": self.fused,
                "cycles": self.fused_cycles,
                "host_cycles": self.host_cycles,
                "fallbacks": dict(self.gather_fallbacks),
                "rows_synced": (self.device_rows is not None
                                and self._rows_dirty is None),
            },
        }


class _Missing:
    pass


_MISSING = _Missing()


# -- bit-exact comparison -----------------------------------------------------
def _np(a) -> np.ndarray:
    """A field as numpy: a fused batch's device tensors are read back."""
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def compare_batches(resident: tensors.SolverBatch,
                    fresh: tensors.SolverBatch) -> List[str]:
    """Vocabulary-mapped bit-exact comparison of a resident batch against
    a fresh full encode of the same (items, clusters).  The resident axes
    may be larger (retired vocabulary, padded growth); every value a solve
    can read must match.  Returns the mismatching field names ([] =
    parity)."""
    errs: List[str] = []

    def chk(name: str, a, b) -> None:
        if not np.array_equal(_np(a), _np(b)):
            errs.append(name)

    if (resident.n_clusters, resident.C) != (fresh.n_clusters, fresh.C):
        return ["cluster-axis-shape"]
    if resident.n_bindings != fresh.n_bindings:
        return ["binding-count"]
    nB = fresh.n_bindings
    for f in ("cluster_valid", "deleting", "name_rank", "pods_allowed",
              "has_summary", "region_id"):
        chk(f, getattr(resident, f), getattr(fresh, f))
    chk("region_names", np.asarray(resident.region_names or [], object),
        np.asarray(fresh.region_names or [], object))
    # resources (by name)
    try:
        rmap = [resident.res_names.index(nm) for nm in fresh.res_names]
    except ValueError:
        return errs + ["resource-vocab"]
    for rm, r in enumerate(rmap):
        chk(f"avail_milli[{fresh.res_names[rm]}]",
            resident.avail_milli[:, r], fresh.avail_milli[:, rm])
        chk(f"has_alloc[{fresh.res_names[rm]}]",
            resident.has_alloc[:, r], fresh.has_alloc[:, rm])
        chk(f"req_is_cpu[{fresh.res_names[rm]}]",
            resident.req_is_cpu[r], fresh.req_is_cpu[rm])
    # classes (by canonical key)
    qmap: List[int] = []
    for key in fresh.class_keys:
        if key not in resident.class_keys:
            return errs + ["class-vocab"]
        qmap.append(resident.class_keys.index(key))
    for qm, q in enumerate(qmap):
        chk(f"req_milli[q{qm}]", resident.req_milli[q][rmap],
            fresh.req_milli[qm, :len(rmap)])
        chk(f"req_pods[q{qm}]", resident.req_pods[q], fresh.req_pods[qm])
        chk(f"est_override[q{qm}]",
            resident.est_override[q], fresh.est_override[qm])
    # placements (by key)
    pmap: List[int] = []
    res_pk = {tensors._placement_key(p): i  # noqa: SLF001
              for i, p in enumerate(resident.placements or [])}
    for pl in (fresh.placements or []):
        pid = res_pk.get(tensors._placement_key(pl))  # noqa: SLF001
        if pid is None:
            return errs + ["placement-vocab"]
        pmap.append(pid)
    for pm, pid in enumerate(pmap):
        for f in ResidentState._PL_FIELDS:  # noqa: SLF001
            chk(f"{f}[p{pm}]", getattr(resident, f)[pid],
                getattr(fresh, f)[pm])
    # gvks (by key)
    gmap: List[int] = []
    res_gk = {g: i for i, g in enumerate(resident.gvk_keys or [])}
    for gk in (fresh.gvk_keys or []):
        g = res_gk.get(gk)
        if g is None:
            return errs + ["gvk-vocab"]
        gmap.append(g)
    for gm, g in enumerate(gmap):
        chk(f"api_ok[{fresh.gvk_keys[gm]}]",
            resident.api_ok[g], fresh.api_ok[gm])
    if nB == 0:
        return errs
    # per-binding fields
    for f in ("replicas", "uid_desc", "fresh", "non_workload",
              "nw_shortcut", "b_valid"):
        chk(f, _np(getattr(resident, f))[:nB], _np(getattr(fresh, f))[:nB])
    chk("route", resident.route[:nB], fresh.route[:nB])
    pmap_arr = np.asarray(pmap or [0], np.int32)
    chk("placement_id", _np(resident.placement_id)[:nB],
        pmap_arr[fresh.placement_id[:nB]])
    gmap_arr = np.asarray(gmap or [0], np.int32)
    chk("gvk_id", _np(resident.gvk_id)[:nB], gmap_arr[fresh.gvk_id[:nB]])
    qmap_arr = np.asarray(qmap or [0], np.int32)
    cid = fresh.class_id[:nB]
    chk("class_id", _np(resident.class_id)[:nB],
        np.where(cid >= 0, qmap_arr[np.maximum(cid, 0)], -1))
    ra = _canon_sparse(_np(resident.prev_idx)[:nB],
                       _np(resident.prev_val)[:nB])
    fa = _canon_sparse(fresh.prev_idx[:nB], fresh.prev_val[:nB])
    if not (np.array_equal(ra[0], fa[0]) and np.array_equal(ra[1], fa[1])):
        errs.append("prev_assignment")
    re_ = _canon_sparse(_np(resident.evict_idx)[:nB])
    fe = _canon_sparse(fresh.evict_idx[:nB])
    if not np.array_equal(re_[0], fe[0]):
        errs.append("evict_entries")
    return errs


def _canon_sparse(idx: np.ndarray, val: Optional[np.ndarray] = None):
    """Canonicalize a sparse (idx [B, K], val [B, K]) plane for comparison
    across differing pad widths: rows sorted by lane with -1 padding last,
    trimmed to the widest real entry count."""
    idx = np.asarray(idx)
    key = np.where(idx >= 0, idx.astype(np.int64), np.int64(1) << 40)
    order = np.argsort(key, axis=1, kind="stable")
    idx_s = np.take_along_axis(idx, order, axis=1)
    widths = (idx_s >= 0).sum(axis=1)
    w = int(widths.max()) if idx_s.size else 0
    idx_s = idx_s[:, :max(w, 1)]
    if val is None:
        return (idx_s, None)
    val = np.take_along_axis(np.asarray(val), order, axis=1)[:, :max(w, 1)]
    val = np.where(idx_s >= 0, val, 0)  # val is meaningful only where idx >= 0
    return (idx_s, val)
