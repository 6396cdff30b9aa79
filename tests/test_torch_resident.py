"""Resident-plane parity: the port's resident plane (karmada_tpu_torch
resident/state.py, ops/resident_update K10, ops/resident_gather K11, on
the CPU through the kernels' plain versions) equals the JAX package's on
the same inputs, tolerance 0:

  * K10 plain against JAX scatter_rows / scatter_cols / scatter_rows_cow,
    padded duplicate lanes included (a padded scatter equals the unpadded
    one);
  * K11 plain against JAX gather_batch / sub_gather_batch on every row,
    padding and dtypes included, and the layout of K11's call slab;
  * port ResidentState against JAX ResidentState over the same churn
    stream (after tests/test_resident_churn.py and test_resident_fused.py):
    capacity-only deltas, binding churn with vocabulary growth, a
    structural bump, mixed routes, the big tier and explain chunks taking
    the host path -- batches equal field by field, hits and misses equal,
    fused equal to host, a batch gathered before a sync unchanged after it;
  * schedule_items(resident=...) placements equal to JAX
    run_pipeline(encode=...) plus the serial path.
"""

import dataclasses
import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.obs import decisions as JD
from karmada_tpu.ops import resident_gather as JRG
from karmada_tpu.ops import resident_update as JRU
from karmada_tpu.ops import serial as JSER
from karmada_tpu.ops import tensors as JT
from karmada_tpu.resident import ResidentState as JaxResident
from karmada_tpu.resident import RowToken as JaxToken
from karmada_tpu.scheduler import pipeline as JP
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.obs import decisions as PD
from karmada_tpu_torch.ops import resident_gather as PRG
from karmada_tpu_torch.ops import resident_update as PRU
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import tensors as PT
from karmada_tpu_torch.resident import ResidentState, RowToken
from karmada_tpu_torch.resident import compare_batches
from karmada_tpu_torch.scheduler import pipeline as PP
from karmada_tpu_torch.scheduler.core import schedule_items

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")

JAX = SimpleNamespace(M=MJ, RS=JaxResident, Tok=JaxToken, E=JaxEstimator,
                      T=JT, P=JP, kw={})
PORT = SimpleNamespace(M=MP, RS=ResidentState, Tok=RowToken,
                       E=GeneralEstimator, T=PT, P=PP,
                       kw={"device": "cpu"})


def _np(a):
    return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


# -- K10 and K11 plain against the JAX programs --------------------------------

@pytest.mark.parametrize("layout,dtype,n_lanes", [
    ("rows", np.int64, 5), ("rows", np.bool_, 9), ("rows", np.int32, 8),
    ("cols", np.int64, 3), ("cols", np.bool_, 13), ("cow", np.int32, 6)])
def test_scatter_plain_matches_jax(layout, dtype, n_lanes):
    """Padded duplicate lanes (the last pair repeated to a pow2 bucket)
    give the JAX result and the unpadded scatter's, whatever order the
    duplicates land in."""
    rng = np.random.default_rng(n_lanes)
    C = 64
    shape = (6, C) if layout == "cols" else (C, 3)
    dst = rng.integers(0, 7, shape).astype(dtype)
    lanes = rng.choice(C, n_lanes, replace=False).astype(np.int64)
    vals = rng.integers(0, 7, (6, n_lanes) if layout == "cols"
                        else (n_lanes, 3)).astype(dtype)
    pad = PRU.pad_lanes_cols if layout == "cols" else PRU.pad_lanes
    lp, vp = pad(lanes, vals)
    jl, jv = (JRU.pad_lanes_cols if layout == "cols" else JRU.pad_lanes)(
        lanes, vals)
    assert np.array_equal(lp, jl) and np.array_equal(vp, jv)
    assert lp.shape[0] == max(8, 1 << (n_lanes - 1).bit_length())
    jfn = {"rows": JRU.scatter_rows, "cols": JRU.scatter_cols,
           "cow": JRU.scatter_rows_cow}[layout]
    pfn = {"rows": PRU.scatter_rows, "cols": PRU.scatter_cols,
           "cow": PRU.scatter_rows_cow}[layout]
    want = np.asarray(jfn(dst.copy(), jl, jv))
    src = torch.from_numpy(dst.copy())
    got = pfn(src, torch.from_numpy(lp),
              torch.from_numpy(np.ascontiguousarray(vp)))
    unpadded = pfn(torch.from_numpy(dst.copy()), torch.from_numpy(lanes),
                   torch.from_numpy(vals))
    assert got.dtype == unpadded.dtype
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(unpadded.numpy(), want)
    # in place, except the copy-on-write flavour
    assert (got is src) == (layout != "cow")
    if layout == "cow":
        assert np.array_equal(src.numpy(), dst)


@pytest.mark.parametrize("B,staged", [(64, 0), (4096, 4096 * 8),
                                      (7, 16 + 1024 * 4 + 16)])
def test_gather_slab_layout(B, staged):
    """K11's call slab (ops/resident_gather._layout, carved by _views as on
    the card): the staged inputs first, then the twelve outputs with the
    solver's dtypes and shapes, contiguous, each 16-byte aligned region
    after the last, no two outputs sharing a byte, the argument block's
    output addresses those of the views."""
    store = {f: torch.from_numpy(a) for f, a in S.slot_store(
        np.random.default_rng(0), 32, 4, 3, 16).items()}
    plan = PRG._Plan([store[f] for f in PRG.GATHER_FIELDS], 4, 3)
    nbytes, spec, offs = PRG._layout(plan, B, staged)
    assert PRG._layout(plan, B, staged) is PRG._layout(plan, B, staged)
    slab = torch.zeros((nbytes,), dtype=torch.uint8)
    out = PRG._views(slab, spec)
    base = slab.data_ptr()
    spans = []
    for f, t, off in zip(PRG.OUT_FIELDS, out, offs):
        want = ((B, 4) if f in ("prev_idx", "prev_val")
                else (B, 3) if f == "evict_idx" else (B,))
        assert tuple(t.shape) == want and t.is_contiguous(), f
        assert t.dtype == getattr(torch, PT.FIELD_DTYPES[f]), f
        assert t.data_ptr() == base + off >= base + staged, f
        spans.append((off, off + t.numel() * t.element_size()))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= nbytes and nbytes % 16 == 0
    assert all(off % 16 == 0 for off in (offs[PRG.OUT_FIELDS.index(f)]
                                         for f in ("replicas",
                                                   "placement_id",
                                                   "b_valid")))


@pytest.mark.parametrize("flavour", ["plain", "sub"])
def test_gather_plain_matches_jax(flavour):
    """Every output row (pad rows with slot 0 holding a device row
    included) and dtype, against JAX; the sub flavour with out-of-union
    prev lanes and dropped rows."""
    rng = np.random.default_rng(3)
    C, cap, B = 48, 256, 64
    store = S.slot_store(rng, cap, 4, 3, C)
    store["route"][0] = 0  # pads must stay invalid whatever slot 0 holds
    slots = rng.integers(0, cap, B).astype(np.int64)
    slots[-9:] = -1
    mirrors = {f: torch.from_numpy(a) for f, a in store.items()}
    if flavour == "sub":
        inv = np.full(C, -1, np.int32)
        inv[rng.choice(C, 20, replace=False)] = np.arange(20, dtype=np.int32)
        drop = rng.random(B) < 0.25
        want = JRG.sub_gather_batch(
            slots, inv, drop, *(store[f] for f in JRG.GATHER_FIELDS))
        got = PRG.sub_gather_batch(torch.from_numpy(slots), mirrors,
                                   torch.from_numpy(inv),
                                   torch.from_numpy(drop))
    else:
        want = JRG.gather_batch(slots, *(store[f] for f in JRG.GATHER_FIELDS))
        got = PRG.gather_batch(torch.from_numpy(slots), mirrors)
    assert PRG.OUT_FIELDS == JRG.OUT_FIELDS
    assert PRG.GATHER_FIELDS == JRG.GATHER_FIELDS
    for f, a, b in zip(PRG.OUT_FIELDS, got, want):
        b = np.asarray(b)
        assert a.numpy().dtype == b.dtype, f
        assert np.array_equal(a.numpy(), b), f
    assert not got[0][-9:].any()  # b_valid false on every pad row
    if flavour == "sub":
        assert (got[9].numpy() < 20).all() and got[9].dtype == torch.int32
        assert not got[10][got[9] < 0].any()


# -- the resident plane over a churn stream ------------------------------------

BINDING_PLANES = PRG.OUT_FIELDS


class Fleet:
    """One package's mutable (clusters, items) world with an rv ledger and
    a fused + host ResidentState pair driven in lockstep."""

    def __init__(self, K, build, audit=0):
        self.K = K
        self.clusters, self.items = build(K.M)
        self.n = len(self.items)
        self.rvs = [1] * self.n
        self.est = K.E()
        self.fused = K.RS(estimator=self.est, audit_interval=audit,
                          fused=True, **K.kw)
        self.host = K.RS(estimator=self.est, audit_interval=audit,
                         fused=False, **K.kw)

    def tokens(self, state):
        pfx = "f" if state is self.fused else "h"
        return [self.K.Tok(f"{pfx}/{i}", self.rvs[i]) for i in range(self.n)]

    def encode(self, state, explain=False):
        state.begin_cycle(self.clusters)
        return state.encode_cycle(self.items, self.tokens(state),
                                  explain=explain)

    def cycle(self, state, chunk, waves, explain=None):
        state.begin_cycle(self.clusters)
        toks = self.tokens(state)

        def encode(part, offset, armed):
            return state.encode_cycle(part, toks[offset:offset + len(part)],
                                      explain=armed)

        kw = {"carry_spread": True} if self.K is JAX else {"device": "cpu"}
        return self.K.P.run_pipeline(
            self.items, state.cindex, self.est, chunk=chunk, waves=waves,
            cache=state.enc_cache, carry=True, encode=encode,
            explain=explain, **kw)

    def churn_bindings(self, idx):
        for i in idx:
            spec, status = self.items[i]
            self.items[i] = (dataclasses.replace(
                spec, replicas=spec.replicas + 1), status)
            self.rvs[i] += 1

    def churn_capacity(self, lanes, deleting=None):
        import copy

        for lane in lanes:
            c = copy.deepcopy(self.clusters[lane])
            c.metadata.resource_version += 1
            rs = c.status.resource_summary
            if rs is not None and "cpu" in rs.allocated:
                rs.allocated["cpu"] = self.K.M.Quantity.from_milli(
                    rs.allocated["cpu"].milli_value() + 100)
            if deleting is not None:
                c.metadata.deletion_timestamp = deleting
            self.clusters[lane] = c


def _batch_fields(batch):
    """The batch's fields as they are now: numpy copies, so that a later
    step's in-place update of a plane's buffers cannot reach them."""
    out = {f: np.array(_np(getattr(batch, f)), copy=True)
           for f in PT.FIELD_DTYPES if getattr(batch, f, None) is not None}
    out["vocab"] = (list(batch.res_names), list(batch.class_keys),
                    list(batch.region_names or []),
                    [tuple(g) for g in batch.gvk_keys or []])
    out["meta"] = (batch.B, batch.C, batch.n_bindings, batch.n_clusters,
                   bool(batch.fused), batch.nnz_bound_hint)
    return out


def _same_batch(jb, pb, ctx):
    a, b = (x if isinstance(x, dict) else _batch_fields(x) for x in (jb, pb))
    assert a.keys() == b.keys(), ctx
    for f in a:
        if isinstance(a[f], np.ndarray):
            assert a[f].dtype == b[f].dtype, (ctx, f)
            assert np.array_equal(a[f], b[f]), (ctx, f)
        else:
            assert a[f] == b[f], (ctx, f)


def _targets(r):
    if isinstance(r, Exception):
        return type(r).__name__
    return sorted((t.name, t.replicas) for t in r)


def _stats(state):
    st = state.stats()
    return (st["generation"], st["row_hits"], st["row_misses"],
            st["rows_cached"], st["rebuilds"], st["fused"]["cycles"],
            st["fused"]["host_cycles"], st["fused"]["fallbacks"],
            st["audits"], st["vocab"])


def _mixed(M):
    """bench.py's mix (main and region-spread rows) on 24 clusters."""
    rng = random.Random(1)
    clusters = S.build_fleet(M, rng, 24)
    pls = S.build_placements(M, rng, [c.name for c in clusters])
    return clusters, S.build_bindings(M, rng, 48, pls)


def _gpu_item(M):
    """A binding with a new resource, request class and placement."""
    return (M.ResourceBindingSpec(
        resource=M.ObjectReference(api_version="apps/v1", kind="Deployment",
                                   namespace="d", name="gpu-new",
                                   uid="uid-gpu-new"),
        replicas=2,
        replica_requirements=M.ReplicaRequirements(resource_request={
            "nvidia.com/gpu": M.Quantity.from_units(1),
            "cpu": M.Quantity.from_milli(111)}),
        placement=M.Placement(replica_scheduling=M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED))),
        M.ResourceBindingStatus())


def _big_world(M):
    """Main rows beside ROUTE_DEVICE_BIG rows (560 clusters pad past the
    compact lanes; replicas beyond the tier-1 division cap)."""
    rng = random.Random(7)
    clusters = S.build_fleet(M, rng, 560)

    def binding(b, big):
        rs = (M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
            replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
            weight_preference=M.ClusterPreferences(
                dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))
              if big else M.ReplicaSchedulingStrategy(
                  replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED))
        return (M.ResourceBindingSpec(
            resource=M.ObjectReference(api_version="apps/v1",
                                       kind="Deployment", namespace="d",
                                       name=f"a{b}", uid=f"u{b}"),
            replicas=(80 + b) if big else 2,
            replica_requirements=M.ReplicaRequirements(resource_request={
                "cpu": M.Quantity.from_milli(100)}),
            placement=M.Placement(replica_scheduling=rs)),
            M.ResourceBindingStatus())

    return clusters, [binding(b, big=b % 2 == 0) for b in range(6)]


def _stream(K, case):
    """One package's run of a churn stream: per step the fused and host
    batches of encode_cycle (their fields captured at that step), the
    pipeline results through both planes, and the planes' counts; the
    last step's batches stay in `fleet.last`."""
    out = []
    if case == "big":
        fleet = Fleet(K, _big_world)
        steps = ["adopt", "cycle", "cap", "cycle"]
        chunk, waves = 3, 1
    elif case == "mixed":
        fleet = Fleet(K, lambda M: S.random_scenario(
            M, 5, n_clusters=12, n_bindings=30))
        steps = ["adopt", "cycle", "bind", "cycle", "explain"]
        chunk, waves = 8, 2
    else:
        fleet = Fleet(K, _mixed)
        steps = ["adopt", "cap", "cycle", "bind", "grow", "cycle",
                 "flip", "struct", "cycle", "explain", "cycle"]
        chunk, waves = 24, 4
    rng = random.Random(2)
    for step in steps:
        if step == "cap":
            fleet.churn_capacity(rng.sample(range(len(fleet.clusters)), 3))
        elif step == "flip":
            # a deleting flip: a feasibility change the plane must scatter
            fleet.churn_capacity([4], deleting=1.0)
        elif step == "bind":
            fleet.churn_bindings(rng.sample(range(fleet.n), 9))
        elif step == "grow":
            fleet.items.append(_gpu_item(K.M))
            fleet.rvs.append(1)
            fleet.n += 1
        elif step == "struct":
            extra = S.build_fleet(K.M, random.Random(99), 30)[-1]
            fleet.clusters = fleet.clusters + [extra]
        rec = None
        if step == "explain":
            rec = (JD if K is JAX else PD).DecisionRecorder(capacity=256)
        if step in ("adopt", "cycle", "explain"):
            results = [fleet.cycle(st, chunk, waves, explain=rec).results
                       for st in (fleet.fused, fleet.host)]
        else:
            results = None
        batches = [fleet.encode(st) for st in (fleet.fused, fleet.host)]
        fleet.last = batches
        out.append((step, [_batch_fields(b) for b in batches], results,
                    [_stats(st) for st in (fleet.fused, fleet.host)],
                    list(fleet.fused.last_flip_lanes)))
    return out, fleet


@pytest.mark.parametrize("case", ["stream", "mixed", "big"])
def test_resident_stream_matches_jax(case):
    """The port's fused and host planes equal the JAX package's step by
    step: every encode_cycle batch field by field (device fields read
    back), the pipeline results through the resident encoder, hits,
    misses, rebuilds, fallbacks and the flip lanes; and fused == host."""
    jout, _ = _stream(JAX, case)
    pout, pfleet = _stream(PORT, case)
    for (step, jb, jr, js, jf), (_s, pb, pr, ps, pf) in zip(jout, pout):
        ctx = f"{case}/{step}"
        assert js == ps, ctx
        assert [int(x) for x in jf] == [int(x) for x in pf], ctx
        for a, b in zip(jb, pb):
            _same_batch(a, b, ctx)
        fused, host = pb
        for f in BINDING_PLANES:
            assert np.array_equal(fused[f], host[f]), (ctx, f)
        if jr is not None:
            for a, b in zip(jr, pr):
                assert a.keys() == b.keys(), ctx
                assert {i: _targets(r) for i, r in a.items()} == {
                    i: _targets(r) for i, r in b.items()}, ctx
            assert pr[0].keys() == pr[1].keys()
            assert {i: _targets(r) for i, r in pr[0].items()} == {
                i: _targets(r) for i, r in pr[1].items()}, ctx
    fs = pfleet.fused.stats()
    assert fs["fused"]["cycles"] > 0
    if case == "stream":
        assert fs["rebuilds"] == {"init": 1, "membership": 1}
        assert fs["fused"]["fallbacks"]["explain"] > 0
        assert any(len(x[4]) for x in pout)  # the deleting flip was seen
        # the last batch passes the plane's own bit-exact audit
        last = pfleet.last[0]
        assert last.fused and compare_batches(last, PT.encode_batch(
            pfleet.items, pfleet.fused.cindex, pfleet.est)) == []


def test_fused_batch_survives_a_later_sync():
    """The slot store's mirrors advance in place (K10 without a copy): a
    batch gathered before a sync keeps its values after it.  And the fused
    path uploads no binding field; the host control uploads them all."""
    fleet = Fleet(PORT, _mixed)
    fleet.encode(fleet.fused)
    before = fleet.encode(fleet.fused)
    assert before.fused
    kept = {f: _np(getattr(before, f)).copy() for f in BINDING_PLANES}
    fleet.churn_bindings(range(0, 48, 3))  # the next sync scatters these
    after = fleet.encode(fleet.fused)
    assert fleet.fused.stats()["fused"]["rows_synced"]
    assert not np.array_equal(_np(after.replicas), kept["replicas"])
    for f in BINDING_PLANES:
        assert np.array_equal(_np(getattr(before, f)), kept[f]), f
    h0 = PS.TRANSFERS["h2d_binding_fields"]
    fleet.cycle(fleet.fused, 24, 4)
    assert PS.TRANSFERS["h2d_binding_fields"] == h0
    fleet.cycle(fleet.host, 24, 4)
    assert PS.TRANSFERS["h2d_binding_fields"] > h0


def test_frozen_masters_and_identity_caches():
    """Mirrors are copies, never views of the frozen masters (an in-place
    plain scatter must not write into what the audit compares against);
    quiet cycles hand the same frozen objects to every chunk, so the
    solver's transfer cache hits instead of uploading."""
    fleet = Fleet(PORT, _mixed)
    fleet.cycle(fleet.fused, 24, 4)
    state = fleet.fused
    mirror = state.device_mirrors.mirrors["pods_allowed"]
    master = state.plane.pods_allowed
    assert not master.flags.writeable
    assert mirror.data_ptr() != master.__array_interface__["data"][0]
    slot = state.device_rows.mirrors["replicas"]
    assert slot.data_ptr() != state.plane.replicas.__array_interface__[
        "data"][0]
    PRU.scatter_rows(mirror, torch.tensor([0]), torch.tensor([12345]))
    assert master[0] != 12345
    fleet.churn_capacity([0])  # the next sync rewrites lane 0 again
    fleet.cycle(fleet.fused, 24, 4)
    assert int(state.device_mirrors.mirrors["pods_allowed"][0]) == int(
        state.plane.pods_allowed[0])
    hits0 = PS.TRANSFERS["cluster_hits"]
    up0 = PS.TRANSFERS["cluster_uploads"]
    res = fleet.cycle(fleet.fused, 24, 4)
    assert res.chunks == 2
    assert PS.TRANSFERS["cluster_uploads"] == up0
    assert PS.TRANSFERS["cluster_hits"] - hits0 >= 2


def _jax_cycle(clusters, items, toks, state, chunk, waves):
    """JAX Scheduler._solve with the resident plane: run_pipeline through
    the plane's encoder, then the serial path for the host rows."""
    state.begin_cycle(clusters)

    def encode(part, offset, armed):
        return state.encode_cycle(part, toks[offset:offset + len(part)],
                                  explain=armed)

    carry = len(items) > chunk
    res = JP.run_pipeline(items, state.cindex, state.estimator, chunk=chunk,
                          waves=waves, cache=state.enc_cache, carry=carry,
                          carry_spread=carry, encode=encode)
    cal = JSER.make_cal_available([state.estimator])
    out = []
    for i, (spec, status) in enumerate(items):
        if i in res.results:
            out.append(res.results[i])
            continue
        try:
            out.append(JSER.schedule(spec, status, list(clusters), cal))
        except Exception as e:  # noqa: BLE001
            out.append(e)
    return out


@pytest.mark.parametrize("fused", [False, True])
def test_schedule_items_resident_matches_jax(fused):
    """schedule_items(resident=...) over three cycles (adopt, binding
    churn, capacity churn) against the JAX package's resident pipeline
    plus serial fallback, row by row, host routes included."""
    outs = {}
    for K in (JAX, PORT):
        clusters, items = S.random_scenario(K.M, 8, n_clusters=12,
                                            n_bindings=40)
        est = K.E()
        state = K.RS(estimator=est, audit_interval=2, fused=fused, **K.kw)
        rvs = [1] * len(items)
        rng = random.Random(4)
        per = []
        for cyc in range(3):
            if cyc == 1:
                for i in rng.sample(range(len(items)), 6):
                    spec, status = items[i]
                    items[i] = (dataclasses.replace(
                        spec, replicas=spec.replicas + 1), status)
                    rvs[i] += 1
            toks = [K.Tok(f"k/{i}", rvs[i]) for i in range(len(items))]
            if K is JAX:
                res = _jax_cycle(clusters, items, toks, state, 16, 2)
            else:
                res = schedule_items(items, clusters, chunk=16, waves=2,
                                     device="cpu", estimator=est,
                                     resident=state, tokens=toks)
            per.append([_targets(r) for r in res])
        outs["jax" if K is JAX else "port"] = (per, _stats(state))
    assert outs["jax"] == outs["port"]
    # and the resident cycles equal a cycle without the plane
    clusters, items = S.random_scenario(MP, 8, n_clusters=12, n_bindings=40)
    plain = [_targets(r) for r in schedule_items(
        items, clusters, chunk=16, waves=2, device="cpu")]
    assert outs["port"][0][0] == plain


def test_resident_refuses_a_device_mismatch():
    clusters, items = S.random_scenario(MP, 8, n_clusters=6, n_bindings=4)
    state = ResidentState(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ResidentState()
        return
    with pytest.raises(ValueError, match="resident plane lives on"):
        schedule_items(items, clusters, resident=state)


def test_untokened_fused_cycle_matches_plain():
    """Without tokens every slot frees right after its chunk's merge, so
    the next chunk's misses rewrite those slots before this chunk's
    finalize: the spread sub-solve must read the chunk's own gathered
    rows, not the host masters.  Fused and host planes equal a plain
    cycle over region-spread rows in eight chunks, twice."""
    clusters, items, _rng, _names = S.bench_scenario(MP, 3, 300, 256)
    plain = [_targets(r) for r in schedule_items(
        items, clusters, chunk=32, waves=2, device="cpu")]
    for fused in (False, True):
        state = ResidentState(audit_interval=0, fused=fused, device="cpu")
        for _ in range(2):
            got = [_targets(r) for r in schedule_items(
                items, clusters, chunk=32, waves=2, device="cpu",
                resident=state)]
            assert got == plain, fused
    assert state.fused_cycles > 0
