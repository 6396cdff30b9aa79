"""Explain-plane parity: the port's explain plane (karmada_tpu_torch, the
plain version of kernel K7 explain_rows on the CPU) equals the JAX
package's explain variant on the same inputs, tolerance 0 -- the dense
(verdict, score, avail, outcome) planes of the main solve and of the
spread phase B, the Decision records of a whole cycle (apart from
ts/id/trace_id) and the `reason` attached to every unschedulable result.

Fixtures set all nine verdict bits (after tests/test_explain.py:58-180).
The hazards of the port are pinned by name: which capacity each wave's
verdict sees (waves 1 and 4, with a carry-in), and the disarmed path
running no K7.  The JAX side always gets its own DecisionRecorder: the
process-wide recorder (obs/decisions.configure) is never armed here."""

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.obs import decisions as JD
from karmada_tpu.ops import serial as jax_serial
from karmada_tpu.ops import solver as JS
from karmada_tpu.ops import spread as JSP
from karmada_tpu.ops import tensors as JT
from karmada_tpu.scheduler import pipeline as JP
from karmada_tpu.scheduler.plugins import REGISTRY as JAX_PLUGINS
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.obs import decisions as PD
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import spread as PSP
from karmada_tpu_torch.ops import tensors as PT
from karmada_tpu_torch.scheduler import pipeline as PP
from karmada_tpu_torch.scheduler.core import schedule_items
from karmada_tpu_torch.scheduler.plugins import REGISTRY as PORT_PLUGINS

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")


@pytest.fixture
def plugin():
    """The explain scenario's filter plugin, in both packages."""
    JAX_PLUGINS.register_filter("explainPlug", S.plugin_filter)
    PORT_PLUGINS.register_filter("explainPlug", S.plugin_filter)
    yield
    JAX_PLUGINS.unregister("explainPlug")
    PORT_PLUGINS.unregister("explainPlug")


def _encode(build, explain=True):
    cj, ij = build(MJ)
    cp, ip = build(MP)
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator(),
                         explain=explain)
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(cp), GeneralEstimator(),
                         explain=explain)
    return (jb, ij, cj), (pb, ip, cp)


def _carry(batch, seed):
    rng = np.random.default_rng(seed)
    return PT.carry_from_arrays(
        rng.integers(0, 30_000, batch.avail_milli.shape),
        rng.integers(0, 60, batch.pods_allowed.shape),
        rng.integers(0, 4, batch.est_override.shape))


def _same_planes(want, got):
    for name, a, b in zip(("verdict", "score", "avail", "outcome"), want,
                          got):
        a = np.asarray(a)
        assert a.dtype == b.dtype == np.int32, name
        assert np.array_equal(a, b), (name, np.argwhere(a != b)[:5])


SCENARIOS = {
    "every_stage": S.explain_scenario,
    "random_direct": lambda M: S.random_scenario(M, 3, n_clusters=11,
                                                 n_bindings=32),
    "random_gather": lambda M: S.random_scenario(M, 4, n_clusters=700,
                                                 n_bindings=16),
}


@pytest.mark.parametrize("scenario,waves,carry", [
    ("every_stage", 1, False),
    ("every_stage", 4, False),
    ("every_stage", 4, True),
    ("random_direct", 4, True),
    ("random_gather", 1, True),
])
def test_hazard_explain_planes_see_each_waves_capacity(plugin, scenario,
                                                       waves, carry):
    """solve_compact(explain=True): the port's planes (explain_rows_plain
    once per wave, after that wave's K2) equal the JAX explain variant's
    bit for bit, COO and carry included.  At waves 4 and with a carry-in
    each wave's verdict must see that wave's avail_cal (carry-in plus
    earlier waves' charges): a K7 reading the chunk's first or last est
    passes only the waves-1 cases."""
    (jb, _, _), (pb, _, _) = _encode(SCENARIOS[scenario])
    used0 = _carry(pb, 7) if carry else None
    want = JS.solve_compact(jb, waves=waves, with_used=True, used0=used0,
                            explain=True)
    got = PS.solve_compact(pb, waves=waves, with_used=True, used0=used0,
                           explain=True, device="cpu")
    nnz = want[3]
    assert nnz == got[3]
    assert np.array_equal(np.asarray(want[0])[:nnz], got[0])
    assert np.array_equal(np.asarray(want[1])[:nnz], got[1])
    assert np.array_equal(np.asarray(want[2]), got[2])
    for a, b in zip(want[4], got[4]):
        assert np.array_equal(np.asarray(a), b)
    _same_planes(want[5], got[5])
    if scenario == "every_stage":
        verdict, _score, _avail, outcome = got[5]
        bits = np.bitwise_or.reduce(verdict.reshape(-1))
        assert bits == (1 << PD.N_VERDICT_BITS) - 1, bin(bits)
        # an UNSCHEDULABLE row always classifies as capacity
        st, dom = PD.split_outcome(int(outcome[2]))
        assert (st, dom) == (PT.STATUS_UNSCHEDULABLE, "capacity")


def test_dense_solve_and_plain_rows_equal_schedule_batch(plugin):
    """solve(explain=True) (dense) against JAX schedule_batch(explain=
    True); and explain_rows_plain called row slice by row slice on the
    wave's est writes exactly those planes."""
    (jb, _, _), (pb, _, _) = _encode(S.explain_scenario)
    out = JS.schedule_batch(*JS._batch_args(jb),
                            pl_fail_bits=jb.pl_fail_bits, waves=1,
                            use_extra=JS._use_extra(jb), explain=True)
    got = PS.solve(pb, waves=1, device="cpu", explain=True)
    for a, b in zip(out[:3], got[:3]):
        assert np.array_equal(np.asarray(a), b)
    _same_planes(out[3], got[3])
    db = PS.device_batch(pb, "cpu", explain=True)
    rep, sel, status, used, _ = PS.schedule_core(db, waves=1,
                                                 use_extra=False)
    zeros = PS._zeros_used(db)
    est = PS.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                      db.avail_milli, zeros[0], db.has_alloc,
                      db.pods_allowed, zeros[1], db.has_summary,
                      db.est_override, zeros[2])
    planes = PS.explain_planes(db.B, db.C, db.device)
    for r0 in range(0, db.B, 3):
        PS.explain_rows_plain(db, r0, min(db.B, r0 + 3), est,
                              db.pl_fail_bits, sel, status, planes)
    _same_planes(out[3], tuple(p.numpy() for p in planes))


SPREAD = {
    "region": (lambda M: S.region_scenario(M, 3), 1),
    "label": (lambda M: S.label_scenario(M, 2), 8),
    "big_tier": (S.spread_big_scenario, 8),
}


@pytest.mark.parametrize("scenario", sorted(SPREAD))
def test_spread_explain_rows_match_jax(scenario):
    """solve_spread(explain=True): the callback rows of every live binding
    equal the JAX package's (raw-snapshot planes, pick AND selection, the
    real placement's fail bits), on region and label axes and the big
    tier, with a carry-in."""
    build, waves = SPREAD[scenario]
    (jb, ij, _), (pb, ip, _) = _encode(build)
    used0 = _carry(pb, 3)
    groups_j = JT.spread_groups(jb, ij)
    groups_p = PT.spread_groups(pb, ip)
    assert groups_j == groups_p and groups_p
    for (axis, tier), idxs in groups_p.items():
        rows_j, rows_p = {}, {}
        JSP.solve_spread(jb, ij, idxs, waves=waves, collect_used=True,
                         used0=used0, axis=axis, tier=tier, explain=True,
                         explain_cb=lambda b, *r: rows_j.__setitem__(b, r))
        PSP.solve_spread(pb, ip, idxs, waves=waves, collect_used=True,
                         used0=used0, axis=axis, tier=tier, explain=True,
                         explain_cb=lambda b, *r: rows_p.__setitem__(b, r),
                         device="cpu")
        assert rows_j.keys() == rows_p.keys() and rows_p
        for b, want in rows_j.items():
            got = rows_p[b]
            for a, c in zip(want[:3], got[:3]):
                assert np.array_equal(np.asarray(a), c), (axis, tier, b)
            assert int(want[3]) == got[3], (axis, tier, b)


def _strip(d):
    return {k: v for k, v in d.items() if k not in ("ts", "id", "trace_id")}


def _jax_cycle(clusters, items, chunk, waves, rec):
    """The JAX Scheduler._solve (backend="device", explain armed)
    unrolled: run_pipeline with the recorder, then the serial path for
    host rows with outcome-level decisions (service.py:1411-1421)."""
    est = JaxEstimator()
    cache = JT.EncoderCache()
    cache.reset_for_cycle()
    carry = len(items) > chunk
    res = JP.run_pipeline(items, JT.ClusterIndex.build(clusters), est,
                          chunk=chunk, waves=waves, cache=cache, carry=carry,
                          carry_spread=carry, explain=rec)
    cal = jax_serial.make_cal_available([est])
    out = []
    for i, (spec, status) in enumerate(items):
        if i in res.results:
            out.append(res.results[i])
            continue
        try:
            out.append(jax_serial.schedule(spec, status, clusters, cal))
        except Exception as e:  # noqa: BLE001 — the binding's outcome
            out.append(e)
    for i in range(len(items)):
        if i not in res.results:
            rec.record(JD.decision_from_result(
                JD.default_key(items[i][0]), out[i], len(clusters),
                backend="serial"))
    return out


def _norm(r):
    if isinstance(r, Exception):
        return (type(r).__name__, getattr(r, "reason", None))
    return sorted((t.name, t.replicas) for t in r)


def test_schedule_items_decisions_equal_jax_cycle():
    """schedule_items(explain=rec) vs JAX run_pipeline(explain=rec) plus
    the serial path, over every device route and host routes in two
    carried chunks: the same results, the same exc.reason on every
    unschedulable one, and the same Decision records in the same order
    (apart from ts/id/trace_id).  Every binding gets exactly one."""
    import test_torch_slice as TS

    chunk, waves = 24, 8
    cj, ij = TS.all_routes_scenario(MJ, 5)
    cp, ip = TS.all_routes_scenario(MP, 5)
    rec_j, rec_p = JD.DecisionRecorder(), PD.DecisionRecorder()
    want = _jax_cycle(cj, ij, chunk, waves, rec_j)
    stats = PP.PipelineResult()
    got = schedule_items(ip, cp, chunk=chunk, waves=waves, device="cpu",
                         explain=rec_p, stats=stats)
    assert [_norm(r) for r in got] == [_norm(r) for r in want]
    assert any(getattr(r, "reason", None) for r in got)
    dj = [_strip(d) for d in rec_j.recent()]
    dp = [_strip(d) for d in rec_p.recent()]
    assert len(dp) == len(ip) and len({d["key"] for d in dp}) == len(ip)
    assert dp == dj
    assert {d["backend"] for d in dp} == {"device", "device-spread",
                                          "device-big", "serial"}
    assert stats.explain_s > 0
    assert rec_p.stats() == rec_j.stats()
    # the read side: the shelf of failed decisions and the lookup by key
    assert [_strip(d) for d in rec_p.unschedulable()] == [
        _strip(d) for d in rec_j.unschedulable()]
    assert rec_p.unschedulable()
    for d in dp[::7]:
        assert _strip(rec_p.get(d["key"])) == _strip(rec_j.get(d["key"]))


def test_disarmed_path_runs_no_k7_and_equal_results(monkeypatch, plugin):
    """Without explain= nothing calls explain_rows and no plane is
    allocated; armed, the placements are identical to the disarmed run."""
    calls = []
    real = PS.explain_rows

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(PS, "explain_rows", spy)
    monkeypatch.setattr(PSP, "explain_rows", spy)
    import test_torch_slice as TS

    cp, ip = TS.all_routes_scenario(MP, 5, n_clusters=40, n_bindings=24)
    stats = PP.PipelineResult()
    off = schedule_items(ip, cp, chunk=12, waves=4, device="cpu",
                         stats=stats)
    assert calls == [] and stats.explain_s == 0
    rec = PD.DecisionRecorder()
    on = schedule_items(ip, cp, chunk=12, waves=4, device="cpu",
                        explain=rec)
    assert calls
    assert [_norm(r)[:1] if isinstance(r, Exception) else _norm(r)
            for r in on] == [
        _norm(r)[:1] if isinstance(r, Exception) else _norm(r) for r in off]
    assert len(rec.recent()) == len(ip)
    handle = PS.dispatch_compact(
        PT.encode_batch(ip[:12], PT.ClusterIndex.build(cp)), waves=4,
        device="cpu")
    assert handle.explain is None and len(PS.finalize_compact(handle)) == 4


# -- the rows K7's design branches on ------------------------------------------

@pytest.mark.parametrize("waves,carry", [(1, False), (4, True), (16, False)])
def test_explain_edge_rows_match_jax(plugin, waves, carry):
    """solve_compact(explain=True) on explain_edge_batch, the same arrays
    in both packages: duplicate prev lanes (a prev lane is an OR of its
    entries), an evict lane that is also a prev lane, an invalid row, an
    UNSCHEDULABLE row, a non-workload-shortcut row and a class whose est
    is MAX_INT32 (avail_cal the row's replicas) -- planes, COO and carry
    equal the JAX package's bit for bit."""
    jb, row, lane = S.explain_edge_batch(MJ, JT, JaxEstimator())
    pb, _row, _lane = S.explain_edge_batch(MP, PT, GeneralEstimator())
    used0 = _carry(pb, 5) if carry else None
    want = JS.solve_compact(jb, waves=waves, with_used=True, used0=used0,
                            explain=True)
    got = PS.solve_compact(pb, waves=waves, with_used=True, used0=used0,
                           explain=True, device="cpu")
    nnz = want[3]
    assert nnz == got[3]
    assert np.array_equal(np.asarray(want[0])[:nnz], got[0])
    assert np.array_equal(np.asarray(want[1])[:nnz], got[1])
    assert np.array_equal(np.asarray(want[2]), got[2])
    for a, b in zip(want[4], got[4]):
        assert np.array_equal(np.asarray(a), b)
    _same_planes(want[5], got[5])
    verdict, score, avail, outcome = got[5]
    dups = pb.prev_idx[row["dups"]]
    assert len(set(dups.tolist())) < len(dups) and (dups >= 0).all()
    # the evicted prev lane: evicted, and scored as previous
    ev, ok1 = row["evprev"], lane["m-ok1"]
    assert verdict[ev, ok1] & (1 << 4) and score[ev, ok1] == 100
    assert not verdict[row["invalid"]].any()
    st, dom = PD.split_outcome(int(outcome[row["too-big"]]))
    assert (st, dom) == (PT.STATUS_UNSCHEDULABLE, "capacity")
    assert (avail[row["shortcut"]] == 2 ** 31 - 1).all()
    if not carry:
        free = row["free"]
        n = pb.replicas[free]
        assert avail[free, ok1] == avail[free, lane["m-ok3"]] == n


def test_spread_explain_edge_rows_match_jax():
    """K7's spread flavour (solve_spread(explain=True)) on
    spread_explain_edge_batch, the same arrays in both packages: the
    callback rows of every live binding equal the JAX package's."""
    jb, ij = S.spread_explain_edge_batch(MJ, JT, JaxEstimator())
    pb, ip = S.spread_explain_edge_batch(MP, PT, GeneralEstimator())
    used0 = _carry(pb, 3)
    groups = PT.spread_groups(pb, ip)
    assert groups == JT.spread_groups(jb, ij) and groups
    for (axis, tier), idxs in groups.items():
        rows_j, rows_p = {}, {}
        JSP.solve_spread(jb, ij, idxs, waves=4, collect_used=True,
                         used0=used0, axis=axis, tier=tier, explain=True,
                         explain_cb=lambda b, *r: rows_j.__setitem__(b, r))
        PSP.solve_spread(pb, ip, idxs, waves=4, collect_used=True,
                         used0=used0, axis=axis, tier=tier, explain=True,
                         explain_cb=lambda b, *r: rows_p.__setitem__(b, r),
                         device="cpu")
        assert rows_j.keys() == rows_p.keys() and rows_p
        for b, want in rows_j.items():
            got = rows_p[b]
            for a, c in zip(want[:3], got[:3]):
                assert np.array_equal(np.asarray(a), c), (axis, tier, b)
            assert int(want[3]) == got[3], (axis, tier, b)


@pytest.mark.parametrize("n_clusters", [1, 3, 5, 11, 700])
def test_encoded_cluster_axis_is_a_multiple_of_four(n_clusters):
    """K7 takes four lanes a thread (16-byte vectors) and needs C a
    multiple of 4: both packages' encoders pad C to a power of two >= 8,
    so they cannot hand it another C (the wrapper refuses one:
    test_explain_vec_check_refuses_other_layouts)."""
    cp, ip = S.random_scenario(MP, 1, n_clusters=n_clusters, n_bindings=4)
    cj, ij = S.random_scenario(MJ, 1, n_clusters=n_clusters, n_bindings=4)
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(cp), GeneralEstimator())
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator())
    assert pb.C == jb.C and pb.C % 4 == 0 and pb.C >= 8


@pytest.mark.parametrize("C, a_at, b_at, ok", [
    (16, 0, 0, True), (16, 4, 16, True), (13, 0, 0, False),
    (4099, 0, 0, False), (16, 1, 0, False), (16, 0, 1, False)])
def test_explain_vec_check_refuses_other_layouts(C, a_at, b_at, ok):
    """The wrapper's check before K7's vector path (solver.
    check_explain_vec, run by every ExplainWorkspace): C a multiple of 4
    and every plane 16-byte aligned pass; a C of 13 or 4,099, or a plane
    one or four bytes off its boundary, raises."""
    a = torch.zeros(64, dtype=torch.int32)
    b = torch.zeros(80, dtype=torch.bool)
    assert a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
    planes = [a[a_at:], b[b_at:]]
    if ok:
        PS.check_explain_vec(C, planes)
    else:
        with pytest.raises(ValueError):
            PS.check_explain_vec(C, planes)
