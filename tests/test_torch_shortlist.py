"""Shortlist parity: the port's two-tier solve (karmada_tpu_torch
ops/shortlist, the plain versions of kernels K8 shortlist_topk and K9
group_sums plus the solver on the CPU) equals the JAX package's
ops/shortlist on the same inputs, tolerance 0: the tier-1 candidate plane
and the per-group sums, the cycle aggregates and their memo, the
sub-vocabulary batch field by field, and whole cycles -- port shortlisted
== JAX shortlisted == port dense -- on tests/test_shortlist.py's cases
(covered fuzz, prev lanes in the union, carry across shortlisted chunks,
widen and retry, every fallback reason, truncation at waves 1 and its
refusal at waves > 1, explain through the remap).  Both packages' memos
and counters are reset around every test."""

import random

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.obs import decisions as JD
from karmada_tpu.ops import shortlist as JSL
from karmada_tpu.ops import solver as JS
from karmada_tpu.ops import tensors as JT
from karmada_tpu.scheduler import pipeline as JP
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.obs import decisions as PD
from karmada_tpu_torch.ops import shortlist as PSL
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import tensors as PT
from karmada_tpu_torch.scheduler import pipeline as PP

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")


@pytest.fixture(autouse=True)
def _reset_memos():
    JSL.reset_for_tests()
    PSL.reset_for_tests()
    yield
    JSL.reset_for_tests()
    PSL.reset_for_tests()


def _scenario(M, seed, n_clusters, n_items, n_pl=12, lo=3, hi=16,
              prev_of=None, shrink_pods=None, extra_pls=()):
    rng = random.Random(seed)
    clusters = S.build_fleet(M, rng, n_clusters)
    if shrink_pods is not None:
        for c in clusters:
            c.status.resource_summary.allocatable["pods"] = (
                M.Quantity.from_units(shrink_pods))
    names = [c.name for c in clusters]
    pls = S.affinity_placements(M, rng, names, n=n_pl, lo=lo, hi=hi)
    for n, elo, ehi in extra_pls:
        pls += S.affinity_placements(M, rng, names, n=n, lo=elo, hi=ehi)
    items = S.shortlist_items(M, rng, n_items, pls,
                              prev_of=prev_of(names) if prev_of else None)
    return clusters, items


def _targets(r):
    if isinstance(r, Exception):
        return type(r).__name__
    return sorted((t.name, t.replicas) for t in r)


def _jax_run(clusters, items, cfg, chunk, waves, explain=None):
    return JP.run_pipeline(
        items, JT.ClusterIndex.build(clusters), JaxEstimator(), chunk=chunk,
        waves=waves, carry=True, carry_spread=True, shortlist=cfg,
        explain=explain)


def _port_run(clusters, items, cfg, chunk, waves, explain=None):
    return PP.run_pipeline(
        items, PT.ClusterIndex.build(clusters), GeneralEstimator(),
        chunk=chunk, waves=waves, carry=True, shortlist=cfg, explain=explain,
        device="cpu")


def _same_results(a, b):
    assert a.results.keys() == b.results.keys()
    for i in a.results:
        assert _targets(a.results[i]) == _targets(b.results[i]), i


def _cfg(pkg, **kw):
    return (JSL if pkg == "jax" else PSL).ShortlistConfig(**kw)


def _jax_counts():
    """The JAX package's shortlist counters (process-wide, cumulative)."""
    return {"dispatches": JSL.SHORTLIST_DISPATCHES.value(),
            "rows": JSL.SHORTLIST_ROWS.value(),
            "widenings": JSL.SHORTLIST_WIDENINGS.value(),
            **{f"fallback:{r}": JSL.SHORTLIST_FALLBACKS.value(reason=r)
               for r in PSL.FALLBACKS}}


def _port_counts():
    return {"dispatches": PSL.COUNTS["dispatches"],
            "rows": PSL.COUNTS["rows"],
            "widenings": PSL.COUNTS["widenings"],
            **{f"fallback:{r}": n for r, n in PSL.FALLBACKS.items()}}


# -- tier 1: K8 and K9 plain against the JAX kernels ---------------------------

def _topk_case(batch, case):
    """Edit an encoded batch (either package's) for one case of the
    tier-1 contract; the same edit lands in both packages' batches."""
    rng = np.random.default_rng(sum(map(ord, case)))
    C = batch.C
    for f in ("est_override", "class_id", "has_summary", "pods_allowed",
              "req_milli", "pl_mask", "b_valid"):
        setattr(batch, f, np.array(getattr(batch, f)))
    if case == "override":
        # overrides >= 0 (zero included) on every class, some lanes each
        mask = rng.random(batch.est_override.shape) < 0.3
        batch.est_override[mask] = rng.integers(0, 6, int(mask.sum()))
    elif case == "class_none":
        batch.class_id[1::3] = -1  # the no-requirements row Q
    elif case == "no_summary":
        batch.has_summary[rng.random(C) < 0.3] = False
        batch.pods_allowed[rng.random(C) < 0.3] = 0
    elif case == "max_int32":
        # class 0 requests nothing and the pods bound passes MAX_INT32:
        # its capacity is MAX_INT32, read as the row's replicas
        batch.req_milli[0, :] = 0
        batch.pods_allowed[::2] = 1 << 40
        batch.class_id[::4] = 0
        batch.est_override[0, ::3] = (1 << 31) - 1
    elif case == "ineligible":
        # a valid row whose placement admits no lane and with no prev lane
        r = int(np.flatnonzero(batch.b_valid & (batch.prev_idx < 0).all(1))[0])
        batch.pl_mask[batch.placement_id[r], :] = False
    return batch


@pytest.mark.parametrize("case", ["base", "override", "class_none",
                                  "no_summary", "max_int32", "ineligible"])
@pytest.mark.parametrize("k", [3, 16, 40])
def test_shortlist_topk_plain_matches_jax(k, case):
    """The candidate plane of real binding rows -- prev and evict lanes,
    taints, histogram-override classes, invalid rows -- through JAX
    shortlist_topk (its own capacity estimate) and the port's
    shortlist_topk_plain (capacity_plain's, no est argument): cand equal
    as arrays (order included), fcount equal.  Cases: overrides >= 0,
    class -1 rows, clusters without a summary or pods, capacity MAX_INT32
    (read as replicas), a valid row with no eligible lane; k = 40 is the
    whole fleet, beyond every row's eligible count."""
    cj, ij = S.random_scenario(MJ, 11, n_clusters=40, n_bindings=32)
    cp, ip = S.random_scenario(MP, 11, n_clusters=40, n_bindings=32)
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator())
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(cp), GeneralEstimator())
    assert (pb.prev_idx >= 0).any() and (pb.evict_idx >= 0).any()
    jb.b_valid[::5] = False  # padding-like rows: every lane ineligible
    pb.b_valid[::5] = False
    jb, pb = _topk_case(jb, case), _topk_case(pb, case)
    assert (pb.est_override >= 0).any()
    rng = np.random.default_rng(5)
    pref = rng.integers(0, 32, pb.C).astype(np.int64)
    cand_j, fc_j = JSL.shortlist_topk(
        jb.cluster_valid, jb.deleting, jb.name_rank, jb.pods_allowed,
        jb.has_summary, jb.avail_milli, jb.has_alloc, jb.api_ok,
        jb.req_milli, jb.req_is_cpu, jb.req_pods, jb.est_override,
        jb.pl_mask, jb.pl_tol_bypass, pref, jb.b_valid, jb.placement_id,
        jb.gvk_id, jb.class_id, jb.replicas, jb.prev_idx, jb.prev_val,
        jb.evict_idx, k=k)
    db = PS.device_batch(pb, "cpu")
    cand_p, fc_p = PSL.shortlist_topk(db, torch.from_numpy(pref), k)
    assert np.array_equal(np.asarray(cand_j), cand_p.numpy())
    assert np.array_equal(np.asarray(fc_j), fc_p.numpy())
    fc = fc_p.numpy()
    assert (fc < k).any()
    if k < 40:
        assert (fc > k).any()
    if case == "ineligible":
        assert ((fc == 0) & pb.b_valid[:len(fc)]).any()
    if case == "max_int32":
        z = PS._zeros_used(db)
        est = PS.capacity_plain(db.req_milli, db.req_is_cpu, db.req_pods,
                                db.avail_milli, z[0], db.has_alloc,
                                db.pods_allowed, z[1], db.has_summary,
                                db.est_override, z[2])
        assert (est[0] == PS.MAX_INT32).any()
    if case == "class_none":
        assert (pb.class_id[pb.b_valid] == -1).any()
    gid = rng.integers(-1, 5, pb.C).astype(np.int32)
    cap = rng.integers(0, 300, pb.C).astype(np.int64)
    want = np.asarray(JSL._group_sums(gid, cap, n_groups=5))
    got = PSL.group_sums(torch.from_numpy(gid), torch.from_numpy(cap), 5)
    assert np.array_equal(want, got.numpy())


def test_shortlist_topk_plain_k_beyond_lanes():
    """k above C (the kernel takes up to kernels.TOPK_MAX_K): the plain
    version's columns past C are -1, the first C as at k = C."""
    _cp, ip = S.random_scenario(MP, 11, n_clusters=40, n_bindings=32)
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(_cp), GeneralEstimator())
    db = PS.device_batch(pb, "cpu")
    pref = torch.from_numpy(np.random.default_rng(5).integers(
        0, 32, pb.C).astype(np.int64))
    at_c = PSL.shortlist_topk(db, pref, pb.C)
    beyond = PSL.shortlist_topk(db, pref, pb.C + 25)
    assert torch.equal(beyond[0][:, :pb.C], at_c[0])
    assert (beyond[0][:, pb.C:] == -1).all()
    assert torch.equal(beyond[1], at_c[1])


@pytest.mark.parametrize("case", ["beyond_tile", "below_minus_one",
                                  "above_groups", "wrap", "one_group"])
def test_group_sums_plain_edge_cases_match_jax(case):
    """K9's contract at its edges, plain against JAX _group_sums: more
    groups than one shared-memory tile of bins holds (the kernel's tiled
    branch), ids below -1 (the trailing bucket), ids above G (dropped), an
    int64 sum that wraps, every lane in one group."""
    from karmada_tpu_torch.ops import kernels

    rng = np.random.default_rng(sum(map(ord, case)))
    C, G = 16384, 200
    gid = rng.integers(-1, G, C)
    cap = rng.integers(0, 256, C)
    if case == "beyond_tile":
        G = kernels.GROUP_SUM_TILE_BINS + 1000
        gid = rng.integers(-1, G, C)
        gid[::7] = G - 1 - rng.integers(0, 500, gid[::7].size)
    elif case == "below_minus_one":
        gid[::3] = rng.integers(-(1 << 31), -1, gid[::3].size)
    elif case == "above_groups":
        gid[::5] = rng.integers(G + 1, G + 40, gid[::5].size)
        gid[1] = G  # the trailing bucket by id, kept
    elif case == "wrap":
        cap = rng.integers(1 << 61, 1 << 62, C)
        gid = np.sort(gid)  # runs of one group, as a region layout has
    else:
        gid = np.full(C, 3)
    gid, cap = gid.astype(np.int32), cap.astype(np.int64)
    want = np.asarray(JSL._group_sums(gid, cap, n_groups=G))
    got = PSL.group_sums(torch.from_numpy(gid), torch.from_numpy(cap), G)
    assert got.dtype == torch.int64 and got.shape == (G + 1,)
    assert np.array_equal(want, got.numpy())
    if case == "wrap":
        exact = [sum(int(v) for v in cap[gid == g]) for g in range(3)]
        assert any(not -(1 << 63) <= x < (1 << 63) for x in exact)


def test_cycle_aggregates_equal_and_memoized():
    cj, ij = _scenario(MJ, 73, 32, 16, n_pl=3)
    cp, ip = _scenario(MP, 73, 32, 16, n_pl=3)
    jcache, pcache = JT.EncoderCache(), PT.EncoderCache()
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator(),
                         cache=jcache)
    pidx = PT.ClusterIndex.build(cp)
    p1 = PT.encode_batch(ip, pidx, GeneralEstimator(), cache=pcache)
    p2 = PT.encode_batch(ip, pidx, GeneralEstimator(), cache=pcache)
    want = JSL.cycle_aggregates(jb)
    a1 = PSL.cycle_aggregates(p1, "cpu")
    for key in ("group_cap", "group_pref", "cap_proxy"):
        assert np.array_equal(want[key], a1[key]), key
    assert want["names"] == a1["names"]
    assert want["n_groups"] == a1["n_groups"]
    # same frozen cluster planes -> one aggregation, pinned sources
    assert p1.avail_milli is p2.avail_milli
    assert PSL.cycle_aggregates(p2, "cpu") is a1
    assert a1["src"][0] is p1.avail_milli


def test_sub_batch_field_by_field_and_batch_round_trip():
    """_sub_batch over a truncation-free chunk with prev lanes equals the
    JAX sub-batch on every field; the JAX sub-batch (explain-encoded)
    carried across with batch_from_arrays solves like the port's own."""
    def prev_of(names):
        return {b: [(names[(b * 7 + 3) % len(names)], 2),
                    (names[(b * 11 + 9) % len(names)], 1)]
                for b in range(0, 40, 5)}

    cj, ij = _scenario(MJ, 5, 64, 40, n_pl=6, prev_of=prev_of)
    cp, ip = _scenario(MP, 5, 64, 40, n_pl=6, prev_of=prev_of)
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator(),
                         explain=True)
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(cp), GeneralEstimator(),
                         explain=True)
    sj, ij_info = JSL.shrink_chunk(jb, _cfg("jax", k=24, min_cells=0,
                                            union_frac=1.0))
    sp, ip_info = PSL.shrink_chunk(pb, _cfg("port", k=24, min_cells=0,
                                            union_frac=1.0), device="cpu")
    assert sj is not None and sp is not None
    for key in ("k", "widened", "union", "sub_c", "profiles", "residual",
                "cells_solve", "cells_dense"):
        assert ij_info[key] == ip_info[key], key
    for f in PT.FIELD_DTYPES:
        a, b = getattr(sj, f, None), getattr(sp, f, None)
        if a is None and b is None:
            continue
        assert np.array_equal(np.asarray(a), np.asarray(b)), f
    for f in ("B", "C", "n_bindings", "n_clusters", "sub_full_c", "sub_sig",
              "region_names", "res_names", "class_keys", "explain"):
        assert getattr(sj, f) == getattr(sp, f), f
    assert sj.cluster_index.names == sp.cluster_index.names
    prev = pb.prev_idx[pb.prev_idx >= 0]
    assert set(prev.tolist()) <= set(sp.sub_lanes[sp.sub_lanes >= 0])
    # the recall view of tier 1: per binding, profile candidates + prev
    cands = PSL.binding_candidates(pb, 24, device="cpu")
    assert cands == JSL.binding_candidates(jb, 24)
    assert set().union(*cands) == set(sp.sub_lanes[sp.sub_lanes >= 0])
    # the round trip: JAX's sub-batch, carried across, solves as the port's
    fields = {f: getattr(sj, f) for f in PT.FIELD_DTYPES
              if getattr(sj, f, None) is not None}
    crossed = PT.batch_from_arrays(fields, sj)
    assert crossed.sub_sig == sp.sub_sig and crossed.explain
    assert np.array_equal(crossed.sub_lanes, sp.sub_lanes)
    assert np.array_equal(crossed.pl_fail_bits, sp.pl_fail_bits)
    a = PS.solve_compact(crossed, waves=4, with_used=True, explain=True,
                         device="cpu")
    b = PS.solve_compact(sp, waves=4, with_used=True, explain=True,
                         device="cpu")
    for x, y in zip(a[:3] + a[4] + a[5], b[:3] + b[4] + b[5]):
        assert np.array_equal(x, y)


# -- whole cycles: port shortlisted == JAX shortlisted == port dense ------------

CASES = {
    # name: (scenario kwargs, config kwargs, chunk, waves, expected)
    "covered_fuzz": (dict(seed=3, n_clusters=96, n_items=150),
                     dict(k=24, min_cells=0, union_frac=1.0), 64, 4,
                     "shortlisted"),
    "prev_lanes": (dict(seed=5, n_clusters=64, n_items=40, n_pl=6,
                        prev_of=lambda names: {
                            b: [(names[(b * 7 + 3) % len(names)], 2),
                                (names[(b * 11 + 9) % len(names)], 1)]
                            for b in range(0, 40, 5)}),
                   dict(k=24, min_cells=0, union_frac=1.0), 64, 4,
                   "shortlisted"),
    "carry_across_chunks": (dict(seed=29, n_clusters=48, n_items=180,
                                 n_pl=8, lo=4, hi=10, shrink_pods=24),
                            dict(k=16, min_cells=0, union_frac=1.0), 48, 4,
                            "shortlisted"),
    "widen_and_retry": (dict(seed=41, n_clusters=64, n_items=30, n_pl=4,
                             lo=12, hi=20),
                        dict(k=4, k_max=64, min_cells=0, union_frac=1.0),
                        64, 4, "widened"),
    "uncovered": (dict(seed=43, n_clusters=64, n_items=24, n_pl=3, lo=4,
                       hi=6, extra_pls=[(1, 20, 24)]),
                  dict(k=4, k_max=8, min_cells=0, union_frac=1.0,
                       truncate=False), 64, 4, "uncovered"),
    "truncation_waves1": (dict(seed=43, n_clusters=64, n_items=24, n_pl=3,
                               lo=4, hi=6, extra_pls=[(1, 40, 48)]),
                          dict(k=8, k_max=16, min_cells=0, union_frac=1.0),
                          64, 1, "residual"),
    "truncation_off_waves4": (dict(seed=43, n_clusters=64, n_items=24,
                                   n_pl=3, lo=4, hi=6,
                                   extra_pls=[(1, 40, 48)]),
                              dict(k=8, k_max=16, min_cells=0,
                                   union_frac=1.0), 64, 4, "uncovered"),
    "union_wide": (dict(seed=53, n_clusters=64, n_items=64, n_pl=16, lo=10,
                        hi=16),
                   dict(k=16, min_cells=0, union_frac=0.2), 64, 4,
                   "union_wide"),
    "below_threshold": (dict(seed=59, n_clusters=32, n_items=16, n_pl=3),
                        dict(k=8, min_cells=1 << 30), 64, 4,
                        "below_threshold"),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cycle_shortlisted_equals_jax_and_dense(case):
    scen, cfgkw, chunk, waves, expect = CASES[case]
    cj, ij = _scenario(MJ, **scen)
    cp, ip = _scenario(MP, **scen)
    before = _jax_counts()
    want = _jax_run(cj, ij, _cfg("jax", **cfgkw), chunk, waves)
    jax_delta = {k: v - before[k] for k, v in _jax_counts().items()}
    got = _port_run(cp, ip, _cfg("port", **cfgkw), chunk, waves)
    assert _port_counts() == jax_delta
    dense = _port_run(cp, ip, None, chunk, waves)
    _same_results(want, got)
    _same_results(dense, got)
    st = got.shortlist
    if expect in ("uncovered", "union_wide", "below_threshold"):
        assert st["fallbacks"].get(expect, 0) >= 1, st
    else:
        assert st["chunks"] == got.chunks and not st["fallbacks"], st
        assert st["cells_solve"] <= st["cells_dense"]
    if expect == "widened":
        assert st["widened"] >= 1
    if expect == "residual":
        assert st["residual_rows"] >= 1


def test_mixed_routes_fall_back():
    """A chunk holding a region-spread row stays dense (mixed_routes), in
    both packages, and places like the dense run."""
    def build(M):
        clusters, items = _scenario(M, 47, 64, 20, n_pl=3)
        spread = S.region_spread_placement(M, region_max=2, cluster_max=4)
        for b in range(3, 20, 4):
            items[b][0].placement = spread
        return clusters, items

    cj, ij = build(MJ)
    cp, ip = build(MP)
    cfgkw = dict(k=24, min_cells=0)
    want = _jax_run(cj, ij, _cfg("jax", **cfgkw), 64, 4)
    got = _port_run(cp, ip, _cfg("port", **cfgkw), 64, 4)
    _same_results(want, got)
    _same_results(_port_run(cp, ip, None, 64, 4), got)
    assert got.shortlist["fallbacks"] == {"mixed_routes": 1}
    assert PSL.FALLBACKS["mixed_routes"] == 1
    assert PSL.COUNTS["fallback_rows_needed"] == 5
    # a fused batch keeps the dense path too
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(cp))
    pb.fused = True
    sub, info = PSL.shrink_chunk(pb, _cfg("port", **cfgkw), device="cpu")
    assert sub is None and info["fallback"] == "fused"


def test_explain_verdicts_through_the_remap():
    """An explain-armed shortlisted cycle: the decisions equal the JAX
    package's (cluster tables over the union's names), and the results
    equal the dense explain run's."""
    scen = dict(seed=67, n_clusters=64, n_items=40, n_pl=6)
    cj, ij = _scenario(MJ, **scen)
    cp, ip = _scenario(MP, **scen)
    cfgkw = dict(k=24, min_cells=0, union_frac=1.0)
    rec_j, rec_p = JD.DecisionRecorder(), PD.DecisionRecorder()
    want = _jax_run(cj, ij, _cfg("jax", **cfgkw), 64, 4, explain=rec_j)
    got = _port_run(cp, ip, _cfg("port", **cfgkw), 64, 4, explain=rec_p)
    _same_results(want, got)
    assert got.shortlist["chunks"] == 1
    strip = [{k: v for k, v in d.items() if k not in ("ts", "id",
                                                       "trace_id")}
             for d in rec_p.recent()]
    assert strip == [{k: v for k, v in d.items()
                      if k not in ("ts", "id", "trace_id")}
                     for d in rec_j.recent()]
    assert len(strip) == len(ip)
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(cp))
    sub, _ = PSL.shrink_chunk(pb, _cfg("port", **cfgkw), device="cpu")
    union = set(sub.cluster_index.names)
    assert all(row["name"] in union for d in strip for row in d["clusters"])
    dense = _port_run(cp, ip, None, 64, 4, explain=PD.DecisionRecorder())
    _same_results(dense, got)


def test_hazard_carry_segments_key_on_the_lane_set():
    """Two shortlisted chunks of equal shapes but different lane sets
    never chain device accumulators: the chain's signature holds sub_sig,
    and a sub-batch's consumption reaches the keyed store in the full
    vocabulary."""
    rng = random.Random(31)
    cp, pls = S.build_megafleet(MP, rng, 64, 4)
    ip = S.build_mega_bindings(MP, rng, 96, pls, block=48)
    cindex = PT.ClusterIndex.build(cp)
    cfg = _cfg("port", k=16, min_cells=0, union_frac=1.0)
    cache = PT.EncoderCache()
    subs = []
    for lo in (0, 48):
        b = PT.encode_batch(ip[lo:lo + 48], cindex, GeneralEstimator(),
                            cache=cache)
        s, _ = PSL.shrink_chunk(b, cfg, device="cpu")
        subs.append(s)
    a, b = subs
    assert a.C == b.C and a.sub_sig != b.sub_sig
    chain = PP._CarryChain()
    u0 = chain.carry_in(a)
    h = PS.dispatch_compact(a, waves=4, with_used=True, used0=u0,
                            device="cpu")
    chain.dispatched(a, h)
    assert chain._sig(a) != chain._sig(b) and not chain._subset(a, b)
    snap = chain.snapshot()
    full = PT.CarryState()
    full.absorb(a, tuple(u.numpy() for u in h.used), u0)
    assert snap.pods.shape == (a.sub_full_c,)
    assert np.array_equal(snap.pods, full.pods)
    lanes = a.sub_lanes[a.sub_lanes >= 0]
    outside = np.setdiff1d(np.arange(a.sub_full_c), lanes)
    assert not snap.pods[outside].any() and snap.pods[lanes].any()
    # the next chunk renders it through its own lane map
    u1 = chain.carry_in(b)
    ok = b.sub_lanes >= 0
    assert np.array_equal(u1[1][ok], snap.pods[b.sub_lanes[ok]])
