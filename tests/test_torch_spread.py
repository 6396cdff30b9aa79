"""Spread-plane parity: the port's ops/spread (karmada_tpu_torch, the plain
versions of kernels K5 spread_group_info and K6 spread_pick plus K1-K4 on
the CPU) equals the JAX package's ops/spread on the same inputs.  Integer
math: tolerance 0 on every output.

Covered: phase A's group scalars on batches carried across with
batch_from_arrays; solve_spread on region and spread-by-label axes, 40
one-cluster regions, the std and the big assignment tier, waves 1 and 8,
plugin scores, and the carry (collect_used with a nonzero used0).  The hazards of the
port are pinned by name: the sub-batch padding that decides the waves,
and which snapshot each step prices against."""

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import spread as JSP
from karmada_tpu.ops import tensors as JT
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import spread as PSP
from karmada_tpu_torch.ops import tensors as PT

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")

SCENARIOS = {
    "region": lambda M: S.region_scenario(M, 3),
    "region_many": lambda M: S.region_scenario(M, 104, n_clusters=24,
                                               n_bindings=12, n_regions=8),
    "label": lambda M: S.label_scenario(M, 2),
    "one_cluster_regions": lambda M: S.one_cluster_regions_scenario(M, 1),
    "big_tier": S.spread_big_scenario,
}


def norm(r):
    if isinstance(r, Exception):
        return type(r).__name__
    return sorted((t.name, t.replicas) for t in r)


def _both(build):
    """The JAX batch and items, and the port's own encode of the same
    scenario built with its models."""
    cj, ij = build(MJ)
    cp, ip = build(MP)
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator())
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(cp), GeneralEstimator())
    return (jb, ij), (pb, ip)


def _carry(batch, seed, scale=1):
    rng = np.random.default_rng(seed)
    return PT.carry_from_arrays(
        rng.integers(0, 4000 * scale, batch.avail_milli.shape),
        rng.integers(0, 20 * scale, batch.pods_allowed.shape),
        rng.integers(0, 3 * scale, batch.est_override.shape))


def _assert_spread(jside, pside, waves, used=None, idx_of=None):
    """solve_spread of every (axis, tier) group, JAX vs port; returns the
    number of rows compared and how many of them got placements."""
    (jb, ij), (pb, ip) = jside, pside
    groups = JT.spread_groups(jb, ij)
    assert groups == PT.spread_groups(pb, ip)
    assert groups, "scenario must exercise the spread plane"
    rows = placed = 0
    for (axis, tier), idxs in groups.items():
        idxs = idx_of(idxs) if idx_of is not None else idxs
        kw = dict(waves=waves, axis=axis, tier=tier)
        if used is not None:
            kw.update(collect_used=True, used0=used)
        want = JSP.solve_spread(jb, ij, idxs, **kw)
        got = PSP.solve_spread(pb, ip, idxs, device="cpu", **kw)
        if used is not None:
            (want, wu), (got, gu) = want, got
            assert (wu is None) == (gu is None)
            for a, b in zip(wu or (), gu or ()):
                assert np.array_equal(np.asarray(a), b)
        assert sorted(want) == sorted(got) == sorted(idxs)
        for k in want:
            assert norm(got[k]) == norm(want[k]), (axis, tier, k)
        rows += len(idxs)
        placed += sum(not isinstance(got[k], Exception) for k in got)
    return rows, placed


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_group_info_matches_jax(name):
    """Phase A on a batch carried across with batch_from_arrays: the
    port's spread_group_info (K5's plain version) equals JAX
    spread_group_info on score_g, avail_g, value_g and feas_any."""
    cj, ij = SCENARIOS[name](MJ)
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator())
    fields = {f: getattr(jb, f) for f in PT.FIELD_DTYPES
              if getattr(jb, f, None) is not None}
    pb = PT.batch_from_arrays(fields, jb)
    for (axis, _tier), idxs in JT.spread_groups(jb, ij).items():
        gid, names = ((jb.region_id, jb.region_names) if axis == ""
                      else jb.label_axes[axis])
        G = JT._next_pow2(len(names), 8)
        Bp = JT._next_pow2(len(idxs), 8)
        idx = np.asarray(idxs + [idxs[0]] * (Bp - len(idxs)))
        pid = jb.placement_id[idx]
        rmin, cmin = jb.pl_region_min[pid], jb.pl_sc_min[pid]
        dup = jb.pl_strategy[pid] == JT.STRAT_DUPLICATED
        want = JSP.spread_group_info(
            jb.cluster_valid, jb.deleting, jb.name_rank, jb.pods_allowed,
            jb.has_summary, jb.avail_milli, jb.has_alloc, jb.api_ok, gid,
            jb.req_milli, jb.req_is_cpu, jb.req_pods, jb.est_override,
            jb.pl_mask, jb.pl_tol_bypass, jb.pl_extra_score, pid,
            jb.gvk_id[idx], jb.class_id[idx], jb.replicas[idx], rmin, cmin,
            dup, jb.nw_shortcut[idx], jb.prev_idx[idx], jb.prev_val[idx],
            jb.evict_idx[idx], G=G)
        db = PS.device_batch(pb, "cpu", rows=idx)
        z = PS._zeros_used(db)
        est = PS.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                          db.avail_milli, z[0], db.has_alloc,
                          db.pods_allowed, z[1], db.has_summary,
                          db.est_override, z[2])
        t = torch.from_numpy
        got = PSP.spread_group_info(
            db, est, t(np.asarray(gid, np.int32)), t(rmin.astype(np.int64)),
            t(cmin.astype(np.int64)), t(dup), G)
        for name_, a, b in zip(("score_g", "avail_g", "value_g", "feas_any"),
                               want, got):
            assert np.array_equal(np.asarray(a), b.numpy()), name_
        assert np.asarray(want[2]).sum() > 0


@pytest.mark.parametrize("name,waves,variant", [
    ("region", 1, ""), ("region_many", 8, ""), ("label", 8, ""),
    ("one_cluster_regions", 1, ""), ("big_tier", 8, ""),
    ("big_tier", 8, "plugin_scores"), ("region", 1, "carry")])
def test_solve_spread_matches_jax(name, waves, variant):
    """solve_spread of every (axis, tier) group, JAX vs port.  Variants:
    `plugin_scores` -- out-of-tree plugin scores enter the lane score, so
    the group scores, the sort key of the pick and phase B's gather (its
    fifth, score-key group) all see them; `carry` -- collect_used with a
    nonzero used0 in the batch's vocabulary: the assignment prices against
    snapshot minus used0, and the returned accumulators (carry-in plus the
    spread rows' consumption) match."""
    jside, pside = _both(SCENARIOS[name])
    used = None
    if variant == "plugin_scores":
        extra = np.random.default_rng(8).integers(0, 101,
                                                   jside[0].pl_mask.shape)
        jside[0].pl_extra_score = extra
        pside[0].pl_extra_score = extra.copy()
        assert PS._use_extra(pside[0])
    elif variant == "carry":
        used = _carry(jside[0], 5)
    rows, placed = _assert_spread(jside, pside, waves, used=used)
    assert placed > 0
    tiers = {tier for _, tier in PT.spread_groups(*pside)}
    assert tiers == ({"big"} if name == "big_tier" else {"std"})


def test_hazard_sub_batch_padding_decides_waves():
    """11 spread rows pad to Bp = 16 in phase A; the live rows pad the
    same way in phase B, and _effective_waves(Bs, 8) then sets how many
    rows share each capacity wave (2 of 16, not 1 wave of 11).  On a
    fleet where each row takes about one cluster's cores that decides who
    is placed; the port pads exactly as the JAX program does."""
    jside, pside = _both(S.tight_region_scenario)
    groups = JT.spread_groups(*jside)
    assert [len(v) for v in groups.values()] == [11]
    assert _assert_spread(jside, pside, 1) == (11, 11)
    rows, placed = _assert_spread(jside, pside, 8)
    assert rows == 11 and 0 < placed < 11
    assert PS._effective_waves(16, 8) == 8 and PS._effective_waves(11, 8) == 1


def test_hazard_raw_snapshot_for_phase_a():
    """Phase A and the pick price against the raw snapshot; only the
    phase-B assignment sees used0.  A carry-in large enough to exhaust
    most clusters changes the assignment but not the group choice, in
    both packages alike."""
    jside, pside = _both(SCENARIOS["region_many"])
    _assert_spread(jside, pside, 2, used=_carry(jside[0], 6, scale=50))


@pytest.mark.parametrize("case", sorted(S.SPREAD_EDGE_CASES))
def test_spread_plain_matches_jax_on_edges(case):
    """K5's and K6's plain versions against the JAX programs on the
    scenarios of the kernels' branches (tests/torch_scenarios.py
    spread_edge_scenario at its CPU size): spread_group_info on score_g,
    avail_g, value_g and feas_any, and spread_pick_plain against
    _pick_one vmapped over the same planes' key order, with chosen groups
    and cluster caps of 0, 1, beyond every row's members and 2-8 (and on
    plugin_scores the case's plugin scores, some lanes above 200).  The
    card tests hold the kernels against these plain versions on the same
    scenarios at full size."""
    import jax.numpy as jnp

    cj, ij = S.spread_edge_scenario(MJ, case, small=True)
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator())
    xs = S.spread_edge_scores(case, jb.pl_extra_score.shape)
    if xs is not None:
        jb.pl_extra_score = xs
    fields = {f: getattr(jb, f) for f in PT.FIELD_DTYPES
              if getattr(jb, f, None) is not None}
    pb = PT.batch_from_arrays(fields, jb)
    groups = JT.spread_groups(jb, ij)
    assert groups
    rng = np.random.default_rng(11)
    seen = dict(rows=0, dup=0, infeasible=0, exhausted=0, deep=0, nodec=0)
    for (axis, _tier), idxs in groups.items():
        gid, names = ((jb.region_id, jb.region_names) if axis == ""
                      else jb.label_axes[axis])
        G = JT._next_pow2(len(names), 8)
        Bp = JT._next_pow2(len(idxs), 8)
        idx = np.asarray(idxs + [idxs[0]] * (Bp - len(idxs)))
        pid = jb.placement_id[idx]
        rmin, cmin = jb.pl_region_min[pid], jb.pl_sc_min[pid]
        dup = jb.pl_strategy[pid] == JT.STRAT_DUPLICATED
        rows = (pid, jb.gvk_id[idx], jb.class_id[idx], jb.replicas[idx])
        coo = (jb.nw_shortcut[idx], jb.prev_idx[idx], jb.prev_val[idx],
               jb.evict_idx[idx])
        want = JSP.spread_group_info(
            jb.cluster_valid, jb.deleting, jb.name_rank, jb.pods_allowed,
            jb.has_summary, jb.avail_milli, jb.has_alloc, jb.api_ok, gid,
            jb.req_milli, jb.req_is_cpu, jb.req_pods, jb.est_override,
            jb.pl_mask, jb.pl_tol_bypass, jb.pl_extra_score, *rows, rmin,
            cmin, dup, *coo, G=G)
        db = PS.device_batch(pb, "cpu", rows=idx)
        z = PS._zeros_used(db)
        est = PS.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                          db.avail_milli, z[0], db.has_alloc,
                          db.pods_allowed, z[1], db.has_summary,
                          db.est_override, z[2])
        t = torch.from_numpy
        gid_t = t(np.asarray(gid, np.int32))
        got = PSP.spread_group_info(
            db, est, gid_t, t(rmin.astype(np.int64)),
            t(cmin.astype(np.int64)), t(dup), G)
        for name_, a, b in zip(("score_g", "avail_g", "value_g", "feas_any"),
                               want, got):
            assert np.array_equal(np.asarray(a), b.numpy()), name_
        feasible, avail_sel, score, *_ = JSP._spread_planes(
            jb.cluster_valid, jb.deleting, jb.pods_allowed, jb.has_summary,
            jb.avail_milli, jb.has_alloc, jb.api_ok, jb.req_milli,
            jb.req_is_cpu, jb.req_pods, jb.est_override, jb.pl_mask,
            jb.pl_tol_bypass, jb.pl_extra_score, pid, rows[1], rows[2],
            rows[3], *coo)
        order = jnp.argsort(JSP._sort_key(score, avail_sel,
                                          jb.name_rank[None, :], feasible),
                            axis=1)
        chosen, cmax = S.spread_edge_chosen(rng, Bp, G, len(names))
        want_pick = JSP._pick_vmap(order, feasible, jnp.asarray(gid),
                                   jnp.asarray(chosen), jnp.asarray(cmax), G)
        got_pick = PSP.spread_pick_plain(db, est, gid_t, t(chosen), t(cmax),
                                         G)
        assert np.array_equal(np.asarray(want_pick), got_pick.numpy())
        assert got_pick.any()
        # what the case drove
        val = np.asarray(want[2])
        seen["rows"] += len(idxs)
        seen["dup"] += int(dup.sum())
        seen["infeasible"] += int((~np.asarray(want[3])).sum())
        tgt = np.where(rmin > 0, -(-jb.replicas[idx] // np.maximum(rmin, 1)),
                       jb.replicas[idx])
        avail_g = np.asarray(want[1])
        seen["exhausted"] += int(((val > 0) & ~dup[:, None]
                                  & (avail_g < tgt[:, None])).sum())
        seen["deep"] += int(((val > 0) & ~dup[:, None]
                             & (tgt[:, None] > 8 * 16)).sum())
        seen["nodec"] += int((np.asarray(feasible) & ~dup[:, None]
                              & (np.asarray(score) > 200)).sum())
    assert seen["rows"] > 0
    need = {"duplicated": "dup", "infeasible": "infeasible",
            "exhausted": "exhausted", "deep_walk": "deep",
            "wide_deep": "deep", "plugin_scores": "nodec"}.get(case)
    if need:
        assert seen[need] > 0, seen
