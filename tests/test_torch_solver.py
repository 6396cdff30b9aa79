"""Solver parity: the port's solve / solve_compact (karmada_tpu_torch, the
plain versions of kernels K1-K4 on the CPU) equal the JAX package's on the
same batch, carried across with batch_from_arrays.  Integer math:
tolerance 0 on every output.

Covered: waves 1, 4 and B; the direct lane path (C <= 528) and the
compact gather path (a 700-cluster fleet, 1024 lanes); dense rep/sel/
status, compact idx[:nnz]/val[:nnz]/status/nnz, the with_used carry
accumulators; prev/evict duplicates, uid_desc, scale-up/down/steady/
fresh, the Aggregated prefix, plugin scores (use_extra); and the four
hazards of a port, each pinned by name: stable sort, top-k ties, floor
division, duplicate scatters."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import solver as JS
from karmada_tpu.ops import tensors as JT
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import tensors as PT

MJ = S.models_of("karmada_tpu")


def _pair(clusters, items, mutate=None):
    """The JAX batch of (clusters, items) and the port's batch carried
    across from its arrays (after `mutate` edits the JAX arrays)."""
    jb = JT.encode_batch(items, JT.ClusterIndex.build(clusters),
                         JaxEstimator())
    if mutate is not None:
        mutate(jb)
    fields = {f: getattr(jb, f) for f in PT.FIELD_DTYPES
              if getattr(jb, f, None) is not None}
    return jb, PT.batch_from_arrays(fields, jb)


def direct_scenario(seed):
    """11 clusters -> 16 lanes (direct path), 24 bindings -> B = 32."""
    return S.random_scenario(MJ, seed, n_clusters=11, n_bindings=24)


def gather_scenario(seed):
    """700 clusters -> 1024 lanes (compact gather path), B = 16."""
    return S.random_scenario(MJ, seed, n_clusters=700, n_bindings=16)


def rebalance_scenario(seed, n_clusters=700, n_bindings=16):
    """bench.py's mix plus its rebalance cycle: prev assignments drive
    scale-up, scale-down and steady rows, a reschedule trigger fresh."""
    clusters, items, rng, names = S.bench_scenario(MJ, seed, n_clusters,
                                                   n_bindings)
    return clusters, S.build_rebalance_items(MJ, rng, items, names)


def _assert_dense(jb, pb, waves):
    want = JS.solve(jb, waves=waves)
    got = PS.solve(pb, waves=waves, device="cpu")
    for name, a, b in zip(("rep", "sel", "status"), want, got):
        assert a.shape == b.shape and np.array_equal(a, b), name
    return got


def _assert_compact(jb, pb, waves, used0=None, keep_sel=False):
    want = JS.solve_compact(jb, waves=waves, with_used=True, used0=used0,
                            keep_sel=keep_sel)
    got = PS.solve_compact(pb, waves=waves, with_used=True, used0=used0,
                           keep_sel=keep_sel, device="cpu")
    nnz = int(want[3])
    assert got[3] == nnz
    assert np.array_equal(got[0], np.asarray(want[0])[:nnz])
    assert np.array_equal(got[1], np.asarray(want[1])[:nnz])
    assert np.array_equal(got[2], np.asarray(want[2]))
    for a, b in zip(want[4], got[4]):
        assert np.array_equal(np.asarray(a), b)
    return got


@pytest.mark.parametrize("path,waves", [
    ("direct", 1), ("direct", 4), ("direct", "B"),
    ("gather", 1), ("gather", 4), ("gather", "B")])
def test_dense_parity(path, waves):
    build = direct_scenario if path == "direct" else gather_scenario
    jb, pb = _pair(*build(3))
    w = jb.B if waves == "B" else waves
    rep, sel, status = _assert_dense(jb, pb, w)
    assert (path == "direct") == (pb.C <= PS.TIERS["std"][2])
    # the scenario reaches several strategies and result classes
    strat = pb.pl_strategy[pb.placement_id[pb.b_valid]]
    assert len(set(strat.tolist())) >= 3
    assert rep.sum() > 0


@pytest.mark.parametrize("path", ["direct", "gather"])
def test_compact_with_used_carry(path):
    """COO extraction and the carry accumulators, with a nonzero carry-in
    (earlier chunks' consumption) in the batch's vocabulary."""
    build = direct_scenario if path == "direct" else gather_scenario
    jb, pb = _pair(*build(4))
    rng = np.random.default_rng(4)
    used0 = PT.carry_from_arrays(
        rng.integers(0, 4000, jb.avail_milli.shape),
        rng.integers(0, 20, jb.pods_allowed.shape),
        rng.integers(0, 3, jb.est_override.shape))
    got = _assert_compact(jb, pb, 4, used0)
    assert got[3] > 0
    assert any((u != u0).any() for u, u0 in zip(got[4], used0))


def test_compact_keep_sel():
    """Empty-workload propagation extracts every selected lane, replicas
    or not."""
    jb, pb = _pair(*direct_scenario(14))
    got = _assert_compact(jb, pb, 4, keep_sel=True)
    assert (got[1] == 0).any()


def test_uid_desc_strategies_and_modes():
    """The rebalance mix on the gather path: both uid tiebreak orders, all
    four strategies, and scale-up / scale-down / steady / fresh rows."""
    jb, pb = _pair(*rebalance_scenario(5, n_bindings=64))
    assert set(pb.uid_desc[:pb.n_bindings].tolist()) == {False, True}
    strat = pb.pl_strategy[pb.placement_id[:pb.n_bindings]]
    assert set(strat.tolist()) == {0, 1, 2, 3}
    prev = np.where(pb.prev_idx >= 0, pb.prev_val, 0).sum(1)
    dyn = (strat >= 2) & ~pb.fresh[:pb.n_bindings]
    n = pb.replicas[:pb.n_bindings]
    p = prev[:pb.n_bindings]
    assert (dyn & (p < n)).any() and (dyn & (p > n)).any()
    assert (dyn & (p == n)).any() and pb.fresh.any()
    _assert_dense(jb, pb, 4)


def test_plugin_score_use_extra():
    """Out-of-tree plugin scores switch the gather to its fifth (score
    key) group; the selection key then carries them."""
    def mutate(jb):
        rng = np.random.default_rng(7)
        jb.pl_extra_score = rng.integers(0, 101, jb.pl_mask.shape)
    jb, pb = _pair(*gather_scenario(6), mutate=mutate)
    assert PS._use_extra(pb)
    _assert_dense(jb, pb, 4)


def test_hazard_stable_sort():
    """Identical clusters: selection and Aggregated-prefix keys tie on
    score and capacity and differ only by name; infeasible lanes all carry
    the same sentinel key.  jnp.argsort is stable, torch.argsort is not
    unless asked -- the port sorts stably and breaks ties by lane."""
    def build():
        clusters, items = S.random_scenario(MJ, 8, n_clusters=11,
                                            n_bindings=24)
        for c in clusters:
            c.status.resource_summary = clusters[0].status.resource_summary
            c.status.api_enablements = [MJ.APIEnablement(*S.GVK[:1],
                                                         [S.GVK[1]])]
        return clusters, items
    jb, pb = _pair(*build())
    _assert_dense(jb, pb, 1)
    _assert_dense(jb, pb, 4)


def test_hazard_topk_ties():
    """Gather path with few eligible lanes: affinity subsets of 3-24
    clusters leave most keys at -1, and rows with fewer than 16 prev lanes
    fill the prev group with the lowest-index non-prev lanes (feasible
    ones included) -- lax.top_k's lowest-index tie order decides which
    lanes join the gathered set."""
    jb, pb = _pair(*rebalance_scenario(9, n_clusters=700, n_bindings=16))
    strat = pb.pl_strategy[pb.placement_id[:pb.n_bindings]]
    assert (strat <= 1).any()  # affinity-subset placements present
    _assert_dense(jb, pb, 1)
    _assert_compact(jb, pb, 4)


def test_hazard_floor_division():
    """The ceil trick -((-avail) // 1000) runs on avail - used, which goes
    negative under a large carry-in and is a non-multiple of 1000 for
    milli-quantified non-cpu resources: C-style truncation would differ
    from floor division on both."""
    rng = np.random.default_rng(11)
    Q, R, C = 4, 4, 64
    req = rng.integers(0, 3000, (Q, R))
    req[:, 1] = rng.integers(1, 5, Q)
    is_cpu = np.array([True, False, False, True])
    pods = rng.integers(1, 4, Q)
    avail = rng.integers(-5000, 9000, (C, R))
    used = rng.integers(-500, 4000, (C, R))
    has_alloc = rng.random((C, R)) < 0.9
    pods_allowed = rng.integers(0, 40, C)
    used_pods = rng.integers(0, 10, C)
    has_summary = rng.random(C) < 0.9
    ovr = np.where(rng.random((Q, C)) < 0.3, rng.integers(0, 9, (Q, C)), -1)
    used_sets = rng.integers(0, 5, (Q, C))
    want = JS._capacity_estimates(
        jnp.asarray(req), jnp.asarray(is_cpu), jnp.asarray(pods),
        jnp.asarray(avail - used), jnp.asarray(has_alloc),
        jnp.asarray(np.maximum(pods_allowed - used_pods, 0)),
        jnp.asarray(has_summary))
    want = np.asarray(want).copy()
    want[:Q] = np.where(ovr >= 0, np.maximum(ovr - used_sets, 0), want[:Q])
    t = torch.from_numpy
    got = PS.capacity(t(req), t(is_cpu), t(pods), t(avail), t(used),
                      t(has_alloc), t(pods_allowed), t(used_pods),
                      t(has_summary), t(ovr), t(used_sets))
    assert np.array_equal(got.numpy(), want)
    assert ((avail - used) < 0).any() and ((avail - used) % 1000 != 0).any()


def test_hazard_duplicate_scatters():
    """Duplicate prev/evict COO entries of one row (and -1 padding): the
    JAX program's .at[].add sums duplicates onto one lane; the port's
    scatter_add and the kernel's per-lane sum must agree."""
    def mutate(jb):
        rows = np.nonzero((jb.prev_idx >= 0).any(1))[0][:6]
        for b in rows:
            jb.prev_idx[b, 1] = jb.prev_idx[b, 0]
            jb.prev_val[b, 1] = 3
        ev = np.nonzero((jb.evict_idx >= 0).any(1))[0][:3]
        for b in ev:
            jb.evict_idx[b, 1] = jb.evict_idx[b, 0]
    for build in (direct_scenario, gather_scenario):
        jb, pb = _pair(*build(12), mutate=mutate)
        _assert_dense(jb, pb, 4)


def test_waves_clamp_and_cpu_wrappers():
    """A wave count that does not divide B clamps to the nearest divisor,
    and every wrapper takes its plain version for CPU tensors."""
    assert PS._effective_waves(32, 5) == 4
    assert PS._effective_waves(8, 64) == 8
    jb, pb = _pair(*direct_scenario(13))
    a = PS.solve(pb, waves=5, device="cpu")
    b = PS.solve(pb, waves=4, device="cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    rng = random.Random(0)
    rep = torch.tensor([[0, rng.randint(1, 5), 0], [2, 0, 0]])
    sel = torch.tensor([[True, False, False], [False, False, True]])
    st = torch.zeros(2, dtype=torch.int32)
    nw = torch.tensor([True, False])
    idx, val, _, nnz = PS.compact(rep, sel, st, nw, False)
    assert idx.tolist() == [0, 1, 3] and int(nnz) == 3
    assert val.tolist() == [0, int(rep[0, 1]), 2]
