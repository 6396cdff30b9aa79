"""Big-lane-tier parity: the port's solve_big and the dense big-tier solve
(karmada_tpu_torch, the plain version of K2 on tier "big" plus K1, K3 and
K4 on the CPU) equal the JAX package's on the same inputs.  Integer math:
tolerance 0 on every output.

Covered: the ROUTE_DEVICE_BIG fixture of tests/test_solver_batch.py
(replicas beyond 64, cluster MaxGroups beyond 64, more than 16 previous
clusters) on the big tier's direct lane path (700 clusters, 1,024 lanes)
and its gather path (5,000 clusters, 8,192 lanes: the union of top-128
prev lanes and top-1,024 lanes per key), waves 1 and 4, and the sub-batch
carry (collect_used with a nonzero used0 remapped into the sub-batch);
and the big tier's gather select on torch_scenarios.BIG_SELECT_CASES (C
just above DIRECT_MAX, five groups, groups short of k, boundary buckets
that overflow the select's shared-memory room, prev / evict / uid_desc
rows), dense over four charged waves.  tests/test_torch_gpu.py holds
K2-big against these plain versions on the same cases."""

import numpy as np
import pytest

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import solver as JS
from karmada_tpu.ops import tensors as JT
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import tensors as PT

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")


def norm(r):
    if isinstance(r, Exception):
        return type(r).__name__
    return sorted((t.name, t.replicas) for t in r)


def _solve_both(build, waves, used_seed=None):
    """solve_big of the scenario's ROUTE_DEVICE_BIG rows in both packages;
    with used_seed, a carry-in in the chunk batch's vocabulary and
    collect_used.  Returns the port's results and its collected triple."""
    cj, ij = build(MJ)
    cp, ip = build(MP)
    ej, ep = JaxEstimator(), GeneralEstimator()
    xj, xp = JT.ClusterIndex.build(cj), PT.ClusterIndex.build(cp)
    jb = JT.encode_batch(ij, xj, ej)
    pb = PT.encode_batch(ip, xp, ep)
    big = [i for i in range(len(ij)) if jb.route[i] == JT.ROUTE_DEVICE_BIG]
    assert big and big == [i for i in range(len(ip))
                            if pb.route[i] == PT.ROUTE_DEVICE_BIG]
    kw = {}
    if used_seed is not None:
        rng = np.random.default_rng(used_seed)
        used0 = PT.carry_from_arrays(
            rng.integers(0, 3000, jb.avail_milli.shape),
            rng.integers(0, 10, jb.pods_allowed.shape),
            rng.integers(0, 3, jb.est_override.shape))
        kw = dict(collect_used=True, used0=used0)
    want = JS.solve_big(ij, big, xj, ej, None, waves=waves,
                        from_batch=jb, **kw)
    got = PS.solve_big(ip, big, xp, ep, None, waves=waves, from_batch=pb,
                       device="cpu", **kw)
    used = None
    if used_seed is not None:
        (want, (_, wu, wu0)), (got, (_, gu, gu0)) = want, got
        for a, b in zip(tuple(wu) + tuple(wu0), tuple(gu) + tuple(gu0)):
            assert np.array_equal(np.asarray(a), np.asarray(b))
        used = (gu, gu0)
    assert sorted(got) == sorted(want) == big
    for i in big:
        assert norm(got[i]) == norm(want[i]), i
    return got, used


@pytest.mark.parametrize("seed", range(4))
def test_solve_big_matches_jax(seed):
    """The 700-cluster fixture (C = 1,024 <= 4,224: the big tier's direct
    lane path), per binding against the untouched snapshot."""
    got, _ = _solve_both(lambda M: S.big_scenario(M, seed), waves=1)
    assert any(not isinstance(r, Exception) for r in got.values())


def test_solve_big_waves_and_carry():
    """waves 4 over the sub-batch and a nonzero carry-in remapped from the
    chunk's vocabulary; the collected accumulators hold the sub-batch's
    own consumption on top of it."""
    got, (used, used0) = _solve_both(
        lambda M: S.big_scenario(M, 11, n_bindings=12), waves=4,
        used_seed=3)
    assert any((u != u0).any() for u, u0 in zip(used, used0))


def test_solve_big_gather_path_5000_clusters():
    """5,000 clusters (8,192 lanes > 4,224): the big tier gathers the
    union of its top-K lane groups, with lax.top_k's tie order at K =
    1,024 and 128; B = 8 (six bindings padded)."""
    got, _ = _solve_both(
        lambda M: S.big_scenario(M, 5, n_clusters=5000, n_bindings=6),
        waves=2)
    assert any(not isinstance(r, Exception) for r in got.values())


@pytest.mark.parametrize("waves,plugin", [(1, False), (4, True)])
def test_dense_big_tier_matches_jax(waves, plugin):
    """Dense solve(tier="big") on a batch carried across with
    batch_from_arrays: rep, sel and status equal -- on the direct path
    (1,024 lanes), and with plugin scores on the gather path (8,192
    lanes), where the big gather takes its fifth (score-key) group."""
    cj, ij = S.big_scenario(MJ, 2, n_bindings=8,
                            n_clusters=5000 if plugin else 700)
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator())
    jb.b_valid[:jb.n_bindings] = jb.route == JT.ROUTE_DEVICE_BIG
    if plugin:
        rng = np.random.default_rng(7)
        jb.pl_extra_score = rng.integers(0, 101, jb.pl_mask.shape)
    fields = {f: getattr(jb, f) for f in PT.FIELD_DTYPES
              if getattr(jb, f, None) is not None}
    pb = PT.batch_from_arrays(fields, jb)
    want = JS.solve(jb, waves=waves, tier="big")
    got = PS.solve(pb, waves=waves, device="cpu", tier="big")
    for name, a, b in zip(("rep", "sel", "status"), want, got):
        assert np.array_equal(np.asarray(a), b), name
    assert got[0].sum() > 0


def _big_select_pair(name):
    clusters, items, lanes, extra_seed = S.big_select_case(MJ, name)
    jb = JT.encode_batch(items, JT.ClusterIndex.build(clusters),
                         JaxEstimator())
    jb = S.shape_big_select_batch(jb, lanes, extra_seed, JT)
    fields = {f: getattr(jb, f) for f in PT.FIELD_DTYPES
              if getattr(jb, f, None) is not None}
    return jb, PT.batch_from_arrays(fields, jb)


@pytest.mark.parametrize("name", S.BIG_SELECT_CASES)
def test_big_tier_gather_select_matches_jax(name):
    """Dense solve(tier="big") over four charged waves on the big tier's
    gather path: rep, sel and status equal the JAX package's."""
    jb, pb = _big_select_pair(name)
    g_prev, g_topk, direct_max = PS.TIERS["big"]
    assert pb.C > direct_max  # the gather path
    want = JS.solve(jb, waves=4, tier="big")
    got = PS.solve(pb, waves=4, device="cpu", tier="big")
    for field, a, b in zip(("rep", "sel", "status"), want, got):
        a = np.asarray(a)
        assert a.shape == b.shape and np.array_equal(a, b), field
    rows = pb.b_valid
    n = pb.n_bindings
    assert (got[0][rows] > 0).any()
    if name == "c4225":
        assert pb.C == direct_max + 1
    if name == "extra":
        assert PS._use_extra(pb)
    else:
        assert not PS._use_extra(pb)
    if name == "short_groups":
        # every placement leaves fewer eligible lanes than k
        assert (pb.pl_mask.sum(1) < g_topk).all()
    if name == "overflow":
        w = pb.pl_static_w[pb.pl_strategy == 1]
        assert (w >= 1 << 34).any() and (w == 5).sum() > 4 * 256
    if name == "prev_evict_uid":
        # a valid row whose prev group selects its g_prev of 300
        assert ((pb.prev_idx[:n] >= 0).sum(1)[rows[:n]] > 2 * g_prev).any()
        assert (pb.evict_idx[:n] >= 0).any()
        assert set(pb.uid_desc[:n].tolist()) == {False, True}
