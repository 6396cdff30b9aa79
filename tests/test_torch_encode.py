"""Encoder parity: the port's encode_batch (karmada_tpu_torch, on port model
objects) equals the JAX package's encode_batch (on JAX-package objects
built from the same seed) on every FIELD_DTYPES field -- values and dtype
-- and on the route of every binding.  Integer/boolean arrays: exact."""

import random

import numpy as np
import pytest

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import tensors as JT
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.ops import tensors as PT

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")


def _encode_both(build, cache=False):
    cj, ij = build(MJ)
    cp, ip = build(MP)
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator(),
                         cache=JT.EncoderCache() if cache else None)
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(cp), GeneralEstimator(),
                         cache=PT.EncoderCache() if cache else None)
    return jb, pb


def _assert_same(jb, pb):
    assert (jb.B, jb.C, jb.n_bindings, jb.n_clusters) == (
        pb.B, pb.C, pb.n_bindings, pb.n_clusters)
    assert PT.FIELD_DTYPES == JT.FIELD_DTYPES
    checked = 0
    for f, dt in PT.FIELD_DTYPES.items():
        a = getattr(jb, f, None)
        b = getattr(pb, f, None)
        if a is None and b is None:
            continue
        assert a is not None and b is not None, f
        assert b.dtype == np.dtype(dt) and a.dtype == b.dtype, f
        assert a.shape == b.shape and np.array_equal(a, b), f
        checked += 1
    assert checked >= 33
    assert list(jb.res_names) == list(pb.res_names)
    assert list(jb.class_keys) == list(pb.class_keys)


@pytest.mark.parametrize("seed", range(6))
def test_encode_random_mix(seed):
    """The randomized mix of tests/test_solver_batch.py (11 clusters pad to
    16 lanes; affinity, taints, tolerations, spread, histogram-modeled
    clusters, prev assignments, evictions, all four strategies)."""
    jb, pb = _encode_both(
        lambda M: S.random_scenario(M, seed, n_clusters=11, n_bindings=24))
    _assert_same(jb, pb)


def test_encode_compact_fleet_routes():
    """A 700-cluster fleet (1024 lanes, the compact gather path): routes
    include host fallbacks (topology spread, compact caps) besides the
    device route, and the cached encode of a second chunk matches too."""
    def build(M):
        clusters, items = S.random_scenario(M, 11, n_clusters=700,
                                            n_bindings=40, spread_p=0.8)
        rng = random.Random(5)
        names = [c.name for c in clusters]
        # a binding beyond the compact division cap and one naming a
        # vanished previous cluster
        items[0][0].replicas = 100
        items[1][0].clusters = [M.TargetCluster(name="gone", replicas=1)]
        items[2][0].clusters = [M.TargetCluster(name=rng.choice(names),
                                                replicas=2)]
        return clusters, items

    jb, pb = _encode_both(build, cache=True)
    _assert_same(jb, pb)
    assert len(set(pb.route.tolist())) > 1


def test_encode_bench_mix():
    """bench.py's mix (its region-spread fifth included) and its rebalance
    cycle: every row on the main route or the spread plane."""
    def build(M, rebalance):
        clusters, items, rng, names = S.bench_scenario(M, 3, 600, 64)
        if rebalance:
            items = S.build_rebalance_items(M, rng, items, names)
        return clusters, items

    for rebalance in (False, True):
        jb, pb = _encode_both(lambda M: build(M, rebalance))
        _assert_same(jb, pb)
        assert set(pb.route.tolist()) == {PT.ROUTE_DEVICE,
                                          PT.ROUTE_DEVICE_SPREAD}


def test_batch_and_carry_from_arrays():
    """batch_from_arrays / carry_from_arrays carry the JAX package's arrays
    across field by field and dtype by dtype."""
    jb, _ = _encode_both(lambda M: S.random_scenario(M, 2))
    fields = {f: getattr(jb, f) for f in PT.FIELD_DTYPES
              if getattr(jb, f, None) is not None}
    fields = {f: a.astype(np.int64) if a.dtype == np.int32 else a
              for f, a in fields.items()}
    pb = PT.batch_from_arrays(fields, jb)
    _assert_same(jb, pb)
    used = PT.carry_from_arrays(np.ones((jb.C, 4), np.int32),
                                np.zeros(jb.C), np.full((4, jb.C), 2))
    assert [u.dtype for u in used] == [np.int64] * 3
    assert int(used[2].sum()) == 8 * jb.C
