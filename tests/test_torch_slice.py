"""Slice parity: one scheduling cycle through the port's entry point,
karmada_tpu_torch.scheduler.core.schedule_items (device="cpu": the kernels'
plain versions), equals the JAX package's run_pipeline plus the serial
path for host-routed rows (what Scheduler._solve does with
backend="device") -- target names and replicas, and exception classes.
Multi-chunk cycles run with carry on, as the JAX scheduler does."""

import random

import pytest

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import serial as jax_serial
from karmada_tpu.ops import tensors as JT
from karmada_tpu.scheduler import pipeline as JP
from karmada_tpu_torch.ops import tensors as PT
from karmada_tpu_torch.scheduler import pipeline as PP
from karmada_tpu_torch.scheduler.core import schedule_items

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")


def jax_cycle(clusters, items, chunk, waves):
    """Scheduler._solve (backend="device") of the JAX package, unrolled."""
    est = JaxEstimator()
    cache = JT.EncoderCache()
    cache.reset_for_cycle()
    carry = len(items) > chunk
    res = JP.run_pipeline(items, JT.ClusterIndex.build(clusters), est,
                          chunk=chunk, waves=waves, cache=cache, carry=carry,
                          carry_spread=carry)
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
    return out


def norm(r):
    if isinstance(r, Exception):
        return type(r).__name__
    return sorted((t.name, t.replicas) for t in r)


def mixed_scenario(M, seed, n_clusters, n_bindings):
    """The randomized mix plus host routes: a provider-only spread
    (topology spread), a vanished previous cluster and a replica count
    beyond the kernel's cap."""
    clusters, items = S.random_scenario(M, seed, n_clusters=n_clusters,
                                        n_bindings=n_bindings)
    provider_only = M.Placement(spread_constraints=[M.SpreadConstraint(
        spread_by_field=M.SPREAD_BY_FIELD_PROVIDER, min_groups=1,
        max_groups=2)])
    for k in range(3, n_bindings, 11):
        items[k][0].placement = provider_only
    for k in range(5, n_bindings, 13):
        items[k][0].clusters = [M.TargetCluster(name="vanished", replicas=2)]
    items[7][0].replicas = 1 << 26
    return clusters, items


@pytest.mark.parametrize("n_clusters,chunk,waves", [
    (11, 16, 4),    # direct lanes, 3 chunks
    (700, 24, 8),   # gather lanes, 2 chunks
])
def test_schedule_items_matches_jax_cycle(n_clusters, chunk, waves):
    n = 48
    cj, ij = mixed_scenario(MJ, 21, n_clusters, n)
    cp, ip = mixed_scenario(MP, 21, n_clusters, n)
    want = [norm(r) for r in jax_cycle(cj, ij, chunk, waves)]
    got = [norm(r) for r in schedule_items(ip, cp, chunk=chunk, waves=waves,
                                           device="cpu")]
    assert got == want
    # both host and device routes were exercised
    routes = PT.encode_batch(ip, PT.ClusterIndex.build(cp)).route
    assert (routes == PT.ROUTE_DEVICE).any()
    assert {PT.ROUTE_TOPOLOGY_SPREAD, PT.ROUTE_VANISHED_PREV,
            PT.ROUTE_HUGE_REPLICAS} <= set(routes.tolist())
    assert any(isinstance(w, str) for w in want)  # some bindings fail


def test_bench_mix_rebalance_cycle():
    """bench.py's mix -- its region-spread fifth included -- and its
    rebalance cycle over three carried chunks."""
    def build(M):
        clusters, items, rng, names = S.bench_scenario(M, 2, 300, 96)
        return clusters, S.build_rebalance_items(M, rng, items, names)

    cj, ij = build(MJ)
    cp, ip = build(MP)
    want = [norm(r) for r in jax_cycle(cj, ij, 32, 8)]
    got = [norm(r) for r in schedule_items(ip, cp, chunk=32, waves=8,
                                           device="cpu")]
    assert got == want
    routes = PT.encode_batch(ip, PT.ClusterIndex.build(cp)).route
    assert (routes == PT.ROUTE_DEVICE_SPREAD).sum() == sum(
        b % 40 >= 32 for b in range(96))


def all_routes_scenario(M, seed, n_clusters=700, n_bindings=48):
    """Every route in one cycle on a gather-lane fleet with regions and a
    ring label: the randomized mix (ROUTE_DEVICE and host routes), region
    spread, spread by label, and the big styles (ROUTE_DEVICE_BIG and
    ROUTE_DEVICE_SPREAD_BIG)."""
    rng = random.Random(seed)
    names = [f"member-{i:03d}" for i in range(n_clusters)]
    clusters = []
    for i, nm in enumerate(names):
        c = S.mk_region_cluster(M, rng, nm, f"r{i % 6}")
        if rng.random() < 0.85:
            c.metadata.labels[S.RING] = f"ring-{i % 4}"
        clusters.append(c)
    placements = [S.mk_placement(M, rng, names) for _ in range(3)]
    placements += [S.mk_spread_placement(M, rng, names) for _ in range(2)]
    placements.append(S.mk_label_placement(M, rng))
    items = [S.mk_binding(M, rng, b, names, placements)
             for b in range(n_bindings)]
    for k in range(4, n_bindings, 5):
        items[k] = S.big_binding(M, rng, k, names, (k // 5) % 4)
    items[2][0].placement = M.Placement(spread_constraints=[
        M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_PROVIDER,
                           min_groups=1, max_groups=2)])
    return clusters, items


def test_schedule_items_all_device_routes():
    """A two-chunk cycle (carry on, for the sub-solves too) over every
    device route -- main, region and label spread, spread on the big tier,
    big tier -- and host routes equals the JAX cycle."""
    chunk, waves = 24, 8
    cj, ij = all_routes_scenario(MJ, 5)
    cp, ip = all_routes_scenario(MP, 5)
    want = [norm(r) for r in jax_cycle(cj, ij, chunk, waves)]
    stats = PP.PipelineResult()
    got = [norm(r) for r in schedule_items(ip, cp, chunk=chunk, waves=waves,
                                           device="cpu", stats=stats)]
    assert got == want
    # the device path owns exactly the device-routed rows
    batch = PT.encode_batch(ip, PT.ClusterIndex.build(cp))
    assert sorted(stats.results) == [i for i in range(len(ip))
                                     if batch.route[i] in PP.DEVICE_ROUTES]
    routes = set(batch.route[:len(ip)].tolist())
    assert {PT.ROUTE_DEVICE, PT.ROUTE_DEVICE_SPREAD,
            PT.ROUTE_DEVICE_SPREAD_BIG, PT.ROUTE_DEVICE_BIG,
            PT.ROUTE_TOPOLOGY_SPREAD} <= routes
    assert {a for a, _ in PT.spread_groups(batch, ip)} == {"", S.RING}
    assert sum(isinstance(w, list) for w in want) > len(want) // 3


def test_spread_consumption_reaches_chunk_k_plus_2():
    """The one-chunk lag of the sub-solve carry (after
    tests/test_pipeline_executor.py:349-393): chunk 0's spread binding
    takes 800m of a 1000m cluster at chunk 0's finalize, which runs after
    chunk 1 dispatched.  So chunk 1 (300m) still sees the raw cluster and
    fits, and chunk 2 (600m, which would fit beside chunk 1 alone) sees
    both and is refused -- in both packages."""
    def build(M):
        items = [S.capacity_binding(M, 0, 8, 100,
                                    S.region_spread_placement(M)),
                 S.capacity_binding(M, 1, 3, 100),
                 S.capacity_binding(M, 2, 6, 100)]
        return [S.capacity_cluster(M, "m1", 1000, "r1")], items

    cj, ij = build(MJ)
    cp, ip = build(MP)
    want = [norm(r) for r in jax_cycle(cj, ij, 1, 1)]
    got = [norm(r) for r in schedule_items(ip, cp, chunk=1, waves=1,
                                           device="cpu")]
    assert got == want
    assert want[0] == [("m1", 8)] and want[1] == [("m1", 3)]
    assert want[2] == "UnschedulableError"
