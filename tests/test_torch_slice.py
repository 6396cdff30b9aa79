"""Slice parity: one scheduling cycle through the port's entry point,
karmada_tpu_torch.scheduler.core.schedule_items (device="cpu": the kernels'
plain versions), equals the JAX package's run_pipeline plus the serial
path for host-routed rows (what Scheduler._solve does with
backend="device") -- target names and replicas, and exception classes.
Multi-chunk cycles run with carry on, as the JAX scheduler does."""

import pytest

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import serial as jax_serial
from karmada_tpu.ops import tensors as JT
from karmada_tpu.scheduler import pipeline as JP
from karmada_tpu_torch.ops import tensors as PT
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
    """bench.py's mix and its rebalance cycle over three carried chunks."""
    def build(M):
        clusters, items, rng, names = S.bench_scenario(M, 2, 300, 96)
        return clusters, S.build_rebalance_items(M, rng, items, names)

    cj, ij = build(MJ)
    cp, ip = build(MP)
    want = [norm(r) for r in jax_cycle(cj, ij, 32, 8)]
    got = [norm(r) for r in schedule_items(ip, cp, chunk=32, waves=8,
                                           device="cpu")]
    assert got == want


def test_unported_device_routes_raise():
    """Rows the encoder sends to the device spread plane are not ported in
    this slice: the cycle raises NotImplementedError naming the route
    instead of silently taking another path."""
    clusters, items = S.random_scenario(MP, 4, n_clusters=11, n_bindings=8)
    items[2][0].placement = MP.Placement(spread_constraints=[
        MP.SpreadConstraint(spread_by_field=MP.SPREAD_BY_FIELD_REGION,
                            min_groups=1, max_groups=2),
        MP.SpreadConstraint(spread_by_field=MP.SPREAD_BY_FIELD_CLUSTER,
                            min_groups=1, max_groups=3)])
    with pytest.raises(NotImplementedError, match="ROUTE_DEVICE_SPREAD"):
        schedule_items(items, clusters, chunk=4, device="cpu")
