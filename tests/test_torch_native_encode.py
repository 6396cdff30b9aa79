"""The port's C encode (native/encode_fast.c, encode_batch's default) is
field-identical to its Python loop (encode_batch(native=False)) and to the
JAX package's Python loop (its own extension disabled by this test's
monkeypatch), on every FIELD_DTYPES field and every route: fleets of the
shared scenario builders at two seeds, the compact gather fleet, the
corner shapes the C loop hands back to Python, and two cycles on one
EncoderCache.  The counters say how many bindings the C loop filled and
how many it handed back."""

import dataclasses

import numpy as np
import pytest

import torch_scenarios as S
from karmada_tpu import native as JN
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import tensors as JT
from karmada_tpu_torch import native as PN
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.ops import tensors as PT

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")


@pytest.fixture
def jax_python(monkeypatch):
    """The JAX package's encode on its Python loop."""
    monkeypatch.setattr(JN, "_enc_mod", None)
    monkeypatch.setattr(JN, "_enc_error", "disabled for parity test")


def corner_items(M, clusters, items):
    """Shapes the C loop must hand back to encode_one (previous
    assignments, eviction tasks, reschedule triggers, components,
    ClusterAffinities terms, replica counts beyond the caps, list pairs)
    and shapes it keeps (zero replicas, empty and non-ASCII uids, an empty
    request)."""
    names = [c.name for c in clusters]
    n = len(names)
    out = []
    for k in range(48):
        spec, st = items[k % len(items)]
        out.append((dataclasses.replace(
            spec,
            clusters=([M.TargetCluster(name=names[k % n], replicas=2)]
                      if k % 4 else []),
            graceful_eviction_tasks=(
                [M.GracefulEvictionTask(from_cluster=names[0])]
                if k % 3 == 0 else []),
            reschedule_triggered_at=(50.0 if k % 2 else None),
            replicas=(0 if k % 5 == 0 else spec.replicas),
        ), st))
    spec0, st0 = items[0]
    req = M.ReplicaRequirements(resource_request={
        "cpu": M.Quantity.from_milli(250), "memory": M.Quantity.from_units(1)})
    out += [
        (dataclasses.replace(spec0, replicas=PT.KERNEL_REPLICA_CAP + 1), st0),
        (dataclasses.replace(spec0, replicas=100), st0),  # compact caps
        list(items[1]),
        (dataclasses.replace(spec0, components=[
            M.Component(name="a", replicas=2, replica_requirements=req),
            M.Component(name="b", replicas=1, replica_requirements=req)]),
         st0),
        (dataclasses.replace(spec0, components=[
            M.Component(name="a", replicas=3, replica_requirements=req)]),
         st0),
        (dataclasses.replace(spec0, replicas=0, replica_requirements=None),
         st0),
        (dataclasses.replace(spec0, replica_requirements=M.ReplicaRequirements(
            resource_request={})), st0),
        (dataclasses.replace(spec0, resource=dataclasses.replace(
            spec0.resource, uid="")), st0),
        (dataclasses.replace(spec0, resource=dataclasses.replace(
            spec0.resource, uid="uid-é中")), st0),
    ]
    terms = M.Placement(
        cluster_affinities=[
            M.ClusterAffinityTerm(affinity_name="primary",
                                  affinity=M.ClusterAffinity(
                                      cluster_names=names[:3])),
            M.ClusterAffinityTerm(affinity_name="backup",
                                  affinity=M.ClusterAffinity(
                                      cluster_names=names[3:6]))],
        replica_scheduling=spec0.placement.replica_scheduling)
    for observed in ("", "backup"):
        out.append((dataclasses.replace(spec0, placement=terms),
                    M.ResourceBindingStatus(
                        scheduler_observed_affinity_name=observed)))
    return items + out


SCENARIOS = {
    # bench.py's mix (common shapes: mostly C hits)
    "bench": lambda M, seed: S.bench_scenario(M, seed, 200, 512)[:2],
    # the randomized mix (prev clusters, evictions, spread, histograms)
    "random": lambda M, seed: S.random_scenario(M, seed, n_clusters=11,
                                                n_bindings=64),
    # 700 clusters: 1,024 lanes, the compact caps' route changes
    "compact": lambda M, seed: S.random_scenario(
        M, seed, n_clusters=700, n_bindings=96, spread_p=0.8),
}


def _build(M, name, seed, corners):
    clusters, items = SCENARIOS[name](M, seed)
    return clusters, (corner_items(M, clusters, items) if corners else items)


def _assert_same(a, b, what):
    assert (a.B, a.C, a.n_bindings, a.n_clusters) == (
        b.B, b.C, b.n_bindings, b.n_clusters), what
    checked = 0
    for f in PT.FIELD_DTYPES:
        x, y = getattr(a, f, None), getattr(b, f, None)
        if x is None and y is None:
            continue
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, (what, f)
        assert np.array_equal(x, y), (what, f)
        checked += 1
    assert checked >= 33, what
    assert np.array_equal(np.asarray(a.route), np.asarray(b.route)), what
    assert list(a.res_names) == list(b.res_names), what
    assert list(a.class_keys) == list(b.class_keys), what


def _encode_port(clusters, chunks, native):
    """Two cycles of the chunks on one EncoderCache (the second after
    reset_for_cycle, as the scheduler runs them); the batches and the
    counters of the run."""
    cindex = PT.ClusterIndex.build(clusters)
    cache = PT.EncoderCache()
    PN.reset_counts()
    out = []
    for _cycle in range(2):
        cache.reset_for_cycle()
        out += [PT.encode_batch(c, cindex, GeneralEstimator(), cache=cache,
                                native=native) for c in chunks]
    return out, dict(PN.COUNTS)


def _encode_jax(clusters, chunks):
    cindex = JT.ClusterIndex.build(clusters)
    cache = JT.EncoderCache()
    out = []
    for _cycle in range(2):
        cache.reset_for_cycle()
        out += [JT.encode_batch(c, cindex, JaxEstimator(), cache=cache)
                for c in chunks]
    return out


@pytest.mark.parametrize("name,seed,corners", [
    ("bench", 3, False), ("bench", 29, True),
    ("random", 3, True), ("random", 29, True),
    ("compact", 11, True),
])
def test_c_encode_equals_python_and_jax(name, seed, corners, jax_python):
    cp, ip = _build(MP, name, seed, corners)
    cj, ij = _build(MJ, name, seed, corners)
    half = len(ip) // 2
    chunks_p = [ip[:half], ip[half:]]
    chunks_j = [ij[:half], ij[half:]]
    c_out, c_counts = _encode_port(cp, chunks_p, native=True)
    py_out, py_counts = _encode_port(cp, chunks_p, native=False)
    jax_out = _encode_jax(cj, chunks_j)
    assert JN.load_encode_fast() is None  # the fixture held
    for k, (a, b, j) in enumerate(zip(c_out, py_out, jax_out)):
        _assert_same(a, b, f"C vs Python, batch {k}")
        _assert_same(a, j, f"C vs JAX, batch {k}")

    n = 2 * len(ip)
    assert c_counts["encode_c"] + c_counts["encode_miss"] == n
    assert c_counts["encode_py"] == 0
    assert py_counts["encode_py"] == n
    assert py_counts["encode_c"] == py_counts["encode_miss"] == 0
    assert c_counts["encode_c"] > 0 and c_counts["encode_miss"] > 0
    if corners:
        # every corner the C loop cannot fill went to encode_one
        assert c_counts["encode_miss"] >= 2 * 40
    if not corners:
        # one miss per distinct placement x class x GVK a chunk, not per
        # binding
        assert c_counts["encode_miss"] * 5 < n


def test_c_encode_of_no_bindings():
    clusters, _ = S.random_scenario(MP, 1, n_clusters=5, n_bindings=1)
    PN.reset_counts()
    b = PT.encode_batch([], PT.ClusterIndex.build(clusters),
                        GeneralEstimator())
    assert b.n_bindings == 0 and sum(PN.COUNTS.values()) == 0


def test_extension_is_the_ports_own():
    """Both packages' _encode_fast extensions load side by side: the
    port's is its own build, under its own module name."""
    mod = PN.load_encode_fast()
    assert mod.__name__ == "karmada_tpu_torch.native._encode_fast"
    assert "karmada_tpu_torch/native/_build/" in mod.__file__
    jmod = JN.load_encode_fast()
    if jmod is not None:
        assert jmod is not mod and jmod.__file__ != mod.__file__
