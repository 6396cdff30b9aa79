"""Kernels K1-K6 and K2's big-tier instantiation on the card against their
plain versions, bit-exact.

Marked `gpu`: these need a CUDA card and nvcc, decide inside the test
whether a card is present, and skip without one.  On a machine with a
card run them with

    python -m pytest tests/test_torch_gpu.py -q -m gpu

(chip_smoke.py holds the same kernels against the same plain versions at
the full 4096 x 8192 chunk size).  Here the randomized scenario mix runs
through solve_compact on the card and on the CPU: both lane paths, taints,
deleting clusters, histogram overrides, evictions, spread constraints
(selection swap loop), plugin scores, empty-workload propagation and a
wide prev axis; solve_big on the big tier's direct and gather lane paths;
and solve_spread on region and label axes, with K5 and K6 held against
their plain versions on shared-memory rows and on 16,384-lane rows (the
device-memory sort path).
"""

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import spread as PSP
from karmada_tpu_torch.ops import tensors as PT

MAIN_PATH = ("capacity", "schedule_rows", "webster_batch", "compact")

MP = S.models_of("karmada_tpu_torch")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the card)")
    return torch.device("cuda", 0)


def _batch(n_clusters, seed, wide_prev=False):
    clusters, items = S.random_scenario(MP, seed, n_clusters=n_clusters,
                                        n_bindings=64)
    if wide_prev:
        # one row with 40 prev clusters widens the prev axis of every row
        names = [c.name for c in clusters]
        items[0][0].clusters = [MP.TargetCluster(name=n, replicas=1)
                                for n in names[:40]]
    return PT.encode_batch(items, PT.ClusterIndex.build(clusters),
                           GeneralEstimator())


def _launched(names):
    """Every kernel of the path under test ran (counters since the last
    reset); kernels of other paths may stay at 0."""
    missing = [k for k in names if kernels.LAUNCHES[k] <= 0]
    assert not missing, (missing, kernels.LAUNCHES)


def _same(batch, waves, keep_sel=False, tier="std"):
    dev = _card()
    kernels.reset_counts()
    got = PS.solve_compact(batch, waves=waves, with_used=True,
                           keep_sel=keep_sel, device=dev, tier=tier)
    torch.cuda.synchronize()
    want = PS.solve_compact(batch, waves=waves, with_used=True,
                            keep_sel=keep_sel, device="cpu", tier=tier)
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    for a, b in zip(got[4], want[4]):
        assert np.array_equal(a, b)
    k2 = "schedule_rows" if tier == "std" else "schedule_rows_big"
    _launched(("capacity", k2, "webster_batch", "compact"))


@pytest.mark.gpu
@pytest.mark.parametrize("n_clusters", [11, 700, 1500])
@pytest.mark.parametrize("seed", range(4))
def test_kernels_match_plain_on_card(n_clusters, seed):
    _same(_batch(n_clusters, seed), waves=8)


@pytest.mark.gpu
@pytest.mark.parametrize("n_clusters", [11, 700])
def test_kernels_plugin_scores_keep_sel_wide_prev(n_clusters):
    _card()
    batch = _batch(n_clusters, 9, wide_prev=True)
    assert batch.prev_idx.shape[1] >= min(n_clusters, 40)
    rng = np.random.default_rng(9)
    batch.pl_extra_score = rng.integers(0, 101, batch.pl_mask.shape)
    _same(batch, waves=4, keep_sel=True)


@pytest.mark.gpu
def test_webster_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(3)
    B, L = 64, 40
    n = torch.from_numpy(rng.integers(0, 300, B)).to(dev)
    w = torch.from_numpy(rng.integers(0, 5000, (B, L))).to(dev)
    s0 = torch.from_numpy(rng.integers(0, 4, (B, L))).to(dev)
    active = torch.from_numpy(rng.random((B, L)) < 0.8).to(dev)
    rank = torch.from_numpy(
        np.stack([rng.permutation(L) for _ in range(B)])).to(dev)
    got = PS.webster_batch(n, w, s0, active, rank)
    want = PS.webster_plain(n, w, s0, active, rank)
    assert torch.equal(got, want)


def _big_batch(n_clusters, seed, n_bindings=8):
    clusters, items = S.big_scenario(MP, seed, n_clusters=n_clusters,
                                     n_bindings=n_bindings)
    batch = PT.encode_batch(items, PT.ClusterIndex.build(clusters),
                            GeneralEstimator())
    batch.b_valid[:batch.n_bindings] = batch.route == PT.ROUTE_DEVICE_BIG
    assert batch.b_valid.any()
    return batch


@pytest.mark.gpu
@pytest.mark.parametrize("n_clusters,plugin", [(700, False), (5000, False),
                                               (5000, True)])
def test_big_tier_kernel_matches_plain_on_card(n_clusters, plugin):
    """K2-big (and K4 at 5,248 lanes) on the big tier's direct (1,024
    lanes) and gather (8,192 lanes) paths, the latter also with plugin
    scores (five gather groups)."""
    batch = _big_batch(n_clusters, 3)
    if plugin:
        rng = np.random.default_rng(4)
        batch.pl_extra_score = rng.integers(0, 101, batch.pl_mask.shape)
    _same(batch, waves=4, tier="big")


def _spread_case(build):
    clusters, items = build(MP)
    batch = PT.encode_batch(items, PT.ClusterIndex.build(clusters),
                            GeneralEstimator())
    groups = PT.spread_groups(batch, items)
    assert groups
    return batch, items, groups


def _norm(r):
    if isinstance(r, Exception):
        return type(r).__name__
    return sorted((t.name, t.replicas) for t in r)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["region", "label", "big_tier"])
def test_solve_spread_on_card(case):
    """solve_spread through K5, K6 and the assignment kernels on the card
    equals the CPU plain path (collected accumulators included)."""
    dev = _card()
    build = {"region": lambda M: S.region_scenario(M, 3),
             "label": lambda M: S.label_scenario(M, 2),
             "big_tier": S.spread_big_scenario}[case]
    batch, items, groups = _spread_case(build)
    rng = np.random.default_rng(5)
    used0 = PT.carry_from_arrays(
        rng.integers(0, 4000, batch.avail_milli.shape),
        rng.integers(0, 20, batch.pods_allowed.shape),
        rng.integers(0, 3, batch.est_override.shape))
    for (axis, tier), idxs in groups.items():
        kernels.reset_counts()
        kw = dict(waves=8, axis=axis, tier=tier, collect_used=True,
                  used0=used0)
        got, gu = PSP.solve_spread(batch, items, idxs, device=dev, **kw)
        torch.cuda.synchronize()
        want, wu = PSP.solve_spread(batch, items, idxs, device="cpu", **kw)
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}
        for a, b in zip(gu or (), wu or ()):
            assert np.array_equal(a, b)
        k2 = "schedule_rows" if tier == "std" else "schedule_rows_big"
        _launched(("spread_group_info", "spread_pick", "capacity", k2))


def _spread_rows(batch, idxs, axis, dev):
    """The phase-A operands of solve_spread on `dev`."""
    gid, names = ((batch.region_id, batch.region_names) if axis == ""
                  else batch.label_axes[axis])
    G = PT._next_pow2(len(names), 8)
    db = PS.device_batch(batch, dev, rows=np.asarray(idxs))
    z = PS._zeros_used(db)
    est = PS.capacity(db.req_milli, db.req_is_cpu, db.req_pods,
                      db.avail_milli, z[0], db.has_alloc, db.pods_allowed,
                      z[1], db.has_summary, db.est_override, z[2])
    pid = batch.placement_id[np.asarray(idxs)]

    def t(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)

    extra = (t(batch.pl_region_min[pid], np.int64),
             t(batch.pl_sc_min[pid], np.int64),
             t(batch.pl_strategy[pid] == PT.STRAT_DUPLICATED, bool))
    return db, est, t(gid, np.int32), G, extra


def _hold_spread_kernels(batch, idxs, axis):
    dev = _card()
    db, est, gid, G, extra = _spread_rows(batch, idxs, axis, dev)
    kernels.reset_counts()
    got = PSP.spread_group_info(db, est, gid, *extra, G)
    want = PSP.spread_group_info_plain(db, est, gid, *extra, G)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    rng = np.random.default_rng(2)
    chosen = torch.from_numpy(rng.random((db.B, G)) < 0.5).to(dev)
    cmax = torch.from_numpy(rng.integers(0, 9, db.B)).to(dev)
    got = PSP.spread_pick(db, est, gid, chosen, cmax, G)
    want = PSP.spread_pick_plain(db, est, gid, chosen, cmax, G)
    assert torch.equal(got, want) and bool(got.any())
    _launched(("spread_group_info", "spread_pick"))


@pytest.mark.gpu
def test_spread_kernels_match_plain_on_card():
    """K5 and K6 on shared-memory rows (16 lanes) with random chosen
    groups and cluster caps."""
    batch, items, groups = _spread_case(lambda M: S.region_scenario(M, 4))
    (axis, _), idxs = next(iter(groups.items()))
    _hold_spread_kernels(batch, idxs, axis)


@pytest.mark.gpu
def test_spread_kernels_device_memory_path_on_card():
    """K5 and K6 at 16,384 lanes: wider than the shared-memory sort, so
    the rows sort in their device-memory scratch."""
    def build(M):
        clusters, items = S.region_scenario(M, 6, n_clusters=9000,
                                            n_bindings=8, n_regions=5)
        return clusters, items
    batch, items, groups = _spread_case(build)
    assert batch.C == 16384 > kernels.SPREAD_SMEM_LANES
    (axis, _), idxs = next(iter(groups.items()))
    _hold_spread_kernels(batch, idxs, axis)
