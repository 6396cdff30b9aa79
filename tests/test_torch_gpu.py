"""Kernels K1-K13 and K2's big-tier instantiation on the card against their
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
wide prev axis; K3 compact over test_torch_select_compact.py's cases
and phase 2's 4096 x 8192 shape (one launch a call), and K2's std tier
over that file's gather cases, the select's bucket overflow included
(no key scratch), and K2-big over tests/test_torch_big.py's gather cases
(1 and 4 waves; no key scratch either); the wave's launch path (one
workspace a chunk, two chunks in flight each on its own, a workspace
for other operands refused); K4 webster_batch on the main path's shapes, a row in its
device-memory scratch and the contract's edges, and its division helper
over the int64 range; solve_big on the big tier's direct and gather lane
paths;
and solve_spread on region and label axes, with K5 and K6 held against
their plain versions on shared-memory rows, on 16,384-lane rows (the
device-memory key buffer) and on the scenarios of their branches (long
walks, exhausted walks, Duplicated and infeasible rows, cluster caps at
their edges, 4,100 label groups); K7 explain_rows in both flavours (the main
solve's waves and the spread phase B, the CPU suite's edge rows, and
synthetic rows at every shape its design branches on: two bitmap
tiles, prev / evict axes past 48 KB of shared memory with and without
the static bitmaps, use_extra both ways; a C not a multiple of 4 and
misaligned operands refused); K8 shortlist_topk on its
shared-memory and device-memory key paths; K9 group_sums (round-robin
and region-run layouts, the tiled branch, one group); a shortlisted
megafleet cycle, card against CPU; K10 scatter_lanes (both layouts, 1-,
4- and 8-byte elements, and the fused multi-field scatter of a mirror
sync, one launch per table), K11 gather_rows (both flavours; its launch
path: one launch a call, staged uploads, outputs of calls in flight
apart, a re-placed mirror checked again; its staging ring with more
dispatches in flight than buffers behind a busy stream, and its inputs at
their edges),
K12 dirty_codes (the contract's -1 padded operands; its edges: ragged
and tiny stores, no flip lanes, every rv entry padded, one placement,
32,771 placements, odd and misaligned prev / evict rows, rv runs longer
than a warp, the rv list as given and ascending; dirty_codes' one C call
on a fused plane), and a fused incremental run card against CPU; K13
rebalance_score (and no launch on zero lanes; a cluster of one block,
one of several and lanes past its registers; invalid lanes, zero totals, wrapped products
and totals; score's one C call and its results' ownership), and one
rebalance-plane cycle card against CPU; and the loop with the
descheduler armed and two members squeezed, then the facade's answers,
card against CPU (chip phase 15a in small).
"""

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.obs import decisions as PD
from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops import shortlist as PSL
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


@pytest.mark.gpu
@pytest.mark.parametrize("name", S.WEBSTER_CASES)
def test_webster_kernel_cases_on_card(name):
    """K4 against webster_plain, bit for bit, in one launch a call, on
    tests/torch_scenarios.webster_case: the main path's shapes (656 lanes
    with n <= 64 and s0 = 0, 5,248 with n <= 512), a row wider than the
    kernel's shared memory (its device-memory scratch), and the contract's
    edges (w = 2^34 - 1 with n = 2^25 - 1 and values beyond the caps, s0
    at its cap, all weights equal, w = 1 with n >> L, inactive rows and
    n = 0, ranks beyond the lane count)."""
    dev = _card()
    cols = [torch.from_numpy(a).to(dev) for a in S.webster_case(name)]
    kernels.reset_counts()
    got = PS.webster_batch(*cols)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["webster_batch"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert torch.equal(got, PS.webster_plain(*cols))


@pytest.mark.gpu
def test_webster_floordiv_on_card():
    """K4's division by an FP64 reciprocal with its exact correction
    (webster.cuh floordiv_r) against torch's floor division: numerators
    over the whole int64 range, negatives and the extremes included,
    divisors from 1 to 2^62 + 1 (powers of two and their neighbours, the
    lane counts, random)."""
    dev = _card()
    g = np.random.default_rng(11)
    edges_d = [1, 2, 3, 656, 5248, (1 << 62) + 1, 1 << 62, (1 << 62) - 1]
    for k in range(1, 62):
        edges_d += [(1 << k) - 1, 1 << k, (1 << k) + 1]
    d = np.concatenate([np.array(edges_d, np.int64),
                        g.integers(1, (1 << 62) + 2, 200_000),
                        g.integers(1, 1 << 20, 200_000)])
    a = g.integers(-(1 << 63), (1 << 63) - 1, d.size, dtype=np.int64,
                   endpoint=True)
    a[: len(edges_d)] = (1 << 63) - 1
    a[len(edges_d): 2 * len(edges_d)] = -(1 << 63)
    a[-100_000:] = g.integers(-(1 << 40), 1 << 40, 100_000)
    # the threshold's numerators, w << 28
    a[-150_000:-100_000] = g.integers(0, 1 << 34, 50_000) << 28
    at, dt = torch.from_numpy(a).to(dev), torch.from_numpy(d).to(dev)
    q = torch.empty_like(at)
    kernels.launch("webster_batch", kernels.FloordivArgs(
        kernels.ptr(at), kernels.ptr(dt), kernels.ptr(q), at.shape[0]),
        "webster_floordiv")
    assert torch.equal(q, torch.div(at, dt, rounding_mode="floor"))


@pytest.mark.gpu
@pytest.mark.parametrize("keep_sel", [False, True])
@pytest.mark.parametrize("name", list(S.COMPACT_CASES) + ["phase2"])
def test_compact_kernel_matches_plain_on_card(name, keep_sel):
    """K3 against compact_plain, bit for bit, in one launch a call, over
    the CPU cases and at phase 2's 4096 x 8192 chunk (random density)."""
    dev = _card()
    rep, sel, status, nw = (torch.from_numpy(a).to(dev) for a in (
        S.compact_case(name, shape=(4096, 8192) if name == "phase2"
                       else None)))
    kernels.reset_counts()
    got = PS.compact(rep, sel, status, nw, keep_sel)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["compact"] == 1
    want = PS.compact_plain(rep, sel, status, nw, keep_sel)
    nnz = int(want[3])
    assert int(got[3]) == nnz
    assert torch.equal(got[0][:nnz], want[0])
    assert torch.equal(got[1][:nnz], want[1])
    assert torch.equal(got[2], want[2])


@pytest.mark.gpu
@pytest.mark.parametrize("name", S.SELECT_CASES)
def test_schedule_rows_std_gather_on_card(name):
    """K2 std (with K1, K4, K3) against the plain path over the gather
    cases, every wave charged; the std tier allocates no key scratch."""
    _card()
    clusters, items, lanes, extra_seed = S.select_case(MP, name)
    batch = S.shape_select_batch(
        PT.encode_batch(items, PT.ClusterIndex.build(clusters),
                        GeneralEstimator()), lanes, extra_seed)
    assert batch.C > PS.TIERS["std"][2]
    before = dict(PS.KEY_SCRATCH_BYTES)
    _same(batch, waves=4)
    assert kernels.LAUNCHES["compact"] == 1
    assert PS.KEY_SCRATCH_BYTES["std"] == before["std"]


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
    before = PS.KEY_SCRATCH_BYTES["big"]
    _same(batch, waves=4, tier="big")
    # the big tier's gather recomputes its keys: no key scratch
    assert PS.KEY_SCRATCH_BYTES["big"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("waves", [1, 4])
@pytest.mark.parametrize("name", S.BIG_SELECT_CASES)
def test_schedule_rows_big_gather_on_card(name, waves):
    """K2-big (with K1, K4, K3) against the plain path over the big
    tier's gather cases (tests/test_torch_big.py holds the plain path
    against the JAX package on them), 1 and 4 waves; no key scratch."""
    _card()
    clusters, items, lanes, extra_seed = S.big_select_case(MP, name)
    batch = S.shape_big_select_batch(
        PT.encode_batch(items, PT.ClusterIndex.build(clusters),
                        GeneralEstimator()), lanes, extra_seed, PT)
    assert batch.C > PS.TIERS["big"][2]
    before = dict(PS.KEY_SCRATCH_BYTES)
    _same(batch, waves=waves, tier="big")
    assert kernels.LAUNCHES["compact"] == 1
    assert PS.KEY_SCRATCH_BYTES == before == {"std": 0, "big": 0}


@pytest.mark.gpu
@pytest.mark.parametrize("tier", ["std", "big"])
def test_chunks_in_flight_keep_their_workspaces_on_card(tier):
    """Two chunks dispatched back to back before either is finalized, each
    on its own RowsWorkspace (schedule_core makes one a chunk): each
    equals its own plain solve, so one chunk's work buffers never alias
    the other's in flight."""
    dev = _card()
    if tier == "std":
        batches = [_batch(700, 21), _batch(1500, 22)]
    else:
        batches = [_big_batch(5000, 7, n_bindings=16),
                   _big_batch(5000, 8, n_bindings=16)]
    kernels.reset_counts()
    handles = [PS.dispatch_compact(b, waves=4, with_used=True, device=dev,
                                   tier=tier) for b in batches]
    got = [PS.finalize_compact(h) for h in handles]
    k2 = "schedule_rows" if tier == "std" else "schedule_rows_big"
    assert kernels.LAUNCHES["capacity"] == 8
    assert kernels.LAUNCHES[k2] == kernels.LAUNCHES["webster_batch"] >= 8
    for g, b in zip(got, batches):
        want = PS.solve_compact(b, waves=4, with_used=True, device="cpu",
                                tier=tier)
        assert g[3] == want[3]
        for x, y in zip(g[:3] + g[4], want[:3] + want[4]):
            assert np.array_equal(x, y)


@pytest.mark.gpu
def test_rows_workspace_launch_path_on_card():
    """The wave's launch path: a chunk's waves share one workspace (one C
    call a slice; capacity once a wave, K2 and K4 once a slice), a
    workspace built for other operands is refused, and a call without one
    builds its own with the same results."""
    dev = _card()
    batch = _batch(700, 23)
    db = PS.device_batch(batch, dev)
    B, C = db.B, db.C
    Q = db.req_milli.shape[0]
    use_extra = PS._use_extra(batch)

    def operands():
        return (torch.empty((Q + 1, C), dtype=torch.int64, device=dev),
                *PS._zeros_used(db),
                torch.empty((B, C), dtype=torch.int64, device=dev),
                torch.empty((B, C), dtype=torch.bool, device=dev),
                torch.empty((B,), dtype=torch.int32, device=dev))

    a, b = operands(), operands()
    ws = PS.RowsWorkspace(db, B // 4, *a, tier="std", use_extra=use_extra,
                          charge=True)
    kernels.reset_counts()
    for wv in range(4):
        PS.schedule_rows(db, wv * (B // 4), (wv + 1) * (B // 4), *a,
                         use_extra=use_extra, charge=True, fill_est=True,
                         workspace=ws)
        PS.schedule_rows(db, wv * (B // 4), (wv + 1) * (B // 4), *b,
                         use_extra=use_extra, charge=True, fill_est=True)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["capacity"] == 8
    assert kernels.LAUNCHES["schedule_rows"] == 8
    assert kernels.LAUNCHES["webster_batch"] == 8
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    with pytest.raises(ValueError):
        PS.schedule_rows(db, 0, B // 4, *b, use_extra=use_extra, charge=True,
                         workspace=ws)


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
    # group_id 4 bytes off a 16-byte boundary: the lanes load one at a time
    odd = torch.cat([gid[:1], gid])[1:]
    assert odd.data_ptr() % 16
    for a, b in zip(PSP.spread_group_info(db, est, odd, *extra, G),
                    PSP.spread_group_info_plain(db, est, gid, *extra, G)):
        assert torch.equal(a, b)
    assert torch.equal(PSP.spread_pick(db, est, odd, chosen, cmax, G), want)


@pytest.mark.gpu
def test_spread_kernels_match_plain_on_card():
    """K5 and K6 on shared-memory rows (16 lanes) with random chosen
    groups and cluster caps."""
    batch, items, groups = _spread_case(lambda M: S.region_scenario(M, 4))
    (axis, _), idxs = next(iter(groups.items()))
    _hold_spread_kernels(batch, idxs, axis)


@pytest.mark.gpu
def test_spread_kernels_device_memory_path_on_card():
    """K5 and K6 at 16,384 lanes: wider than the shared-memory key
    buffer, so the rows keep their keys in a device-memory scratch."""
    def build(M):
        clusters, items = S.region_scenario(M, 6, n_clusters=9000,
                                            n_bindings=8, n_regions=5)
        return clusters, items
    batch, items, groups = _spread_case(build)
    assert batch.C == 16384 > kernels.SPREAD_SMEM_LANES
    (axis, _), idxs = next(iter(groups.items()))
    _hold_spread_kernels(batch, idxs, axis)



@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(S.SPREAD_EDGE_CASES))
def test_spread_kernels_edges_on_card(case):
    """K5 and K6 bit for bit against their plain versions on the scenarios
    of their branches (torch_scenarios.spread_edge_scenario at full size):
    Divided walks that qualify only deep in their group (K5's long-walk
    branch, past a sort chunk), walks exhausted by members and by
    availability, Duplicated rows, rows with no feasible lane, lanes that
    share score and availability (name_rank decides), prev and evict
    entries, cluster_max 0, 1 and beyond every row's members, a label axis
    of 4,100 groups (the device-memory group state of both kernels),
    16,384-lane rows (the device-memory key buffer) and plugin scores up
    to 300 (the extra-score loads; keys that do not hold their lane's
    score, so K5's long walk starts from the group's least key).  Each
    kernel runs with use_extra as solve_spread passes it and, where the
    extra scores are 0, also with the rows read, both with group_id on
    and off a 16-byte boundary; then every (axis, tier) group but the
    label axis's (whose host DFS over 4,100 groups would take minutes)
    through solve_spread, card against CPU."""
    dev = _card()
    batch, items, groups = _spread_case(
        lambda M: S.spread_edge_scenario(M, case))
    xs = S.spread_edge_scores(case, batch.pl_extra_score.shape)
    if xs is not None:
        batch.pl_extra_score = xs
    use_extra = PS._use_extra(batch)
    assert use_extra == (xs is not None)
    if case == "label_many":
        assert PT._next_pow2(len(batch.label_axes[S.RING][1]), 8) > \
            kernels.PICK_SMEM_GROUPS
    if case == "wide_deep":
        assert batch.C > kernels.SPREAD_SMEM_LANES
    rng = np.random.default_rng(3)
    for (axis, tier), idxs in groups.items():
        db, est, gid, G, extra = _spread_rows(batch, idxs, axis, dev)
        # group_id 4 bytes off a 16-byte boundary: one load a lane
        odd = torch.cat([gid[:1], gid])[1:]
        assert odd.data_ptr() % 16
        n_groups = len(batch.region_names if axis == ""
                       else batch.label_axes[axis][1])
        chosen, cmax = S.spread_edge_chosen(rng, db.B, G, n_groups)
        chosen, cmax = (torch.from_numpy(x).to(dev) for x in (chosen, cmax))
        want = PSP.spread_group_info_plain(db, est, gid, *extra, G)
        want_pick = PSP.spread_pick_plain(db, est, gid, chosen, cmax, G)
        assert bool(want_pick.any())
        kernels.reset_counts()
        for ux in sorted({use_extra, True}):
            for g in (gid, odd):
                got = PSP.spread_group_info(db, est, g, *extra, G,
                                            use_extra=ux)
                for a, b in zip(got, want):
                    assert torch.equal(a, b)
                got = PSP.spread_pick(db, est, g, chosen, cmax, G,
                                      use_extra=ux)
                assert torch.equal(got, want_pick)
        _launched(("spread_group_info", "spread_pick"))
        if case == "label_many":
            continue  # the host group DFS over 4,100 groups is the cost
        kw = dict(waves=8, axis=axis, tier=tier)
        got = PSP.solve_spread(batch, items, idxs, device=dev, **kw)
        torch.cuda.synchronize()
        want = PSP.solve_spread(batch, items, idxs, device="cpu", **kw)
        assert {k: _norm(v) for k, v in got.items()} == \
            {k: _norm(v) for k, v in want.items()}

# -- K7 explain_rows, K8 shortlist_topk, K9 group_sums ---------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("case", ["every_stage", "direct", "gather"])
def test_explain_kernel_matches_plain_on_card(case):
    """solve_compact(explain=True): K7 after every wave's K2, planes equal
    to the CPU plain path, at waves 4 with a carry-in."""
    from karmada_tpu_torch.scheduler.plugins import REGISTRY

    dev = _card()
    build = {"every_stage": S.explain_scenario,
             "direct": lambda M: S.random_scenario(M, 3, n_clusters=11,
                                                   n_bindings=32),
             "gather": lambda M: S.random_scenario(M, 4, n_clusters=700,
                                                   n_bindings=32)}[case]
    REGISTRY.register_filter("explainPlug", S.plugin_filter)
    try:
        clusters, items = build(MP)
        batch = PT.encode_batch(items, PT.ClusterIndex.build(clusters),
                                GeneralEstimator(), explain=True)
        rng = np.random.default_rng(7)
        used0 = PT.carry_from_arrays(
            rng.integers(0, 30_000, batch.avail_milli.shape),
            rng.integers(0, 60, batch.pods_allowed.shape),
            rng.integers(0, 4, batch.est_override.shape))
        kernels.reset_counts()
        got = PS.solve_compact(batch, waves=4, with_used=True, used0=used0,
                               explain=True, device=dev)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["explain_rows"] == 4
        want = PS.solve_compact(batch, waves=4, with_used=True, used0=used0,
                                explain=True, device="cpu")
    finally:
        REGISTRY.unregister("explainPlug")
    assert got[3] == want[3]
    for a, b in zip(got[:3] + got[4] + got[5], want[:3] + want[4] + want[5]):
        assert np.array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["region", "big_tier"])
def test_spread_explain_kernel_matches_plain_on_card(case):
    """K7's spread flavour: solve_spread(explain=True) hands the same
    callback rows on the card as on the CPU."""
    dev = _card()
    build = {"region": lambda M: S.region_scenario(M, 3),
             "big_tier": S.spread_big_scenario}[case]
    clusters, items = build(MP)
    batch = PT.encode_batch(items, PT.ClusterIndex.build(clusters),
                            GeneralEstimator(), explain=True)
    for (axis, tier), idxs in PT.spread_groups(batch, items).items():
        rows = {}
        for d in (dev, "cpu"):
            got = rows.setdefault(str(d), {})
            kernels.reset_counts()
            PSP.solve_spread(batch, items, idxs, waves=8, axis=axis,
                             tier=tier, explain=True, device=d,
                             explain_cb=lambda b, *r, got=got:
                             got.__setitem__(b, r))
            if d is dev:
                torch.cuda.synchronize()
                _launched(("explain_rows",))
        card, cpu = rows[str(dev)], rows["cpu"]
        assert card.keys() == cpu.keys() and card
        for b in cpu:
            for x, y in zip(card[b][:3], cpu[b][:3]):
                assert np.array_equal(x, y)
            assert card[b][3] == cpu[b][3]


def _explain_operands(C, B, dev, seed, Kp=4, Ke=4, extra=True,
                      misaligned=False):
    """K7's operands on synthetic rows at any lane count, with every row
    kind its design branches on: row 0's Kp prev entries all set on two
    lanes (duplicates), row 1's evict lane also its prev lane, rows 2 and
    7 invalid, rows 3 and 9 UNSCHEDULABLE, rows 4 and 8 with the
    non-workload shortcut, est holding MAX_INT32 (and values beyond it,
    and negatives); fail bits, selection, pick and status random.
    `misaligned` hands sel and the verdict plane 1 and 4 bytes off a
    16-byte boundary.  Returns (db, est, fail_bits [P, C], fail_bits
    [B, C], sel, pick, status)."""
    rng = np.random.default_rng(seed)
    P, G, Q = 6, 3, 4
    MAX32 = 2 ** 31 - 1

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    prev = np.full((B, Kp), -1, np.int32)
    some = rng.random(B) < 0.5
    prev[some, :min(2, Kp)] = rng.integers(0, C, (int(some.sum()),
                                                  min(2, Kp)))
    two = rng.choice(C, 2, replace=C >= 2)
    prev[0] = np.resize(two, Kp)
    evict = np.full((B, Ke), -1, np.int32)
    evict[1::3, 0] = rng.integers(0, C, len(evict[1::3]))
    prev[1, 0] = evict[1, 0]
    est = rng.integers(-5, 60, (Q + 1, C)).astype(np.int64)
    est[rng.random((Q + 1, C)) < 0.15] = MAX32
    est[rng.random((Q + 1, C)) < 0.02] = MAX32 + 7
    b_valid = rng.random(B) < 0.9
    b_valid[[2, 7 % B]] = False
    nw = np.zeros(B, bool)
    nw[[4 % B, 8 % B]] = True
    status = rng.integers(0, 4, B).astype(np.int32)
    status[[3 % B, 9 % B]] = 2
    tt = {
        "cluster_valid": t(rng.random(C) < 0.93),
        "deleting": t(rng.random(C) < 0.05),
        "api_ok": t(rng.random((G, C)) < 0.9),
        "pl_mask": t(rng.random((P, C)) < 0.7),
        "pl_tol_bypass": t(rng.random((P, C)) < 0.85),
        "pl_extra_score": t(rng.integers(0, 300, (P, C)) if extra
                            else np.zeros((P, C), np.int64)),
        "req_milli": t(np.ones((Q, 2), np.int64)),
        "b_valid": t(b_valid),
        "placement_id": t(rng.integers(0, P, B).astype(np.int32)),
        "gvk_id": t(rng.integers(0, G, B).astype(np.int32)),
        "class_id": t(rng.integers(-1, Q, B).astype(np.int32)),
        "replicas": t(rng.integers(0, 40, B).astype(np.int64)),
        "non_workload": t(rng.random(B) < 0.1),
        "nw_shortcut": t(nw),
        "prev_idx": t(prev),
        "prev_val": t(rng.integers(1, 5, (B, Kp)).astype(np.int32)),
        "evict_idx": t(evict),
    }
    db = PS.DeviceBatch(B=B, C=C, device=torch.device(dev), t=tt)
    sel = rng.random((B, C)) < 0.3
    if misaligned:
        buf = torch.zeros((B * C + 1,), dtype=torch.bool, device=dev)
        buf[1:].copy_(torch.from_numpy(sel.reshape(-1)))
        sel_t = buf[1:].view(B, C)
    else:
        sel_t = t(sel)
    return (db, t(est), t(rng.integers(0, 1 << 9, (P, C)).astype(np.int32)),
            t(rng.integers(0, 1 << 9, (B, C)).astype(np.int32)), sel_t,
            t(rng.random((B, C)) < 0.6), t(status))


def _explain_out(B, C, dev, misaligned):
    out = PS.explain_planes(B, C, dev)
    if misaligned:
        buf = torch.zeros((B * C + 1,), dtype=torch.int32, device=dev)
        out = (buf[1:].view(B, C),) + out[1:]
    return out


#: (C, B, Kp, Ke): rows of one and of two bitmap tiles, and prev / evict
#: axes whose COO entries need more than 48 KB of shared memory, or less
#: but more than 48 KB with the block's static bitmaps (kp2048_ke4096,
#: kp1024_ke8192)
EXPLAIN_SHAPES = {
    "c16": (16, 12, 4, 4), "c8192": (8192, 64, 4, 4),
    "c40000_tiles": (40000, 8, 4, 4), "kp_wide": (1024, 12, 4200, 4),
    "kp2048_ke4096": (1024, 12, 2048, 4096),
    "kp1024_ke8192": (1024, 12, 1024, 8192)}

#: (C, B, misaligned): layouts the wrapper refuses (C not a multiple of
#: 4, a plane off a 16-byte boundary)
EXPLAIN_REFUSED = {
    "c13": (13, 12, False), "c4099": (4099, 16, False),
    "c40001_tiles": (40001, 8, False), "misaligned": (8192, 16, True)}


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(EXPLAIN_SHAPES))
@pytest.mark.parametrize("spread", [False, True])
def test_explain_kernel_shapes_on_card(case, spread):
    """K7 in both flavours against explain_rows_plain on the same card
    operands: the rows its design branches on (duplicate prev lanes, an
    evict lane that is also prev, invalid, UNSCHEDULABLE and shortcut
    rows, MAX_INT32 est) at every shape of EXPLAIN_SHAPES, use_extra both
    ways, over two row ranges; one launch a call."""
    dev = _card()
    C, B, Kp, Ke = EXPLAIN_SHAPES[case]
    for extra in (True, False):
        db, est, fb_p, fb_b, sel, pick, status = _explain_operands(
            C, B, dev, 3, Kp=Kp, Ke=Ke, extra=extra)
        fb = fb_b if spread else fb_p
        pk = pick if spread else None
        out_k = PS.explain_planes(B, C, dev)
        out_p = PS.explain_planes(B, C, dev)
        # use_extra False only where the extra scores are all 0
        uxs = (True,) if extra else (True, False)
        for r0, r1 in ((0, B // 2), (B // 2, B)):
            kernels.reset_counts()
            for ux in uxs:
                PS.explain_rows(db, r0, r1, est, fb, sel, status, out_k,
                                pick=pk, use_extra=ux)
                PS.explain_rows_plain(db, r0, r1, est, fb, sel, status,
                                      out_p, pick=pk)
                torch.cuda.synchronize()
                for name, a, b in zip(("verdict", "score", "avail",
                                       "outcome"), out_k, out_p):
                    assert torch.equal(a, b), (case, spread, extra, ux,
                                               name)
            assert kernels.LAUNCHES["explain_rows"] == len(uxs)
            assert sum(kernels.LAUNCHES.values()) == len(uxs)
        # the cases the design branches on are there
        assert (out_p[0][2] == 0).all() and (out_p[3][3] >> 8 == 7).all()
        assert (out_p[2][4] == 2 ** 31 - 1).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", sorted(EXPLAIN_REFUSED))
@pytest.mark.parametrize("spread", [False, True])
def test_explain_kernel_refuses_other_layouts_on_card(case, spread):
    """K7 on a C that is not a multiple of 4, or with a plane off a
    16-byte boundary, raises before any launch (its lanes go four at a
    time); the plain version runs them all."""
    dev = _card()
    C, B, mis = EXPLAIN_REFUSED[case]
    db, est, fb_p, fb_b, sel, pick, status = _explain_operands(
        C, B, dev, 3, misaligned=mis)
    fb = fb_b if spread else fb_p
    pk = pick if spread else None
    kernels.reset_counts()
    with pytest.raises(ValueError):
        PS.explain_rows(db, 0, B, est, fb, sel, status,
                        _explain_out(B, C, dev, mis), pick=pk)
    assert sum(kernels.LAUNCHES.values()) == 0
    PS.explain_rows_plain(db, 0, B, est, fb, sel, status,
                          PS.explain_planes(B, C, dev), pick=pk)


@pytest.mark.gpu
def test_explain_workspace_launch_path_on_card():
    """K7's launch path: one ExplainWorkspace serves every wave of a chunk
    (one launch a wave, the planes equal to the plain version's); a
    workspace built for other operands, or another use_extra, is
    refused."""
    dev = _card()
    C, B = 8192, 16
    db, est, fb, _fbb, sel, _pick, status = _explain_operands(
        C, B, dev, 5, extra=False)
    out_k = PS.explain_planes(B, C, dev)
    out_p = PS.explain_planes(B, C, dev)
    ws = PS.ExplainWorkspace(db, est, fb, sel, status, out_k,
                             use_extra=False)
    kernels.reset_counts()
    for r0 in range(0, B, 4):
        PS.explain_rows(db, r0, r0 + 4, est, fb, sel, status, out_k,
                        use_extra=False, workspace=ws)
        PS.explain_rows_plain(db, r0, r0 + 4, est, fb, sel, status, out_p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["explain_rows"] == 4
    for a, b in zip(out_k, out_p):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        PS.explain_rows(db, 0, 4, est.clone(), fb, sel, status, out_k,
                        use_extra=False, workspace=ws)
    with pytest.raises(ValueError):
        PS.explain_rows(db, 0, 4, est, fb, sel, status, out_k,
                        use_extra=True, workspace=ws)
    assert kernels.LAUNCHES["explain_rows"] == 4


@pytest.mark.gpu
@pytest.mark.parametrize("waves", [1, 4])
def test_explain_edge_rows_on_card(waves):
    """solve_compact(explain=True) on explain_edge_batch (the rows of
    test_torch_explain.test_explain_edge_rows_match_jax): the planes, COO
    and carry equal the CPU plain path's, one K7 launch a wave."""
    from karmada_tpu_torch.scheduler.plugins import REGISTRY

    dev = _card()
    REGISTRY.register_filter("explainPlug", S.plugin_filter)
    try:
        batch, _row, _lane = S.explain_edge_batch(MP, PT,
                                                  GeneralEstimator())
        kernels.reset_counts()
        got = PS.solve_compact(batch, waves=waves, with_used=True,
                               explain=True, device=dev)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["explain_rows"] == waves
        want = PS.solve_compact(batch, waves=waves, with_used=True,
                                explain=True, device="cpu")
    finally:
        REGISTRY.unregister("explainPlug")
    assert got[3] == want[3]
    for a, b in zip(got[:3] + got[4] + got[5], want[:3] + want[4] + want[5]):
        assert np.array_equal(a, b)


def _profile_db(C, B, dev, seed):
    """Synthetic tier-1 rows at any lane count: random cluster planes and
    snapshot (overrides, clusters without a summary or pods, a class that
    requests nothing so its capacity is MAX_INT32), placements, classes
    (class -1 included), previous and evicting lanes: K8's full operand
    set."""
    rng = np.random.default_rng(seed)
    P, G, Q, R, Kp, Ke = 8, 4, 5, 3, 4, 4

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    prev = np.full((B, Kp), -1, np.int32)
    prev[::3, :2] = rng.integers(0, C, (len(prev[::3]), 2))
    evict = np.full((B, Ke), -1, np.int32)
    evict[1::4, 0] = rng.integers(0, C, len(evict[1::4]))
    req = rng.integers(0, 4000, (Q, R)).astype(np.int64)
    req[req < 500] = 0
    req[0] = 0  # class 0 requests nothing
    pods = rng.integers(0, 120, C).astype(np.int64)
    pods[rng.random(C) < 0.05] = 1 << 40
    ovr = np.where(rng.random((Q, C)) < 0.05,
                   rng.integers(0, 40, (Q, C)), -1).astype(np.int64)
    tt = {
        "cluster_valid": t(rng.random(C) < 0.97),
        "deleting": t(rng.random(C) < 0.02),
        "name_rank": t(rng.permutation(C).astype(np.int64)),
        "api_ok": t(rng.random((G, C)) < 0.95),
        "pl_mask": t(rng.random((P, C)) < rng.random((P, 1))),
        "pl_tol_bypass": t(rng.random((P, C)) < 0.9),
        "pods_allowed": t(pods),
        "has_summary": t(rng.random(C) < 0.95),
        "avail_milli": t(rng.integers(-2000, 1 << 22, (C, R))),
        "has_alloc": t(rng.random((C, R)) < 0.9),
        "req_milli": t(req),
        "req_is_cpu": t(np.array([True, False, False])),
        "req_pods": t(rng.integers(0, 3, Q).astype(np.int64)),
        "est_override": t(ovr),
        "b_valid": t(np.arange(B) % 7 != 6),
        "placement_id": t(rng.integers(0, P, B).astype(np.int32)),
        "gvk_id": t(rng.integers(0, G, B).astype(np.int32)),
        "class_id": t(rng.integers(-1, Q, B).astype(np.int32)),
        "replicas": t(rng.integers(0, 50, B).astype(np.int64)),
        "nw_shortcut": t(np.zeros(B, bool)),
        "prev_idx": t(prev),
        "prev_val": t(rng.integers(1, 5, (B, Kp)).astype(np.int32)),
        "evict_idx": t(evict),
    }
    pref = rng.integers(0, 32, C).astype(np.int64)
    return PS.DeviceBatch(B=B, C=C, device=torch.device(dev), t=tt), t(pref)


@pytest.mark.gpu
@pytest.mark.parametrize("C,k,B", [
    (1, 1, 24), (1, 64, 1), (31, 1, 1), (31, 64, 24), (2048, 64, 24),
    (2048, 4096, 24), (16384, 64, 24), (16384, 256, 1), (16384, 4096, 24),
    (16385, 64, 24), (32768, 64, 24), (32768, 256, 24), (1 << 21, 64, 1),
    (1 << 21, 4096, 1)])
def test_shortlist_topk_kernel_matches_plain_on_card(C, k, B):
    """K8 against its plain version: cand equal as arrays (order included)
    and fcount, one launch and no other kernel: lanes below, at and past
    a multiple of the row's cluster, k from 1 to kernels.TOPK_MAX_K and
    past C, rows in shared memory up to kernels.TOPK_SMEM_LANES and in
    the device-memory pair scratch at 2^21 lanes; padding rows, rows with
    no eligible lane and rows with fewer than k."""
    dev = _card()
    db, pref = _profile_db(C, B, dev, C + k + B)
    kernels.reset_counts()
    got = PSL.shortlist_topk(db, pref, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shortlist_topk"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    want = PSL.shortlist_topk_plain(db, pref, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    fc = want[1].cpu().numpy()
    if B == 24:
        assert (fc == 0).any()
    if 8 * k <= C:
        assert (fc > k).any()


@pytest.mark.gpu
def test_group_sums_kernel_matches_plain_on_card():
    dev = _card()
    rng = np.random.default_rng(1)
    gid = torch.from_numpy(rng.integers(-1, 200, 16384).astype(np.int32))
    cap = torch.from_numpy(rng.integers(0, 256, 16384).astype(np.int64))
    kernels.reset_counts()
    got = PSL.group_sums(gid.to(dev), cap.to(dev), 200)
    torch.cuda.synchronize()
    _launched(("group_sums",))
    assert torch.equal(got.cpu(), PSL.group_sums_plain(gid, cap, 200))


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["round_robin", "region_runs", "tiled",
                                    "one_group"])
def test_group_sums_layouts_on_card(layout):
    """K9 on the megafleet's round-robin region layout, on region runs (the
    warp-level peer reduction), with more groups than one shared-memory
    tile (the tiled branch) and with every lane in one group: one launch
    and no other, every bin written (the output block is reused from a
    freed block of garbage), equal to the plain sums."""
    dev = _card()
    g = np.random.default_rng(3)
    C, G = 10_000, 200
    if layout == "round_robin":
        gid = np.arange(C) % G
        gid[::97] = -1
    elif layout == "region_runs":
        gid = np.sort(g.integers(-1, G, C))
    elif layout == "tiled":
        G = 2 * kernels.GROUP_SUM_TILE_BINS + 5
        gid = g.integers(-3, G + 3, C)
    else:
        gid = np.full(C, 7)
    gid = torch.from_numpy(gid.astype(np.int32))
    cap = torch.from_numpy(g.integers(0, 1 << 40, C).astype(np.int64))
    gd, cd = gid.to(dev), cap.to(dev)
    torch.full((G + 1,), -7, dtype=torch.int64, device=dev)  # freed garbage
    kernels.reset_counts()
    got = PSL.group_sums(gd, cd, G)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["group_sums"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert torch.equal(got.cpu(), PSL.group_sums_plain(gid, cap, G))


@pytest.mark.gpu
def test_shortlisted_megafleet_cycle_on_card():
    """A small megafleet cycle with the shortlist armed and explain on:
    every chunk shortlisted, results and decisions equal card vs CPU."""
    import random

    from karmada_tpu_torch.scheduler.pipeline import PipelineResult
    from karmada_tpu_torch.scheduler.core import schedule_items

    dev = _card()
    rng = random.Random(3)
    clusters, pls = S.build_megafleet(MP, rng, 1200, 24)
    items = S.build_mega_bindings(MP, rng, 768, pls, block=256)
    cfg = PSL.ShortlistConfig(k=64, min_cells=0)
    out = {}
    for d in (dev, "cpu"):
        PSL.reset_for_tests()
        kernels.reset_counts()
        st = PipelineResult()
        rec = PD.DecisionRecorder(capacity=1024)
        res = schedule_items(items, clusters, chunk=256, waves=8, device=d,
                             shortlist=cfg, stats=st, explain=rec)
        if d is dev:
            torch.cuda.synchronize()
            _launched(("shortlist_topk", "group_sums", "explain_rows")
                      + MAIN_PATH)
            # K1 runs once per tier-2 wave and never for tier 1
            assert (kernels.LAUNCHES["capacity"]
                    == kernels.LAUNCHES["schedule_rows"])
        assert st.shortlist["chunks"] == 3 and not st.shortlist["fallbacks"]
        out[str(d)] = ([_norm(r) for r in res],
                       [{k: v for k, v in x.items() if k not in ("ts", "id")}
                        for x in rec.recent()])
    assert out[str(dev)] == out["cpu"]


@pytest.mark.gpu
def test_shortlist_tier1_launches_no_capacity_on_card():
    """Tier 1 of a shortlisted chunk (shrink_chunk: profiles, K9, K8) is
    K8 alone: no "capacity" launch, and the candidates equal the CPU's."""
    import random

    dev = _card()
    rng = random.Random(5)
    clusters, pls = S.build_megafleet(MP, rng, 1200, 24)
    items = S.build_mega_bindings(MP, rng, 256, pls, block=64)
    batch = PT.encode_batch(items, PT.ClusterIndex.build(clusters),
                            GeneralEstimator())
    cfg = PSL.ShortlistConfig(k=64, min_cells=0)
    out = {}
    for d in (dev, "cpu"):
        PSL.reset_for_tests()
        kernels.reset_counts()
        sub, info = PSL.shrink_chunk(batch, cfg, device=d)
        assert sub is not None, info
        out[str(d)] = (sub.sub_lanes.tolist(), info["k"], info["union"])
        if d is dev:
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["capacity"] == 0
            assert kernels.LAUNCHES["shortlist_topk"] >= 1
    assert out[str(dev)] == out["cpu"]


# -- K1 in the wave: enqueued by K2's first launch -----------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("tier,waves,slices", [
    ("std", 1, False), ("std", 4, False), ("std", 8, False),
    ("big", 1, True), ("big", 4, True), ("big", 4, False)])
def test_wave_capacity_from_k2_on_card(tier, waves, slices, monkeypatch):
    """solve_compact with a carry-in, the batch's histogram overrides, on
    the card and on the CPU, bit for bit (COO, status, the carry): each
    wave's K1 enqueued by its first K2 launch, once a wave.  With
    `slices` the big tier's slice bound is cut to two rows, so each wave
    launches in several slices and every slice must read the est of the
    wave's start."""
    dev = _card()
    if tier == "std":
        batch = _batch(700, 5)
    else:
        batch = _big_batch(5000, 4, n_bindings=16)
    assert (batch.est_override >= 0).any()
    if slices:
        monkeypatch.setattr(PS, "SLICE_BYTES",
                            2 * kernels.rows_work_bytes("big"))
    rng = np.random.default_rng(waves)
    used0 = PT.carry_from_arrays(
        rng.integers(0, 30_000, batch.avail_milli.shape),
        rng.integers(0, 60, batch.pods_allowed.shape),
        rng.integers(0, 4, batch.est_override.shape))
    kernels.reset_counts()
    got = PS.solve_compact(batch, waves=waves, with_used=True, used0=used0,
                           device=dev, tier=tier)
    torch.cuda.synchronize()
    k2 = "schedule_rows" if tier == "std" else "schedule_rows_big"
    w = PS._effective_waves(batch.B, waves)
    assert kernels.LAUNCHES["capacity"] == w
    assert (kernels.LAUNCHES[k2] > w) == slices
    want = PS.solve_compact(batch, waves=waves, with_used=True, used0=used0,
                            device="cpu", tier=tier)
    assert got[3] == want[3]
    for a, b in zip(got[:3] + got[4], want[:3] + want[4]):
        assert np.array_equal(a, b)


# -- the resident plane and the incremental solve: K10, K11, K12 -------------

def _on(d, dev):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in d.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["rows", "cols"])
@pytest.mark.parametrize("dtype", [np.bool_, np.int32, np.int64])
def test_scatter_lanes_kernel_matches_plain_on_card(mode, dtype):
    """K10 in both layouts and all three element sizes, with the padded
    duplicate lanes the resident plane sends, against the plain scatter."""
    from karmada_tpu_torch.ops import resident_update as RU

    dev = _card()
    rng = np.random.default_rng(5)
    C = 4096
    lanes = rng.choice(C, 37, replace=False)
    shape = (C, 3) if mode == "rows" else (6, C)
    dst = (rng.integers(-50, 50, shape) % 2 if dtype is np.bool_
           else rng.integers(-50, 50, shape)).astype(dtype)
    vals = (rng.integers(0, 2, (37, 3) if mode == "rows" else (6, 37))
            .astype(dtype))
    if mode == "rows":
        lp, vp = RU.pad_lanes(lanes, vals)
        fn, plain = RU.scatter_rows, RU.scatter_rows_plain
    else:
        lp, vp = RU.pad_lanes_cols(lanes, vals)
        fn, plain = RU.scatter_cols, RU.scatter_cols_plain
    assert lp.shape[0] == 64  # padded with the last pair repeated
    kernels.reset_counts()
    got = fn(torch.from_numpy(dst.copy()).to(dev),
             torch.from_numpy(lp).to(dev),
             torch.from_numpy(np.ascontiguousarray(vp)).to(dev))
    torch.cuda.synchronize()
    _launched(("scatter_lanes",))
    want = plain(torch.from_numpy(dst.copy()), torch.from_numpy(lp),
                 torch.from_numpy(np.ascontiguousarray(vp)))
    assert torch.equal(got.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("name", S.SCATTER_CASES)
def test_scatter_fields_kernel_matches_plain_on_card(name):
    """The fused K10 over tests/torch_scenarios.scatter_case's items (mixed
    dtypes and layouts, a shared lane list, duplicates with equal values,
    the split, the twelve slot-store fields at 1,024 slots, the nine
    cluster-side fields at 64 lanes) against scatter_fields_plain over the
    same staging, bit for bit: one scatter_lanes launch per table of
    SCATTER_FIELDS entries and no other launch."""
    from karmada_tpu_torch.ops import resident_update as RU

    dev = _card()
    items = S.scatter_case(name, np.random.default_rng(sum(map(ord, name))))
    card = [torch.from_numpy(d.copy()).to(dev) for d, *_rest in items]
    host = [torch.from_numpy(d.copy()) for d, *_rest in items]
    torch.cuda.synchronize()
    kernels.reset_counts()
    RU.scatter_fields([(t, la, v, m) for t, (_d, la, v, m)
                       in zip(card, items)], dev)
    torch.cuda.synchronize()
    tables = -(-len(items) // RU.SCATTER_FIELDS)
    assert kernels.LAUNCHES["scatter_lanes"] == tables
    assert sum(kernels.LAUNCHES.values()) == tables
    st = RU.stage_fields([(t, la, v, m) for t, (_d, la, v, m)
                          in zip(host, items)])
    RU.scatter_fields_plain(st.dsts, torch.from_numpy(st.buf), st.desc)
    for a, b in zip(card, host):
        assert torch.equal(a.cpu(), b)
    kernels.reset_counts()
    RU.scatter_fields([], dev)
    assert sum(kernels.LAUNCHES.values()) == 0


@pytest.mark.gpu
def test_mirror_syncs_one_launch_each_on_card():
    """The fused resident plane's mirror syncs on the card
    (tests/torch_scenarios.fused_plane_syncs: mirrors equal a fresh
    placement of their masters after every cycle): every sync that
    scatters stages one upload and makes exactly one K10 launch."""
    from karmada_tpu_torch.resident import state as ST

    per_sync = S.fused_plane_syncs(MP, _card())
    torch.cuda.synchronize()
    scattered = [name for name, d, _k in per_sync if d["scatter_fields"]]
    assert set(scattered) == {"_DeviceRows", "_DevicePlane"}
    for name, d, launched in per_sync:
        assert d["scatter_staged"] == d["scatter_tables"] == launched == int(
            d["scatter_fields"] > 0), (name, d, launched)
    assert any(name == "_DeviceRows"
               and d["scatter_fields"] == len(ST.DEVICE_SLOT_FIELDS)
               for name, d, _k in per_sync)


@pytest.mark.gpu
@pytest.mark.parametrize("flavour", ["plain", "sub"])
def test_gather_rows_kernel_matches_plain_on_card(flavour):
    """K11 on pad rows, every route, and (sub flavour) a 64-lane union with
    out-of-union prev lanes and dropped rows, against the plain gather:
    every output row and dtype."""
    from karmada_tpu_torch.ops import resident_gather as RG

    dev = _card()
    rng = np.random.default_rng(7)
    C, cap, B = 2048, 4096, 512
    store = S.slot_store(rng, cap, 4, 2, C, 16)
    slots = rng.integers(0, cap, B).astype(np.int64)
    slots[-40:] = -1
    args = []
    if flavour == "sub":
        inv = np.full(C, -1, np.int32)
        lanes = rng.choice(C, 64, replace=False)
        inv[lanes] = np.arange(64, dtype=np.int32)
        args = [inv, rng.random(B) < 0.2]
    cpu = [torch.from_numpy(a) for a in [slots] + args]
    card = [a.to(dev) for a in cpu]
    kernels.reset_counts()
    if flavour == "sub":
        got = RG.sub_gather_batch(card[0], _on(store, dev), *card[1:])
        want = RG.sub_gather_batch_plain(cpu[0], _on(store, "cpu"), *cpu[1:])
    else:
        got = RG.gather_batch(card[0], _on(store, dev))
        want = RG.gather_batch_plain(cpu[0], _on(store, "cpu"))
    torch.cuda.synchronize()
    _launched(("gather_rows",))
    for f, a, b in zip(RG.OUT_FIELDS, got, want):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), f


@pytest.mark.gpu
def test_gather_rows_launch_path_on_card():
    """K11's launch path: one launch a call from card slots and from host
    slots (the staged upload), two calls in flight whose outputs do not
    alias and both equal the plain gather, slots on the host with the
    mirrors on the card raise, and a re-placed mirror of the wrong dtype
    raises (the validated mirror set is checked again)."""
    from karmada_tpu_torch.ops import resident_gather as RG

    dev = _card()
    rng = np.random.default_rng(8)
    C, cap, B = 1024, 8192, 256
    store = S.slot_store(rng, cap, 4, 4, C)
    mirrors = _on(store, dev)
    cpu = _on(store, "cpu")
    slots = [rng.integers(-1, cap, B).astype(np.int64) for _ in range(2)]
    inv = np.full(C, -1, np.int32)
    inv[rng.choice(C, 64, replace=False)] = np.arange(64, dtype=np.int32)
    drop = rng.random(B) < 0.2
    kernels.reset_counts()
    first = RG.gather_batch(torch.from_numpy(slots[0]).to(dev), mirrors)
    second = RG.dispatch_gather(slots[1], mirrors)  # nothing waited between
    third = RG.dispatch_sub_gather(slots[0], mirrors, inv, drop)
    assert kernels.LAUNCHES["gather_rows"] == 3
    assert sum(kernels.LAUNCHES.values()) == 3
    torch.cuda.synchronize()

    def span(out):
        lo = min(t.data_ptr() for t in out)
        return lo, max(t.data_ptr() + t.numel() * t.element_size()
                       for t in out)

    (a0, a1), (b0, b1) = span(first), span(second)
    assert a1 <= b0 or b1 <= a0
    for got, want in (
            (first, RG.gather_batch_plain(torch.from_numpy(slots[0]), cpu)),
            (second, RG.gather_batch_plain(torch.from_numpy(slots[1]), cpu)),
            (third, RG.sub_gather_batch_plain(
                torch.from_numpy(slots[0]), cpu, torch.from_numpy(inv),
                torch.from_numpy(drop)))):
        for f, x, y in zip(RG.OUT_FIELDS, got, want):
            assert x.dtype == y.dtype and x.is_contiguous(), f
            assert torch.equal(x.cpu(), y), f
    with pytest.raises(ValueError):
        RG.gather_batch(torch.from_numpy(slots[0]), mirrors)
    mirrors["replicas"] = mirrors["replicas"].to(torch.int32)
    with pytest.raises(TypeError):
        RG.gather_batch(torch.from_numpy(slots[0]).to(dev), mirrors)


def _same_gather(got, slots, cpu, inv=None, drop=None):
    from karmada_tpu_torch.ops import resident_gather as RG

    sl = torch.from_numpy(np.asarray(slots, np.int64))
    want = (RG.gather_batch_plain(sl, cpu) if inv is None else
            RG.sub_gather_batch_plain(sl, cpu, torch.from_numpy(inv),
                                      torch.from_numpy(drop)))
    for f, x, y in zip(RG.OUT_FIELDS, got, want):
        assert x.dtype == y.dtype and x.is_contiguous(), f
        assert torch.equal(x.cpu(), y), f


@pytest.mark.gpu
def test_gather_rows_staging_ring_on_card():
    """K11's staging ring: with the stream held busy, GATHER_RING + 3
    dispatches from host slots (both flavours in turn, other slots each
    time) are in flight before one sync, and the host arrays are
    overwritten as soon as each call returns; every result equals the
    plain gather of its own inputs, so no ring buffer was reused before
    its copy had run.  Then the inputs at their edges, from host and from
    card slots: B = 1 and B = 37, every slot -1, drop all set and all
    clear, lane_inv all -1 and holding -1, a wider lane_inv that grows
    the ring; one launch a call; and a re-placed mirror of the wrong
    dtype still raises."""
    from karmada_tpu_torch.ops import resident_gather as RG

    dev = _card()
    rng = np.random.default_rng(9)
    C, cap, B = 1024, 8192, 300
    store = S.slot_store(rng, cap, 4, 4, C)
    mirrors, cpu = _on(store, dev), _on(store, "cpu")
    inv = np.full(C, -1, np.int32)
    inv[rng.choice(C, 64, replace=False)] = np.arange(64, dtype=np.int32)
    kernels.reset_counts()
    torch.cuda._sleep(100_000_000)  # the copies queue behind it
    calls = []
    for i in range(kernels.GATHER_RING + 3):
        sl = rng.integers(-1, cap, B).astype(np.int64)
        keep = sl.copy()
        if i % 2:
            dr = rng.random(B) < 0.3
            out = RG.dispatch_sub_gather(sl, mirrors, inv, dr)
            calls.append((out, keep, inv.copy(), dr.copy()))
            dr[:] = ~dr
        else:
            out = RG.dispatch_gather(sl, mirrors)
            calls.append((out, keep, None, None))
        sl[:] = 0
    assert kernels.LAUNCHES["gather_rows"] == len(calls)
    torch.cuda.synchronize()
    for out, keep, iv, dr in calls:
        _same_gather(out, keep, cpu, iv, dr)

    neg = np.full(C, -1, np.int32)
    part = inv.copy()
    part[::2] = -1
    wide = np.concatenate([inv, np.full(3 * C, -1, np.int32)])
    cases = []
    for n in (1, 37, 256):
        sl = rng.integers(-1, cap, n).astype(np.int64)
        cases += [(sl, None, None), (np.full(n, -1, np.int64), None, None)]
        for iv in (inv, neg, part, wide):
            for dr in (np.ones(n, bool), np.zeros(n, bool),
                       rng.random(n) < 0.5):
                cases.append((sl, iv, dr))
    for sl, iv, dr in cases:
        kernels.reset_counts()
        if iv is None:
            host = RG.dispatch_gather(sl, mirrors)
            card = RG.gather_batch(torch.from_numpy(sl).to(dev), mirrors)
        else:
            host = RG.dispatch_sub_gather(sl, mirrors, iv, dr)
            card = RG.sub_gather_batch(
                torch.from_numpy(sl).to(dev), mirrors,
                torch.from_numpy(iv).to(dev), torch.from_numpy(dr).to(dev))
        assert kernels.LAUNCHES["gather_rows"] == 2
        assert sum(kernels.LAUNCHES.values()) == 2
        torch.cuda.synchronize()
        for got in (host, card):
            _same_gather(got, sl, cpu, iv, dr)
    mirrors["replicas"] = mirrors["replicas"].to(torch.int32)
    with pytest.raises(TypeError):
        RG.dispatch_gather(cases[0][0], mirrors)


@pytest.mark.gpu
def test_dirty_codes_kernel_matches_plain_on_card():
    """K12 with rv slots holding slot 0 plus -1 padding, absent prev lanes,
    real prev lane 0, -1 evict pads and flip lanes, against the plain
    pass."""
    from karmada_tpu_torch.ops import dirty as DM

    dev = _card()
    rng = np.random.default_rng(9)
    C, P, cap = 1024, 24, 8192
    store = S.slot_store(rng, cap, 4, 2, C, P)
    store["prev_idx"][:8, 0] = 0  # a real prev lane 0
    plane = {
        "cluster_valid": rng.random(C) < 0.95,
        "deleting": rng.random(C) < 0.05,
        "pl_mask": rng.random((P, C)) < 0.3,
        "pl_strategy": rng.integers(0, 5, P).astype(np.int32),
        "pl_has_cluster_sc": rng.random(P) < 0.2,
        "pl_has_region_sc": rng.random(P) < 0.1,
    }
    flips = DM._pad_lanes(rng.choice(C, 5, replace=False))
    rv = DM._pad_lanes(np.concatenate([[0], rng.choice(cap, 20)]))
    ins = [store[f] for f in DM.SLOT_FIELDS] + [
        plane[f] for f in DM.PLANE_FIELDS] + [flips, rv]
    kernels.reset_counts()
    got = DM.dirty_kernel(*(torch.from_numpy(a).to(dev) for a in ins))
    torch.cuda.synchronize()
    _launched(("dirty_codes",))
    want = DM.dirty_kernel_plain(*(torch.from_numpy(a) for a in ins))
    assert torch.equal(got.cpu(), want)
    assert int(want[0]) & DM.DIRTY


def _dirty_store(rng, cap, C, P, Kp, Ke):
    """A slot store and planes for K12 (numpy), with half the Dynamic rows
    steady (replicas = the replicas on their feasible prev lanes), so
    every branch of the verdict runs."""
    store = S.slot_store(rng, cap, Kp, Ke, C, P)
    store["prev_val"] = np.where(store["prev_idx"] >= 0, store["prev_val"],
                                 0).astype(np.int32)
    plane = {
        "cluster_valid": rng.random(C) < 0.95,
        "deleting": rng.random(C) < 0.05,
        "pl_mask": rng.random((P, C)) < 0.5,
        "pl_strategy": rng.integers(0, 5, P).astype(np.int32),
        "pl_has_cluster_sc": rng.random(P) < 0.15,
        "pl_has_region_sc": rng.random(P) < 0.1,
    }
    pi, pid = store["prev_idx"], store["placement_id"]
    li = np.where(pi >= 0, pi, 0)
    ev = store["evict_idx"]
    evicted = (li[:, :, None] == np.where(ev >= 0, ev, -2)[:, None, :]).any(2)
    feas = ((pi >= 0) & plane["cluster_valid"][li] & ~plane["deleting"][li]
            & plane["pl_mask"][pid[:, None], li] & ~evicted)
    assigned = np.where(feas, store["prev_val"], 0).sum(1)
    steady = rng.random(cap) < 0.5
    store["replicas"] = np.where(steady, assigned,
                                 store["replicas"]).astype(np.int64)
    store["fresh"] &= rng.random(cap) < 0.3
    return store, plane


def _misaligned(a: torch.Tensor) -> torch.Tensor:
    """`a` as a contiguous view 4 bytes past a 16-byte boundary."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    v = buf[1:].view(a.shape)
    v.copy_(a)
    assert v.data_ptr() % 16 and v.is_contiguous()
    return v


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    "cap_ragged", "cap_tiny", "no_flips", "rv_all_padded", "one_placement",
    "many_placements", "odd_kp_ke", "misaligned", "rv_long_runs"])
def test_dirty_kernel_edges_on_card(case):
    """K12 at the shapes its design branches on, against the plain pass:
    a cap that is no multiple of a block (and one below a warp), F = 0,
    every rv entry padded, P = 1, P = 32,771 (a placement's flags are
    probed a warp, whatever P), Kp / Ke not multiples of 4, prev / evict
    planes off a 16-byte boundary (scalar loads), and rv runs longer than
    a warp within one block (a slot repeated, every slot of a block);
    each with the rv list as given (padded, duplicates, slots >= cap) and
    ascending (the wrapper sorts it on the card), one launch of K12 a
    call."""
    from karmada_tpu_torch.ops import dirty as DM

    dev = _card()
    rng = np.random.default_rng(sum(map(ord, case)))
    cap, C, P, Kp, Ke, F = 3 * 2048 + 77, 256, 24, 4, 4, 5
    if case == "cap_tiny":
        cap = 19
    elif case == "one_placement":
        P = 1
    elif case == "many_placements":
        P, C = 32771, 16
    elif case == "odd_kp_ke":
        Kp, Ke = 3, 5
    elif case == "no_flips":
        F = 0
    store, plane = _dirty_store(rng, cap, C, P, Kp, Ke)
    flips = (DM._pad_lanes(rng.choice(C, F, replace=False)) if F
             else np.zeros(0, np.int64))
    rv = (np.full(16, -1, np.int64) if case == "rv_all_padded" else
          DM._pad_lanes(np.concatenate([[0, 0, cap, cap + 9],
                                        rng.choice(cap, 40)])))
    if case == "rv_long_runs":
        rv = DM._pad_lanes(np.concatenate([[300] * 70, np.arange(512, 800),
                                           [cap - 1] * 3]))
    ins = [store[f] for f in DM.SLOT_FIELDS] + [
        plane[f] for f in DM.PLANE_FIELDS] + [flips, rv]
    want = DM.dirty_kernel_plain(*(torch.from_numpy(a) for a in ins))
    dv = [torch.from_numpy(a).to(dev) for a in ins]
    if case == "misaligned":
        for i in (5, 6, 7):  # prev_idx, prev_val, evict_idx
            dv[i] = _misaligned(dv[i])
    srt = dv[:-1] + [torch.sort(dv[-1]).values]
    for name, args in (("as given", dv), ("ascending", srt)):
        kernels.reset_counts()
        got = DM.dirty_kernel(*args)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["dirty_codes"] == 1
        assert sum(kernels.LAUNCHES.values()) == 1
        assert torch.equal(got.cpu(), want), name
    assert want.unique().numel() >= 2  # more than one verdict


@pytest.mark.gpu
def test_dirty_codes_call_on_card():
    """dirty_codes as the incremental solver calls it on a fused plane on
    the card: one launch, equal to the plain pass over the host masters
    with flip lanes and an rv list of pads, duplicates, slot 0 and slots
    >= cap; the codes are the caller's (a second call leaves them)."""
    import random

    from karmada_tpu_torch.ops import dirty as DM
    from karmada_tpu_torch.resident import ResidentState
    from karmada_tpu_torch.resident.deltas import CycleDeltas
    from karmada_tpu_torch.scheduler.incremental import IncrementalSolver

    dev = _card()
    rng = random.Random(5)
    clusters, pls = S.build_megafleet(MP, rng, 96, 6)
    bindings = S.as_bindings(MP, S.build_mega_bindings(MP, rng, 600, pls,
                                                       block=100))
    state = ResidentState(audit_interval=0, fused=True, device=dev)
    solver = IncrementalSolver(state, GeneralEstimator(), chunk=128,
                               audit_every=0)
    solver.adopt(clusters, bindings)
    solver.write_back()
    solver.cycle(clusters, bindings, CycleDeltas())
    p = state.plane
    cap = p.placement_id.shape[0]
    state.last_flip_lanes = np.array([3, 40, 77], np.int64)
    rv = np.array([-1, 0, 5, 5, cap, cap + 3, 17, -1], np.int64)
    host = [torch.from_numpy(np.array(getattr(p, f)))
            for f in DM.SLOT_FIELDS + DM.PLANE_FIELDS]
    want = DM.dirty_kernel_plain(
        *host, torch.from_numpy(DM._pad_lanes(state.last_flip_lanes)),
        torch.from_numpy(DM._pad_lanes(rv))).numpy()
    torch.cuda.synchronize()
    kernels.reset_counts()
    got = DM.dirty_codes(state, rv, mirrors=state.device_rows.mirrors)
    assert kernels.LAUNCHES["dirty_codes"] == 1
    assert sum(kernels.LAUNCHES.values()) == 1
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    keep = got.copy()
    again = DM.dirty_codes(state, np.zeros(0, np.int64))
    assert np.array_equal(got, keep) and not np.shares_memory(got, again)


@pytest.mark.gpu
def test_fused_incremental_steady_state_on_card():
    """The fused resident plane with the shortlist under the incremental
    solver, card against CPU: the same reports, results and ledgers; K10,
    K11 and K12 on the card; no binding field uploaded in a warm cycle."""
    import random

    from karmada_tpu_torch.resident import ResidentState
    from karmada_tpu_torch.resident.deltas import CycleDeltas
    from karmada_tpu_torch.scheduler.incremental import IncrementalSolver

    dev = _card()
    out = {}
    for d in (dev, "cpu"):
        PSL.reset_for_tests()
        rng = random.Random(3)
        clusters, pls = S.build_megafleet(MP, rng, 1200, 24)
        items = S.build_mega_bindings(MP, rng, 768, pls, block=256)
        bindings = S.as_bindings(MP, items)
        state = ResidentState(audit_interval=0, fused=True, device=d)
        solver = IncrementalSolver(
            state, GeneralEstimator(), chunk=256, audit_every=0,
            shortlist=PSL.ShortlistConfig(k=64, min_cells=0))
        kernels.reset_counts()
        reps = [solver.adopt(clusters, bindings)]
        solver.write_back()
        reps.append(solver.cycle(clusters, bindings, CycleDeltas()))
        solver.write_back()
        d0 = PS.TRANSFERS["h2d_binding_fields"]
        deltas = S.churn(CycleDeltas, rng, clusters, bindings, 8, n_caps=2)
        reps.append(solver.cycle(clusters, bindings, deltas,
                                 force_audit=True))
        assert reps[-1].audit_outcome == "ok"
        assert PS.TRANSFERS["h2d_binding_fields"] == d0
        if d is dev:
            torch.cuda.synchronize()
            _launched(("scatter_lanes", "gather_rows", "dirty_codes",
                       "shortlist_topk") + MAIN_PATH)
        out[str(d)] = ([(r.mode, r.dirty, r.groups, r.audit_outcome)
                        for r in reps],
                       {p: _norm(r) for p, r in solver.results.items()},
                       {k: v.tolist() for k, v in solver.ledger.milli.items()})
    assert out[str(dev)] == out["cpu"]


@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 7, 5000, 16384])
def test_rebalance_score_kernel_matches_plain_on_card(C):
    """K13 against score_kernel_plain: negatives, zero capacity with load,
    invalid lanes; thresholds 800 and 1000, spread off and 50."""
    from karmada_tpu_torch.ops import rebalance_detect as PRD

    dev = _card()
    rng = np.random.default_rng(C)
    com = rng.integers(-50, 1 << 20, C)
    cap = rng.integers(-50, 1 << 20, C)
    cap[rng.random(C) < 0.15] = 0
    valid = rng.random(C) < 0.85
    args = [torch.from_numpy(a) for a in (com, cap, valid)]
    for thr in (800, 1000):
        for tol in (1 << 20, 50):
            kernels.reset_counts()
            got = PRD.score_kernel(*(a.to(dev) for a in args), thr, tol)
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["rebalance_score"] == 1
            want = PRD.score_kernel_plain(*args, thr, tol)
            for g, w in zip(got, want):
                assert torch.equal(g.cpu(), w)
    kernels.reset_counts()
    empty = torch.zeros(0, dtype=torch.int64, device=dev)
    out = PRD.score_kernel(empty, empty, empty.bool(), 1000, 50)
    assert all(o.shape == (0,) for o in out)
    assert kernels.LAUNCHES["rebalance_score"] == 0  # no lanes, no launch


def _score_lanes(rng, C, mix):
    com = rng.integers(-50, 1 << 20, C)
    cap = rng.integers(-50, 1 << 20, C)
    cap[rng.random(C) < 0.15] = 0
    valid = rng.random(C) < 0.85
    if mix == "all_invalid":
        valid[:] = False
    elif mix == "zero_totals":
        com = np.minimum(com, 0)
        cap = np.minimum(cap, 0)
    elif mix == "wrap" and C:
        # com * 1000 wraps; the committed total past the reciprocal's
        # range (2^62 + 1) but positive; the capacity total wraps negative
        valid[:3] = True
        com[0] = (1 << 62) + 12345
        cap[:3] = 1 << 62
        com[1:3] = np.minimum(com[1:3], (1 << 53) + 7)
    return com, cap, valid


@pytest.mark.gpu
@pytest.mark.parametrize("C", [0, 1, 7, 5000, 10000, 16384, 1 << 17])
@pytest.mark.parametrize("mix", ["random", "all_invalid", "zero_totals",
                                 "wrap"])
def test_rebalance_score_edges_on_card(C, mix):
    """K13 from device operands (score_kernel) and from numpy (score, one
    C call: upload, launch, download, sync) against the plain version:
    a cluster of one block, one of several and lanes past the cluster's
    registers (kernels.SCORE_BLOCK_LANES, SCORE_CLUSTER_MAX); all lanes invalid,
    zero totals, wrapped products and totals; thresholds 800 / 1000,
    spread off, 50 and -5.  One launch a call (none for C = 0); score's
    arrays are the caller's; its timing reads the kernel's events."""
    from karmada_tpu_torch.ops import rebalance_detect as PRD

    dev = _card()
    rng = np.random.default_rng(C + len(mix))
    com, cap, valid = _score_lanes(rng, C, mix)
    cpu = [torch.from_numpy(a) for a in (com, cap, valid)]
    card = [a.to(dev) for a in cpu]
    held = []
    for thr in (800, 1000):
        for tol in (1 << 20, 50, -5):
            want = PRD.score_kernel_plain(*cpu, thr, tol)
            kernels.reset_counts()
            got = PRD.score_kernel(*card, thr, tol)
            torch.cuda.synchronize()
            tm = {}
            host = PRD.score(com, cap, valid, thr, tol, device=dev,
                             timing=tm)
            assert kernels.LAUNCHES["rebalance_score"] == (2 if C else 0)
            assert sum(kernels.LAUNCHES.values()) == (2 if C else 0)
            for g, h, w in zip(got, host, want):
                assert torch.equal(g.cpu(), w)
                assert h.dtype == np.int64 and np.array_equal(h, w.numpy())
            assert (tm["kernel_ms"] > 0) == (C > 0)
            held.append((host, [w.numpy() for w in want]))
    for host, want in held:  # later calls left the earlier results
        assert all(np.array_equal(h, w) for h, w in zip(host, want))


@pytest.mark.gpu
def test_rebalance_plane_cycle_on_card():
    """One rebalance cycle on the card and on the CPU over the same store
    contents: equal snapshots and evictions; K13 launched once."""
    import random

    from karmada_tpu_torch.rebalance import RebalanceConfig, RebalancePlane
    from karmada_tpu_torch.store import ObjectStore

    class Stub:
        def __init__(self, clock):
            self.queue = type("Q", (), {"now": staticmethod(clock)})()
            self.promoted = []

        def promote(self, key, priority=0, origin="rebalance"):
            self.promoted.append((key, priority, origin))

    dev = _card()
    out = {}
    for d in (dev, "cpu"):
        rng = random.Random(4)
        store = ObjectStore()
        fleet = S.control_fleet(MP, rng, 64)
        names = [c.name for c in fleet]
        for c in fleet:
            store.create(c)
        bindings = S.control_bindings(MP, rng, 400,
                                      S.control_placements(MP, rng, names))
        for rb in bindings:
            rb.spec.clusters = [MP.TargetCluster(name=n,
                                                 replicas=rb.spec.replicas)
                                for n in sorted(rng.sample(names[:16], 2))]
            store.create(rb)
        held = S.committed_by_cluster(bindings)
        for n in sorted(held, key=lambda n: (-held[n], n))[:4]:
            S.crush(MP, store, n, held[n])
        clock = S.FakeClock()
        stub = Stub(clock)
        plane = RebalancePlane(store, stub, clock=clock, device=d,
                               cfg=RebalanceConfig(max_evictions_per_cycle=64))
        kernels.reset_counts()
        snap = plane.run_cycle()
        if d is dev:
            torch.cuda.synchronize()
            assert kernels.LAUNCHES["rebalance_score"] == 1
            assert plane.last_timing["kernel_ms"] > 0
        out[str(d)] = (snap, stub.promoted)
    assert out[str(dev)][0]["evicted"] > 0
    assert out[str(dev)] == out["cpu"]


def _loop_snapshot(device, failover=False, descheduler=False):
    """A ControlPlane on `device`: 8 members, a Divided / Duplicated /
    region-spread / Aggregated policy mix over 40 Deployments, an image
    override on one member, ticked to quiescence; returns the normalized
    snapshot (uids, resourceVersions and times cleared) and the plane.
    Uids come from a counter: a template's uid breaks scheduling ties.
    With `failover`, on a clock only the test moves: then two members
    fail past their tolerations and the eviction pacing, and recover."""
    import dataclasses
    import itertools
    from unittest import mock

    from karmada_tpu_torch.e2e import ControlPlane
    from karmada_tpu_torch.store import store as store_mod

    cleared = {"uid", "resource_version", "resourceVersion",
               "creation_timestamp", "deletion_timestamp",
               "last_transition_time", "last_scheduled_time", "renew_time"}

    def norm(v):
        if dataclasses.is_dataclass(v) and not isinstance(v, type):
            return {f.name: (None if f.name in cleared
                             else norm(getattr(v, f.name)))
                    for f in dataclasses.fields(v)}
        if isinstance(v, dict):
            return {k: (None if k in cleared else norm(x))
                    for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [norm(x) for x in v]
        return v

    seq = itertools.count(1)
    with mock.patch.object(store_mod, "new_uid",
                           lambda: f"uid-{next(seq):06d}"):
        cp = _loop_plane(ControlPlane, device, failover, descheduler)
    snap = {}
    for obj in cp.store.items():
        snap[(obj.KIND, obj.metadata.namespace, obj.metadata.name)] = \
            norm(obj)
    for name, m in cp.members.items():
        for obj in m.store.items():
            snap[(name, obj.KIND, obj.metadata.namespace,
                  obj.metadata.name)] = norm(obj)
    return snap, cp


def _loop_plane(ControlPlane, device, failover=False, descheduler=False):
    import random

    M = MP
    rng = random.Random(9)
    clock = [1000.0]
    cp = ControlPlane(device=device, clock=lambda: clock[0],
                      enable_descheduler=descheduler)
    for i in range(8):
        cp.add_member(f"m{i}", cpu_milli=rng.choice([8_000, 16_000, 32_000]),
                      region=f"r{i % 3}", collect=False)
    cp.cluster_status.collect_all()
    divided = M.ReplicaSchedulingStrategy(
        replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
        replica_division_preference=M.REPLICA_DIVISION_WEIGHTED,
        weight_preference=M.ClusterPreferences(
            dynamic_weight=M.DYNAMIC_WEIGHT_AVAILABLE_REPLICAS))
    placements = [
        M.Placement(replica_scheduling=divided),
        M.Placement(cluster_affinity=M.ClusterAffinity(
            cluster_names=["m1", "m4", "m6"]),
            replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)),
        M.Placement(spread_constraints=[
            M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_REGION,
                               min_groups=1, max_groups=2),
            M.SpreadConstraint(spread_by_field=M.SPREAD_BY_FIELD_CLUSTER,
                               min_groups=2, max_groups=4)],
            replica_scheduling=divided),
        M.Placement(spread_constraints=[M.SpreadConstraint(
            spread_by_field=M.SPREAD_BY_FIELD_CLUSTER, min_groups=2,
            max_groups=3)], replica_scheduling=M.ReplicaSchedulingStrategy(
                replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                replica_division_preference=(
                    M.REPLICA_DIVISION_AGGREGATED))),
    ]
    for p, placement in enumerate(placements):
        cp.apply_policy(M.ClusterPropagationPolicy(
            metadata=M.ObjectMeta(name=f"p{p}"),
            spec=M.PropagationSpec(
                resource_selectors=[M.ResourceSelector(
                    api_version="apps/v1", kind="Deployment",
                    label_selector=M.LabelSelector(
                        match_labels={"placement": f"p{p}"}))],
                placement=placement)))
    cp.apply_policy(M.OverridePolicy(
        metadata=M.ObjectMeta(name="img", namespace="ns-0"),
        spec=M.OverrideSpec(
            resource_selectors=[M.ResourceSelector(kind="Deployment")],
            override_rules=[M.RuleWithCluster(
                target_cluster=M.ClusterAffinity(cluster_names=["m4"]),
                overriders=M.Overriders(image_overrider=[M.ImageOverrider(
                    component="Registry", operator="replace",
                    value="mirror.local")]))])))
    for b in range(40):
        cp.apply({"apiVersion": "apps/v1", "kind": "Deployment",
                  "metadata": {"name": f"app-{b}", "namespace": f"ns-{b % 3}",
                               "labels": {"placement": f"p{b % 4}"}},
                  "spec": {"replicas": rng.choice([1, 2, 5, 10]),
                           "template": {"spec": {"containers": [{
                               "name": "c", "image": "nginx:1.19",
                               "resources": {"requests": {
                                   "cpu": rng.choice(["100m", "500m"]),
                                   "memory": "1Gi"}}}]}}}})
    for _ in range(4):
        cp.tick()
    if failover:
        for name in ("m2", "m5"):
            cp.member(name).healthy = False
        cp.tick()
        for _ in range(3):
            clock[0] += 310.0
            cp.tick()
        for name in ("m2", "m5"):
            cp.member(name).healthy = True
        for _ in range(3):
            clock[0] += 30.0
            cp.tick()
    if descheduler:
        # the two members holding the most replicas squeezed to 60% of
        # their pods through the member model: the descheduler shrinks
        # the Divided replicas stuck there, the Scheduler re-places them
        held = {}
        for rb in cp.store.visit("ResourceBinding"):
            for t in rb.spec.clusters:
                held[t.name] = held.get(t.name, 0) + t.replicas
        for name in sorted(held, key=lambda m: (-held[m], m))[:2]:
            member = cp.member(name)
            member.pods_allocatable = (
                member.used_milli()["pods"] // 1000 * 6 // 10)
        for _ in range(4):
            clock[0] += 60.0
            cp.tick()
    return cp


@pytest.mark.gpu
def test_control_plane_loop_on_card():
    """The port's propagation loop (ControlPlane: detector, the Scheduler's
    device cycle, Works, members, status) on the card equals the same loop
    with device="cpu", and the cycle went through K1-K4."""
    dev = _card()
    kernels.reset_counts()
    card, cp = _loop_snapshot(dev)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    cpu, _ = _loop_snapshot("cpu")
    assert card == cpu
    for k in ("capacity", "schedule_rows", "webster_batch", "compact"):
        assert launches[k] > 0, launches
    assert cp.scheduler.faults() == {} and cp.execution.sync_failures == 0
    assert not any(cp.runtime.reconcile_errors().values())
    ready = [o.manifest["status"]["readyReplicas"]
             for o in cp.store.list("Deployment")]
    assert len(ready) == 40 and sum(ready) > 0


@pytest.mark.gpu
def test_failover_loop_on_card():
    """The failover loop on the card (two members fail past the 300 s
    toleration, the taint manager evicts through its queue, the Scheduler
    re-places on the card with the evicted clusters in K2's lanes, then
    the members recover) equals the same loop with device="cpu"."""
    dev = _card()
    kernels.reset_counts()
    card, cp = _loop_snapshot(dev, failover=True)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    cpu, _ = _loop_snapshot("cpu", failover=True)
    assert card == cpu
    for k in ("capacity", "schedule_rows", "webster_batch", "compact"):
        assert launches[k] > 0, launches
    assert cp.taint_manager.evicted > 0
    assert cp.scheduler.faults() == {} and cp.execution.sync_failures == 0
    assert not any(cp.runtime.reconcile_errors().values())
    assert {c["backend"] for c in cp.scheduler.cycle_log} == {"device"}
    for rb in cp.store.list("ResourceBinding"):
        assert not rb.spec.graceful_eviction_tasks


def _facade_answers(cp):
    """Sixteen AssignReplicas through one FacadeService (two coalesced
    batches) and the three what-if queries, as JSON."""
    from karmada_tpu_torch.estimator import wire
    from karmada_tpu_torch.facade import FacadeService, WhatIfRequest

    svc = FacadeService(cp.scheduler, cp.store, batch_window=8,
                        batch_deadline_s=600.0)
    try:
        pending = [svc.assign_async(wire.AssignReplicasRequest(
            namespace="facade", name=f"r{i}", replicas=1 + i % 5,
            resource_request={"cpu": ["100m", "500m"][i % 2],
                              "memory": "1Gi"},
            divided=i % 3 != 0,
            cluster_names=["m1", "m4"] if i % 4 == 0 else []))
            for i in range(16)]
        out = [p.result(120).to_json() for p in pending]
        for q in ("placement", "headroom", "cluster-loss"):
            out.append(svc.whatif(WhatIfRequest(
                query=q, replicas=4,
                resource_request={"cpu": "500m"})).to_json())
        assert svc.state_payload()["batches"] == 2
    finally:
        svc.close()
    return out


@pytest.mark.gpu
def test_descheduler_and_facade_on_card():
    """Chip phase 15a in small: the loop with the descheduler armed and two
    members squeezed through the member model, then the facade's
    coalesced answers and what-if queries -- card equal to
    device="cpu", the descheduler shrinking over the estimator tier and
    the facade's device cycles through K1-K4."""
    dev = _card()
    kernels.reset_counts()
    card, cp = _loop_snapshot(dev, descheduler=True)
    answers = _facade_answers(cp)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    cpu, cpu_cp = _loop_snapshot("cpu", descheduler=True)
    assert card == cpu
    assert answers == _facade_answers(cpu_cp)
    assert cp.descheduler.shrinks > 0
    assert cp.descheduler_estimator.counts()["errors"] == {}
    for k in ("capacity", "schedule_rows", "webster_batch", "compact"):
        assert launches[k] > 0, launches
    assert cp.scheduler.faults() == {} and cp.execution.sync_failures == 0
    assert not any(cp.runtime.reconcile_errors().values())
