"""Incremental-solve parity: the port's dirty pass (karmada_tpu_torch
ops/dirty.py, K12's plain version) and IncrementalSolver
(scheduler/incremental.py) equal the JAX package's on the same inputs,
tolerance 0:

  * dirty_kernel_plain against JAX dirty_kernel, with the hazards pinned:
    an rv set holding slot 0 plus -1 padding, -1 evict pads against absent
    prev lanes and a real prev lane 0, flip lanes;
  * IncrementalSolver on both packages over the cases of
    tests/test_incremental_solve.py: the churn property at 0.01% / 0.1% /
    5% with the audit forced every cycle, the quiet cycle, the fixed
    point, roster append, cluster removal, forced mismatch recovery,
    carry-state seeding, ledger retirement on capacity churn, and the
    fused plane with the shortlist: every CycleReport, every result and
    the carried ledger equal, cycle by cycle.

Both packages' shortlist memos and counters are reset around every test.
"""

import random
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import dirty as JDM
from karmada_tpu.ops import shortlist as JSL
from karmada_tpu.ops import tensors as JT
from karmada_tpu.resident import ResidentState as JaxResident
from karmada_tpu.resident.deltas import CycleDeltas as JaxDeltas
from karmada_tpu.scheduler import pipeline as JP
from karmada_tpu.scheduler.incremental import IncrementalSolver as JaxSolver
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.ops import dirty as PDM
from karmada_tpu_torch.ops import shortlist as PSL
from karmada_tpu_torch.ops import tensors as PT
from karmada_tpu_torch.resident import ResidentState
from karmada_tpu_torch.resident.deltas import CycleDeltas
from karmada_tpu_torch.scheduler import pipeline as PP
from karmada_tpu_torch.scheduler.incremental import (
    CycleReport,
    IncrementalSolver,
)

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")

JAX = SimpleNamespace(M=MJ, RS=JaxResident, CD=JaxDeltas, IS=JaxSolver,
                      E=JaxEstimator, SL=JSL, kw={})
PORT = SimpleNamespace(M=MP, RS=ResidentState, CD=CycleDeltas,
                       IS=IncrementalSolver, E=GeneralEstimator, SL=PSL,
                       kw={"device": "cpu"})


@pytest.fixture(autouse=True)
def _reset_memos():
    JSL.reset_for_tests()
    PSL.reset_for_tests()
    yield
    JSL.reset_for_tests()
    PSL.reset_for_tests()


# -- K12 plain against the JAX program -----------------------------------------

@pytest.mark.parametrize("seed,n_flip,n_rv", [(0, 0, 0), (1, 3, 17),
                                              (2, 9, 200)])
def test_dirty_kernel_plain_matches_jax(seed, n_flip, n_rv):
    rng = np.random.default_rng(seed)
    C, P, cap, Kp, Ke = 40, 12, 512, 4, 3
    prev = rng.integers(-1, C, (cap, Kp)).astype(np.int32)
    prev[:16, 0] = 0              # a real prev lane 0 ...
    ev = rng.integers(-1, C, (cap, Ke)).astype(np.int32)
    ev[:8, 0] = 0                 # ... evicted on half of those rows
    ev[8:16] = -1                 # -1 pads must never evict lane 0
    slot = {
        "placement_id": rng.integers(0, P, cap).astype(np.int32),
        "replicas": rng.integers(0, 9, cap).astype(np.int64),
        "fresh": rng.random(cap) < 0.2,
        "non_workload": rng.random(cap) < 0.1,
        "route": rng.choice([0, 0, 0, 0, 6, 8], cap).astype(np.int32),
        "prev_idx": prev,
        "prev_val": np.where(prev >= 0, rng.integers(0, 4, (cap, Kp)),
                             0).astype(np.int32),
        "evict_idx": ev,
    }
    plane = {
        "cluster_valid": rng.random(C) < 0.9,
        "deleting": rng.random(C) < 0.1,
        "pl_mask": rng.random((P, C)) < 0.4,
        "pl_strategy": rng.integers(0, 5, P).astype(np.int32),
        "pl_has_cluster_sc": rng.random(P) < 0.2,
        "pl_has_region_sc": rng.random(P) < 0.1,
    }
    plane["cluster_valid"][0] = True
    plane["deleting"][0] = False
    flips = PDM._pad_lanes(rng.choice(C, n_flip, replace=False))
    # slot 0 among the rv slots, then the -1 pads (JAX scatters max(False)
    # onto slot 0 for each pad: a store would clear the hit)
    rv = PDM._pad_lanes(np.concatenate([[0], rng.choice(cap, n_rv)]))
    assert np.array_equal(rv, JDM._pad_lanes(np.concatenate(
        [[0], rv[1:n_rv + 1]])))
    ins = [slot[f] for f in PDM.SLOT_FIELDS] + [
        plane[f] for f in PDM.PLANE_FIELDS] + [flips, rv]
    want = np.asarray(JDM.dirty_kernel(*ins))
    got = PDM.dirty_kernel(*(torch.from_numpy(a) for a in ins))
    assert got.dtype == torch.uint8 and want.dtype == np.uint8
    assert np.array_equal(got.numpy(), want)
    assert want[0] & PDM.DIRTY and want[0] & PDM.SENSITIVE
    assert (PDM.DIRTY, PDM.SENSITIVE, PDM.CONSUMER) == (
        JDM.DIRTY, JDM.SENSITIVE, JDM.CONSUMER)


# -- IncrementalSolver, port against JAX ---------------------------------------

def _world(K, n_clusters, n_bindings, seed, pods=None, n_pl=6):
    rng = random.Random(seed)
    clusters = S.build_fleet(K.M, rng, n_clusters)
    if pods is not None:
        for c in clusters:
            c.status.resource_summary.allocatable["pods"] = (
                K.M.Quantity.from_units(pods))
    names = [c.name for c in clusters]
    pls = S.affinity_placements(K.M, rng, names, n=n_pl, lo=4, hi=10)
    items = S.build_bindings(K.M, rng, n_bindings, pls)
    return rng, clusters, names, S.as_bindings(K.M, items)


def _static_world(K, seed, n_clusters=32, n_bindings=128):
    """Duplicated / StaticWeight placements over an ample fleet: quiet
    cycles classify every row clean."""
    M = K.M
    rng = random.Random(seed)
    clusters = S.build_fleet(M, rng, n_clusters)
    names = [c.name for c in clusters]
    pls = []
    for j in range(6):
        picked = rng.sample(names, rng.randint(4, 10))
        rs = (M.ReplicaSchedulingStrategy(
            replica_scheduling_type=M.REPLICA_SCHEDULING_DUPLICATED)
              if j % 2 else M.ReplicaSchedulingStrategy(
                  replica_scheduling_type=M.REPLICA_SCHEDULING_DIVIDED,
                  replica_division_preference=M.REPLICA_DIVISION_WEIGHTED))
        pls.append(M.Placement(
            cluster_affinity=M.ClusterAffinity(cluster_names=picked),
            replica_scheduling=rs))
    items = S.build_bindings(M, rng, n_bindings, pls)
    return rng, clusters, names, S.as_bindings(M, items)


def _targets(r):
    if isinstance(r, Exception):
        return type(r).__name__
    return sorted((t.name, t.replicas) for t in r)


class Trace:
    """One package's run: a snapshot after every step."""

    def __init__(self, K, solver):
        self.K, self.solver, self.steps = K, solver, []

    def snap(self, rep=None, wrote=None):
        s = self.solver
        led = s.ledger
        self.steps.append({
            "report": None if rep is None else (
                rep.mode, rep.reason, rep.total, rep.dirty, rep.chunk_groups,
                list(rep.groups), rep.host_rows, rep.audited,
                rep.audit_outcome),
            "wrote": wrote,
            "results": {p: _targets(r) for p, r in s.results.items()},
            "ledger": ({k: v.tolist() for k, v in led.milli.items()},
                       None if led.pods is None else led.pods.tolist(),
                       {str(k): v.tolist() for k, v in led.sets.items()}),
        })
        return rep

    def adopt(self, clusters, bindings):
        return self.snap(self.solver.adopt(clusters, bindings))

    def cycle(self, clusters, bindings, deltas=None, force_audit=True):
        return self.snap(self.solver.cycle(
            clusters, bindings, deltas if deltas is not None
            else self.K.CD(), force_audit=force_audit))

    def write_back(self):
        n = self.solver.write_back()
        self.snap(wrote=n)
        return n

    def settle(self, clusters, bindings):
        rep = self.adopt(clusters, bindings)
        assert rep.mode == "full" and rep.reason == "adopt"
        assert self.write_back() > 0
        rep = self.cycle(clusters, bindings)
        assert rep.mode == "incremental" and rep.audit_outcome == "ok"
        assert self.write_back() == 0  # identical answers: no rv bumps


def _solver(K, fused=False, shortlist=None, chunk=64):
    cfg = (K.SL.ShortlistConfig(**shortlist) if shortlist is not None
           else None)
    return K.IS(K.RS(audit_interval=0, fused=fused, **K.kw), K.E(),
                chunk=chunk, audit_every=0, shortlist=cfg)


def _case_churn(K, frac):
    rng, clusters, _names, bindings = _world(K, 48, 256, 17, pods=64)
    t = Trace(K, _solver(K))
    t.settle(clusters, bindings)
    n_rows = max(1, int(len(bindings) * frac))
    for cyc in range(3):
        deltas = S.churn(K.CD, rng, clusters, bindings, n_rows,
                         n_caps=(1 if cyc % 2 else 0))
        rep = t.cycle(clusters, bindings, deltas)
        assert rep.mode == "incremental" and rep.audit_outcome == "ok"
        assert rep.dirty >= n_rows and sum(rep.groups) == rep.dirty
        if frac < 0.01:
            assert rep.dirty < len(bindings) // 2  # dirty-only
        t.write_back()
    return t


def _case_quiet(K):
    _rng, clusters, _names, bindings = _static_world(K, 23)
    t = Trace(K, _solver(K))
    t.settle(clusters, bindings)
    d0 = PDM.COUNTS["rows"]
    rep = t.cycle(clusters, bindings)
    assert rep.dirty == 0 and rep.groups == []
    assert rep.audit_outcome == "ok"
    if K is PORT:
        assert PDM.COUNTS["rows"] == d0
        assert PDM.COUNTS["dirty_fraction"] == 0.0
    return t


def _case_fixed_point(K):
    _rng, clusters, _names, bindings = _world(K, 32, 128, 23)
    t = Trace(K, _solver(K))
    t.settle(clusters, bindings)
    reps = [t.cycle(clusters, bindings) for _ in range(3)]
    assert all(r.audit_outcome == "ok" for r in reps)
    assert len({r.dirty for r in reps}) == 1  # the fixed point
    assert reps[0].dirty < len(bindings) // 4
    return t


def _case_append(K):
    rng, clusters, names, bindings = _world(K, 48, 192, 29)
    t = Trace(K, _solver(K))
    t.settle(clusters, bindings)
    grown = bindings + S.as_bindings(K.M, S.build_bindings(
        K.M, rng, 24, S.affinity_placements(K.M, rng, names, n=2, lo=3,
                                            hi=8)), tag="grown-")
    rep = t.cycle(clusters, grown)
    assert rep.mode == "incremental"  # an append is not a full solve
    assert rep.audit_outcome == "ok" and 24 <= rep.dirty < len(grown) // 2
    t.write_back()
    assert t.cycle(clusters, grown).audit_outcome == "ok"
    return t


def _case_removal(K):
    _rng, clusters, _names, bindings = _world(K, 48, 192, 31)
    t = Trace(K, _solver(K))
    t.settle(clusters, bindings)
    shrunk = clusters[:-4]  # membership change: structural rebuild
    rep = t.cycle(shrunk, bindings, force_audit=None)
    assert rep.mode == "full" and rep.reason == "plane-rebuild"
    t.write_back()
    rep = t.cycle(shrunk, bindings)
    assert rep.mode == "incremental" and rep.audit_outcome == "ok"
    r1, r2 = t.cycle(shrunk, bindings), t.cycle(shrunk, bindings)
    assert r1.audit_outcome == r2.audit_outcome == "ok"
    assert r1.dirty == r2.dirty < len(bindings)
    return t


def _case_mismatch(K):
    _rng, clusters, _names, bindings = _world(K, 32, 128, 37)
    t = Trace(K, _solver(K))
    t.settle(clusters, bindings)
    s = t.solver
    pos = next(p for p, r in sorted(s.results.items())
               if not isinstance(r, Exception))
    good = _targets(s.results[pos])
    s.results[pos] = []  # a diverged state
    assert t.cycle(clusters, bindings).audit_outcome == "mismatch"
    assert _targets(s.results[pos]) == good  # the control's answer adopted
    assert t.cycle(clusters, bindings).audit_outcome == "ok"
    return t


def _case_retire(K):
    _rng, clusters, _names, bindings = _static_world(K, 43)
    t = Trace(K, _solver(K))
    t.settle(clusters, bindings)
    assert not t.solver.ledger.empty()
    for c in clusters:  # every cluster reports: the whole ledger retires
        q = c.status.resource_summary.allocatable["pods"]
        c.status.resource_summary.allocatable["pods"] = (
            type(q).from_units(int(q.value())))
        c.metadata.resource_version += 1
    assert t.cycle(clusters, bindings).audit_outcome == "ok"
    assert all(not arr.any() for arr in t.solver.ledger.milli.values())
    return t


def _case_fused_shortlist(K):
    rng, clusters, _names, bindings = _world(K, 64, 128, 47)
    t = Trace(K, _solver(K, fused=True, shortlist={
        "k": 16, "min_cells": 0, "union_frac": 1.0}))
    assert t.adopt(clusters, bindings).mode == "full"
    assert t.solver.state.fused_cycles > 0
    t.write_back()
    t.cycle(clusters, bindings, force_audit=None)
    for _ in range(2):
        deltas = S.churn(K.CD, rng, clusters, bindings, 4, n_caps=1)
        assert t.cycle(clusters, bindings, deltas).audit_outcome == "ok"
        t.write_back()
    if K is PORT:
        assert PSL.COUNTS["dispatches"] > 0
        assert not any(PSL.FALLBACKS.values()), PSL.FALLBACKS
    return t


CASES = {
    "churn_0.0001": lambda K: _case_churn(K, 0.0001),
    "churn_0.001": lambda K: _case_churn(K, 0.001),
    "churn_0.05": lambda K: _case_churn(K, 0.05),
    "quiet": _case_quiet,
    "fixed_point": _case_fixed_point,
    "roster_append": _case_append,
    "cluster_removal": _case_removal,
    "audit_mismatch": _case_mismatch,
    "ledger_retire": _case_retire,
    "fused_shortlist": _case_fused_shortlist,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_incremental_solver_matches_jax(case):
    """Step by step, the port's reports, results and ledger equal the JAX
    package's (each case's own properties asserted on both runs)."""
    jt = CASES[case](JAX)
    pt = CASES[case](PORT)
    assert len(jt.steps) == len(pt.steps)
    for i, (a, b) in enumerate(zip(jt.steps, pt.steps)):
        assert a == b, (case, i)


def test_carry_state_seed_changes_pricing():
    """run_pipeline(carry_state=...) flows into the solve on both
    packages alike: a previous run's consumption scaled 40x moves
    placements on a tight fleet, the seed object is never mutated, and the
    collected ledgers are equal."""
    outs = {}
    for name, M, est, T, P, kw in (
            ("jax", MJ, JaxEstimator(), JT, JP, {"carry_spread": False}),
            ("port", MP, GeneralEstimator(), PT, PP,
             {"device": "cpu", "carry_spread": False})):
        rng = random.Random(41)
        clusters = S.build_fleet(M, rng, 24)
        for c in clusters:
            c.status.resource_summary.allocatable["pods"] = (
                M.Quantity.from_units(24))
        cindex = T.ClusterIndex.build(clusters)
        pls = S.affinity_placements(M, rng, [c.name for c in clusters],
                                    n=4, lo=4, hi=8)
        items = S.build_bindings(M, rng, 96, pls)
        base = P.run_pipeline(items, cindex, est, chunk=32, waves=1,
                              carry=True, collect_carry=True, **kw)
        assert base.carry is not None and not base.carry.empty()
        seed = base.carry.copy()
        for arr in seed.milli.values():
            arr *= 40
        if seed.pods is not None:
            seed.pods *= 40
        before = {k: v.copy() for k, v in seed.milli.items()}
        seeded = P.run_pipeline(items, cindex, est, chunk=32, waves=1,
                                carry=True, carry_state=seed,
                                collect_carry=True, **kw)
        for k, v in before.items():
            assert np.array_equal(seed.milli[k], v), "seed object mutated"
        moved = sum(1 for i, want in base.results.items()
                    if _targets(want) != _targets(seeded.results[i]))
        assert moved > 0, "a 40x consumption seed moved no placement"
        outs[name] = ({i: _targets(r) for i, r in seeded.results.items()},
                      {k: v.tolist() for k, v in seeded.carry.milli.items()},
                      seeded.carry.pods.tolist())
    assert outs["jax"] == outs["port"]
    with pytest.raises(ValueError, match="carry=True"):
        PP.run_pipeline(items, cindex, GeneralEstimator(), chunk=32,
                        carry=False, carry_state=PT.CarryState(),
                        device="cpu")


def test_retire_lanes_matches_jax():
    """CarryState.retire_lanes zeroes exactly the listed lanes of every
    store, ignores lanes beyond an accumulator, as the JAX package's."""
    rng = np.random.default_rng(1)
    stores = []
    for T in (JT, PT):
        st = T.CarryState()
        st.milli = {"cpu": rng.integers(0, 9, 16), "mem": np.arange(16)}
        st.pods = np.arange(16, dtype=np.int64) + 1
        st.sets = {("k",): np.ones(8, np.int64)}
        st.retire_lanes(np.array([0, 3, 9, 40]))
        stores.append(st)
        rng = np.random.default_rng(1)
    a, b = stores
    assert {k: v.tolist() for k, v in a.milli.items()} == {
        k: v.tolist() for k, v in b.milli.items()}
    assert a.pods.tolist() == b.pods.tolist() and b.pods[3] == 0
    assert b.sets[("k",)].tolist() == [0, 1, 1, 0, 1, 1, 1, 1]


def test_identity_caches_hit_on_quiet_cycles():
    """Quiet cycles hand every chunk the same frozen masters: tier 1's
    memo hits (no K8 dispatch) and the grouping's pl_mask / placement_id
    views stay the same objects.  A capacity change misses, as it must.
    (The solver's transfer cache is held in test_torch_resident.py: a
    shortlisted chunk dispatches its own sub-vocabulary planes.)"""
    rng, clusters, _names, bindings = _world(PORT, 64, 128, 47)
    solver = _solver(PORT, fused=True, shortlist={
        "k": 16, "min_cells": 0, "union_frac": 1.0})
    solver.adopt(clusters, bindings)
    solver.write_back()
    solver.cycle(clusters, bindings, CycleDeltas())
    solver.write_back()
    deltas = S.churn(CycleDeltas, rng, clusters, bindings, 6)
    solver.cycle(clusters, bindings, deltas)  # warms the caches
    solver.write_back()
    plm, pid = solver._plm(), solver._pid()
    t1 = PSL.COUNTS["dispatches"]
    rep =solver.cycle(clusters, bindings, CycleDeltas(), force_audit=True)
    assert rep.audit_outcome == "ok" and rep.dirty > 0
    assert PSL.COUNTS["dispatches"] == t1  # tier 1 served from the memo
    assert solver._plm() is plm and solver._pid() is pid
    S.churn(CycleDeltas, rng, clusters, bindings, 0, n_caps=2)
    rep = solver.cycle(clusters, bindings, CycleDeltas(), force_audit=True)
    assert rep.audit_outcome == "ok"
    assert PSL.COUNTS["dispatches"] > t1  # new capacity: tier 1 reruns


def test_report_shape_and_waves_guard():
    state = ResidentState(audit_interval=0, device="cpu")
    with pytest.raises(AssertionError):
        IncrementalSolver(state, GeneralEstimator(), waves=2)
    rep = CycleReport()
    assert rep.mode == "incremental" and rep.groups == []
