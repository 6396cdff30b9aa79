"""The host side of K12's and K13's calls (karmada_tpu_torch ops/dirty.py,
ops/rebalance_detect.py), on the CPU:

  * normalise_rv, the rv list dirty_codes hands the kernel on a card
    (an ascending copy; pads, duplicates and slots >= cap stay and never
    hit): its edges, and the plain pass over it equal to the plain pass
    over the -1 padded list (slot 0 real against slot 0 padded,
    duplicates, slots >= cap);
  * dirty_codes reads the cluster-side fields from the plane's device
    mirrors, synced first: with a `deleting` flip and an api_ok column
    change between cycles it equals the plain pass over the host masters
    (what it read before), which the stale mirrors would not;
  * score's staged layout and the ownership of its results: views of one
    copy of the pinned buffer, untouched when the buffer is refilled.

(The call blocks' layouts against the C structs are in
tests/test_torch_rows_args.py; the kernels themselves on the card in
tests/test_torch_gpu.py.)
"""

import copy
import random

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.ops import dirty as PDM
from karmada_tpu_torch.ops import rebalance_detect as PRD
from karmada_tpu_torch.resident import ResidentState
from karmada_tpu_torch.resident.deltas import CycleDeltas
from karmada_tpu_torch.scheduler.incremental import IncrementalSolver

MP = S.models_of("karmada_tpu_torch")


# -- normalise_rv ---------------------------------------------------------------

@pytest.mark.parametrize("rv,want", [
    ([], []),
    ([-1, -1, -1], [-1, -1, -1]),                # all padded
    ([0, -1, -1, -1], [-1, -1, -1, 0]),          # slot 0 real, then pads
    ([5, 3, 5, -1, 3, 0], [-1, 0, 3, 3, 5, 5]),  # duplicates, any order
    ([7, 8, 1 << 40, -7], [-7, 7, 8, 1 << 40]),  # slots >= cap, negatives
    (np.arange(8)[::-1], list(range(8))),
])
def test_normalise_rv_edges(rv, want):
    src = np.asarray(rv, np.int64)
    got = PDM.normalise_rv(src)
    assert got.dtype == np.int64 and got.ndim == 1
    assert got.tolist() == want and not np.shares_memory(got, src)


def _store(rng, cap, C, P):
    slot = S.slot_store(rng, cap, 4, 3, C, P)
    slot["prev_val"] = np.where(slot["prev_idx"] >= 0, slot["prev_val"], 0)
    plane = {
        "cluster_valid": rng.random(C) < 0.9,
        "deleting": rng.random(C) < 0.1,
        "pl_mask": rng.random((P, C)) < 0.4,
        "pl_strategy": rng.integers(0, 5, P).astype(np.int32),
        "pl_has_cluster_sc": rng.random(P) < 0.2,
        "pl_has_region_sc": rng.random(P) < 0.1,
    }
    return ([torch.from_numpy(slot[f]) for f in PDM.SLOT_FIELDS]
            + [torch.from_numpy(plane[f]) for f in PDM.PLANE_FIELDS])


@pytest.mark.parametrize("seed,rv", [
    (0, [-1] * 8),                               # every slot padded
    (1, [0] + [-1] * 7),                         # slot 0 real
    (2, [3, 3, 200, 0, 0, -1, 1 << 33, 511]),    # duplicates, >= cap
    (3, list(range(0, 512, 7)) + [-1] * 55),
])
def test_plain_pass_equal_on_normalised_rv(seed, rv):
    rng = np.random.default_rng(seed)
    cap = 512
    ops = _store(rng, cap, 40, 12)
    flips = torch.from_numpy(PDM._pad_lanes(rng.choice(40, 3, replace=False)))
    padded = np.asarray(rv, np.int64)
    want = PDM.dirty_kernel_plain(*ops, flips, torch.from_numpy(padded))
    got = PDM.dirty_kernel_plain(*ops, flips, torch.from_numpy(
        PDM.normalise_rv(padded)))
    assert torch.equal(got, want)
    # slot 0 is an rv hit only when it is a real entry
    assert bool(int(want[0]) & PDM.DIRTY) or 0 not in rv
    hit = torch.from_numpy(padded[(padded >= 0) & (padded < cap)])
    assert (want[hit] == 7).all()


# -- dirty_codes reads the synced mirrors --------------------------------------

def test_dirty_codes_reads_the_synced_mirrors():
    """A `deleting` flip (lane a) and an api_ok column change (lane b)
    land between cycles: after begin_cycle the cluster-side mirrors are
    stale, dirty_codes syncs them first and equals the plain pass over
    the host masters, and the stale mirrors would give other codes."""
    rng = random.Random(11)
    clusters, pls = S.build_megafleet(MP, rng, 48, 4)  # DynamicWeight
    bindings = S.as_bindings(MP, S.build_mega_bindings(MP, rng, 256, pls,
                                                       block=64))
    state = ResidentState(audit_interval=0, fused=True, device="cpu")
    solver = IncrementalSolver(state, GeneralEstimator(), chunk=64,
                               audit_every=0)
    solver.adopt(clusters, bindings)
    solver.write_back()
    solver.cycle(clusters, bindings, CycleDeltas())
    solver.write_back()

    p = state.plane
    held = np.bincount(p.prev_idx[p.prev_idx >= 0], minlength=state.C)
    a = int(np.argmax(held[:state.nC]))
    b = (a + 1) % state.nC
    clusters = list(clusters)
    ca = copy.deepcopy(clusters[a])
    ca.metadata.deletion_timestamp = 1.0
    ca.metadata.resource_version += 1
    cb = copy.deepcopy(clusters[b])
    cb.status.api_enablements = []
    cb.metadata.resource_version += 1
    clusters[a], clusters[b] = ca, cb
    state.begin_cycle(clusters, CycleDeltas())
    assert state.last_flip_lanes.tolist() == sorted([a, b])

    p = state.plane
    stale = {f: state.device_mirrors.mirrors[f].clone()
             for f in PDM.PLANE_FIELDS[:-1]}
    assert not torch.equal(stale["deleting"],
                           torch.from_numpy(np.array(p.deleting)))
    rv = np.asarray(solver._slots[:6], np.int64)
    host = [torch.from_numpy(np.array(getattr(p, f)))
            for f in PDM.SLOT_FIELDS + PDM.PLANE_FIELDS]
    tail = [torch.from_numpy(PDM._pad_lanes(state.last_flip_lanes)),
            torch.from_numpy(PDM._pad_lanes(rv))]
    want = PDM.dirty_kernel_plain(*host, *tail).numpy()
    got = PDM.dirty_codes(state, rv)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    for f in PDM.PLANE_FIELDS[:-1]:
        assert torch.equal(state.device_mirrors.mirrors[f],
                           torch.from_numpy(np.array(getattr(p, f)))), f
    old = PDM.dirty_kernel_plain(
        *host[:8], *(stale[f] for f in PDM.PLANE_FIELDS[:-1]), host[-1],
        *tail).numpy()
    assert not np.array_equal(old, want)
    # the codes are the caller's: a second pass leaves them as they were
    keep = got.copy()
    PDM.dirty_codes(state, np.zeros(0, np.int64))
    assert np.array_equal(got, keep)


# -- score's staged layout and results ------------------------------------------

@pytest.mark.parametrize("C", [1, 7, 5000, 16384])
def test_score_layout(C):
    o_out, n = PRD.score_layout(C)
    assert o_out >= 17 * C and o_out % 16 == 0 and o_out - 17 * C < 16
    assert n == o_out + 24 * C


def test_score_results_own_their_memory():
    C = 5
    o_out, n = PRD.score_layout(C)
    buf = np.zeros(n, np.uint8)
    buf[o_out:].view(np.int64)[:] = np.arange(3 * C)
    need, over, div = PRD._results(buf, o_out, C)
    assert [x.tolist() for x in (need, over, div)] == [
        list(range(C)), list(range(C, 2 * C)), list(range(2 * C, 3 * C))]
    buf[:] = 0xFF  # the next call refills the pinned buffer
    assert need.tolist() == list(range(C))
    assert div.tolist() == list(range(2 * C, 3 * C))
    assert all(x.dtype == np.int64 for x in (need, over, div))
    assert need.base is over.base is div.base
    assert not np.shares_memory(need, buf)
