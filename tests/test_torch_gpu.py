"""Kernels K1-K4 on the card against their plain versions, bit-exact.

Marked `gpu`: these need a CUDA card and nvcc, decide inside the test
whether a card is present, and skip without one.  On a machine with a
card run them with

    python -m pytest tests/test_torch_gpu.py -q -m gpu

(chip_smoke.py holds the same kernels against the same plain versions at
the full 4096 x 8192 chunk size).  Here the randomized scenario mix runs
through solve_compact on the card and on the CPU: both lane paths, taints,
deleting clusters, histogram overrides, evictions, spread constraints
(selection swap loop), plugin scores, empty-workload propagation and a
wide prev axis.
"""

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import tensors as PT

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


def _same(batch, waves, keep_sel=False):
    dev = _card()
    kernels.reset_counts()
    got = PS.solve_compact(batch, waves=waves, with_used=True,
                           keep_sel=keep_sel, device=dev)
    torch.cuda.synchronize()
    want = PS.solve_compact(batch, waves=waves, with_used=True,
                            keep_sel=keep_sel, device="cpu")
    assert got[3] == want[3]
    for a, b in zip(got[:3], want[:3]):
        assert np.array_equal(a, b)
    for a, b in zip(got[4], want[4]):
        assert np.array_equal(a, b)
    assert all(v > 0 for v in kernels.LAUNCHES.values()), kernels.LAUNCHES


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
