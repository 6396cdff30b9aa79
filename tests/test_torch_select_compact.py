"""K3 compact and K2's std-tier gather select: the port's plain versions
(compact_plain, schedule_rows_plain on the CPU) against the JAX package on
inputs made from a seed.  Integer math: tolerance 0 on every output.

K3 against JAX _compact_of (max_nnz = B*C), both keep_sel values: nothing
wanted, every lane wanted, C = 5,000 with B*C a multiple of no tile, one
row, wholly non-workload rows, a random mix.  K2 against JAX solve (dense
rep / sel / status over four charged waves) on the std tier's gather path:
C just above DIRECT_MAX (529) and C not a power of two, four and five
gather groups, groups with fewer eligible lanes than k (the -1 fill),
boundary buckets that overflow the select's shared-memory room (equal
static weights, a weight past the 2^34 clamp, identical clusters), and
prev lanes, eviction lanes and uid_desc rows.  tests/test_torch_gpu.py
holds the kernels against these plain versions on the same cases."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import solver as JS
from karmada_tpu.ops import tensors as JT
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import tensors as PT

MJ = S.models_of("karmada_tpu")


@pytest.mark.parametrize("keep_sel", [False, True])
@pytest.mark.parametrize("name", list(S.COMPACT_CASES))
def test_compact_plain_matches_jax(name, keep_sel):
    rep, sel, status, nw = S.compact_case(name)
    B, C = rep.shape
    want = JS._compact_of(jnp.asarray(rep), jnp.asarray(sel),
                          jnp.asarray(status), jnp.asarray(nw), B * C,
                          keep_sel)
    t = torch.from_numpy
    got = PS.compact_plain(t(rep), t(sel), t(status), t(nw), keep_sel)
    nnz = int(want[3])
    assert int(got[3]) == nnz and got[3].dtype == torch.int64
    assert np.array_equal(got[0].numpy(), np.asarray(want[0])[:nnz])
    assert np.array_equal(got[1].numpy(), np.asarray(want[1])[:nnz])
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[0].dtype == got[1].dtype == torch.int32
    # the wrapper takes the plain version for CPU tensors
    via = PS.compact(t(rep), t(sel), t(status), t(nw), keep_sel)
    assert all(torch.equal(a, b) for a, b in zip(via, got))
    if name == "empty":
        assert nnz == 0
    if name == "full":
        assert nnz == B * C
    if name == "non_workload":
        # a non-workload row's selection is extracted, zeros and all
        assert (np.asarray(want[1])[:nnz] == 0).any()


def _pair(name):
    clusters, items, lanes, extra_seed = S.select_case(MJ, name)
    jb = JT.encode_batch(items, JT.ClusterIndex.build(clusters),
                         JaxEstimator())
    jb = S.shape_select_batch(jb, lanes, extra_seed)
    fields = {f: getattr(jb, f) for f in PT.FIELD_DTYPES
              if getattr(jb, f, None) is not None}
    return jb, PT.batch_from_arrays(fields, jb)


@pytest.mark.parametrize("name", S.SELECT_CASES)
def test_schedule_rows_plain_gather_matches_jax(name):
    jb, pb = _pair(name)
    assert pb.C > PS.TIERS["std"][2]  # the gather path
    want = JS.solve(jb, waves=4)
    got = PS.solve(pb, waves=4, device="cpu")
    for field, a, b in zip(("rep", "sel", "status"), want, got):
        assert a.shape == b.shape and np.array_equal(a, b), field
    rows = pb.b_valid
    n = pb.n_bindings
    if name == "c529":
        assert pb.C == 529
    if name in ("c700", "prev_evict_uid"):
        assert pb.C & (pb.C - 1)  # no power of two
        assert (pb.prev_idx[rows] >= 0).any()
    if name == "extra":
        assert PS._use_extra(pb)
    else:
        assert not PS._use_extra(pb)
    if name == "short_groups":
        # every placement's affinity leaves fewer eligible lanes than k
        assert (pb.pl_mask.sum(1) < PS.TIERS["std"][1]).all()
    if name == "overflow":
        w = pb.pl_static_w[pb.pl_strategy == 1]
        assert (w >= 1 << 34).any() and (w == 5).sum() > 256
    if name == "prev_evict_uid":
        assert (pb.evict_idx[:n] >= 0).any()
        assert set(pb.uid_desc[:n].tolist()) == {False, True}
    assert (got[0][rows] > 0).any()
