"""The port's C decode (native/decode_fast.c decode_coo, and encode_fast.c
decode_fast after a Python row split; decode_compact's default) is
bit-exact against its Python builder (decode_compact(native=False)) and
the JAX package's decode on the same COO: fuzzed COO over every route's
rows with full-fleet wide rows and every status, a small fleet (compact
off), the explain outcome plane, the spread plane's int64 COO, and one
CPU solve.  The two re-routes to the Python split -- a COO that breaks the
ascending contract, a TargetCluster that tc_new_is_plain() refuses -- are
counted and keep the Python path's results and diagnostic."""

import random

import numpy as np
import pytest

import torch_scenarios as S
from karmada_tpu import native as JN
from karmada_tpu.estimator.general import GeneralEstimator as JaxEstimator
from karmada_tpu.ops import tensors as JT
from karmada_tpu_torch import native as PN
from karmada_tpu_torch.estimator.general import GeneralEstimator
from karmada_tpu_torch.models.work import TargetCluster
from karmada_tpu_torch.obs.decisions import VERDICT_BIT_NAMES
from karmada_tpu_torch.ops import solver as PS
from karmada_tpu_torch.ops import tensors as PT

MJ = S.models_of("karmada_tpu")
MP = S.models_of("karmada_tpu_torch")


def _mixed(seed, n_clusters=220, n_bindings=512):
    """The same bench mix encoded by both packages: (port batch, port
    items, JAX batch, JAX items)."""
    cp, ip, _rng, _names = S.bench_scenario(MP, seed, n_clusters, n_bindings)
    cj, ij, _rng, _names = S.bench_scenario(MJ, seed, n_clusters, n_bindings)
    pb = PT.encode_batch(ip, PT.ClusterIndex.build(cp), GeneralEstimator(),
                         cache=PT.EncoderCache())
    jb = JT.encode_batch(ij, JT.ClusterIndex.build(cj), JaxEstimator(),
                         cache=JT.EncoderCache())
    return pb, ip, jb, ij


def _fuzz_coo(batch, seed, wide_every=11):
    """Adversarial COO: every route's rows get entries (decode does not
    route-filter), every wide_every-th row is full-fleet wide (decode_coo's
    qsort branch), statuses cycle through OK / FIT_ERROR / UNSCHEDULABLE /
    NO_CLUSTER / unknown; -1 fill at the end."""
    rng = random.Random(seed)
    nb, C, nC = batch.n_bindings, batch.C, batch.n_clusters
    idx_l, val_l = [], []
    status = np.zeros(batch.B, np.int32)
    for b in range(nb):
        status[b] = (0, 0, 0, PT.STATUS_FIT_ERROR, PT.STATUS_UNSCHEDULABLE,
                     PT.STATUS_NO_CLUSTER, 9)[b % 7]
        cs = (range(nC) if b % wide_every == 0
              else sorted(rng.sample(range(nC), rng.randint(0, 6))))
        for c in cs:
            idx_l.append(b * C + c)
            val_l.append(rng.choice((0, 0, 1, 2, 7)))
    pad = 32
    idx = np.full(len(idx_l) + pad, -1, np.int32)
    val = np.zeros(len(idx_l) + pad, np.int32)
    idx[:len(idx_l)] = idx_l
    val[:len(val_l)] = val_l
    return idx, val, status


def _jax_decode(jb, idx, val, status, monkeypatch, **kw):
    """The JAX package's decode on its Python builder."""
    with monkeypatch.context() as m:
        for attr in ("_dec_mod", "_enc_mod"):
            m.setattr(JN, attr, None)
        for attr in ("_dec_error", "_enc_error"):
            m.setattr(JN, attr, "disabled for parity test")
        return JT.decode_compact(jb, idx, val, status, **kw)


def _norm(r):
    if isinstance(r, Exception):
        return (type(r).__name__, str(r), getattr(r, "reason", None))
    return [(t.name, t.replicas) for t in r]


def _assert_bit_exact(a, b):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        assert _norm(x) == _norm(y), f"slot {i}: {x!r} vs {y!r}"
        if not isinstance(x, Exception):
            assert all(type(t) is TargetCluster for t in x), i


def _decode_all(pb, jb, idx, val, status, monkeypatch, items_p, items_j,
                **kw):
    """(port C, port Python, JAX) decodes of one COO, and the port C
    decode's counters."""
    PN.reset_counts()
    c_out = PT.decode_compact(pb, idx, val, status, items=items_p, **kw)
    counts = dict(PN.COUNTS)
    py_out = PT.decode_compact(pb, idx, val, status, items=items_p,
                               native=False, **kw)
    jax_out = _jax_decode(jb, idx, val, status, monkeypatch, items=items_j,
                          **kw)
    _assert_bit_exact(c_out, py_out)
    _assert_bit_exact(c_out, jax_out)
    return c_out, counts


@pytest.mark.parametrize("seed,n_clusters,n_bindings,wide_every,empty_prop", [
    (7, 220, 512, 11, False), (23, 220, 512, 11, True),
    (101, 220, 512, 11, False), (101, 220, 512, 11, True),
    # C <= COMPACT_LANES: compact off, wide Divided rows on the device too
    (3, 12, 96, 5, False),
])
def test_c_decode_equals_python_and_jax(seed, n_clusters, n_bindings,
                                        wide_every, empty_prop, monkeypatch):
    pb, ip, jb, ij = _mixed(seed, n_clusters, n_bindings)
    idx, val, status = _fuzz_coo(pb, seed, wide_every)
    out, counts = _decode_all(
        pb, jb, idx, val, status, monkeypatch, ip, ij,
        enable_empty_workload_propagation=empty_prop)
    built = sum(not isinstance(r, Exception) for r in out)
    assert counts["decode_coo"] == built > 0
    assert counts["decode_py"] == counts["decode_fast"] == 0
    assert counts["decode_reroute"] == 0


def test_c_decode_explain_outcome_plane(monkeypatch):
    """The outcome plane attaches `exc.reason` identically on every path."""
    pb, ip, jb, ij = _mixed(11, 64, 128)
    idx, val, status = _fuzz_coo(pb, 11)
    outcome = np.zeros(pb.B, np.int32)
    for b in range(pb.n_bindings):
        dom = b % (len(VERDICT_BIT_NAMES) + 1)  # 0 = no rejected clusters
        outcome[b] = int(status[b]) | (dom << 8)
    out, _counts = _decode_all(pb, jb, idx, val, status, monkeypatch, ip, ij,
                               outcome=outcome)
    assert any(getattr(x, "reason", None) for x in out
               if isinstance(x, Exception)), "fuzz produced no reasons"


@pytest.mark.parametrize("empty_prop", [False, True])
def test_int64_coo_split_then_c_builder(empty_prop, monkeypatch):
    """The spread plane hands an int64 COO: the row split runs in numpy,
    decode_fast builds the status-0 rows of at most 256 entries and the
    Python builder the wide ones."""
    pb, ip, jb, ij = _mixed(5, 300, 96)
    idx, val, status = _fuzz_coo(pb, 5)
    idx64 = idx[idx >= 0].astype(np.int64)
    val64 = val[:idx64.size].astype(np.int64)
    _out, counts = _decode_all(
        pb, jb, idx64, val64, status, monkeypatch, ip, ij,
        enable_empty_workload_propagation=empty_prop)
    assert counts["decode_coo"] == 0 and counts["decode_reroute"] == 0
    assert counts["decode_fast"] > 0 and counts["decode_py"] > 0


@pytest.mark.parametrize("native", [True, False])
def test_ascending_violation_keeps_the_python_assert(native):
    """Out-of-order COO: the C pass hands back to the Python split, whose
    assert owns the diagnostic -- the same failure either way."""
    pb, _ip, _jb, _ij = _mixed(9, 16, 16)
    C = pb.C
    idx = np.array([3 * C + 1, 1 * C + 0, -1], np.int32)  # rows 3 then 1
    val = np.array([1, 1, 0], np.int32)
    status = np.zeros(pb.B, np.int32)
    PN.reset_counts()
    with pytest.raises(AssertionError, match="row-major"):
        PT.decode_compact(pb, idx, val, status, native=native)
    assert PN.COUNTS["decode_reroute"] == int(native)


def test_tc_new_guard_reroutes_to_python(monkeypatch):
    """A TargetCluster whose construction stopped being __new__-equivalent
    takes the Python split, never decode_coo."""
    pb, ip, _jb, _ij = _mixed(13, 16, 32)
    idx, val, status = _fuzz_coo(pb, 13)
    want = PT.decode_compact(pb, idx, val, status, items=ip, native=False)
    calls = []
    real = PN.load_decode_fast()

    class Spy:
        def decode_coo(self, *a, **k):
            calls.append(1)
            return real.decode_coo(*a, **k)

    monkeypatch.setattr(PT, "tc_new_is_plain", lambda: False)
    monkeypatch.setattr(PN, "load_decode_fast", lambda: Spy())
    PN.reset_counts()
    got = PT.decode_compact(pb, idx, val, status, items=ip)
    assert not calls, "decode_coo ran despite the guard"
    assert PN.COUNTS["decode_reroute"] == 1
    assert PN.COUNTS["decode_fast"] + PN.COUNTS["decode_py"] == sum(
        not isinstance(r, Exception) for r in got)
    _assert_bit_exact(got, want)


def test_cpu_solve_then_decode(monkeypatch):
    """One solve on the CPU (the kernels' plain versions): K3's int32 COO
    read back by finalize_compact decodes through decode_coo, equal to the
    Python builder and to the JAX decode of the same COO."""
    pb, ip, jb, ij = _mixed(21, 10, 12)
    idx, val, status, _nnz = PS.solve_compact(pb, waves=2, device="cpu")[:4]
    assert idx.dtype == np.int32 and val.dtype == np.int32
    out, counts = _decode_all(pb, jb, idx, val, status, monkeypatch, ip, ij)
    assert counts["decode_coo"] == sum(
        not isinstance(r, Exception) for r in out) > 0


def test_extension_is_the_ports_own():
    mod = PN.load_decode_fast()
    assert mod.__name__ == "karmada_tpu_torch.native._decode_fast"
    assert "karmada_tpu_torch/native/_build/" in mod.__file__
