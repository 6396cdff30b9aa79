"""The fused mirror-sync scatter (karmada_tpu_torch ops/resident_update
scatter_fields, K10's plain version over the staged buffer and descriptor
table the kernel reads) against the JAX package's scatter_rows /
scatter_cols applied field by field, tolerance 0:

  * one call mixing bool / int32 / int64 destinations and row / column
    entries, each with its own lane list (L = 1, L not a power of two),
    entries sharing one lane list (staged once), duplicate lanes that
    carry equal values, and more entries than one table holds (the split);
  * the staging itself: 16-byte aligned segments, the descriptor columns,
    the dtype views, and the refusals (a lane outside the lane axis,
    values of another dtype or shape, an unknown mode);
  * an empty item list stages and launches nothing and changes nothing;
  * a fused resident plane under the incremental solver over adopt plus
    churn windows: after every cycle each mirror equals a fresh place_slot
    of its master, and every mirror sync that scatters stages one buffer
    and applies one table (one H2D copy and one K10 launch on the card).
"""

import numpy as np
import pytest
import torch

import torch_scenarios as S
from karmada_tpu.ops import resident_gather as _JRG  # noqa: F401 (x64 on)
from karmada_tpu.ops import resident_update as JRU
from karmada_tpu_torch.ops import resident_gather as PRG
from karmada_tpu_torch.ops import resident_update as PRU
from karmada_tpu_torch.resident import state as PST

MP = S.models_of("karmada_tpu_torch")

def _jax(items):
    out = []
    for dst, lanes, vals, mode in items:
        fn = JRU.scatter_rows if mode == "rows" else JRU.scatter_cols
        out.append(np.asarray(fn(dst.copy(), lanes, vals)))
    return out


def _delta(before):
    return {k: PRG.COUNTS[k] - before[k] for k in before}


@pytest.mark.parametrize("name", S.SCATTER_CASES)
def test_scatter_fields_plain_matches_jax(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    items = S.scatter_case(name, rng)
    want = _jax(items)
    dsts = [torch.from_numpy(d.copy()) for d, _l, _v, _m in items]
    c0 = dict(PRG.COUNTS)
    PRU.scatter_fields([(t, lanes, vals, mode) for t, (_d, lanes, vals, mode)
                        in zip(dsts, items)], "cpu")
    for t, w, (d, *_rest) in zip(dsts, want, items):
        assert t.dtype == torch.from_numpy(d).dtype
        assert np.array_equal(t.numpy(), w)
    n = len(items)
    tables = -(-n // PRU.SCATTER_FIELDS)
    assert _delta(c0) == {
        "dispatches": 0, "rows": 0, "row_scatters": 0, "scatter_fields": n,
        "scatter_staged": 1, "scatter_tables": tables,
        "scatter_splits": int(tables > 1)}
    # each launch's table counts its elements from 0
    st = PRU.stage_fields([(torch.from_numpy(d), lanes, vals, mode)
                           for d, lanes, vals, mode in items])
    start = PRU.DESC_COLUMNS.index("start")
    assert [st.desc[k][start] for k in range(0, n, PRU.SCATTER_FIELDS)] == [
        0] * tables


def test_staging_layout_and_dtype_views():
    """Every segment starts on a 16-byte boundary, a shared lane list is
    staged once, the descriptor columns say where each entry's bytes are,
    and the bytes read back through the descriptor are the entry's."""
    rng = np.random.default_rng(11)
    lanes = np.array([5, 1, 17], np.int64)
    items = [S.scatter_entry(rng, np.bool_, "rows", 20, 0, 0, lanes),
             S.scatter_entry(rng, np.int64, "rows", 20, 0, 3, lanes),
             S.scatter_entry(rng, np.int32, "cols", 30, 4, 5)]
    tens = [(torch.from_numpy(d), la, v, m) for d, la, v, m in items]
    st = PRU.stage_fields(tens)
    assert len(st.desc) == 3 and all(len(r) == len(PRU.DESC_COLUMNS)
                                      for r in st.desc)
    col = {c: i for i, c in enumerate(PRU.DESC_COLUMNS)}
    starts = 0
    for (t, la, v, mode), row in zip(tens, st.desc):
        assert row[col["dst"]] == t.data_ptr()
        assert row[col["lanes"]] % 16 == 0 and row[col["vals"]] % 16 == 0
        assert row[col["L"]] == len(la) and row[col["elem"]] == v.itemsize
        assert row[col["start"]] == starts
        starts += row[col["outer"]] * row[col["L"]] * row[col["inner"]]
        lo = row[col["lanes"]]
        assert np.array_equal(st.buf[lo:lo + 8 * len(la)].view(np.int64), la)
        vo = row[col["vals"]]
        assert np.array_equal(
            st.buf[vo:vo + v.nbytes].view(v.dtype).reshape(v.shape), v)
    # entries 0 and 1 share one lane segment
    assert st.desc[0][col["lanes"]] == st.desc[1][col["lanes"]]
    assert (st.desc[1][col["outer"]], st.desc[1][col["D"]],
            st.desc[1][col["inner"]]) == (1, 20, 3)
    assert (st.desc[2][col["outer"]], st.desc[2][col["D"]],
            st.desc[2][col["inner"]]) == (5, 30, 1)
    assert st.buf.nbytes % 16 == 0


@pytest.mark.parametrize("bad", ["lane_high", "lane_negative", "dtype",
                                 "shape", "mode", "lanes_int32"])
def test_stage_fields_refuses(bad):
    dst = torch.zeros((8, 2), dtype=torch.int32)
    lanes = np.array([1, 3], np.int64)
    vals = np.ones((2, 2), np.int32)
    mode = "rows"
    if bad == "lane_high":
        lanes = np.array([1, 8], np.int64)
    elif bad == "lane_negative":
        lanes = np.array([-1, 3], np.int64)
    elif bad == "dtype":
        vals = vals.astype(np.int64)
    elif bad == "shape":
        vals = np.ones((2, 3), np.int32)
    elif bad == "mode":
        mode = "diag"
    else:
        lanes = lanes.astype(np.int32)
    with pytest.raises((IndexError, TypeError, ValueError)):
        PRU.scatter_fields([(dst, lanes, vals, mode)], "cpu")
    assert not dst.any()


def test_empty_items_change_nothing():
    c0 = dict(PRG.COUNTS)
    PRU.scatter_fields([], "cpu")
    dst = torch.arange(6)
    PRU.scatter_fields([(dst, np.zeros(0, np.int64), np.zeros(0, np.int64),
                         "rows")], "cpu")
    assert torch.equal(dst, torch.arange(6))
    assert _delta(c0) == {k: 0 for k in c0}


def test_fused_plane_syncs_equal_fresh_placement():
    """A fused resident plane under the incremental solver, adopt then
    churn windows (bindings and cluster capacity): after every cycle each
    slot-store and cluster-side mirror equals place_slot of its master
    (tests/torch_scenarios.fused_plane_syncs), and every sync that
    scatters makes one staged upload and applies one table."""
    per_sync = S.fused_plane_syncs(MP, "cpu")
    scattered = [(name, d) for name, d, _k in per_sync if d["scatter_fields"]]
    assert {name for name, _d in scattered} == {"_DeviceRows",
                                                "_DevicePlane"}
    for name, d, launched in per_sync:
        assert d["scatter_staged"] == d["scatter_tables"] == int(
            d["scatter_fields"] > 0), (name, d)
        assert launched == 0  # the CPU runs the plain version
    # the slot store's syncs scatter all twelve fields in their one table
    assert any(name == "_DeviceRows"
               and d["scatter_fields"] == len(PST.DEVICE_SLOT_FIELDS)
               for name, d in scattered)
