"""The argument blocks of the launch paths: kernels.RowsArgs (the ctypes
mirror of schedule_rows.cu's RowsArgs) against the array("q") block the
hot path fills (kernels.rows_block, solver.RowsWorkspace), byte for byte,
and against the C struct in the source, field by field; K7's ExplainArgs
(explain.cu, kernels.explain_block, solver.ExplainWorkspace) the same
way; and K11's call block (resident.cu GatherCall, kernels.GATHER_CALL,
resident_gather._Plan) against its C struct, field by field and width by
width; K12's DirtyCall (dirty.cu, kernels.DIRTY_CALL, ops/dirty.py) and
K13's ScoreCall (rebalance.cu, kernels.SCORE_CALL,
ops/rebalance_detect.py) the same way."""

import re

from karmada_tpu_torch.ops import kernels
from karmada_tpu_torch.ops import solver as PS


def _values():
    """A distinct int64 per field: pointer-like values, small ints, one
    negative and one beyond 2^32 (an int64 field cut to 32 bits would
    show)."""
    vals = {f: 0x7F00_0000_0000 + 0x40 * i
            for i, f in enumerate(kernels.ROWS_FIELDS)}
    vals.update(r0=3, r1=67, C=8192, Q=-1, R=(1 << 40) + 5, Kp=4, Ke=0,
                use_extra=1, charge=0, fill_est=1)
    return vals


def test_rows_block_matches_rows_args_byte_for_byte():
    vals = _values()
    struct = kernels.RowsArgs(**vals)
    blk = kernels.rows_block(vals)
    assert len(kernels.ROWS_FIELDS) == len(set(kernels.ROWS_FIELDS))
    assert blk.itemsize == 8 and len(blk) == len(kernels.ROWS_FIELDS)
    assert bytes(struct) == blk.tobytes()
    # the fields a launch slice patches sit where the struct has them
    for f, i in (("r0", PS._R0), ("r1", PS._R1), ("fill_est", PS._FILL)):
        assert getattr(kernels.RowsArgs, f).offset == 8 * i
        assert blk[i] == vals[f]


def _c_fields(text, struct="RowsArgs"):
    """(name, declaration) of every field of `struct <struct>` in a CUDA
    source, in order."""
    body = text.split(f"struct {struct} {{", 1)[1].split("};", 1)[0]
    body = re.sub(r"//[^\n]*", "", body)
    out = []
    for decl in body.split(";"):
        decl = " ".join(decl.split())
        if not decl:
            continue
        first, *more = [p.strip() for p in decl.split(",")]
        out.append((re.split(r"[\s*]+", first)[-1], decl))
        out += [(m, decl) for m in more]
    return out


def test_rows_args_lists_the_c_structs_fields_in_order():
    text = (kernels.CSRC / "schedule_rows.cu").read_text()
    fields = _c_fields(text)
    assert [f for f, _d in fields] == list(kernels.ROWS_FIELDS)
    # each field is 8 bytes in C too: a pointer or an int64
    for f, decl in fields:
        assert "*" in decl or decl.startswith("i64 "), (f, decl)
    assert [f for f, t in kernels.RowsArgs._fields_
            if t is kernels._I] == list(kernels.ROWS_INT_FIELDS)


def test_explain_block_matches_explain_args_byte_for_byte():
    vals = {f: 0x7F00_0000_0000 + 0x40 * i
            for i, f in enumerate(kernels.EXPLAIN_FIELDS)}
    vals.update(r0=5, r1=(1 << 40) + 3, C=8192, Q=-1, Kp=4, Ke=0,
                use_extra=1)
    struct = kernels.ExplainArgs(**vals)
    blk = kernels.explain_block(vals)
    assert len(kernels.EXPLAIN_FIELDS) == len(set(kernels.EXPLAIN_FIELDS))
    assert blk.itemsize == 8 and len(blk) == len(kernels.EXPLAIN_FIELDS)
    assert bytes(struct) == blk.tobytes()
    # the fields a launch patches sit where the struct has them
    for f, i in (("r0", PS._XR0), ("r1", PS._XR1)):
        assert getattr(kernels.ExplainArgs, f).offset == 8 * i
        assert blk[i] == vals[f]


def test_explain_args_lists_the_c_structs_fields_in_order():
    text = (kernels.CSRC / "explain.cu").read_text()
    fields = _c_fields(text, "ExplainArgs")
    assert [f for f, _d in fields] == list(kernels.EXPLAIN_FIELDS)
    for f, decl in fields:
        assert "*" in decl or decl.startswith("i64 "), (f, decl)
    assert [f for f, _t in kernels.ExplainArgs._fields_][
        :len(kernels.EXPLAIN_TENSOR_FIELDS)] == list(
        kernels.EXPLAIN_TENSOR_FIELDS)


def test_gather_call_lists_the_c_structs_fields_in_order():
    """GatherCall's fields, each an int64 (a pointer's address, an int, or
    an array of them), in kernels.GATHER_CALL's order and widths; the
    ring's width from the source's GATHER_RING; the kernel's parameters
    (GatherArgs) the block's inputs and mirrors, then the outputs; the
    _Plan block's length and the slots the wrapper patches."""
    from karmada_tpu_torch.ops import resident_gather as RG

    text = (kernels.CSRC / "resident.cu").read_text()
    ring = int(re.search(r"constexpr int GATHER_RING = (\d+);",
                         text).group(1))
    assert ring == kernels.GATHER_RING
    got = []
    for name, decl in _c_fields(text, "GatherCall"):
        assert decl.startswith("i64 "), (name, decl)
        m = re.fullmatch(r"(\w+)\[(\w+)\]", name)
        if m:
            n = m.group(2)
            got.append((m.group(1), ring if n == "GATHER_RING" else int(n)))
        else:
            got.append((name, 1))
    assert got == list(kernels.GATHER_CALL)
    args = [f for f, _d in _c_fields(text, "GatherArgs")]
    assert args[3:15] == [f"s_{f}" for f in RG.GATHER_FIELDS]
    assert args[15:27] == list(RG.OUT_FIELDS)
    assert args[:3] == ["slots", "lane_inv", "drop"] and args[27:] == [
        "B", "Kp", "Ke"]
    at = kernels.gather_call_offsets()
    assert at["len"] == sum(n for _f, n in kernels.GATHER_CALL)
    assert (at["mirrors"], at["out_off"], at["B"]) == (3, 15, 27)
    assert (RG._B, RG._SLAB, RG._STAGED, RG._NINV) == (
        at["B"], at["slab"], at["staged"], at["n_inv"])


def _call_layout(text, struct, consts):
    """[(field, width in int64 slots)] of an all-int64 C struct, array
    widths read as numbers or as the named constants."""
    got = []
    for name, decl in _c_fields(text, struct):
        assert decl.startswith("i64 "), (name, decl)
        m = re.fullmatch(r"(\w+)\[(\w+)\]", name)
        if m:
            n = m.group(2)
            got.append((m.group(1), consts[n] if n in consts else int(n)))
        else:
            got.append((name, 1))
    return got


def _const(text, name):
    return int(re.search(rf"constexpr \w+ {name} = (\d+);", text).group(1))


def test_dirty_call_lists_the_c_structs_fields_in_order():
    """K12's call block (dirty.cu DirtyCall) against kernels.DIRTY_CALL,
    field by field and width by width; the kernel's parameters
    (DirtyArgs) begin with the block's device operands in
    DIRTY_DEVICE_FIELDS order; the block's size agrees with the source's
    static_assert; the slots ops/dirty.py patches sit where the block has
    them."""
    from karmada_tpu_torch.ops import dirty as DM

    text = (kernels.CSRC / "dirty.cu").read_text()
    assert _call_layout(text, "DirtyCall", {}) == list(kernels.DIRTY_CALL)
    args = [f for f, _d in _c_fields(text, "DirtyArgs")]
    n = len(kernels.DIRTY_DEVICE_FIELDS)
    assert args[:n] == list(kernels.DIRTY_DEVICE_FIELDS)
    assert args[n:n + 4] == ["pl_has_region_sc", "flip_lanes", "rv_slots",
                             "out"]
    assert list(kernels.DIRTY_DEVICE_FIELDS) == list(
        DM.SLOT_FIELDS + DM.PLANE_FIELDS[:-1])
    at = kernels.block_offsets(kernels.DIRTY_CALL)
    size = re.search(r"sizeof\(DirtyCall\) == (\d+) \* sizeof", text)
    assert at["len"] == int(size.group(1)) == 30
    assert (DM._F0, DM._NF, DM._REG, DM._CAP, DM._VEC, DM._STAGED, DM._PIN,
            DM._PIN_BYTES) == (at["fields"], n, at["region_sc"], at["cap"],
                               at["vec"], at["staged"], at["pin"],
                               at["pin_bytes"])


def test_score_call_lists_the_c_structs_fields_in_order():
    """K13's call block (rebalance.cu ScoreCall) against
    kernels.SCORE_CALL; the lanes a block keeps in registers and the
    cluster's blocks agree with the source; the slots
    ops/rebalance_detect.py patches sit where the block has them."""
    from karmada_tpu_torch.ops import rebalance_detect as RD

    text = (kernels.CSRC / "rebalance.cu").read_text()
    assert _call_layout(text, "ScoreCall", {}) == list(kernels.SCORE_CALL)
    assert _const(text, "NT") * _const(text, "LPT") == \
        kernels.SCORE_BLOCK_LANES
    assert _const(text, "CLUSTER_MAX") == kernels.SCORE_CLUSTER_MAX
    at = kernels.block_offsets(kernels.SCORE_CALL)
    assert at["len"] == 15
    assert (RD._COM, RD._OUT, RD._C, RD._STAGED, RD._PIN_BYTES, RD._TIMED,
            RD._NS) == (at["committed"], at["out"], at["C"], at["staged"],
                        at["pin_bytes"], at["timed"], at["kernel_ns"])
