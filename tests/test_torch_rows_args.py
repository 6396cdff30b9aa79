"""K2's argument block on the launch path: kernels.RowsArgs (the ctypes
mirror of schedule_rows.cu's RowsArgs) against the array("q") block the
hot path fills (kernels.rows_block, solver.RowsWorkspace), byte for byte,
and against the C struct in the source, field by field."""

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


def _c_fields(text):
    """(name, declaration) of every field of `struct RowsArgs` in a CUDA
    source, in order."""
    body = text.split("struct RowsArgs {", 1)[1].split("};", 1)[0]
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
