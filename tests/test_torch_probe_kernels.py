"""K14 probe_mm (wgmma + TMA) and K15 marker_affine (16-byte vectors, a
lean launch): their argument blocks, K14's shape rule, and their plain
versions against the JAX programs on the CPU; the kernels against their
plain versions on the card.

On the CPU: ``probe_mm_plain`` against the probe snippet's ``jax.jit(
lambda a: a @ a)`` on seeded normal(0, 1) bf16 matrices (JAX imported
inside the test, on the CPU), within one bf16 ulp of the plain result
plus n * 2^-24 * sum_k |a_ik * a_kj| (the two sum in another order); the
array("q") block both wrappers fill against probe.cu's ProbeMmArgs and
MarkerArgs, field by field and byte for byte; the n % 8 rule's message.

On the card (marked `gpu`, skipped here inside the test): K14 within
the tolerance on normal inputs at 128, 1,000 and 1,024, its ValueError
at n = 100 and on an operand off a 16-byte boundary, and the launch
counters; K14 bit for bit on {-1, 0, 1} inputs and K15 at every length
and offset are tests/test_torch_lifecycle.py's card cases.

    python -m pytest tests/test_torch_probe_kernels.py -q -m gpu
"""

import ctypes

import numpy as np
import pytest
import torch

from karmada_tpu_torch.ops import kernels, probe
from test_torch_rows_args import _c_fields

INT64 = np.iinfo(np.int64)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels run only on the card)")


def _normal_bf16(n, seed):
    """A seeded n x n normal(0, 1) matrix, rounded to bf16 (as float32)."""
    a = np.random.default_rng(seed).standard_normal((n, n)).astype(
        np.float32)
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _within_order_tolerance(got, want, a):
    """|got - want| <= one bf16 ulp of the plain result `want` + n * 2^-24
    * (|a| @ |a|): two float32 sums of the same n products in another
    order, each rounded once to bf16 (the ulp of a bf16 in [2^e, 2^(e+1))
    is 2^(e-7); a zero `want` gets the second term alone)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = a.shape[0]
    absa = np.abs(a.astype(np.float64))
    mag = np.abs(want)
    ulp = np.where(mag > 0, np.ldexp(1.0, (np.floor(np.log2(
        np.where(mag > 0, mag, 1.0))) - 7).astype(np.int64)), 0.0)
    tol = ulp + n * 2.0 ** -24 * (absa @ absa)
    return np.abs(got - want) <= tol


def _ternary(n, seed):
    """{-1, 0, 1} entries: every float32 partial sum of the square is an
    exact integer, whatever the order."""
    return torch.from_numpy(np.random.default_rng(seed).integers(
        -1, 2, (n, n)).astype(np.float32)).to(torch.bfloat16)


def _marker_input(n, offset, seed):
    """n seeded int64 values, the int64 edges and -1 first, as a view
    `offset` elements into its storage (offset 1: 8 bytes off a 16-byte
    boundary)."""
    h = np.random.default_rng(seed).integers(INT64.min, INT64.max,
                                             n + offset, dtype=np.int64)
    h[offset:offset + 3] = (INT64.min, INT64.max, -1)[:min(3, n)]
    return torch.from_numpy(h)[offset:]


# -- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("n", [8, 64, 128])
def test_probe_mm_plain_matches_jax_on_normal_inputs(n):
    import jax
    import jax.numpy as jnp

    a = _normal_bf16(n, seed=100 + n)
    want = jax.jit(lambda x: x @ x)(jnp.asarray(a, jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    got = probe.probe_mm(torch.from_numpy(a).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (n, n)
    ok = _within_order_tolerance(got.float().numpy(),
                                 np.asarray(want, np.float32), a)
    assert ok.all(), np.argwhere(~ok)[:5]


@pytest.mark.parametrize("struct,names", [
    ("ProbeMmArgs", ("a", "c", "n", "device")),
    ("MarkerArgs", ("a", "out", "n", "device"))])
def test_probe_block_matches_the_c_struct(struct, names):
    """probe.block fills probe.cu's struct: two pointers, then n and the
    device index as int64, byte for byte with a ctypes mirror of it."""
    fields = _c_fields((kernels.CSRC / "probe.cu").read_text(), struct)
    assert tuple(f for f, _d in fields) == names
    assert len(fields) == len(probe.BLOCK_FIELDS)
    for (f, decl), role in zip(fields, probe.BLOCK_FIELDS):
        want_ptr = role in ("src", "dst")
        assert ("*" in decl) == want_ptr, (f, decl)
        assert want_ptr or decl.startswith("i64 "), (f, decl)
    mirror = kernels._struct(struct, names[:2], names[2:])  # noqa: SLF001
    vals = (0x7F00_0000_0040, 0x7F00_0000_1080, (1 << 40) + 3, 5)
    blk = probe.block(*vals)
    assert blk.itemsize == 8 and list(blk) == list(vals)
    assert bytes(mirror(*vals)) == blk.tobytes()
    assert ctypes.sizeof(mirror) == 8 * len(probe.BLOCK_FIELDS)


@pytest.mark.parametrize("n,ok", [(8, True), (100, False), (128, True),
                                  (1000, True), (1001, False), (1024, True)])
def test_probe_mm_shape_rule(n, ok):
    """On the card n % 8 == 0 (TMA's 16-byte row stride); the wrapper's
    docstring states the rule and its ValueError says why."""
    err = probe.probe_mm_shape_error(n)
    assert (err is None) == ok
    if not ok:
        assert "n % 8 == 0" in err and "16 bytes" in err and str(n) in err
    assert "n % 8 == 0" in probe.probe_mm.__doc__
    assert "ValueError" in probe.probe_mm.__doc__
    assert "16-byte aligned" in probe.probe_mm_shape_error(128, 8)
    # the plain version takes any n
    a = _ternary(n, seed=n)
    assert torch.equal(probe.probe_mm(a).view(torch.int16),
                       probe.probe_mm_plain(a).view(torch.int16))


@pytest.mark.parametrize("n", [1, 2, 127, 128, 1 << 12])
@pytest.mark.parametrize("offset", [0, 1])
def test_marker_affine_plain_wraps_like_numpy(n, offset):
    """The plain version on any length and an 8-byte-offset view: 2 a + 1
    modulo 2^64, as numpy's wrapping int64 arithmetic gives it."""
    a = _marker_input(n, offset, seed=n)
    got = probe.marker_affine(a)
    with np.errstate(over="ignore"):
        want = a.numpy() * np.int64(2) + np.int64(1)
    np.testing.assert_array_equal(got.numpy(), want)


# -- on the card -------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n", [128, 1000, 1024])
def test_probe_mm_normal_within_tolerance_on_card(n):
    _card()
    a = _normal_bf16(n, seed=200 + n)
    t = torch.from_numpy(a).to(torch.bfloat16)
    got = probe.probe_mm(t.cuda()).float().cpu().numpy()
    ok = _within_order_tolerance(got, probe.probe_mm_plain(t).float().numpy(),
                                 a)
    assert ok.all(), np.argwhere(~ok)[:5]


@pytest.mark.gpu
def test_probe_mm_refuses_n_not_multiple_of_8_on_card():
    _card()
    kernels.reset_counts()
    with pytest.raises(ValueError, match=r"n % 8 == 0"):
        probe.probe_mm(torch.zeros((100, 100), dtype=torch.bfloat16,
                                   device="cuda"))
    # an operand 8 bytes off a 16-byte boundary
    flat = torch.zeros(129 * 128, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        probe.probe_mm(flat[4:4 + 128 * 128].view(128, 128))
    assert kernels.LAUNCHES["probe_mm"] == 0


@pytest.mark.gpu
def test_launch_counters_count_one_per_launch_on_card():
    _card()
    kernels.reset_counts()
    a = torch.ones((128, 128), dtype=torch.bfloat16, device="cuda")
    m = torch.arange(128, device="cuda")
    for i in range(3):
        probe.probe_mm(a)
        probe.marker_affine(m)
        assert kernels.LAUNCHES["probe_mm"] == i + 1
        assert kernels.LAUNCHES["marker_affine"] == i + 1
    probe.probe_mm(a[:0, :0])  # n = 0: nothing to launch
    probe.marker_affine(m[:0])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["probe_mm"] == 3
    assert kernels.LAUNCHES["marker_affine"] == 3
    with pytest.raises(TypeError):
        probe.marker_affine(m.int())
    assert kernels.LAUNCHES["marker_affine"] == 3
